"""QR decomposition + dependent-column detection.

Parity: Matrix::QRDecomposition / getDependentColumns = pdgeqrf_ with an
R-diagonal threshold test (matrix.cpp:3501-3600, matrix.h:578-590), used
by grouped GWAS to drop linearly dependent SNP columns before the joint
fit (gwas.cpp:916-967).  Port of dissect_tpu/linalg/qr.py; the QR runs
on the matrix's device, batched over any leading axes.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def qr_r_diagonal(a: torch.Tensor) -> torch.Tensor:
    """|diag(R)| of the QR factorization of a (..., rows, cols)."""
    r = torch.linalg.qr(a, mode="r").R
    return torch.abs(torch.diagonal(r, dim1=-2, dim2=-1))


def dependent_from_diagonal(diag: np.ndarray, threshold: float = 1e-8) -> np.ndarray:
    """Columns whose pivot |R[j,j]| falls below threshold * max|R| of
    their own matrix (matrix.cpp:3501-3600); all of them when max|R| is 0."""
    scale = diag.max() if diag.size else 1.0
    if scale == 0.0:
        return np.arange(diag.shape[0])
    return np.nonzero(diag < threshold * scale)[0]


def dependent_columns(a, threshold: float = 1e-8) -> np.ndarray:
    """Indices of linearly dependent columns of `a` (a tensor, or an array
    taken to the CPU in float64), as a host int array."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, dtype=np.float64))
    return dependent_from_diagonal(qr_r_diagonal(a).cpu().numpy(), threshold)


def dependent_columns_batched(a: torch.Tensor, threshold: float = 1e-8) -> List[np.ndarray]:
    """`dependent_columns` of each matrix of a (B, rows, cols) batch, with
    one batched QR."""
    diags = qr_r_diagonal(a).cpu().numpy()
    return [dependent_from_diagonal(d, threshold) for d in diags]
