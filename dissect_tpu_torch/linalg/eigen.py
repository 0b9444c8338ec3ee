"""Symmetric eigensolver — kernel diagonalization.

Parity: Matrix::eigenDecomposition -> pdsyev_ (matrix.cpp:3327-3380),
consumed by Kernel::diagonalizeKernel (kernel.cpp:2106-2141) and the
diagonal REML fast path (reml.cpp:480-545).  Port of
dissect_tpu/linalg/eigen.py:eigh_full.

The solve runs in float64 on the matrix's own device (cuSOLVER on the
card, LAPACK on the CPU).  The JAX package's routing of mid-size
accelerator eighs to host LAPACK (dissect_tpu/linalg/eigen.py:29-48)
worked around TPU compile sizes and has no counterpart here.  Note the
JAX CLI diagonalizes the float32 GRM in float32; the port's float64
eigenpairs are the more exact ones (ROADMAP.md, deliberate departures).
"""

from __future__ import annotations

import torch


def eigh_full(a: torch.Tensor):
    """Eigenvalues (ascending) + eigenvectors of a symmetric matrix, float64."""
    return torch.linalg.eigh(a.to(torch.float64))
