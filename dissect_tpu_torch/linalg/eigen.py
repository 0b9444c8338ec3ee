"""Symmetric eigensolver — kernel diagonalization and PCA.

Parity: Matrix::eigenDecomposition -> pdsyev_ (matrix.cpp:3327-3380),
consumed by Kernel::diagonalizeKernel (kernel.cpp:2106-2141), PCA
(pca.cpp:36-102) and the diagonal REML fast path (reml.cpp:480-545).
Port of dissect_tpu/linalg/eigen.py: the full solve and, for k << N,
randomized subspace iteration.

The solve runs in float64 on the matrix's own device (cuSOLVER on the
card, LAPACK on the CPU).  The JAX package's routing of mid-size
accelerator eighs to host LAPACK (dissect_tpu/linalg/eigen.py:29-48)
worked around TPU compile sizes and has no counterpart here.  Note the
JAX CLI diagonalizes the float32 GRM in float32; the port's float64
eigenpairs are the more exact ones (ROADMAP.md, deliberate departures).
`eigh_topk` runs in float64 too, and draws its random start from a
`torch.Generator` seeded with `seed`: JAX's `jax.random` draw cannot be
reproduced, so the two agree on converged eigenpairs, not on iterates.
"""

from __future__ import annotations

import torch


def eigh_full(a: torch.Tensor):
    """Eigenvalues (ascending) + eigenvectors of a symmetric matrix, float64."""
    return torch.linalg.eigh(a.to(torch.float64))


def eigh_topk(a: torch.Tensor, k: int, n_iter: int = 12, seed: int = 0):
    """Top-k eigenpairs via randomized subspace iteration, float64 on the
    matrix's device: a Gaussian start of k + 8 columns, n_iter + 1
    orthonormalized products with A, then Rayleigh-Ritz on the subspace.
    Returns (w, v) with w descending, v of shape (N, k)."""
    a = a.to(torch.float64)
    n = a.shape[0]
    over = min(n, k + 8)
    gen = torch.Generator(device=a.device)
    gen.manual_seed(seed)
    q = torch.randn((n, over), generator=gen, device=a.device, dtype=a.dtype)
    q, _ = torch.linalg.qr(a @ q)
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(a @ q)
    t = q.T @ (a @ q)
    w, s = torch.linalg.eigh(t)
    w = torch.flip(w, dims=(0,))[:k]
    v = torch.flip(q @ s, dims=(1,))[:, :k]
    return w, v
