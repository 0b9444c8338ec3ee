"""SPD inverse + log-determinant, with the LU fallback.

Parity: Matrix::symmetricInvert = pdpotrf_ + pdpotri_ with log-det from
the Cholesky diagonal (matrix.cpp:3080-3153); Matrix::invert = pdgetrf_
+ pdgetri_ with GCTA-style absolute log-det (matrix.cpp:3155-3300), used
when the Cholesky fails (reml.cpp:1859-1871); Matrix::bendMatrix
(matrix.cpp:3382+).  Port of dissect_tpu/linalg/spd.py.

The JAX package caps the size of its fused inverse and of its LU
fallback (DENSE_INVERSE_MAX_N, LU_FALLBACK_MAX_N) and routes larger
matrices through a blocked cyclic Cholesky and a ridge-jittered
Cholesky: those were limits of the TPU compiler.  Here one
`torch.linalg.cholesky_ex` serves every size, its `info` is read once on
the host as the PD test, and the non-PD fallback is the LU inverse at
every size.  No function raises on a singular input: failure comes back
as ok=False.
"""

from __future__ import annotations

import torch


def cholesky_logdet(v):
    """(L, logdet, ok): lower Cholesky factor, log|V| and the PD flag,
    read on the host in one transfer."""
    chol, info = torch.linalg.cholesky_ex(v)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    ok = bool((info == 0).all() & torch.isfinite(diag).all() & (diag > 0).all())
    logdet = 2.0 * torch.sum(torch.log(torch.where(diag > 0, diag, torch.ones_like(diag))))
    return chol, logdet, ok


def spd_inverse_logdet(v):
    """Full SPD inverse + log-det via Cholesky.  Returns (v_inv, logdet,
    ok).  On non-PD input ok is False, v_inv is None (no inverse of a
    failed factor is formed) and the caller falls back to
    `lu_inverse_logdet`."""
    chol, logdet, ok = cholesky_logdet(v)
    if not ok:
        return None, logdet, False
    return torch.cholesky_inverse(chol), logdet, True


def spd_solve(v, b):
    """V^-1 b via Cholesky solve; returns (x, logdet, ok).  b is (n,) or
    (n, k)."""
    chol, logdet, ok = cholesky_logdet(v)
    rhs = b[:, None] if b.ndim == 1 else b
    x = torch.cholesky_solve(rhs, chol)
    return (x[:, 0] if b.ndim == 1 else x), logdet, ok


def lu_inverse_logdet(v):
    """General inverse + GCTA-style absolute log-det via LU: the sign of
    the determinant is discarded, as in GCTA's REML fallback."""
    lu, piv, _ = torch.linalg.lu_factor_ex(v)
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    ok = bool(torch.isfinite(diag).all() & (diag != 0).all())
    logdet = torch.sum(torch.log(torch.abs(torch.where(diag != 0, diag, torch.ones_like(diag)))))
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    v_inv = torch.linalg.lu_solve(lu, piv, eye)
    return v_inv, logdet, ok


def fallback_inverse_logdet(v):
    """Non-PD fallback inverse of the REML covariance: the LU inverse
    with the absolute log-det (Matrix::invert parity, reml.cpp:1859-1871)
    at every size."""
    return lu_inverse_logdet(v)


def bend_matrix(v, min_eigenvalue_ratio=1e-10):
    """Clip eigenvalues upward to repair a non-PD symmetric matrix
    (Matrix::bendMatrix, matrix.cpp:3382+): raise small and negative
    eigenvalues to a floor relative to the largest."""
    w, q = torch.linalg.eigh(v)
    floor = torch.clamp_min(w[-1], 0.0) * min_eigenvalue_ratio
    w = torch.maximum(w, floor)
    return (q * w[None, :]) @ q.T
