"""Batched tiny-SPD solves, unrolled over the batch axis.

Port of dissect_tpu/linalg/small.py.  The per-SNP mixed-model fits
(gwas/mlm.py) solve (q, q) normal-equation systems (q = covariates+1)
and (2, 2) Fisher systems for every SNP; they are SPD (the reference
solves them with dpotrf/dposv, reml.cpp:1859-1871).  For q up to
MAX_UNROLL_Q the Cholesky is unrolled into q(q+1)/2 elementwise ops over
the batch, with no pivoting; above it `torch.linalg.cholesky_ex` takes
over.  Either way a system that is not positive definite (a
rank-deficient per-SNP design) yields NaN, never an exception: those
SNPs fail the gradient test and reach .gwas.unfitted, as in JAX
(dissect_tpu/gwas/mlm.py:307-317).
"""

from __future__ import annotations

import torch

MAX_UNROLL_Q = 8


def cholesky_small(a):
    """Unrolled Cholesky of (..., q, q) SPD; returns the factor entries
    as a dict {(i, j): (...)-tensor} for i >= j."""
    q = a.shape[-1]
    l = {}
    for j in range(q):
        d = a[..., j, j]
        for k in range(j):
            d = d - l[(j, k)] * l[(j, k)]
        ljj = torch.sqrt(d)
        l[(j, j)] = ljj
        for i in range(j + 1, q):
            off = a[..., i, j]
            for k in range(j):
                off = off - l[(i, k)] * l[(j, k)]
            l[(i, j)] = off / ljj
    return l


def cho_solve_small(l, b):
    """Solve L L' x = b for b of shape (..., q); returns (..., q)."""
    q = max(i for i, _ in l) + 1
    y = []
    for i in range(q):
        t = b[..., i]
        for k in range(i):
            t = t - l[(i, k)] * y[k]
        y.append(t / l[(i, i)])
    x = [None] * q
    for i in reversed(range(q)):
        t = y[i]
        for k in range(i + 1, q):
            t = t - l[(k, i)] * x[k]
        x[i] = t / l[(i, i)]
    return torch.stack(x, dim=-1)


def solve_spd_small(a, b):
    """x = a^{-1} b for SPD (..., q, q) and (..., q) — unrolled, no LU."""
    return cho_solve_small(cholesky_small(a), b)


def inv_spd_small(a):
    """Full inverse of SPD (..., q, q) via q unrolled cho-solves against
    the identity columns."""
    q = a.shape[-1]
    l = cholesky_small(a)
    eye = torch.eye(q, dtype=a.dtype, device=a.device)
    cols = [
        cho_solve_small(l, torch.broadcast_to(eye[j], a.shape[:-2] + (q,)))
        for j in range(q)
    ]
    return torch.stack(cols, dim=-1)


def cholesky_diag_small(a):
    """Just the Cholesky diagonal of SPD (..., q, q), stacked (..., q) —
    enough for logdet and the PD check (NaN/non-positive on failure)."""
    l = cholesky_small(a)
    q = a.shape[-1]
    return torch.stack([l[(j, j)] for j in range(q)], dim=-1)


def _cholesky_nan(a):
    """Batched Cholesky factor with NaN for every non-PD system."""
    chol, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(chol, float("nan")), chol)


def solve_spd_auto(a, b):
    """Unrolled solve when q is small, batched Cholesky otherwise."""
    if a.shape[-1] <= MAX_UNROLL_Q:
        return solve_spd_small(a, b)
    return torch.cholesky_solve(b[..., None], _cholesky_nan(a))[..., 0]


def inv_spd_auto(a):
    """Unrolled inverse when q is small, batched Cholesky otherwise."""
    if a.shape[-1] <= MAX_UNROLL_Q:
        return inv_spd_small(a)
    return torch.cholesky_inverse(_cholesky_nan(a))
