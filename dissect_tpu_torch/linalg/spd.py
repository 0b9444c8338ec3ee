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

A whole V of more than TRIANGULAR_INVERSE_MIN_N rows is inverted from
its factor as LAPACK's potri does it, trtri then lauum, in place over the
factor (`triangular_inverse_`): torch.cholesky_inverse of one CUDA matrix
solves against an n x n identity (potrs, 2n^3 flops and two more n x n
planes), where trtri and lauum take n^3/3 each, nearly all in GEMMs.
Smaller and batched matrices keep torch.cholesky_inverse.
"""

from __future__ import annotations

import torch

from dissect_tpu_torch.runtime.timers import timers

# a whole V of more rows takes `triangular_inverse_`
TRIANGULAR_INVERSE_MIN_N = 4096
# its recursion's leaves: blocks of at most this many rows take the plain
# solve and product
TRIANGULAR_LEAF = 512
# its split points are multiples of this, so the products' tiles stay
# whole; at most TRIANGULAR_LEAF / 2
TRIANGULAR_ALIGN = 256


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
    if chol.ndim == 2 and chol.shape[-1] > TRIANGULAR_INVERSE_MIN_N:
        timers.count("spd.triangular_inverses")
        return triangular_inverse_(chol), logdet, True
    return torch.cholesky_inverse(chol), logdet, True


def triangular_inverse_(chol):
    """V^-1 = L^-T L^-1 from V's lower Cholesky factor L (zero above the
    diagonal), in place over L's storage: trtri, then the lower triangle
    of lauum, then the upper triangle mirrored from it, so the result is
    exactly symmetric.  Both steps recurse on halves split at multiples of
    TRIANGULAR_ALIGN and multiply triangles only in their leaves of at
    most TRIANGULAR_LEAF rows, so n^3/3 flops each, nearly all in large
    GEMMs, with leaf-sized temporaries."""
    leaf, align = TRIANGULAR_LEAF, TRIANGULAR_ALIGN
    _trtri_(chol, leaf, align)
    _lauum_lower_(chol, leaf, align)
    _mirror_lower_(chol, leaf)
    return chol


def _split(n, align):
    """A multiple of `align` near n / 2; inside (0, n) for n > 2 * align."""
    return max(align, round(n / (2 * align)) * align)


def _trtri_(l, leaf, align):
    """L^-1 in place over the lower-triangular L (recursive dtrtri).  With
    L = [[A, 0], [B, C]], A and C invert in their blocks, then B becomes
    -C^-1 B A^-1 by two triangular products.  (Solving for B against the
    untouched A and C instead leaves cuBLAS TRSMs on leaf-wide strips,
    which ran at a third of the FP64 peak on an H100.)"""
    n = l.shape[0]
    if n <= leaf:
        eye = torch.eye(n, dtype=l.dtype, device=l.device)
        l.copy_(torch.linalg.solve_triangular(l, eye, upper=False))
        return
    k = _split(n, align)
    a, b, c = l[:k, :k], l[k:, :k], l[k:, k:]
    _trtri_(a, leaf, align)
    _trtri_(c, leaf, align)
    _trmm_(a, b, False, leaf, align)
    _trmm_(c, b, True, leaf, align)
    b.neg_()


def _trmm_(t, b, left, leaf, align):
    """b <- t b (`left`) or b t, in place over b, for the lower-triangular
    t (recursive dtrmm).  With t = [[T11, 0], [T21, T22]], one GEMM with
    T21 sits between two half-size products, each ordered to read the
    half of b it needs before that half is overwritten."""
    n = t.shape[0]
    if n <= leaf:
        b.copy_(t @ b if left else b @ t)
        return
    k = _split(n, align)
    t11, t21, t22 = t[:k, :k], t[k:, :k], t[k:, k:]
    if left:
        b1, b2 = b[:k], b[k:]
        _trmm_(t22, b2, left, leaf, align)
        b2.addmm_(t21, b1)
        _trmm_(t11, b1, left, leaf, align)
    else:
        b1, b2 = b[:, :k], b[:, k:]
        _trmm_(t11, b1, left, leaf, align)
        b1.addmm_(b2, t21)
        _trmm_(t22, b2, left, leaf, align)


def _lauum_lower_(w, leaf, align):
    """The lower triangle of W^T W in place over the lower-triangular W
    (recursive dlauum).  With W = [[P, 0], [Q, R]], the top-left block
    becomes lauum(P) + Q^T Q and the bottom-left R^T Q (as Q^T R,
    transposed), both while Q and R are untouched, then R's block
    recurses.  What lands above the diagonal is overwritten by
    `_mirror_lower_`."""
    n = w.shape[0]
    if n <= leaf:
        w.copy_(w.mT @ w)
        return
    k = _split(n, align)
    p, q, r = w[:k, :k], w[k:, :k], w[k:, k:]
    _lauum_lower_(p, leaf, align)
    _syrk_lower_(p, q, leaf, align)
    _trmm_(r, q.mT, False, leaf, align)
    _lauum_lower_(r, leaf, align)


def _syrk_lower_(c, a, leaf, align):
    """The lower triangle of c += a^T a (recursive dsyrk): only the
    diagonal leaves form a whole square."""
    n = c.shape[0]
    if n <= leaf:
        c.addmm_(a.mT, a)
        return
    k = _split(n, align)
    a1, a2 = a[:, :k], a[:, k:]
    _syrk_lower_(c[:k, :k], a1, leaf, align)
    c[k:, :k].addmm_(a2.mT, a1)
    _syrk_lower_(c[k:, k:], a2, leaf, align)


def _mirror_lower_(m, panel):
    """The upper triangle of `m` set to the transpose of its lower one,
    a column panel at a time."""
    n = m.shape[0]
    for j0 in range(0, n, panel):
        j1 = min(j0 + panel, n)
        d = m[j0:j1, j0:j1]
        d.copy_(torch.tril(d) + torch.tril(d, -1).mT)
        m[j0:j1, j1:].copy_(m[j1:, j0:j1].mT)


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
