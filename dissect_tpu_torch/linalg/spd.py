"""SPD inverse + log-determinant, with the LU fallback.

Parity: Matrix::symmetricInvert = pdpotrf_ + pdpotri_ with log-det from
the Cholesky diagonal (matrix.cpp:3080-3153); Matrix::invert = pdgetrf_
+ pdgetri_ with GCTA-style absolute log-det (matrix.cpp:3155-3300), used
when the Cholesky fails (reml.cpp:1859-1871).  Port of the two functions
of dissect_tpu/linalg/spd.py the diagonal REML path uses.  Neither
raises on a singular input: failure comes back as ok=False.
"""

from __future__ import annotations

import torch


def spd_inverse_logdet(v):
    """Full SPD inverse + log-det via Cholesky.  Returns (v_inv, logdet,
    ok); on non-PD input ok is False and the caller falls back to
    `lu_inverse_logdet`."""
    chol, info = torch.linalg.cholesky_ex(v)
    diag = torch.diagonal(chol)
    ok = bool(info == 0) and bool(torch.all(torch.isfinite(diag))) and bool(torch.all(diag > 0))
    logdet = 2.0 * torch.sum(torch.log(torch.where(diag > 0, diag, torch.ones_like(diag))))
    v_inv = torch.cholesky_inverse(chol)
    return v_inv, logdet, ok


def lu_inverse_logdet(v):
    """General inverse + GCTA-style absolute log-det via LU: the sign of
    the determinant is discarded, as in GCTA's REML fallback."""
    lu, piv, _ = torch.linalg.lu_factor_ex(v)
    diag = torch.diagonal(lu)
    ok = bool(torch.all(torch.isfinite(diag))) and bool(torch.all(diag != 0))
    logdet = torch.sum(torch.log(torch.abs(torch.where(diag != 0, diag, torch.ones_like(diag)))))
    eye = torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)
    v_inv = torch.linalg.lu_solve(lu, piv, eye)
    return v_inv, logdet, ok
