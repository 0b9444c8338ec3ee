"""Batched per-SNP ordinary least squares.

Parity: GWAS::computeGLMWithoutCovariance (gwas.cpp:702-785): for each
SNP the incidence is [X | g]; b = (X'X)^-1 X'y, SE_i =
sqrt(MSE * (X'X)^-1_ii), t-tests with df = n - p, p = 2*t_sf(df, |t|).
Port of dissect_tpu/gwas/ols.py.

The per-SNP loop is a closed-form block-inverse update batched over the
SNP axis.  With A = X'X and for each SNP g: u = X'g, gt = g - X A^-1 u,
d = gt'gt:
  b_snp   = gt'y / d
  b_cov   = A^-1 X'y - (A^-1 u) b_snp
  SSE     = SSE_base - b_snp^2 d
  (X'X)^-1 diagonal: cov part A^-1_ii + (A^-1 u)_i^2/d, SNP part 1/d.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dissect_tpu_torch.runtime.stats import f_sf, t_sf


@dataclasses.dataclass
class GwasResults:
    """Per-SNP association results (host arrays).

    snp_beta/se/stat/p: (M,); cov_beta/cov_se/cov_p: (M, c) the
    covariate coefficients refitted per SNP."""

    snp_beta: np.ndarray
    snp_se: np.ndarray
    snp_stat: np.ndarray
    snp_p: np.ndarray
    cov_beta: np.ndarray
    cov_se: np.ndarray
    cov_p: np.ndarray
    df: float
    model: str = "OLS"
    converged: "np.ndarray" = None  # per-SNP fit convergence (ML refits)
    # per-SNP GROUPPV (computeGroupSignificance, gwas.cpp:916-967):
    # OLS F-test / mixed-model chi2 LRT of the SNP fit vs the
    # covariate-only reduced model; -1 marks a negative LRT ratio
    group_p: "np.ndarray" = None


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def ols_gwas(genotypes: torch.Tensor, y, x) -> GwasResults:
    """Batched OLS GWAS.  genotypes: (M, n) centered dosage rows (missing
    zeroed by the caller) on the compute device, in its bulk dtype; y:
    (n,); x: (n, c) incl. the mean column."""
    g = genotypes
    dtype, device = g.dtype, g.device
    yv = torch.as_tensor(np.asarray(y), device=device).to(dtype)
    xm = torch.as_tensor(np.asarray(x), device=device).to(dtype)
    n, c = xm.shape
    a = xm.T @ xm
    a_inv = torch.linalg.inv(a)
    b0 = a_inv @ (xm.T @ yv)  # base OLS coefficients
    y_res = yv - xm @ b0
    sse_base = yv @ y_res  # y'y - b0'X'y
    u = g @ xm  # (M, c)
    au = u @ a_inv  # (M, c) = (A^-1 u)^T rows
    g_res_dot_y = g @ y_res
    gg = torch.einsum("mi,mi->m", g, g)
    d = gg - torch.einsum("mc,mc->m", u, au)  # g~'g~
    d = torch.where(d > 0, d, torch.full_like(d, float("inf")))
    b_snp = g_res_dot_y / d
    b_cov = b0[None, :] - au * b_snp[:, None]
    sse = sse_base - b_snp**2 * d

    df = float(n - (c + 1))
    mse = _host(sse) / df
    d = _host(d)
    snp_se = np.sqrt(mse / d)
    snp_beta = _host(b_snp)
    snp_t = snp_beta / snp_se
    snp_p = 2.0 * t_sf(df, np.abs(snp_t))
    cov_var = mse[:, None] * (_host(torch.diagonal(a_inv))[None, :] + _host(au) ** 2 / d[:, None])
    cov_se = np.sqrt(cov_var)
    cov_beta = _host(b_cov)
    cov_p = 2.0 * t_sf(df, np.abs(cov_beta / cov_se))
    # GROUPPV (gwas.cpp:919-939): F = (b_snp^2 d / 1) / MSE
    group_p = f_sf(1.0, df, snp_beta**2 * d / mse)
    return GwasResults(
        snp_beta=snp_beta,
        snp_se=snp_se,
        snp_stat=snp_t,
        snp_p=snp_p,
        cov_beta=cov_beta,
        cov_se=cov_se,
        cov_p=cov_p,
        df=df,
        model="OLS",
        group_p=group_p,
    )
