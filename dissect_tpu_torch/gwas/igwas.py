"""Inverse GWAS — the SNP is the outcome.

Parity: igwas.{h,cpp} (igwas.cpp:102-200, igwas.h:43-116): for every
SNP, regress the (standardized) genotype on the tested covariates from
--igwas-covar/--igwas-qcovar, or, with a GRM, fit the SNP by ML with its
own variances per SNP (igwas.cpp:575-720).  Port of
dissect_tpu/gwas/igwas.py without its `mesh_ctx` argument (multi-GPU is
ROADMAP.md queue 1 item 9).

All M regressions share the design, so each branch is one batched solve
over the SNP axis.  The bulk of each branch (the genotype rows and their
products) runs in the bulk dtype, float32 on the card and float64 on the
CPU; the per-SNP c x c and 2 x 2 solves of the ML branch run in float64.

Departure from JAX: the ML branch's per-step moments are kernel K3's
contract (dissect_tpu/gwas/pallas_moments.py:3-4 names IGWAS as a user):
m1, m2 over the features [x(x)x | lam x(x)x | lam | 1 | lam^2] of the
rotated covariates, the three weighted products g @ x and gg2, gg3.
JAX computes them on XLA (dissect_tpu/gwas/igwas.py:107-144); here every
Fisher step calls `fused_refit_moments`, which launches K3 on the card
and runs its plain version for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from dissect_tpu_torch.gwas.mlm import GRADIENT_THRESHOLD, _ml_fit_diagonal, refit_features
from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments, moment_columns
from dissect_tpu_torch.linalg.small import inv_spd_auto, solve_spd_auto, solve_spd_small
from dissect_tpu_torch.reml.engine import _host
from dissect_tpu_torch.runtime.dtypes import bulk_dtype
from dissect_tpu_torch.runtime.stats import chi2_sf, f_sf, t_sf
from dissect_tpu_torch.runtime.log import output_open


@dataclasses.dataclass
class IGwasResults:
    snp_names: List[str]
    covariate_names: List[str]
    beta: np.ndarray  # (M, c)
    se: np.ndarray
    p: np.ndarray
    model: str
    # per-SNP test of the full fit vs the reduced model: the F-test of
    # the tested covariates (OLS) or the chi2 LRT of the genetic
    # variance (covariance mode) — the reference reports this as the
    # GROUPPV column, the SNP effect columns being NA
    # (IGWAS::storeResults, igwas.cpp:932-947)
    group_p: Optional[np.ndarray] = None
    converged: Optional[np.ndarray] = None
    n_base: Optional[int] = None  # leading columns of beta that are BASE covariates

    def write(self, prefix: str):
        with output_open(prefix + ".igwas", "w") as fh:
            fh.write("SNP COVAR BETA SE PV\n")
            for i, snp in enumerate(self.snp_names):
                for j, cov in enumerate(self.covariate_names):
                    fh.write(
                        f"{snp} {cov} {self.beta[i, j]:.8g} "
                        f"{self.se[i, j]:.8g} {self.p[i, j]:.6g}\n"
                    )

    @staticmethod
    def concatenate(parts: Sequence["IGwasResults"]) -> "IGwasResults":
        """Per-chunk results joined along the SNP axis."""
        first = parts[0]
        cat = lambda attr: (
            None if getattr(first, attr) is None
            else np.concatenate([getattr(p, attr) for p in parts])
        )
        return dataclasses.replace(
            first,
            snp_names=sum((p.snp_names for p in parts), []),
            beta=cat("beta"), se=cat("se"), p=cat("p"),
            group_p=cat("group_p"), converged=cat("converged"),
        )


def _igwas_ols_core(g, x):
    a_inv = torch.linalg.inv(x.T @ x)
    beta = g @ x @ a_inv  # (M, c)
    resid = g - beta @ x.T
    sse = torch.einsum("mi,mi->m", resid, resid)
    return beta, sse, torch.diagonal(a_inv)


def _igwas_gls_core(g, x, vi):
    vix = vi @ x
    a_inv = torch.linalg.inv(x.T @ vix)
    beta = g @ vix @ a_inv
    return beta, torch.diagonal(a_inv)


def _igwas_ml_core_vmapped(g_rot, x_rot, lam, theta0s, n_iterations):
    """Reference formulation: one `_ml_fit_diagonal` per SNP, the SNP
    axis written out as a batch axis (the oracle for the moment form
    below; tests only)."""
    m = g_rot.shape[0]
    return _ml_fit_diagonal(lam, g_rot, x_rot.expand(m, *x_rot.shape), theta0s, n_iterations)


def _igwas_ml_core(g_rot, x_rot, lam, theta0s, n_iterations, moments=fused_refit_moments):
    """Per-SNP ML variance refits with the SNP as the outcome.

    IGWAS::computeGLMWithCovariance (igwas.cpp:575-720): every SNP's fit
    is an embedded ML REML with V = t1*K + t2*I, the variances FIT per
    SNP, each from its own start (theta0s: (M, 2)).  Moment form: with
    the design X shared across SNPs, every per-SNP sum is a weighted
    moment of the shared feature columns plus three weighted-outcome
    products, one `moments` call per Fisher step (K3 on the card, with
    s = x_rot: q = c columns, K = c(c+1) + 3 features).  g_rot, x_rot and
    lam are in the bulk dtype; the moments are taken to float64 and
    everything after them (solves, gradient, ML-F matrix, the thetas)
    runs in float64.  `moments` is a seam for holding K3 against its
    plain version on the card."""
    c = x_rot.shape[1]
    x_rot = x_rot.contiguous()
    feats = refit_features(x_rot, lam).contiguous()
    n_pairs = c * (c + 1) // 2
    k_feats = feats.shape[1]
    idx_np = np.zeros((c, c), np.int64)
    k_ = 0
    for i in range(c):
        for j in range(i, c):
            idx_np[i, j] = idx_np[j, i] = k_
            k_ += 1
    idx = torch.as_tensor(idx_np, device=g_rot.device)
    col_lam, col_one, col_lam2 = 2 * n_pairs, 2 * n_pairs + 1, 2 * n_pairs + 2
    c0_m1, c0_m2, c0_g1, c0_g2, c0_g3, c0_gg, _ = moment_columns(c, k_feats)
    theta0s = theta0s.to(torch.float64)
    floor = (1e-6 * (theta0s[:, 0] + theta0s[:, 1]))[:, None]

    def quad(mxx_w, gx_w, gg_w, b):
        """Sum_n w r^2 with r = g - X b."""
        return (
            gg_w
            - 2.0 * torch.einsum("mi,mi->m", b, gx_w)
            + torch.einsum("mi,mij,mj->m", b, mxx_w, b)
        )

    def quantities(thetas):
        mom = moments(g_rot, thetas.to(g_rot.dtype).contiguous(), lam, x_rot, feats)
        mom = mom.to(torch.float64)
        m1 = mom[:, c0_m1:c0_m1 + k_feats]
        m2 = mom[:, c0_m2:c0_m2 + k_feats]
        gx1 = mom[:, c0_g1:c0_g1 + c]
        gx2 = mom[:, c0_g2:c0_g2 + c]
        gx3 = mom[:, c0_g3:c0_g3 + c]
        gg2, gg3 = mom[:, c0_gg + 1], mom[:, c0_gg + 2]
        a_mat = m1[:, idx]  # (M, c, c) = X' Vi X, SPD
        b = solve_spd_auto(a_mat, gx1)
        grad = 0.5 * torch.stack(
            [
                quad(m2[:, n_pairs + idx], gx3, gg3, b) - m1[:, col_lam],
                quad(m2[:, idx], gx2, gg2, b) - m1[:, col_one],
            ],
            dim=1,
        )
        fmat = 0.5 * torch.stack(
            [
                torch.stack([m2[:, col_lam2], m2[:, col_lam]], dim=-1),
                torch.stack([m2[:, col_lam], m2[:, col_one]], dim=-1),
            ],
            dim=-2,
        )
        return a_mat, gx1, grad, fmat

    thetas = theta0s
    for _ in range(n_iterations):
        _, _, grad, fmat = quantities(thetas)
        delta = solve_spd_small(fmat, grad)  # (M, 2, 2) ML-F systems
        thetas = torch.maximum(thetas + delta, floor)

    a_mat, gx1, grad, _ = quantities(thetas)
    a_inv = inv_spd_auto(a_mat)
    b = torch.einsum("mij,mj->mi", a_inv, gx1)
    th = thetas.to(g_rot.dtype)
    v = th[:, :1] * lam[None, :] + th[:, 1:]
    r = g_rot - b.to(g_rot.dtype) @ x_rot.T
    logl = -0.5 * (torch.sum(torch.log(v), dim=1) + torch.sum(r * r / v, dim=1))
    grad_norm = torch.amax(torch.abs(grad), dim=1)
    return b, torch.diagonal(a_inv, dim1=1, dim2=2), thetas, logl, grad_norm


def igwas(
    genotypes: torch.Tensor,
    snp_names: Sequence[str],
    x,
    covariate_names: Sequence[str],
    test_x=None,
    test_names: Optional[Sequence[str]] = None,
    v_inv=None,
    covariance=None,
    initial_h2: float = 0.5,
    n_iterations: int = 15,
    dtype: Optional[torch.dtype] = None,
    moments=fused_refit_moments,
) -> IGwasResults:
    """Batched inverse GWAS.

    genotypes: (M, n) outcome rows (centered dosages, missing -> 0) on
    the compute device, best in float64: the per-SNP start variances are
    taken from them as given, then they go to `dtype` (default the
    device's bulk dtype).  x: (n, c) BASE covariates incl. the mean
    column; `test_x`/`test_names`: the TESTED covariates from
    --igwas-covar/--igwas-qcovar (no mean column, igwas.cpp:134-140) —
    the full fit is [x | test_x], the reduced fit is x alone, and
    group_p is the F-test of the added block (computeGroupSignificance,
    gwas.cpp:919-939).  `covariance` = (eigenvalues, eigenvectors) of the
    GRM enables the reference's per-SNP ML refits against an E-only
    reduced ML fit (igwas.cpp:575-720 + 604-624); `v_inv` is a fixed-V
    GLS fast path (EMMAX-style, no per-SNP variance refit).  The ML
    branch has no retry pass (none in JAX either)."""
    device = genotypes.device
    dtype = dtype or bulk_dtype(device)
    g = genotypes.to(dtype)
    put = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    n_base = np.shape(x)[1]
    if test_x is not None:
        if covariance is not None or v_inv is not None:
            # the reference rejects testing covariates under a
            # covariance (igwas.cpp:70-76)
            raise ValueError(
                "testing covariates cannot be combined with a GRM "
                "covariance (igwas.cpp:70-76)"
            )
        x = np.column_stack([np.asarray(x), np.asarray(test_x)])
        covariate_names = list(covariate_names) + list(test_names or [])
    xm = put(np.asarray(x, dtype=np.float64))
    n, c = xm.shape
    group_p = None
    converged = None
    if covariance is not None:
        lam, u = covariance
        uj = put(u)
        g_rot = (g @ uj).contiguous()
        x_rot = uj.T @ xm
        # per-SNP initial variances: h2 * var(snp) genetic, rest
        # residual (reml.prepare's OLS-variance seeding applied to the
        # SNP outcome, reml.cpp:1100-1131)
        snp_var = torch.var(genotypes.to(torch.float64), dim=1, correction=1)
        theta0s = torch.stack([initial_h2 * snp_var, (1.0 - initial_h2) * snp_var], dim=1)
        beta, a_inv_diag, _, logl, grad_norm = (
            _host(v) for v in _igwas_ml_core(
                g_rot, x_rot, put(lam).contiguous(), theta0s, n_iterations, moments=moments)
        )
        del g_rot
        se = np.sqrt(np.maximum(a_inv_diag, 0.0))
        with np.errstate(divide="ignore", invalid="ignore"):
            chi2 = (beta / se) ** 2
        p = chi2_sf(1, chi2)
        model = "MLM-ML"
        # reduced model: E-only ML (the reference deletes every non-E
        # sub-covariance and refits, igwas.cpp:604-624) — for V = s2*I
        # the profile ML is closed-form from the OLS residuals
        sse_red = _host(_igwas_ols_core(g, xm)[1])
        logl_null = -0.5 * (n * np.log(sse_red / n) + n)
        ratio = 2.0 * (logl - logl_null)
        # one extra variance in the full model; the statistically
        # standard df=1 chi2 (the reference passes the fixed-effect df
        # difference, 0, to chi1_CDF here — a degenerate corner its own
        # LRT helper avoids, results.cpp:38-52)
        group_p = np.where(ratio < 0.0, -1.0, chi2_sf(1, np.maximum(ratio, 0.0)))
        converged = grad_norm < GRADIENT_THRESHOLD
    elif v_inv is None:
        beta, sse, a_inv_diag = (_host(v) for v in _igwas_ols_core(g, xm))
        mse = sse[:, None] / (n - c)
        se = np.sqrt(mse * a_inv_diag[None, :])
        t = beta / se
        p = 2.0 * t_sf(n - c, np.abs(t))
        model = "OLS"
        if c > n_base:
            # F-test of the tested-covariate block vs the base-only
            # reduced fit (SSR = sse_reduced - sse_full, h = c - n_base)
            sse_red = _host(_igwas_ols_core(g, xm[:, :n_base])[1])
            h = float(c - n_base)
            f_stat = (sse_red - sse) / h / (sse / (n - c))
            group_p = f_sf(h, float(n - c), np.maximum(f_stat, 0.0))
    else:
        beta, a_inv_diag = (_host(v) for v in _igwas_gls_core(g, xm, put(v_inv)))
        se = np.sqrt(a_inv_diag)[None, :] * np.ones((g.shape[0], 1))
        chi2 = (beta / se) ** 2
        p = chi2_sf(1, chi2)
        model = "GLS"
    return IGwasResults(
        snp_names=list(snp_names),
        covariate_names=list(covariate_names),
        beta=beta,
        se=se,
        p=p,
        model=model,
        group_p=group_p,
        converged=converged,
        n_base=n_base,
    )
