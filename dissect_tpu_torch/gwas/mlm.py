"""Mixed-model GWAS — batched GLS and exact per-SNP ML refits.

Parity: GWAS::computeGLMWithCovariance (gwas.cpp:787-914): each SNP's
incidence [X | g] is fit by ML with the null-model covariance kernel,
warm-started variances, chi2 Wald tests with p = chi2_sf(1, chi2)
(gwas.cpp:900-903).  After >10 tests the reference disables EM first
steps and step damping (gwas.cpp:836-841) — i.e. plain Newton — which is
what the batched path runs from the start.  Port of
dissect_tpu/gwas/mlm.py:

  mlm_gwas_fixed_v    variances fixed at the null fit: the per-SNP GLS
                      solves collapse into block-inverse products over the
                      SNP axis (--gwas-use-null-variances);
  mlm_gwas_ml_refit   the null covariance kernel is eigendecomposed once
                      and y/X/G rotate into its eigenbasis
                      (gwas.cpp:189-209), where V(theta) = t1*diag(lam) +
                      t2*I is diagonal; a Fisher-scoring ML Newton then
                      runs over all SNPs at once, O(n) per SNP per
                      iteration.

Two deliberate departures from the JAX package:

  * JAX runs its fused moments kernel only on a TPU backend
    (dissect_tpu/gwas/mlm.py:47-57) and otherwise the XLA moments.  Here
    every Fisher step calls `fused_refit_moments`, which launches kernel
    K3 for any CUDA tensor (float32, the bulk policy) and runs its plain
    version only for CPU tensors.
  * JAX's warm-started retry pass runs the XLA moments
    (dissect_tpu/gwas/mlm.py:444).  Here the retry goes through K3 too,
    and it is not padded to a power of two (that bounded JAX's compiled
    shapes; PyTorch runs eagerly).
"""

from __future__ import annotations

import numpy as np
import torch

from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments, moment_columns
from dissect_tpu_torch.gwas.ols import GwasResults
from dissect_tpu_torch.linalg.small import inv_spd_auto, solve_spd_auto, solve_spd_small
from dissect_tpu_torch.runtime.stats import chi2_sf

# per-SNP gradient threshold of a converged refit (gwas.cpp:546-554)
GRADIENT_THRESHOLD = 1e-2


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _ml_gradient(lam, vi, r):
    """0.5 * (y'P dV P y - tr(Vi dV)) for dV = diag(lam), I; batched over
    the leading axes of vi and r (..., n)."""
    pyr = vi * r  # P y in the ML profile sense
    return 0.5 * torch.stack(
        [
            torch.sum(pyr * lam * pyr, dim=-1) - torch.sum(vi * lam, dim=-1),
            torch.sum(pyr * pyr, dim=-1) - torch.sum(vi, dim=-1),
        ],
        dim=-1,
    )


def _gls_core(g, y, x, vi):
    """Batched GLS with fixed V^-1: block-inverse over the SNP axis."""
    vix = vi @ x
    viy = vi @ y
    a_inv = torch.linalg.inv(x.T @ vix)
    b0 = a_inv @ (x.T @ viy)
    y_res_vi = viy - vix @ b0  # Vi (y - X b0) = P0 y

    u = g @ vix  # (M, c)
    au = u @ a_inv
    d = torch.sum((g @ vi) * g, dim=1) - torch.sum(u * au, dim=1)
    d_safe = torch.where(d > 0, d, torch.full_like(d, float("inf")))
    b_snp = (g @ y_res_vi) / d_safe
    b_cov = b0[None, :] - au * b_snp[:, None]
    return b_snp, b_cov, d_safe, au, torch.diagonal(a_inv)


def mlm_gwas_fixed_v(genotypes: torch.Tensor, y, x, v_inv) -> GwasResults:
    """Mixed-model GWAS with variances fixed at the null-model fit
    (EMMAX-style, --gwas-use-null-variances): the per-SNP GLS solves
    collapse into block-inverse products over the SNP axis.

    genotypes: (M, n) centered dosage rows on the compute device, in its
    bulk dtype, as the refit takes them; y, x and v_inv (the (n, n)
    inverse covariance of the null fit) are moved there.  SEs come
    straight from the GLS information (no MSE factor); chi2 Wald tests
    (gwas.cpp:898-903)."""
    g = genotypes
    put = lambda a: torch.as_tensor(a).to(device=g.device, dtype=g.dtype)
    b_snp, b_cov, d, au, a_inv_diag = (
        _host(v) for v in _gls_core(g, put(y), put(x), put(v_inv))
    )
    snp_se = np.sqrt(1.0 / d)
    chi2 = b_snp**2 * d
    snp_p = chi2_sf(1, chi2)
    cov_se = np.sqrt(a_inv_diag[None, :] + au**2 / d[:, None])
    cov_chi2 = (b_cov / cov_se) ** 2
    return GwasResults(
        snp_beta=b_snp,
        snp_se=snp_se,
        snp_stat=chi2,
        snp_p=snp_p,
        cov_beta=b_cov,
        cov_se=cov_se,
        cov_p=chi2_sf(1, cov_chi2),
        df=1.0,
        model="MLM-fixedV",
        # with V fixed the LRT of adding the SNP is exactly
        # delta(r'V^-1 r) = b^2 d = the Wald chi2
        group_p=snp_p,
    )


def _ml_fit_diagonal(lam, y, xg, theta0, n_iterations):
    """Fisher-scoring ML fit of V = t1*diag(lam) + t2*I.

    Mirrors the reference's embedded ML REML with the ML-F matrix
    (computeMLFMatrix, reml.cpp:2051-2157): gradient_k =
    0.5*(y'P dV P y - tr(Vi dV)), F_kl = 0.5 tr(Vi dV_k Vi dV_l).
    Variances are clamped positive (constraint M1,
    covariancematrix.cpp:1183).  xg is (..., n, q) with any leading batch
    axes (one design, or one per SNP); theta0 is (2,).  Returns
    (b, diag((X'ViX)^-1), theta, logL, max|gradient|)."""
    floor = 1e-6 * (theta0[0] + theta0[1])
    batch = xg.shape[:-2]
    theta = theta0.expand(*batch, 2).clone()

    def solve(theta):
        v = theta[..., :1] * lam + theta[..., 1:]
        vi = 1.0 / v
        xgvi = xg * vi[..., :, None]
        a_inv = inv_spd_auto(xgvi.transpose(-1, -2) @ xg)
        b = (a_inv @ (xgvi.transpose(-1, -2) @ y[..., None]))[..., 0]
        r = y - (xg @ b[..., None])[..., 0]
        return v, vi, a_inv, b, r

    for _ in range(n_iterations):
        _, vi, _, _, r = solve(theta)
        grad = _ml_gradient(lam, vi, r)
        vi2 = vi * vi
        f01 = torch.sum(vi2 * lam, dim=-1)
        f = 0.5 * torch.stack(
            [
                torch.stack([torch.sum(vi2 * lam * lam, dim=-1), f01], dim=-1),
                torch.stack([f01, torch.sum(vi2, dim=-1)], dim=-1),
            ],
            dim=-2,
        )
        theta = torch.clamp_min(theta + solve_spd_small(f, grad), floor)
    # final fixed-effect estimates at the fitted variances
    v, vi, a_inv, b, r = solve(theta)
    logl = -0.5 * (torch.sum(torch.log(v), dim=-1) + torch.sum(r * r * vi, dim=-1))
    # convergence marker: residual variance-gradient norm (non-converged
    # per-SNP fits are reported to .gwas.unfitted, gwas.cpp:546-554)
    grad_norm = torch.amax(torch.abs(_ml_gradient(lam, vi, r)), dim=-1)
    return b, torch.diagonal(a_inv, dim1=-2, dim2=-1), theta, logl, grad_norm


def _ml_refit_core_vmapped(g_rot, y_rot, x_rot, lam, theta0, n_iterations):
    """Reference formulation: one `_ml_fit_diagonal` per SNP, the SNP
    axis written out as a batch axis.  Kept as the oracle for the
    moment-form path below (tests only)."""
    m = g_rot.shape[0]
    xg = torch.cat([x_rot.expand(m, *x_rot.shape), g_rot[:, :, None]], dim=2)
    return _ml_fit_diagonal(lam, y_rot, xg, theta0, n_iterations)


def refit_features(s, lam):
    """The shared feature columns of the moment form, (n, K) with
    K = 2 q(q+1)/2 + 3: [s(x)s | lam*s(x)s | lam | 1 | lam^2] over the
    upper-triangle pairs (i <= j) of s = [X | y]."""
    q = s.shape[1]
    pairs = [(i, j) for i in range(q) for j in range(i, q)]
    ss = torch.stack([s[:, i] * s[:, j] for i, j in pairs], dim=1)
    col = lambda v: v[:, None]
    return torch.cat([ss, col(lam) * ss, col(lam), torch.ones_like(col(lam)), col(lam * lam)], dim=1)


def _ml_refit_core(g_rot, y_rot, x_rot, lam, theta0, n_iterations,
                   moments=fused_refit_moments):
    """Moment-form per-SNP ML refits: the hot path.

    Every per-SNP sum a Fisher step needs is a weighted moment of the
    shared columns s = [X | y] (and of g), with per-SNP weights
    w = 1/(t1*lam + t2) and w^2: one `moments` call per step (kernel K3
    on the card), then batched (c+1)x(c+1) solves — the same math as
    `_ml_fit_diagonal` (gradient, ML-F matrix, M1 clamp).  `moments` is
    a seam for holding K3 against its plain version on the card."""
    m_snps, n = g_rot.shape
    c = x_rot.shape[1]
    q = c + 1
    s = torch.cat([x_rot, y_rot[:, None]], dim=1).contiguous()  # (n, q)
    feats = refit_features(s, lam).contiguous()
    n_pairs = q * (q + 1) // 2
    k_feats = feats.shape[1]
    idx_np = np.zeros((q, q), np.int64)
    k_ = 0
    for i in range(q):
        for j in range(i, q):
            idx_np[i, j] = idx_np[j, i] = k_
            k_ += 1
    idx = torch.as_tensor(idx_np, device=g_rot.device)
    col_lam, col_one, col_lam2 = 2 * n_pairs, 2 * n_pairs + 1, 2 * n_pairs + 2
    c0_m1, c0_m2, c0_g1, c0_g2, c0_g3, c0_gg, _ = moment_columns(q, k_feats)
    floor = 1e-6 * (theta0[0] + theta0[1])

    def quad(mss_w, gs_w, gg_w, b):
        """e' M_w e for e = [-b_x, -b_g, 1] on t = [x, g, y]: the
        w-weighted residual sum-of-squares."""
        bx, bg = b[:, :c], b[:, c]
        return (
            mss_w[:, c, c]
            + torch.einsum("mi,mij,mj->m", bx, mss_w[:, :c, :c], bx)
            + bg * bg * gg_w
            - 2.0 * torch.einsum("mi,mi->m", bx, mss_w[:, :c, c])
            - 2.0 * bg * gs_w[:, c]
            + 2.0 * bg * torch.einsum("mi,mi->m", bx, gs_w[:, :c])
        )

    def quantities(thetas):
        mom = moments(g_rot, thetas.contiguous(), lam, s, feats)
        m1 = mom[:, c0_m1:c0_m1 + k_feats]
        m2 = mom[:, c0_m2:c0_m2 + k_feats]
        gs1 = mom[:, c0_g1:c0_g1 + q]
        gs2 = mom[:, c0_g2:c0_g2 + q]
        gs3 = mom[:, c0_g3:c0_g3 + q]
        gg1, gg2, gg3 = mom[:, c0_gg], mom[:, c0_gg + 1], mom[:, c0_gg + 2]
        mss1 = m1[:, idx]  # (M, q, q) s-moments, weight vi
        mss2 = m2[:, idx]
        mss3 = m2[:, n_pairs + idx]  # weight vi^2 * lam
        a_mat = torch.cat(
            [
                torch.cat([mss1[:, :c, :c], gs1[:, :c, None]], dim=2),
                torch.cat([gs1[:, None, :c], gg1[:, None, None]], dim=2),
            ],
            dim=1,
        )  # (M, q, q) = [X|g]' Vi [X|g]
        rhs = torch.cat([mss1[:, :c, c], gs1[:, c:]], dim=1)
        # a rank-deficient per-SNP design gives NaN here (never an
        # exception): the SNP fails the gradient test, gets one
        # warm-started retry, and otherwise lands in .gwas.unfitted
        b = solve_spd_auto(a_mat, rhs)
        grad = 0.5 * torch.stack(
            [
                quad(mss3, gs3, gg3, b) - m1[:, col_lam],
                quad(mss2, gs2, gg2, b) - m1[:, col_one],
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
        return a_mat, rhs, grad, fmat

    thetas = theta0[None, :].expand(m_snps, 2)
    for _ in range(n_iterations):
        _, _, grad, fmat = quantities(thetas)
        thetas = torch.clamp_min(thetas + solve_spd_small(fmat, grad), floor)

    a_mat, rhs, grad, _ = quantities(thetas)
    a_inv = inv_spd_auto(a_mat)
    b = torch.einsum("mij,mj->mi", a_inv, rhs)
    # logL with the residual computed DIRECTLY (the quadratic-form
    # expansion would amplify float32 cancellation when r^2 << y^2)
    v = thetas[:, :1] * lam[None, :] + thetas[:, 1:]
    r = y_rot[None, :] - b[:, :c] @ x_rot.T - b[:, c:] * g_rot
    logl = -0.5 * (torch.sum(torch.log(v), dim=1) + torch.sum(r * r * (1.0 / v), dim=1))
    grad_norm = torch.amax(torch.abs(grad), dim=1)
    return b, torch.diagonal(a_inv, dim1=1, dim2=2), thetas, logl, grad_norm


def mlm_gwas_ml_refit(
    genotypes: torch.Tensor,
    y,
    x,
    kernel_eigenvalues,
    kernel_eigenvectors,
    null_variances,
    n_iterations: int = 15,
    retry_unfitted: bool = True,
    moments=fused_refit_moments,
) -> GwasResults:
    """Exact mixed-model GWAS: per-SNP ML variance refits.

    genotypes: (M, n) centered dosage rows on the compute device, in its
    bulk dtype (float32 on the card, float64 on the CPU); everything else
    is moved there.  kernel_eigen*: eigendecomposition of the null
    covariance kernel (the GRM).  null_variances = (genetic, residual)
    warm start.  Everything is rotated into the eigenbasis once
    (gwas.cpp:189-209), then M independent O(n)-per-iteration ML Newtons
    run as one batch.

    retry_unfitted: the batched analog of the reference's sequential warm
    starts (gwas.cpp:836-869): SNPs that fail the gradient test are refit
    once with theta0 = mean over the converged SNPs' fitted variances and
    double the iterations.
    """
    g = genotypes
    dtype, device = g.dtype, g.device
    put = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    u = put(kernel_eigenvectors)
    lam = put(kernel_eigenvalues).contiguous()
    y_rot = u.T @ put(y)
    x_rot = u.T @ put(x)
    g_rot = (g @ u).contiguous()
    theta0 = put(np.asarray(null_variances, dtype=np.float64))

    b, a_inv_diag, thetas, logl, grad_norm = _ml_refit_core(
        g_rot, y_rot, x_rot, lam, theta0, n_iterations, moments=moments
    )
    b, a_inv_diag, thetas, logl, grad_norm = (
        _host(v) for v in (b, a_inv_diag, thetas, logl, grad_norm)
    )
    if retry_unfitted:
        unfit = grad_norm >= GRADIENT_THRESHOLD  # a NaN gradient is not retried
        fit_thetas = thetas[~unfit]
        if unfit.any() and fit_thetas.size:
            idx = np.flatnonzero(unfit)
            theta_warm = put(fit_thetas.mean(axis=0))
            sub = g_rot[torch.as_tensor(idx, device=device)].contiguous()
            b2, ad2, th2, ll2, gn2 = _ml_refit_core(
                sub, y_rot, x_rot, lam, theta_warm, 2 * n_iterations, moments=moments
            )
            b[idx], a_inv_diag[idx], thetas[idx] = _host(b2), _host(ad2), _host(th2)
            logl[idx], grad_norm[idx] = _host(ll2), _host(gn2)
    # reduced (covariate-only) ML fit for the chi2 LRT GROUPPV
    # (computeGroupSignificance ML branch, gwas.cpp:940-961)
    _, _, _, logl_null, _ = _ml_fit_diagonal(lam, y_rot, x_rot, theta0, n_iterations)
    ratio = 2.0 * (logl - float(logl_null))
    group_p = np.where(ratio < 0.0, -1.0, chi2_sf(1, np.maximum(ratio, 0.0)))
    se = np.sqrt(a_inv_diag)
    chi2 = (b / se) ** 2
    p = chi2_sf(1, chi2)
    res = GwasResults(
        snp_beta=b[:, -1],
        snp_se=se[:, -1],
        snp_stat=chi2[:, -1],
        snp_p=p[:, -1],
        cov_beta=b[:, :-1],
        cov_se=se[:, :-1],
        cov_p=p[:, :-1],
        df=1.0,
        model="MLM-ML",
        group_p=group_p,
    )
    res.converged = grad_norm < GRADIENT_THRESHOLD
    return res
