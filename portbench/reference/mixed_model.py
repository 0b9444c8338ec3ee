"""Plain mixed-model fits in the GRM's eigenbasis: the REML fit (the null
model of a scan, and the `--reml` fit with its BLUEs and BLUPs) and the
per-SNP ML refits.

The model is y = X b + g + e with Var(g) = s2_g K and Var(e) = s2_e I,
so V = s2_g K + s2_e I.  DISSECT's definitions:
  * REML log-likelihood -0.5 (log|V| + log|X'V^-1 X| + y'Py), without
    the constant, P = V^-1 - V^-1 X (X'V^-1 X)^-1 X' V^-1;
  * AI-REML steps theta += AI^-1 grad, grad_k = 0.5 (y'P V_k P y -
    tr(P V_k)), AI_kl = 0.5 y'P V_k P V_l P y;
  * the per-SNP GWAS refit: ML on the design [X | g] with V = t1 diag(lam)
    + t2 I in the eigenbasis, Fisher scoring (F_kl = 0.5 tr(V^-1 V_k V^-1
    V_l)), variances held above 1e-6 of the start's sum, Wald chi2 of
    the SNP's effect with one degree of freedom.
V is diagonal in the eigenbasis of K, so one eigendecomposition serves
every fit (the program's `--reml` inverts V densely each iteration: the
two meet only at the optimum).  Each fit here is iterated until its
variances stop moving, so the reference is the optimum itself, not a
fixed number of steps.
"""

from __future__ import annotations

import torch

from portbench.reference.grm import matmul_precision

# relative change of the variances at which a fit has converged: near
# float64's rounding, and near float32's for the control
TOL = {torch.float64: 1e-11, torch.float32: 1e-5}
MAX_STEPS = 200


def chi2_sf_1(chi2: torch.Tensor) -> torch.Tensor:
    """Upper tail of chi-square with one degree of freedom."""
    return torch.special.erfc(torch.sqrt(chi2.clamp_min(0) / 2.0))


def reml_diagonal(lam, y, x, dtype=torch.float64):
    """REML fit of V = t1 diag(lam) + t2 I to (y, X) rotated into the
    kernel's eigenbasis (where V is diagonal), by AI steps to convergence.
    Returns dict: theta (t1, t2), logl, blue, blue_se and py (P y in the
    eigenbasis), all at the fitted variances."""
    lam, y, x = (a.to(dtype) for a in (lam, y, x))
    var = float(torch.var(y))
    theta = torch.tensor([var / 2, var / 2], dtype=dtype, device=y.device)
    dv = torch.stack([lam, torch.ones_like(lam)])
    for _ in range(MAX_STEPS):
        vi = 1.0 / (theta[0] * lam + theta[1])
        vix = vi[:, None] * x
        a_inv = torch.linalg.inv(x.T @ vix)

        def p(z):
            return vi[:, None] * z - vix @ (a_inv @ (vix.T @ z))

        py = p(y[:, None])[:, 0]
        tr_p = (vi[None, :] * dv).sum(1) - torch.einsum(
            "ij,kji->k", a_inv, torch.einsum("nc,kn,nd->kcd", vix, dv, vix))
        vpy = dv * py[None, :]
        grad = 0.5 * ((vpy * py[None, :]).sum(1) - tr_p)
        ai = 0.5 * vpy @ p(vpy.T)
        step = torch.linalg.solve(ai, grad)
        new = theta + step
        while bool((new <= 0).any()):
            step = step / 2
            new = theta + step
        done = bool((step.abs() <= TOL[dtype] * theta.abs()).all())
        theta = new
        if done:
            break
    v = theta[0] * lam + theta[1]
    vi = 1.0 / v
    vix = vi[:, None] * x
    a = x.T @ vix
    a_inv = torch.linalg.inv(a)
    py = vi * y - vix @ (a_inv @ (vix.T @ y))
    return {
        "theta": theta,
        "logl": -0.5 * (torch.log(v).sum() + torch.linalg.slogdet(a)[1] + y @ py),
        "blue": a_inv @ (vix.T @ y),
        "blue_se": torch.sqrt(torch.diagonal(a_inv)),
        "py": py,
    }


def ml_refit(g_rot, y_rot, x_rot, lam, theta0, dtype=torch.float64):
    """Per-SNP ML refits, batched over the rows of g_rot (S, n), from
    theta0 to convergence.  Returns a dict of (S,) tensors: beta, se,
    chi2, p (the SNP's effect) and grad (the largest |gradient| at the
    end)."""
    g, y, x, lam, theta0 = (a.to(dtype) for a in (g_rot, y_rot, x_rot, lam, theta0))
    s_count, n = g.shape
    c = x.shape[1]
    floor = 1e-6 * float(theta0.sum())
    theta = theta0[None, :].repeat(s_count, 1)
    xx = torch.einsum("ni,nj->nij", x, x).reshape(n, c * c)
    xy = x * y[:, None]

    def solve(theta):
        vi = 1.0 / (theta[:, :1] * lam[None, :] + theta[:, 1:])
        a = torch.empty((s_count, c + 1, c + 1), dtype=dtype, device=g.device)
        a[:, :c, :c] = (vi @ xx).reshape(s_count, c, c)
        vg = vi * g
        a[:, :c, c] = vg @ x
        a[:, c, :c] = a[:, :c, c]
        a[:, c, c] = (vg * g).sum(1)
        rhs = torch.cat([vi @ xy, (vg * y[None, :]).sum(1, keepdim=True)], dim=1)
        a_inv = torch.linalg.inv(a)
        b = torch.einsum("sij,sj->si", a_inv, rhs)
        r = y[None, :] - b[:, :c] @ x.T - b[:, c:] * g
        return vi, a_inv, b, r

    def gradient(vi, r):
        pr = vi * r
        return 0.5 * torch.stack([((pr * pr - vi) * lam).sum(1), (pr * pr - vi).sum(1)], dim=1)

    for _ in range(MAX_STEPS):
        vi, _, _, r = solve(theta)
        grad = gradient(vi, r)
        vi2 = vi * vi
        f01 = (vi2 * lam).sum(1)
        f = 0.5 * torch.stack([torch.stack([(vi2 * lam * lam).sum(1), f01], 1),
                               torch.stack([f01, vi2.sum(1)], 1)], 1)
        new = torch.clamp_min(theta + torch.linalg.solve(f, grad), floor)
        moved = ((new - theta).abs() / theta.abs()).max()
        theta = new
        if float(moved) <= TOL[dtype]:
            break
    vi, a_inv, b, r = solve(theta)
    se = torch.sqrt(torch.diagonal(a_inv, dim1=1, dim2=2))
    chi2 = (b[:, c] / se[:, c]) ** 2
    return {"beta": b[:, c], "se": se[:, c], "chi2": chi2, "p": chi2_sf_1(chi2),
            "grad": gradient(vi, r).abs().amax(1), "theta": theta}


def rotate(rows, u, dtype=torch.float64, tf32=False):
    """rows @ u in `dtype` (TF32 products when asked: the control)."""
    with matmul_precision(tf32):
        return rows.to(dtype) @ u.to(dtype)
