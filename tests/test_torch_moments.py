"""The port's mixed-model GWAS (dissect_tpu_torch.gwas) held against the
JAX package on the CPU: kernel K3's plain version against the Pallas
kernel in interpret mode, and the per-SNP ML refit against JAX's.

Tolerances: in float32 the two sides sum in different orders, so K3's
moments agree to rtol 2e-5 and the refit, which iterates on them, to
rtol 2e-3 (tests/test_gwas_covariance.py:292-333 uses the same bound
between JAX's own two moment paths).  In float64 the refits agree to
the rounding of the iteration (rtol 1e-8 and tighter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.gwas import mlm as jax_mlm
from dissect_tpu.gwas import pallas_moments as jax_pm
from dissect_tpu_torch.gwas import mlm
from dissect_tpu_torch.gwas import moments_kernels as mk
from tests.conftest import make_dosage


def _problem(rng, n=96, m=17, n_cov=1, dtype=np.float64):
    """An unaligned mixed-model GWAS problem in the eigenbasis, as
    tests/test_gwas_covariance.py:300-313 builds it."""
    d = make_dosage(rng, m + 40, n)
    z = (d - d.mean(1, keepdims=True)).astype(np.float64)
    k = z[m:].T @ z[m:] / 40.0
    k /= np.mean(np.diag(k))
    w, u = np.linalg.eigh(k)
    y = z[:3].sum(0) * 0.2 + rng.normal(size=n)
    x = np.column_stack([np.ones(n)] + [rng.normal(size=n) for _ in range(n_cov)])
    theta0 = np.array([0.5 * y.var(), 0.5 * y.var()])
    return dict(
        g=z[:m], y=y, x=x, lam=w, u=u, theta0=theta0,
        g_rot=(z[:m] @ u).astype(dtype), y_rot=(u.T @ y).astype(dtype),
        x_rot=(u.T @ x).astype(dtype), lam_d=w.astype(dtype), theta0_d=theta0.astype(dtype),
    )


def _moment_inputs(p, dtype):
    s = np.column_stack([p["x_rot"], p["y_rot"]]).astype(dtype)
    feats = mlm.refit_features(torch.as_tensor(s), torch.as_tensor(p["lam_d"].astype(dtype)))
    thetas = np.abs(np.random.default_rng(3).normal(size=(p["g_rot"].shape[0], 2))) + 0.2
    return (p["g_rot"].astype(dtype), thetas.astype(dtype), p["lam_d"].astype(dtype), s,
            feats.numpy().astype(dtype))


def test_moment_columns_match_jax():
    for q, k in ((2, 9), (4, 23), (7, 59)):
        assert mk.moment_columns(q, k) == jax_pm.moment_columns(q, k)


def test_refit_features_match_jax_layout(rng):
    """K = 2 q(q+1)/2 + 3 columns [s(x)s | lam s(x)s | lam | 1 | lam^2],
    the layout JAX's moment form builds (dissect_tpu/gwas/mlm.py:212-225)."""
    p = _problem(rng, n_cov=2)
    s = np.column_stack([p["x_rot"], p["y_rot"]])
    feats = mlm.refit_features(torch.as_tensor(s), torch.as_tensor(p["lam_d"])).numpy()
    q = s.shape[1]
    pairs = [(i, j) for i in range(q) for j in range(i, q)]
    ss = np.stack([s[:, i] * s[:, j] for i, j in pairs], axis=1)
    lam = p["lam_d"][:, None]
    ref = np.concatenate([ss, lam * ss, lam, np.ones_like(lam), lam * lam], axis=1)
    np.testing.assert_array_equal(feats, ref)
    assert feats.shape[1] == 2 * len(pairs) + 3


@pytest.mark.parametrize("n_cov", [1, 2])
def test_plain_k3_matches_jax_interpret(rng, n_cov):
    """K3's plain version (its wrapper on CPU tensors) against the Pallas
    kernel in interpret mode with unaligned blocks (block_m 8, block_k
    32 over n = 96, M = 17), float32: rtol 2e-5."""
    p = _problem(rng, n_cov=n_cov, dtype=np.float32)
    g, thetas, lam, s, feats = _moment_inputs(p, np.float32)
    ours = mk.fused_refit_moments(*(torch.as_tensor(a) for a in (g, thetas, lam, s, feats)))
    theirs = jax_pm.fused_refit_moments.__wrapped__(
        *(jnp.asarray(a) for a in (g, thetas, lam, s, feats)),
        block_m=8, block_k=32, interpret=True,
    )
    total = mk.moment_columns(s.shape[1], feats.shape[1])[-1]
    assert tuple(ours.shape) == (g.shape[0], total)
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs)[:, :total], rtol=2e-5, atol=1e-5)


def test_k3_wrapper_refuses_other_devices(rng):
    p = _problem(rng, dtype=np.float32)
    args = [torch.as_tensor(a).to("meta") for a in _moment_inputs(p, np.float32)]
    with pytest.raises(ValueError, match="no moments kernel"):
        mk.fused_refit_moments(*args)


@pytest.mark.parametrize("n_iterations", [1, 3, 8])
def test_ml_refit_core_trajectory_matches_jax_f64(rng, n_iterations):
    """The moment-form refit after 1, 3 and 8 Fisher steps (the
    trajectory) and its outputs, float64: rtol 1e-8."""
    p = _problem(rng)
    ours = mlm._ml_refit_core(*(torch.as_tensor(p[k]) for k in
                                ("g_rot", "y_rot", "x_rot", "lam_d", "theta0_d")), n_iterations)
    theirs = jax_mlm._ml_refit_core(*(jnp.asarray(p[k]) for k in
                                      ("g_rot", "y_rot", "x_rot", "lam_d", "theta0_d")),
                                    n_iterations, use_pallas=False)
    names = ("b", "a_inv_diag", "thetas", "logl", "grad_norm")
    for name, a, b in zip(names, ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=1e-12, err_msg=name)


def test_ml_refit_core_matches_jax_f32(rng):
    """Float32, the bulk policy of the card: rtol 2e-3."""
    p = _problem(rng, dtype=np.float32)
    keys = ("g_rot", "y_rot", "x_rot", "lam_d", "theta0_d")
    ours = mlm._ml_refit_core(*(torch.as_tensor(p[k]) for k in keys), 8)
    theirs = jax_mlm._ml_refit_core(*(jnp.asarray(p[k]) for k in keys), 8, use_pallas=False)
    b, ai, th, ll, _ = ours
    jb, jai, jth, jll, _ = theirs
    assert b.dtype == torch.float32
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(ai.numpy(), np.asarray(jai), rtol=2e-3, atol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jth), rtol=2e-3)
    np.testing.assert_allclose(ll.numpy(), np.asarray(jll), rtol=2e-3, atol=2e-2)


def test_moment_form_matches_its_vmapped_oracle(rng):
    """The port's moment form against its own per-SNP oracle (the SNP
    axis written out), as JAX checks its pair (test_gwas_covariance)."""
    p = _problem(rng)
    keys = ("g_rot", "y_rot", "x_rot", "lam_d", "theta0_d")
    fast = mlm._ml_refit_core(*(torch.as_tensor(p[k]) for k in keys), 12)
    slow = mlm._ml_refit_core_vmapped(*(torch.as_tensor(p[k]) for k in keys), 12)
    for name, a, b, rtol in zip(("b", "ai", "theta", "logl"), fast, slow, (1e-8, 1e-7, 1e-8, 1e-9)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=rtol, err_msg=name)


def test_vmapped_oracle_matches_jax(rng):
    p = _problem(rng)
    keys = ("g_rot", "y_rot", "x_rot", "lam_d", "theta0_d")
    ours = mlm._ml_refit_core_vmapped(*(torch.as_tensor(p[k]) for k in keys), 6)
    theirs = jax_mlm._ml_refit_core_vmapped(*(jnp.asarray(p[k]) for k in keys), 6)
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_reduced_fit_matches_jax(rng):
    """`_ml_fit_diagonal` on the covariate-only design (the GROUPPV
    reduced model)."""
    p = _problem(rng, n_cov=2)
    ours = mlm._ml_fit_diagonal(torch.as_tensor(p["lam_d"]), torch.as_tensor(p["y_rot"]),
                                torch.as_tensor(p["x_rot"]), torch.as_tensor(p["theta0_d"]), 15)
    theirs = jax.jit(jax_mlm._ml_fit_diagonal, static_argnames=("n_iterations",))(
        jnp.asarray(p["lam_d"]), jnp.asarray(p["y_rot"]), jnp.asarray(p["x_rot"]),
        jnp.asarray(p["theta0_d"]), n_iterations=15,
    )
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("retry", [True, False])
def test_mlm_gwas_ml_refit_matches_jax(rng, retry):
    """The whole per-SNP ML refit GWAS, rank-deficient SNP included: a
    SNP equal to a covariate makes its design singular, which must give
    NaN and an unfitted SNP, never an exception, on both sides."""
    p = _problem(rng, m=24)
    g = p["g"].copy()
    g[5] = p["x"][:, 1] - p["x"][:, 1].mean()  # collinear with the covariate
    args = (p["y"], p["x"], p["lam"], p["u"], p["theta0"])
    ours = mlm.mlm_gwas_ml_refit(torch.as_tensor(g), *args, n_iterations=6, retry_unfitted=retry)
    theirs = jax_mlm.mlm_gwas_ml_refit(g, *args, n_iterations=6, retry_unfitted=retry)
    np.testing.assert_array_equal(ours.converged, theirs.converged)
    assert not ours.converged[5]
    for field in ("snp_beta", "snp_se", "snp_p", "cov_beta", "cov_se", "group_p"):
        np.testing.assert_allclose(getattr(ours, field), getattr(theirs, field),
                                   rtol=1e-7, atol=1e-12, err_msg=field)
