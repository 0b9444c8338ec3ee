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


def test_k3_cpu_call_counts_no_launch(rng):
    """On CPU tensors the wrapper runs the plain version: neither K3's
    launch count nor its count by row count M moves."""
    p = _problem(rng, dtype=np.float32)
    before = (mk.fused_refit_moments.launches, dict(mk.fused_refit_moments.launches_by_rows))
    mk.fused_refit_moments(*(torch.as_tensor(a) for a in _moment_inputs(p, np.float32)))
    after = (mk.fused_refit_moments.launches, dict(mk.fused_refit_moments.launches_by_rows))
    assert after == before


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


@pytest.mark.parametrize("m, n, q, k", [(50_000, 10_000, 4, 23), (1, 10_000, 4, 23),
                                        (300, 10_000, 4, 23), (777, 1000, 4, 23),
                                        (777, 1000, 9, 93), (5, 97, 2, 9), (1, 1, 4, 23)])
@pytest.mark.parametrize("sm_count", [132, 8])
def test_k3_geometry_covers_every_row_entry_and_column_once(m, n, q, k, sm_count):
    """K3's launch geometry: every SNP row in exactly one row block, every
    eigenbasis entry in exactly one n split (split starts on a stage
    boundary, each split non-empty), every moment column in exactly one
    column chunk; small M is split until the card has about two blocks
    per SM, M = 50,000 is not split."""
    row_blocks, chunks, splits, per = mk.refit_geometry(m, n, q, k, sm_count)
    rows = np.zeros(m, dtype=int)
    for rb in range(row_blocks):
        rows[rb * mk.K3_ROWS_PER_BLOCK:(rb + 1) * mk.K3_ROWS_PER_BLOCK] += 1
    assert (rows == 1).all() and (row_blocks - 1) * mk.K3_ROWS_PER_BLOCK < m
    entries = np.zeros(n, dtype=int)
    assert per % mk.K3_ENTRIES_PER_STAGE == 0
    for sp in range(splits):
        assert sp * per < n  # no empty split
        entries[sp * per:(sp + 1) * per] += 1
    assert (entries == 1).all()
    feats = np.zeros(k, dtype=int)
    s_cols = np.zeros(q, dtype=int)
    for c in range(chunks):
        feats[c * mk.K3_FEATURE_COLUMNS:(c + 1) * mk.K3_FEATURE_COLUMNS] += 1
        s_cols[c * mk.K3_S_COLUMNS:(c + 1) * mk.K3_S_COLUMNS] += 1
    assert (feats == 1).all() and (s_cols == 1).all()
    blocks = row_blocks * chunks * splits
    if row_blocks * chunks >= sm_count:
        assert splits == 1
    else:  # split, but not past about two blocks per SM
        assert splits > 1 or n <= mk.K3_MIN_SPLIT_ENTRIES
        assert blocks < 2 * sm_count + row_blocks * chunks


@pytest.mark.parametrize("m, n, q, sm_count", [(1, 1000, 4, 132), (300, 1000, 4, 132),
                                               (37, 97, 9, 132), (130, 200, 2, 1)])
def test_k3_blocks_emulated_equal_plain(rng, m, n, q, sm_count):
    """The kernel's blocks run in numpy from the packed shared columns
    (`pack_shared_columns`: per chunk [24 feats | 4 s | lam]), each split's
    partial moments summed in split order, equal the plain version:
    the layout and geometry the kernel consumes are complete."""
    g = rng.normal(size=(m, n))
    lam = 3.0 * rng.uniform(size=n)
    s = rng.normal(size=(n, q))
    thetas = 0.1 + rng.uniform(size=(m, 2))
    feats = mlm.refit_features(torch.as_tensor(s), torch.as_tensor(lam)).numpy()
    k = feats.shape[1]
    y = mk.pack_shared_columns(*(torch.as_tensor(a) for a in (lam, s, feats))).numpy()
    row_blocks, chunks, splits, per = mk.refit_geometry(m, n, q, k, sm_count)
    assert y.shape == (chunks, n, mk.K3_PACKED_WIDTH)
    c_m1, c_m2, c_gs1, c_gs2, c_gs3, c_gg, total = mk.moment_columns(q, k)
    partial = np.zeros((splits, m, total))
    qc, fc = mk.K3_S_COLUMNS, mk.K3_FEATURE_COLUMNS
    for c in range(chunks):
        f_c, s_c, lam_c = y[c, :, :fc], y[c, :, fc:fc + qc], y[c, :, fc + qc]
        assert not y[c, :, fc + qc + 1:].any()
        for sp in range(splits):
            ks = slice(sp * per, min(n, (sp + 1) * per))
            w1 = 1.0 / (thetas[:, :1] * lam_c[None, ks] + thetas[:, 1:])
            w2 = w1 * w1
            h = [w1 * g[:, ks], w2 * g[:, ks], w2 * g[:, ks] * lam_c[None, ks]]
            fcols = np.arange(c * fc, min(k, (c + 1) * fc))
            scols = np.arange(c * qc, min(q, (c + 1) * qc))
            out = partial[sp]
            out[:, c_m1 + fcols] = w1 @ f_c[ks, :len(fcols)]
            out[:, c_m2 + fcols] = w2 @ f_c[ks, :len(fcols)]
            for base, hk in zip((c_gs1, c_gs2, c_gs3), h):
                out[:, base + scols] = hk @ s_c[ks, :len(scols)]
            if c == 0:
                out[:, c_gg:c_gg + 3] = np.stack([(hk * g[:, ks]).sum(1) for hk in h], 1)
    emulated = partial.sum(0)
    plain = mk.plain_refit_moments(*(torch.as_tensor(a) for a in (g, thetas, lam, s, feats)))
    np.testing.assert_allclose(emulated, plain.numpy(), rtol=1e-10, atol=1e-10)
