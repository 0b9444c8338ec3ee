"""The port's row-sharded REML engine on the CPU, float64 against float64:
one Newton step's quantities against JAX's DistributedREMLEngine on a
4-device mesh and the port's single-device REMLEngine (rtol 1e-9),
single-trait with an indivisible N (identity padding) and bivariate
(diagonal elements kept as vectors); whole fits and every post-fit
output against the single-device engine (rtol 1e-8) at a world of one
and on 2 gloo ranks; and the convergence test's logL window, which the
port keeps where the JAX endgame's Newton-decrement rule bypasses it."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dissect_tpu_torch.convert import covariance_model_from_state
from dissect_tpu_torch.reml.distributed_engine import DistributedREMLEngine, pick_block
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions
from dissect_tpu_torch.runtime.mesh import MeshContext
from tests.test_torch_mesh_runtime import run_ranks

KEYS = ("logdet_v", "logdet_xtvix", "ytpy", "grad", "ai")


def _f32(a):
    return np.asarray(a, dtype=np.float32).astype(np.float64)


def _problem(n, n_traits=1, seed=11):
    """A GRM and a 3-level discrete kernel over n individuals, y and a
    design with the mean and one covariate per trait."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(3 * n, n))
    grm = _f32(z.T @ z / (3 * n))
    groups = np.arange(n) % 3
    re1 = (groups[:, None] == groups[None, :]).astype(np.float64)
    y = rng.normal(size=n_traits * n)
    x = np.kron(np.eye(n_traits), np.column_stack([np.ones(n), rng.normal(size=n)]))
    return grm, re1, y, x


def _jax_model(n, n_traits=1):
    from dissect_tpu.reml import builders as jax_builders

    grm, re1, y, x = _problem(n, n_traits)
    if n_traits == 1:
        model = jax_builders.build_variance_model([grm, re1], ["GRM", "RE1"], [1.0], [0.5])
    else:
        model = jax_builders.build_variance_model(
            [grm], ["GRM"], [1.0, 1.2], [0.5, 0.5], n_traits=2
        )
    return model, y, x


def _port(jax_model):
    return covariance_model_from_state(
        jax_model.n, jax_model.n_traits, jax_model.diagonal,
        {k: np.asarray(v) for k, v in jax_model.matrices.items()},
        jax_model.variances, jax_model.elements, jax_model.group_magnitudes,
        device="cpu",
    )


def _host_quantities(q):
    return {k: q[k].detach().numpy().astype(np.float64) for k in KEYS}


def _dist_quantities(ctx, n, n_traits, theta, block):
    jax_model, y, x = _jax_model(n, n_traits)
    eng = DistributedREMLEngine(_port(jax_model), y, x, ctx, block=block)
    return _host_quantities(eng._quantities(theta)), [d is not None for d in eng._sc.diag]


@pytest.mark.parametrize("n_traits, n, world", [(1, 67, 1), (1, 67, 2), (2, 40, 1), (2, 40, 2)])
def test_quantities_match_jax_distributed_engine(n_traits, n, world, tmp_path):
    """N = 67 pads to 80 (world x block 8); identity E elements are
    stored as vectors, as JAX stores them."""
    import jax.numpy as jnp
    from dissect_tpu.reml.distributed_engine import DistributedREMLEngine as JaxDist

    jax_model, y, x = _jax_model(n, n_traits)
    theta = jax_model.initial_theta() * np.linspace(0.8, 1.2, jax_model.n_variances)
    jeng = JaxDist(jax_model, y, x, Mesh(np.array(jax.devices()[:4]), ("i",)), block=8)
    theirs = {k: np.asarray(v, dtype=np.float64)
              for k, v in jeng._quantities(jnp.asarray(theta)).items() if k in KEYS}
    single = _host_quantities(REMLEngine(_port(jax_model), y, x, device="cpu")._quantities(theta))
    if world == 1:
        outs = [_dist_quantities(MeshContext(), n, n_traits, theta, 8)]
    else:
        outs = run_ranks(_dist_quantities, world, tmp_path, n, n_traits, theta, 8)
    for ours, diag in outs:
        assert any(diag) and not all(diag)  # E as a vector, the GRM dense
        for key in KEYS:
            np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-9, atol=1e-11, err_msg=key)
            np.testing.assert_allclose(ours[key], single[key], rtol=1e-9, atol=1e-11, err_msg=key)


def _fit(ctx, n, block):
    jax_model, y, x = _jax_model(n)
    opts = REMLOptions()
    if ctx is None:
        eng = REMLEngine(_port(jax_model), y, x, opts, device="cpu")
    else:
        eng = DistributedREMLEngine(_port(jax_model), y, x, ctx, opts, block=block)
    res = eng.fit()
    blue, blue_se = eng.compute_blue()
    return dict(
        theta=res.variances, logl=res.log_likelihood, it=res.n_iterations,
        ai_inv=res.ai_inverse, blue=blue, blue_se=blue_se,
        blup=eng.compute_blup_individuals("GRM"), err=eng.compute_blup_errors("GRM"),
        resid=eng.residuals(), py=eng.final_py().numpy(),
    )


@pytest.mark.parametrize("world", [1, 2])
def test_fit_and_post_fit_outputs_match_the_single_device_engine(world, tmp_path):
    n = 45
    ref = _fit(None, n, None)
    outs = [_fit(MeshContext(), n, 8)] if world == 1 else run_ranks(_fit, world, tmp_path, n, 4)
    for ours in outs:
        assert ours["it"] == ref["it"]
        for key in ref:
            if key != "it":
                np.testing.assert_allclose(ours[key], ref[key], rtol=1e-8, atol=1e-12, err_msg=key)


def test_convergence_keeps_the_logl_window(monkeypatch):
    """Departure (ADVICE.md, dissect_tpu/reml/distributed_engine.py:1290):
    JAX's endgame declares convergence once the Newton decrement is
    below 1e-4 even when logL fell by more than 1e-2.  The port's fit
    asks for -1e-2 < dlogL < 1e-4 as well: a step whose logL drops by
    0.05 with a vanishing gradient is not the last one."""
    jax_model, y, x = _jax_model(30)
    eng = DistributedREMLEngine(_port(jax_model), y, x, MeshContext(),
                                REMLOptions(first_step_em=False), block=8)
    logls = iter([-100.0, -100.05, -100.05, -100.05])
    k = jax_model.n_variances

    def quantities(theta):
        ll = next(logls)
        t = lambda v: torch.as_tensor(v, dtype=torch.float64)
        return {"logdet_v": t(-2.0 * ll), "logdet_xtvix": t(0.0), "ytpy": t(0.0),
                "grad": t(np.full(k, 1e-12)), "ai": t(np.eye(k)), "finite": torch.tensor(True)}

    monkeypatch.setattr(eng, "_quantities", quantities)
    res = eng.fit()
    decrement_at_step_2 = 0.5 * 1e-24 * k
    assert decrement_at_step_2 < 1e-4  # JAX's rule would stop at step 2
    assert res.success and res.n_iterations == 3


def test_pick_block_matches_jax():
    from dissect_tpu.reml.distributed_engine import pick_block as jax_pick

    for n, d, req in [(10000, 2, None), (67, 8, None), (40, 4, None), (500, 2, 4)]:
        assert pick_block(n, d, req) == jax_pick(n, d, req)
