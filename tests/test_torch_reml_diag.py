"""The port's diagonal (eigenbasis) REML held against the JAX package on
the CPU, in float64 on both sides (the parity policy): the per-step
quantities at one theta to rtol 1e-9, fitted variances to rtol 1e-6
(the fits stop on the same convergence tests; the last step's
rounding is what may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.io.phenotype import Phenotype as JaxPhenotype
from dissect_tpu.model.kernels import Kernel as JaxKernel
from dissect_tpu.model.kernels import KernelType as JaxKernelType
from dissect_tpu.reml import builders as jax_builders
from dissect_tpu.reml import engine as jax_engine
from dissect_tpu.reml.single import SingleREML as JaxSingleREML
from dissect_tpu_torch.convert import kernel_from_state, reml_theta
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.reml import builders, engine
from dissect_tpu_torch.reml.single import SingleREML
from tests.conftest import make_dosage

KEYS = ("logdet_v", "logdet_xtvix", "ytpy", "grad", "ai")


def _eigen_cohort(rng, n=80, m=200):
    d = make_dosage(rng, m, n)
    z = (d - d.mean(1, keepdims=True)) / d.std(1, keepdims=True)
    k = z.T @ z / m
    w, u = np.linalg.eigh(k)
    g = z[:30].T @ rng.normal(scale=0.2, size=30)
    y = 1.0 + g + rng.normal(size=n)
    return w, u, y


@pytest.mark.parametrize(
    "n_traits,use_correlations", [(1, False), (2, False), (2, True)]
)
@pytest.mark.parametrize("use_ml,use_f_matrix", [(False, False), (True, False), (False, True)])
def test_blockdiag_quantities_match_jax(rng, n_traits, use_correlations, use_ml, use_f_matrix):
    n = 50
    lam = np.sort(rng.uniform(0.05, 3.0, size=n))
    y = rng.normal(size=n * n_traits)
    x = np.kron(np.eye(n_traits), np.column_stack([np.ones(n), rng.normal(size=n)]))
    pv, h2 = [1.3] * n_traits, [0.4] * n_traits
    kw = dict(n_traits=n_traits, diagonal=True, use_correlations=use_correlations)
    ours_model = builders.build_variance_model([lam], ["GRM"], pv, h2, **kw)
    jax_model = jax_builders.build_variance_model([lam], ["GRM"], pv, h2, **kw)
    assert ours_model.variance_names() == jax_model.variance_names()
    theta = ours_model.initial_theta() * rng.uniform(0.7, 1.3, size=ours_model.n_variances)
    cc = ours_model.compile("cpu", torch.float64)
    ours = engine._blockdiag_quantities(
        cc, torch.as_tensor(theta), torch.as_tensor(y), torch.as_tensor(x), use_ml, use_f_matrix
    )
    theirs = jax_engine._blockdiag_quantities(
        jax_model.compile(), jnp.asarray(theta), jnp.asarray(y), jnp.asarray(x),
        use_ml, use_f_matrix,
    )
    for key in KEYS:
        np.testing.assert_allclose(
            ours[key].numpy(), np.asarray(theirs[key]), rtol=1e-9, atol=1e-12, err_msg=key
        )


def test_coefficient_derivatives_match_jax():
    lam = np.linspace(0.1, 2.0, 7)
    kw = dict(n_traits=2, diagonal=True, use_correlations=True)
    ours = builders.build_variance_model([lam], ["GRM"], [1.0, 2.0], [0.3, 0.6], **kw).compile()
    theirs = jax_builders.build_variance_model([lam], ["GRM"], [1.0, 2.0], [0.3, 0.6], **kw).compile()
    theta = np.array([0.4, 0.3, 0.8, 0.6, 0.2, 0.5])[: ours.powers.shape[1]]
    for name in ("coefficients", "coefficient_jacobian", "coefficient_hessian"):
        np.testing.assert_allclose(
            getattr(ours, name)(torch.as_tensor(theta)).numpy(),
            np.asarray(getattr(theirs, name)(jnp.asarray(theta))),
            rtol=1e-12, atol=1e-14, err_msg=name,
        )


@pytest.mark.parametrize("use_ml", [False, True])
def test_single_reml_diagonal_fit_matches_jax(rng, use_ml):
    """SingleREML on a diagonalized GRM (the GWAS null fit): fitted
    variances, logL and the AI inverse."""
    w, u, y = _eigen_cohort(rng)
    keys = [f"F{i}@I{i}" for i in range(len(y))]
    opts = dict(use_ml=use_ml)
    ours = SingleREML(
        [kernel_from_state(keys, eigenvalues=w, eigenvectors=u, device="cpu")],
        Phenotype(keys=keys, values=y, column=1), None, engine.REMLOptions(**opts), device="cpu",
    ).compute()
    theirs = JaxSingleREML(
        [JaxKernel(name="GRM", type=JaxKernelType.GRM, individual_keys=keys, diagonalized=True,
                   eigenvalues=jnp.asarray(w), eigenvectors=jnp.asarray(u))],
        JaxPhenotype(keys=keys, values=y, column=1), None, jax_engine.REMLOptions(**opts),
    ).compute(compute_blue=False)
    assert ours.result.success and theirs.result.success
    assert ours.result.variance_names == theirs.result.variance_names
    assert ours.result.n_iterations == theirs.result.n_iterations
    np.testing.assert_allclose(ours.result.variances, theirs.result.variances, rtol=1e-6)
    np.testing.assert_allclose(ours.result.log_likelihood, theirs.result.log_likelihood, rtol=1e-9)
    np.testing.assert_allclose(ours.result.ai_inverse, theirs.result.ai_inverse, rtol=1e-5)
    for a, b in zip(ours.heritabilities, theirs.heritabilities):
        assert a.name == b.name
        np.testing.assert_allclose([a.value, a.std_error], [b.value, b.std_error], rtol=1e-5)


def test_fit_started_from_jax_theta_stays_there(rng):
    """convert.reml_theta: the port's fit started at JAX's fitted
    variances (named, in the port model's order) moves them by no more
    than the convergence threshold allows."""
    w, u, y = _eigen_cohort(rng)
    keys = [f"F{i}@I{i}" for i in range(len(y))]
    theirs = JaxSingleREML(
        [JaxKernel(name="GRM", type=JaxKernelType.GRM, individual_keys=keys, diagonalized=True,
                   eigenvalues=jnp.asarray(w), eigenvectors=jnp.asarray(u))],
        JaxPhenotype(keys=keys, values=y, column=1),
    ).compute(compute_blue=False)
    driver = SingleREML(
        [kernel_from_state(keys, eigenvalues=w, eigenvectors=u, device="cpu")],
        Phenotype(keys=keys, values=y, column=1), device="cpu",
    )
    names = list(reversed(theirs.result.variance_names))
    values = theirs.result.variances[::-1]
    theta0 = reml_theta(names, values, order=theirs.result.variance_names)
    np.testing.assert_array_equal(theta0, theirs.result.variances)
    out = driver.compute(initial_theta=theta0)
    np.testing.assert_allclose(out.result.variances, theirs.result.variances, rtol=1e-4)
    with pytest.raises(ValueError):
        reml_theta(["Var(GRM)"], [1.0], order=["Var(GRM)", "Var(E)"])
