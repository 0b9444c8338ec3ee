"""The port's dense REML family held against the JAX package on the CPU,
in float64 on both sides (the JAX tests run with x64 on): one Newton
step's quantities at the same theta to rtol 1e-9, post-fit outputs at
the same theta to rtol 1e-9, whole fits to rtol 1e-6 (the fits stop on
the same convergence tests; the last step's rounding may differ).  Both
engines evaluate the same V(theta): the port's model is carried over
from the JAX model by `convert.covariance_model_from_state`."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.gwas import mlm as jax_mlm
from dissect_tpu.io.bed import read_plink as jax_read_plink
from dissect_tpu.io.phenotype import Phenotype as JaxPhenotype
from dissect_tpu.linalg import spd as jax_spd
from dissect_tpu.linalg import traces as jax_traces
from dissect_tpu.model.kernels import Kernel as JaxKernel
from dissect_tpu.model.kernels import KernelType as JaxKernelType
from dissect_tpu.reml import builders as jax_builders
from dissect_tpu.reml import engine as jax_engine
from dissect_tpu.reml.reduced import reduced_model_lrts as jax_reduced_model_lrts
from dissect_tpu.reml.single import SingleREML as JaxSingleREML
from dissect_tpu.reml.snp_blup import compute_snp_blup as jax_compute_snp_blup
from dissect_tpu.runtime.checkpoint import REMLCheckpoint as JaxCheckpoint
from dissect_tpu_torch.convert import covariance_model_from_state
from dissect_tpu_torch.gwas.mlm import mlm_gwas_fixed_v
from dissect_tpu_torch.io.bed import read_plink
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.linalg import spd, traces
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.reml import builders, engine
from dissect_tpu_torch.reml.reduced import reduced_model_lrts
from dissect_tpu_torch.reml.single import SingleREML
from dissect_tpu_torch.reml.snp_blup import compute_snp_blup
from dissect_tpu_torch.runtime.checkpoint import REMLCheckpoint
from tests.conftest import make_dosage, make_plink

KEYS = ("logdet_v", "logdet_xtvix", "ytpy", "grad", "ai", "py")
NAMES = ["GRM", "RE1", "GxE"]


def _f32(a):
    """Values a float32 kernel holds exactly, so that both packages see
    the same matrix whatever dtype their kernels keep."""
    return np.asarray(a, dtype=np.float32).astype(np.float64)


@pytest.fixture(scope="module")
def cohort():
    """n = 120: a GRM from 300 SNPs, a 3-level discrete random effect,
    its GxE interaction, a phenotype with genetic and group effects, and
    a design with the mean and one quantitative covariate."""
    rng = np.random.default_rng(20261016)
    n, m = 120, 300
    d = make_dosage(rng, m, n).astype(np.float64)
    z = (d - d.mean(1, keepdims=True)) / d.std(1, keepdims=True)
    grm = _f32(z.T @ z / m)
    groups = np.arange(n) % 3
    re1 = (groups[:, None] == groups[None, :]).astype(np.float64)
    gxe = _f32(grm * re1)
    g = z[:40].T @ rng.normal(scale=0.15, size=40)
    y = 1.0 + g + 0.4 * (groups == 1) + rng.normal(size=n)
    x = np.column_stack([np.ones(n), rng.normal(size=n)])
    keys = [f"F{i}@I{i}" for i in range(n)]
    return dict(n=n, mats=[grm, re1, gxe], y=y, x=x, keys=keys, z=z, rng=rng)


def _to_port(jax_model):
    return covariance_model_from_state(
        jax_model.n, jax_model.n_traits, jax_model.diagonal,
        {k: np.asarray(v) for k, v in jax_model.matrices.items()},
        jax_model.variances, jax_model.elements, jax_model.group_magnitudes,
        device="cpu",
    )


def _models(c, mats=None, names=NAMES, **kw):
    mats = c["mats"] if mats is None else mats
    pv = float(np.var(c["y"], ddof=1))
    jax_model = jax_builders.build_variance_model(mats, names, [pv], [0.5], **kw)
    return jax_model, _to_port(jax_model)


def _quantities(core, model, theta, y, x, use_ml, use_f_matrix):
    return core(
        model.compile("cpu", torch.float64), torch.as_tensor(theta),
        torch.as_tensor(y), torch.as_tensor(x), use_ml, use_f_matrix,
    )


def _assert_quantities(ours, theirs, keys=KEYS, rtol=1e-9):
    for key in keys:
        np.testing.assert_allclose(
            ours[key].numpy(), np.asarray(theirs[key]), rtol=rtol, atol=1e-12, err_msg=key
        )


def test_converted_model_is_the_builders_model(cohort):
    """The port's builders and the model carried over from JAX compile to
    the same element table."""
    pv = float(np.var(cohort["y"], ddof=1))
    jax_model, carried = _models(cohort)
    built = builders.build_variance_model(cohort["mats"], NAMES, [pv], [0.5])
    assert built.variance_names() == carried.variance_names() == jax_model.variance_names()
    np.testing.assert_array_equal(built.initial_theta(), jax_model.initial_theta())
    a, b = built.compile("cpu"), carried.compile("cpu")
    assert a.blocks == b.blocks and a.param_ids == b.param_ids
    torch.testing.assert_close(a.powers, b.powers, rtol=0, atol=0)
    torch.testing.assert_close(a.factors, b.factors, rtol=0, atol=0)
    for ma, mb in zip(a.element_matrices, b.element_matrices):
        torch.testing.assert_close(ma, mb, rtol=0, atol=0)


@pytest.mark.parametrize("use_ml,use_f_matrix", [(False, False), (True, False), (False, True)])
def test_dense_quantities_match_jax(cohort, use_ml, use_f_matrix):
    """GRM + discrete random effect + GxE: log-dets, y'Py, gradient, AI
    and Py at one theta."""
    jax_model, model = _models(cohort)
    theta = jax_model.initial_theta() * cohort["rng"].uniform(0.7, 1.3, jax_model.n_variances)
    y, x = cohort["y"], cohort["x"]
    ours = _quantities(engine._dense_quantities, model, theta, y, x, use_ml, use_f_matrix)
    theirs = jax_engine._dense_quantities(
        jax_model.compile(), jnp.asarray(theta), jnp.asarray(y), jnp.asarray(x),
        use_ml, use_f_matrix,
    )
    _assert_quantities(ours, theirs)


def test_non_pd_v_takes_the_lu_branch_like_jax(cohort):
    """A negative residual variance between two eigenvalues of the
    genetic part makes V indefinite: the Cholesky reports it, and both
    engines take the LU inverse with the absolute log-det."""
    jax_model, model = _models(cohort, mats=cohort["mats"][:1], names=["GRM"])
    lam = np.linalg.eigvalsh(cohort["mats"][0])
    sg = 0.6
    theta = np.array([sg, -sg * 0.5 * (lam[60] + lam[61])])
    v = model.compile("cpu").assemble_dense(torch.as_tensor(theta))
    assert not spd.cholesky_logdet(v)[2]
    assert spd.spd_inverse_logdet(v)[0] is None
    y, x = cohort["y"], cohort["x"]
    ours = _quantities(engine._dense_quantities, model, theta, y, x, False, False)
    theirs = jax_engine._dense_quantities(
        jax_model.compile(), jnp.asarray(theta), jnp.asarray(y), jnp.asarray(x)
    )
    _assert_quantities(ours, theirs)


def test_autodiff_quantities_match_jax_on_a_squared_exponential_kernel(cohort):
    """GRM + a squared-exponential kernel with its fitted alpha0: dV/dtheta
    from torch.func against jax.jacfwd / jax.hessian."""
    n = cohort["n"]
    coords = np.random.default_rng(5).uniform(0, 10, size=(n, 2))
    dist = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    mats = [cohort["mats"][0], dist]
    jax_model, model = _models(
        cohort, mats=mats, names=["GRM", "SEK-1"],
        parameter_kernels={"SEK-1": 1.0 / float(np.mean(dist))},
    )
    assert model.compile("cpu").has_matrix_params
    theta = jax_model.initial_theta() * np.array([1.1, 0.9, 1.2, 0.8])
    for use_ml in (False, True):
        ours = _quantities(
            engine._dense_quantities_autodiff, model, theta, cohort["y"], cohort["x"], use_ml, False
        )
        theirs = jax_engine._dense_quantities_autodiff(
            jax_model.compile(), jnp.asarray(theta), jnp.asarray(cohort["y"]),
            jnp.asarray(cohort["x"]), use_ml,
        )
        _assert_quantities(ours, theirs)


@pytest.mark.parametrize("name", [
    "trace_of_product", "trace_of_product_symmetric", "diag_of_abat", "diag_of_aat",
])
def test_traces_match_jax(name):
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(37, 37)), rng.normal(size=(37, 37))
    b = b + b.T
    args = (a,) if name == "diag_of_aat" else (a, b)
    ours = getattr(traces, name)(*map(torch.as_tensor, args))
    theirs = getattr(jax_traces, name)(*map(jnp.asarray, args))
    np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-11, atol=1e-11)


def test_spd_functions_match_jax():
    """bend_matrix, the Cholesky log-det and solve, and the LU fallback."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(40, 40))
    v = a @ a.T + 40 * np.eye(40)
    indefinite = v - 60 * np.eye(40)
    b = rng.normal(size=(40, 3))
    np.testing.assert_allclose(
        spd.bend_matrix(torch.as_tensor(indefinite)).numpy(),
        np.asarray(jax_spd.bend_matrix(jnp.asarray(indefinite))), rtol=1e-9, atol=1e-9,
    )
    for ours, theirs in zip(spd.cholesky_logdet(torch.as_tensor(v)),
                            jax_spd.cholesky_logdet(jnp.asarray(v))):
        np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), rtol=1e-11, atol=1e-12)
    for col in (b, b[:, 0]):
        x, logdet, ok = spd.spd_solve(torch.as_tensor(v), torch.as_tensor(col))
        assert ok
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(v, col), rtol=1e-10)
    ours = spd.fallback_inverse_logdet(torch.as_tensor(indefinite))
    theirs = jax_spd.fallback_inverse_logdet(jnp.asarray(indefinite))
    for o, t in zip(ours, theirs):
        np.testing.assert_allclose(np.asarray(o), np.asarray(t), rtol=1e-9, atol=1e-11)
    assert not spd.cholesky_logdet(torch.as_tensor(indefinite))[2]


def _small_route(monkeypatch, min_n, leaf, align):
    """The triangular inverse taken above `min_n` rows, recursing down to
    leaves of `leaf` rows split at multiples of `align`."""
    monkeypatch.setattr(spd, "TRIANGULAR_INVERSE_MIN_N", min_n)
    monkeypatch.setattr(spd, "TRIANGULAR_LEAF", leaf)
    monkeypatch.setattr(spd, "TRIANGULAR_ALIGN", align)


def _well_conditioned_spd(n):
    a = np.random.default_rng(n).normal(size=(n, n))
    return a @ a.T / n + np.eye(n)


@pytest.mark.parametrize("leaf,align", [(4, 2), (512, 256)])
@pytest.mark.parametrize("n", [1, 7, 64, 257, 600])
def test_the_triangular_inverse_is_the_cholesky_inverse(monkeypatch, n, leaf, align):
    """spd_inverse_logdet above a lowered size (leaves of 4 rows, or the
    module's 512, which splits only n = 600): torch.cholesky_inverse's
    and numpy's inverse to 1e-12 of the largest entry, exactly
    symmetric, the same log-det, formed in the factor's storage."""
    v = torch.as_tensor(_well_conditioned_spd(n))
    ref, ref_logdet, _ = spd.spd_inverse_logdet(v)
    _small_route(monkeypatch, 0, leaf, align)
    vi, logdet, ok = spd.spd_inverse_logdet(v)
    assert ok and torch.equal(vi, vi.mT)
    assert logdet.item() == ref_logdet.item()
    scale = float(ref.abs().max())
    np.testing.assert_allclose(vi.numpy(), ref.numpy(), rtol=0, atol=1e-12 * scale)
    np.testing.assert_allclose(vi.numpy(), np.linalg.inv(v.numpy()), rtol=0, atol=1e-12 * scale)
    chol = spd.cholesky_logdet(v)[0]
    assert spd.triangular_inverse_(chol).data_ptr() == chol.data_ptr()


def test_v_at_the_size_limit_or_batched_keeps_cholesky_inverse(monkeypatch):
    """At TRIANGULAR_INVERSE_MIN_N rows, and for a batch of any size, the
    inverse is torch.cholesky_inverse's, bit for bit."""
    v = torch.as_tensor(_well_conditioned_spd(40))
    chol = spd.cholesky_logdet(v)[0]
    monkeypatch.setattr(spd, "TRIANGULAR_INVERSE_MIN_N", 40)
    assert torch.equal(spd.spd_inverse_logdet(v)[0], torch.cholesky_inverse(chol))
    monkeypatch.setattr(spd, "TRIANGULAR_INVERSE_MIN_N", 0)
    batch = torch.stack([v, 2 * v])
    assert torch.equal(spd.spd_inverse_logdet(batch)[0],
                       torch.cholesky_inverse(spd.cholesky_logdet(batch)[0]))


def _kernels(c):
    ours = [Kernel(name=nm, type=KernelType.GRM, individual_keys=c["keys"],
                   matrix=torch.as_tensor(m)) for nm, m in zip(NAMES, c["mats"])]
    theirs = [JaxKernel(name=nm, type=JaxKernelType.GRM, individual_keys=c["keys"],
                        matrix=jnp.asarray(m)) for nm, m in zip(NAMES, c["mats"])]
    return ours, theirs


def _single_remls(c, **kw):
    ours, theirs = _kernels(c)
    p = Phenotype(keys=c["keys"], values=c["y"], column=1)
    jp = JaxPhenotype(keys=c["keys"], values=c["y"], column=1)
    return (SingleREML(ours, p, device="cpu", **kw), JaxSingleREML(theirs, jp, **kw))


def test_dense_fit_matches_jax(cohort):
    """SingleREML with three dense kernels, end to end: variances, logL,
    iterations, AI inverse and the summary rows."""
    _assert_dense_fit_matches_jax(cohort)


def test_dense_fit_through_the_triangular_inverse_matches_jax(cohort, monkeypatch):
    """The same fit with V (n = 120) above a lowered size, so each
    evaluation's V^-1 comes from the recursive trtri and lauum (leaves of
    16 rows) and X'V^-1X's (2 x 2) from torch.cholesky_inverse."""
    _small_route(monkeypatch, 64, 16, 8)
    sizes = []
    inverse = spd.triangular_inverse_
    monkeypatch.setattr(spd, "triangular_inverse_",
                        lambda chol: sizes.append(chol.shape[0]) or inverse(chol))
    ours = _assert_dense_fit_matches_jax(cohort)
    assert sizes == [cohort["n"]] * ours.result.n_iterations


def _assert_dense_fit_matches_jax(cohort):
    ours_single, theirs_single = _single_remls(cohort)
    ours = ours_single.compute(compute_blue=False)
    theirs = theirs_single.compute(compute_blue=False)
    assert ours.result.success and theirs.result.success
    assert ours.result.variance_names == theirs.result.variance_names
    assert ours.result.n_iterations == theirs.result.n_iterations
    np.testing.assert_allclose(ours.result.variances, theirs.result.variances, rtol=1e-6)
    np.testing.assert_allclose(ours.result.log_likelihood, theirs.result.log_likelihood, rtol=1e-9)
    np.testing.assert_allclose(ours.result.ai_inverse, theirs.result.ai_inverse, rtol=1e-5)
    for a, b in zip(ours.heritabilities, theirs.heritabilities):
        assert a.name == b.name
        np.testing.assert_allclose([a.value, a.std_error], [b.value, b.std_error], rtol=1e-5)
    return ours


def _post_fit_engines(c, diagonal):
    """Both engines on the same model, their fitted variances set to the
    same theta."""
    if diagonal:
        w, u = np.linalg.eigh(c["mats"][0])
        y, x = u.T @ c["y"], u.T @ c["x"]
        jax_model, model = _models(dict(c, y=y), mats=[w], names=["GRM"], diagonal=True)
    else:
        y, x = c["y"], c["x"]
        jax_model, model = _models(c)
    theta = jax_model.initial_theta() * np.linspace(0.8, 1.2, jax_model.n_variances)
    ours = engine.REMLEngine(model, y, x, device="cpu")
    theirs = jax_engine.REMLEngine(jax_model, y, x)
    ours.final_theta = theirs.final_theta = theta
    return ours, theirs


@pytest.mark.parametrize("diagonal", [False, True])
@pytest.mark.parametrize("what", ["blue", "blup", "blup_errors", "residuals", "py"])
def test_post_fit_outputs_match_jax(cohort, diagonal, what):
    """compute_blue, compute_blup_individuals, compute_blup_errors (dense
    single-trait only; None on the diagonal path in both), residuals and
    final_py at the same fitted variances."""
    ours, theirs = _post_fit_engines(cohort, diagonal)
    call = {
        "blue": lambda e: e.compute_blue(),
        "blup": lambda e: [e.compute_blup_individuals(k) for k in ("GRM", "E")],
        "blup_errors": lambda e: e.compute_blup_errors("GRM"),
        "residuals": lambda e: e.residuals(),
        "py": lambda e: e.final_py(),
    }[what]
    a, b = call(ours), call(theirs)
    if what == "blup_errors" and diagonal:
        assert a is None and b is None
        return
    if what == "py":
        a = a.numpy()
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-9, atol=1e-12)


def test_reduced_model_lrts_match_jax(cohort):
    """Each kernel dropped in turn, refitted from the full estimates with
    the EM first step off: LRTs, p-values and the reduced BLUEs."""
    jax_model, model = _models(cohort)
    y, x = cohort["y"], cohort["x"]
    full_ours = engine.REMLEngine(model, y, x, device="cpu").fit()
    full_theirs = jax_engine.REMLEngine(jax_model, y, x).fit()
    opts = dict(include_blue=True)
    ours = reduced_model_lrts(model, y, x, engine.REMLOptions(), full_ours, NAMES,
                              device="cpu", **opts)
    theirs = jax_reduced_model_lrts(jax_model, y, x, jax_engine.REMLOptions(), full_theirs,
                                    NAMES, **opts)
    assert [r["removed"] for r in ours] == [r["removed"] for r in theirs] == NAMES
    for a, b in zip(ours, theirs):
        assert a["converged"] == b["converged"] and a["df"] == b["df"]
        np.testing.assert_allclose(a["log_likelihood"], b["log_likelihood"], rtol=1e-9)
        np.testing.assert_allclose([a["lrt"], a["p_value"]], [b["lrt"], b["p_value"]],
                                   rtol=1e-4, atol=1e-6)
        for pa, pb in zip(a["blue"], b["blue"]):
            np.testing.assert_allclose(pa, np.asarray(pb), rtol=1e-5)


def test_checkpoint_save_and_resume_match_jax(cohort, tmp_path):
    """A fit cut after three iterations leaves the checkpoint JAX writes
    (each package reads the other's); resumed from it, both packages
    finish at the same variances after the same iterations."""
    jax_model, model = _models(cohort)
    y, x = cohort["y"], cohort["x"]
    ours_path, theirs_path = str(tmp_path / "ours.json"), str(tmp_path / "theirs.json")
    short = dict(max_iterations=3)
    engine.REMLEngine(model, y, x, engine.REMLOptions(**short), device="cpu").fit(
        checkpoint_path=ours_path)
    jax_engine.REMLEngine(jax_model, y, x, jax_engine.REMLOptions(**short)).fit(
        checkpoint_path=theirs_path)
    a, b = JaxCheckpoint.load(ours_path), REMLCheckpoint.load(theirs_path)
    assert a.iteration == b.iteration == 3 and a.variance_names == b.variance_names
    np.testing.assert_allclose(a.theta, b.theta, rtol=1e-9)
    np.testing.assert_allclose(a.log_likelihood, b.log_likelihood, rtol=1e-12)
    shutil.copy(ours_path, tmp_path / "resume_theirs.json")
    ours = engine.REMLEngine(model, y, x, device="cpu").fit(checkpoint_path=ours_path)
    theirs = jax_engine.REMLEngine(jax_model, y, x).fit(
        checkpoint_path=str(tmp_path / "resume_theirs.json"))
    full = engine.REMLEngine(model, y, x, device="cpu").fit()
    assert ours.success and theirs.success
    assert ours.n_iterations == theirs.n_iterations
    np.testing.assert_allclose(ours.variances, theirs.variances, rtol=1e-6)
    np.testing.assert_allclose(ours.variances, full.variances, rtol=1e-4)


def test_subsample_prefit_draws_like_jax(cohort):
    """The same seed picks the same individuals in both packages, so the
    averaged pre-fit variances agree."""
    ours_single, theirs_single = _single_remls(cohort)
    kw = dict(n_replicates=2, proportion=0.5, seed=7, minimum=30)
    ours, theirs = ours_single.subsample_prefit(**kw), theirs_single.subsample_prefit(**kw)
    assert ours is not None and list(ours) == list(theirs)
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), rtol=1e-6)


def test_mlm_gwas_fixed_v_matches_jax(cohort):
    z = cohort["z"][:50] * 0.7
    v = 0.6 * cohort["mats"][0] + 0.4 * np.eye(cohort["n"])
    v_inv = np.linalg.inv(v)
    ours = mlm_gwas_fixed_v(torch.as_tensor(z), cohort["y"], cohort["x"], torch.as_tensor(v_inv))
    theirs = jax_mlm.mlm_gwas_fixed_v(z, cohort["y"], cohort["x"], v_inv)
    for field in ("snp_beta", "snp_se", "snp_stat", "snp_p", "cov_beta", "cov_se", "cov_p",
                  "group_p"):
        np.testing.assert_allclose(getattr(ours, field), np.asarray(getattr(theirs, field)),
                                   rtol=1e-9, atol=1e-14, err_msg=field)
    assert ours.model == theirs.model and ours.df == theirs.df


def test_snp_blup_streamed_in_chunks_matches_jax_whole_matrix(tmp_path):
    """Deliberate departure, in memory only: the port streams SNP chunks
    of raw dosages to the device and standardizes them there, where the
    JAX package forms the whole M x N float64 standardized matrix on the
    host.  The numbers are the same (here 7-SNP chunks, with missing
    calls, an individual subset and a SNP subset in another order)."""
    rng = np.random.default_rng(11)
    d = make_dosage(rng, 40, 50, missing_rate=0.05)
    prefix, _ = make_plink(tmp_path, d)
    keys = [f"F{i}@I{i}" for i in range(0, 50, 2)][::-1]
    snps = [f"snp{i}" for i in (31, 2, 17, 5, 8, 39, 0, 22, 11, 30, 3)]
    py = rng.normal(size=len(keys))
    ours = compute_snp_blup(read_plink(prefix, device="cpu"), keys, torch.as_tensor(py), 0.37,
                            grm_snp_names=snps, chunk=7)
    theirs = jax_compute_snp_blup(jax_read_plink(prefix), keys, py, 0.37, grm_snp_names=snps)
    assert ours["snp_names"] == theirs["snp_names"] and ours["alleles"] == theirs["alleles"]
    for key in ("blup", "std", "mean"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12, atol=1e-15, err_msg=key)


def test_reduced_model_keeps_the_squared_exponential_parameter(cohort):
    """Deliberate departure: dropping another sub-covariance keeps a
    squared-exponential kernel's alpha0 and its inside-matrix link.  The
    JAX package's delete_subcovariance keeps only variances that scale an
    element, so its reduced model loses alpha0 and evaluates the squared
    distances D themselves as the kernel (dissect_tpu/model/covariance.py:
    246-278)."""
    n = cohort["n"]
    coords = np.random.default_rng(6).uniform(0, 10, size=(n, 2))
    dist = ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1)
    jax_model, model = _models(
        cohort, mats=[cohort["mats"][0], dist], names=["GRM", "SEK-1"],
        parameter_kernels={"SEK-1": 0.5},
    )
    ours, theirs = model.delete_subcovariance("GRM"), jax_model.delete_subcovariance("GRM")
    assert "alpha0(SEK-1)" in ours.variance_names()
    assert "alpha0(SEK-1)" not in theirs.variance_names()
    assert ours.compile("cpu").has_matrix_params and not theirs.compile().has_matrix_params
    assert [v.unfix_after for v in ours.variances] == [None, 8, None]
