"""The port's multi-trait REML held against the JAX package on the CPU,
in float64 on both sides: the covariance primitives with per-trait
sizes, one Newton step's quantities at the same theta to rtol 1e-9,
fitted variances, correlations and LRTs to rtol 1e-6, and the CLI's
files against the golden files and the JAX CLI at rtol 2e-5.  Only
unequal per-trait sizes expose a wrong block offset, so most cases use
them (the cases of tests/test_asymmetric_multi.py)."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.io.phenotype import Phenotype as JaxPhenotype
from dissect_tpu.model.kernels import Kernel as JaxKernel
from dissect_tpu.model.kernels import KernelType as JaxKernelType
from dissect_tpu.reml import builders as jax_builders
from dissect_tpu.reml import engine as jax_engine
from dissect_tpu.reml import multi as jax_multi
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.convert import covariance_model_from_state
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.reml import builders, engine, multi
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files
from tests.test_reml import _numpy_reml_quantities

GOLDEN = pathlib.Path(__file__).parent / "golden"
KEYS = ("logdet_v", "logdet_xtvix", "ytpy", "grad", "ai", "py")
NAMES_ASYM = ["Var(GRM_p1)", "Var(GRM_p2)", "Covar(GRM_p1-2)",
              "Var(E_p1)", "Var(E_p2)", "Covar(E_p1-2)"]


def _problem(n=120, n1=100, n2=90, seed=7):
    """A kernel over n individuals; trait 1 observes the first n1, trait 2
    the last n2, both from one genetic effect (rg = 1)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(4 * n, n))
    k = np.asarray(z.T @ z / (4 * n), dtype=np.float32).astype(np.float64)
    keys = [f"F{i}@I{i}" for i in range(n)]
    g = np.linalg.cholesky(k + 1e-8 * np.eye(n)) @ rng.normal(size=n)
    ys = [g * np.sqrt(0.5) + rng.normal(size=n) * np.sqrt(0.5) for _ in range(2)]
    rows = [np.arange(n1), np.arange(n - n2, n)]
    return dict(k=k, keys=keys, ys=ys, rows=rows, rng=rng)


def _phenos(p, cls, rows=None):
    rows = p["rows"] if rows is None else rows
    return [cls(keys=[p["keys"][i] for i in r], values=y[r], column=t + 1)
            for t, (y, r) in enumerate(zip(p["ys"], rows))]


def _kernels(p):
    ours = Kernel(name="GRM", type=KernelType.GRM, individual_keys=p["keys"],
                  matrix=torch.as_tensor(p["k"]))
    theirs = JaxKernel(name="GRM", type=JaxKernelType.GRM, individual_keys=p["keys"],
                       matrix=jnp.asarray(p["k"]))
    return ours, theirs


def _multi_remls(p, rows=None, **kw):
    ours_k, theirs_k = _kernels(p)
    ours = multi.MultiREML([ours_k], _phenos(p, Phenotype, rows), device="cpu", **kw)
    theirs = jax_multi.MultiREML([theirs_k], _phenos(p, JaxPhenotype, rows), **kw)
    return ours, theirs


def _to_port(jax_model):
    return covariance_model_from_state(
        jax_model.n, jax_model.n_traits, jax_model.diagonal,
        {k: np.asarray(v) for k, v in jax_model.matrices.items()},
        jax_model.variances, jax_model.elements, jax_model.group_magnitudes,
        device="cpu", trait_sizes=jax_model.trait_sizes,
    )


@pytest.fixture(scope="module")
def asym():
    """The JAX asymmetric model of _problem() and the port's copy."""
    p = _problem()
    ours, theirs = _multi_remls(p)
    assert not ours.uniform and not theirs.uniform
    theirs.compute(compute_blue=False)
    return p, ours, theirs, theirs.model, _to_port(theirs.model)


def test_asymmetric_model_matches_the_jax_model(asym):
    """build_variance_model_asymmetric through MultiREML.build_model gives
    the element table of the JAX model carried over by convert."""
    p, ours, theirs, jax_model, carried = asym
    built = ours.build_model()
    assert built.trait_sizes == carried.trait_sizes == [100, 90]
    assert built.variance_names() == carried.variance_names() == NAMES_ASYM
    np.testing.assert_array_equal(built.initial_theta(), jax_model.initial_theta())
    a, b = built.compile("cpu"), carried.compile("cpu")
    assert a.blocks == b.blocks and a.trait_sizes == b.trait_sizes == (100, 90)
    torch.testing.assert_close(a.powers, b.powers, rtol=0, atol=0)
    for ma, mb in zip(a.element_matrices, b.element_matrices):
        torch.testing.assert_close(ma, mb, rtol=0, atol=0)


def test_primitives_place_blocks_by_offset(asym):
    """assemble_dense, placed_dense, the element products and traces at
    unequal trait sizes, against the JAX compiled model."""
    p, _, _, jax_model, carried = asym
    cc, jcc = carried.compile("cpu"), jax_model.compile()
    assert cc.offsets == jcc.offsets == (0, 100) and cc.n_total == jcc.n_total == 190
    assert not cc.uniform and cc.n == 100
    theta = np.array([0.5, 0.4, 0.15, 0.6, 0.55, 0.1])
    np.testing.assert_allclose(cc.assemble_dense(torch.as_tensor(theta)).numpy(),
                               np.asarray(jcc.assemble_dense(jnp.asarray(theta))), rtol=1e-14)
    u = p["rng"].normal(size=(190, 3))
    np.testing.assert_allclose(cc.elements_times_matrix(torch.as_tensor(u)).numpy(),
                               np.asarray(jcc.elements_times_matrix(jnp.asarray(u))), rtol=1e-12)
    np.testing.assert_allclose(cc.elements_times_vector(torch.as_tensor(u[:, 0])).numpy(),
                               np.asarray(jcc.elements_times_vector(jnp.asarray(u[:, 0]))),
                               rtol=1e-12)
    sym = u @ u.T
    np.testing.assert_allclose(cc.element_traces_dense(torch.as_tensor(sym)).numpy(),
                               np.asarray(jcc.element_traces_dense(jnp.asarray(sym))), rtol=1e-12)
    for ei in range(cc.n_elements):
        np.testing.assert_array_equal(cc.placed_dense(ei).numpy(),
                                      np.asarray(jax_engine._placed_dense(jcc, ei)))


@pytest.mark.parametrize("use_ml,use_f_matrix", [(False, False), (True, False), (False, True)])
def test_asymmetric_quantities_match_jax_and_brute_force(asym, use_ml, use_f_matrix):
    p, ours, theirs, jax_model, carried = asym
    theta = np.array([0.5, 0.4, 0.15, 0.6, 0.55, 0.1])
    q = engine._dense_quantities(carried.compile("cpu"), torch.as_tensor(theta),
                                 torch.as_tensor(ours.y), torch.as_tensor(ours.x),
                                 use_ml, use_f_matrix)
    jq = jax_engine._dense_quantities(jax_model.compile(), jnp.asarray(theta),
                                      jnp.asarray(theirs.y), jnp.asarray(theirs.x),
                                      use_ml, use_f_matrix)
    for key in KEYS:
        np.testing.assert_allclose(q[key].numpy(), np.asarray(jq[key]), rtol=1e-9, atol=1e-12,
                                   err_msg=key)
    if use_ml or use_f_matrix:
        return
    k = p["k"]
    i1, i2 = p["rows"]
    n1, n2 = len(i1), len(i2)
    z12 = np.zeros((n1, n2))
    e12 = (i1[:, None] == i2[None, :]).astype(np.float64)
    mats = [
        np.block([[k[np.ix_(i1, i1)], z12], [z12.T, np.zeros((n2, n2))]]),
        np.block([[np.zeros((n1, n1)), z12], [z12.T, k[np.ix_(i2, i2)]]]),
        np.block([[np.zeros((n1, n1)), k[np.ix_(i1, i2)]], [k[np.ix_(i1, i2)].T, np.zeros((n2, n2))]]),
        np.block([[np.eye(n1), z12], [z12.T, np.zeros((n2, n2))]]),
        np.block([[np.zeros((n1, n1)), z12], [z12.T, np.eye(n2)]]),
        np.block([[np.zeros((n1, n1)), e12], [e12.T, np.zeros((n2, n2))]]),
    ]
    ref = _numpy_reml_quantities(theta, mats, ours.y, ours.x)
    np.testing.assert_allclose(q["grad"].numpy(), ref["grad"], rtol=1e-9)
    np.testing.assert_allclose(q["ai"].numpy(), ref["ai"], rtol=1e-9)
    logl = -0.5 * float(q["logdet_v"] + q["logdet_xtvix"] + q["ytpy"])
    assert logl == pytest.approx(ref["logl"], rel=1e-10)


def _assert_fits(ours, theirs, rtol=1e-6):
    assert ours.result.success and theirs.result.success
    assert ours.result.variance_names == theirs.result.variance_names
    np.testing.assert_allclose(ours.result.variances, theirs.result.variances, rtol=rtol)
    assert ours.result.log_likelihood == pytest.approx(theirs.result.log_likelihood, rel=1e-9)
    assert [r.name for r in ours.correlations] == [r.name for r in theirs.correlations]
    np.testing.assert_allclose([r.value for r in ours.correlations],
                               [r.value for r in theirs.correlations], rtol=rtol)
    np.testing.assert_allclose([r.std_error for r in ours.correlations],
                               [r.std_error for r in theirs.correlations], rtol=rtol)
    assert ours.individual_keys == theirs.individual_keys


@pytest.mark.parametrize("case", ["asymmetric", "uniform", "uniform_correlations",
                                  "no_environment_covariance"])
def test_multi_reml_fit_matches_jax(case):
    p = _problem()
    kw, rows = {}, None
    if case != "asymmetric":
        rows = [np.arange(120)] * 2
    if case == "uniform_correlations":
        kw["use_correlations"] = True
    if case == "no_environment_covariance":
        kw["environmental_covariance"] = False
    ours, theirs = _multi_remls(p, rows, **kw)
    out, ref = ours.compute(initial_h2s=[0.4, 0.6]), theirs.compute(initial_h2s=[0.4, 0.6])
    _assert_fits(out, ref)
    np.testing.assert_allclose(out.blue, ref.blue, rtol=1e-6)
    np.testing.assert_allclose(out.blue_se, ref.blue_se, rtol=1e-6)
    assert ours.uniform == (case != "asymmetric")
    for sub in ("GRM", "E"):
        np.testing.assert_allclose(ours.engine.compute_blup_individuals(sub),
                                   theirs.engine.compute_blup_individuals(sub),
                                   rtol=1e-5, atol=1e-8)


def test_asymmetric_fit_recovers_the_signal():
    """tests/test_asymmetric_multi.py:85-95 on the port: the fit converges
    and the genetic correlation (true rg = 1) is strongly positive."""
    ours, _ = _multi_remls(_problem(n=300, n1=250, n2=220, seed=12345))
    out = ours.compute()
    assert out.result.success and out.blue is not None
    assert next(r.value for r in out.correlations if "Cor(GRM" in r.name) > 0.3


def test_no_overlap_drops_environmental_covariance():
    p = _problem(n=80)
    ours, theirs = _multi_remls(p, rows=[np.arange(40), np.arange(40, 80)])
    ours.compute(compute_blue=False)
    theirs.compute(compute_blue=False)
    names = ours.model.variance_names()
    assert "Covar(E_p1-2)" not in names and "Covar(GRM_p1-2)" in names
    assert names == theirs.model.variance_names()


def test_reduced_models_match_jax():
    ours, theirs = _multi_remls(_problem())
    out, lrts = ours.compute_with_reduced_models(compute_blue=False)
    ref, ref_lrts = theirs.compute_with_reduced_models(compute_blue=False)
    _assert_fits(out, ref)
    assert [r["removed"] for r in lrts] == [r["removed"] for r in ref_lrts] == ["GRM"]
    for a, b in zip(lrts, ref_lrts):
        assert a["df"] == b["df"] and a["converged"] == b["converged"]
        np.testing.assert_allclose([a["log_likelihood"], a["lrt"], a["p_value"]],
                                   [b["log_likelihood"], b["lrt"], b["p_value"]], rtol=1e-6)


@pytest.mark.parametrize("use_correlations", [False, True])
def test_fixed_correlation_matches_jax(use_correlations):
    ours, theirs = _multi_remls(_problem(), rows=[np.arange(120)] * 2,
                            use_correlations=use_correlations)
    full, lrt = ours.compute_with_fixed_correlation("GRM", 0.0)
    ref_full, ref_lrt = theirs.compute_with_fixed_correlation("GRM", 0.0)
    _assert_fits(full, ref_full)
    assert lrt["fixed"] == ref_lrt["fixed"] and lrt["converged"] and ref_lrt["converged"]
    np.testing.assert_allclose([lrt["log_likelihood"], lrt["lrt"], lrt["p_value"]],
                               [ref_lrt["log_likelihood"], ref_lrt["lrt"], ref_lrt["p_value"]],
                               rtol=1e-6)


def test_fixed_correlation_keeps_per_trait_sizes():
    """A deliberate departure: the JAX package rebuilds the fixed-correlation
    model with uniform trait sizes (dissect_tpu/reml/multi.py:353), so an
    asymmetric model fails its block-shape check there; the port keeps the
    sizes and fits it."""
    ours, theirs = _multi_remls(_problem())
    full, lrt = ours.compute_with_fixed_correlation("GRM", 0.0)
    assert full.result.success and lrt["converged"]
    assert lrt["fixed"] == "Covar(GRM_p1-2)" and lrt["lrt"] >= 0.0
    with pytest.raises(ValueError, match="block shape"):
        theirs.compute_with_fixed_correlation("GRM", 0.0)


def test_lrt_and_correlation_helpers_match_jax():
    rng = np.random.default_rng(3)
    theta = np.array([0.5, 0.4, 0.15, 0.6])
    a = rng.normal(size=(4, 4))
    ai_inv = a @ a.T
    assert multi.correlation_from_covariance(theta, ai_inv, 2, 0, 1) == pytest.approx(
        jax_multi.correlation_from_covariance(theta, ai_inv, 2, 0, 1), rel=1e-12)
    for full, reduced, df in ((-10.0, -13.5, 1), (-10.0, -9.0, 2), (-5.0, -7.0, 3)):
        assert multi.lrt_p_value(full, reduced, df) == pytest.approx(
            jax_multi.lrt_p_value(full, reduced, df), rel=1e-12)


@pytest.mark.parametrize("diagonal", [False, True])
def test_ylist_quantities_match_jax(diagonal):
    """The multi-sample yList core (reml/engine.py:_ylist_quantities), as
    tests/test_engine_branches.py:111-144 holds it: the mean gradient,
    y'Py and AI of several phenotype samples, against the JAX core."""
    p = _problem(n=80)
    k = p["k"]
    y, y2, y3 = p["ys"][0], np.roll(p["ys"][0], 7), p["ys"][1]
    x = np.column_stack([np.ones(80), p["rng"].normal(size=80)])
    if diagonal:
        lam, u = np.linalg.eigh(k)
        mats, y, y2, y3, x = [lam], u.T @ y, u.T @ y2, u.T @ y3, u.T @ x
    else:
        mats = [k]
    jax_model = jax_builders.build_variance_model(mats, ["GRM"], [1.0], [0.5], diagonal=diagonal)
    ours = engine.REMLEngine(_to_port(jax_model), y, x, device="cpu", y_list=[y, y2, y3])
    theirs = jax_engine.REMLEngine(jax_model, y, x, y_list=[y, y2, y3])
    theta = np.array([0.5, 0.6])
    q, jq = ours._quantities(theta), theirs._quantities(jnp.asarray(theta))
    for key in ("grad", "ytpy", "ai", "logdet_v", "logdet_xtvix", "py"):
        np.testing.assert_allclose(q[key].numpy(), np.asarray(jq[key]), rtol=1e-9, atol=1e-12,
                                   err_msg=key)
    assert bool(q["finite"]) and bool(jq["finite"])
    single = [engine.REMLEngine(_to_port(jax_model), v, x, device="cpu")._quantities(theta)["grad"]
              for v in (y, y2, y3)]
    np.testing.assert_allclose(q["grad"].numpy(), torch.stack(single).mean(0).numpy(), rtol=1e-12)
    fit, ref = ours.fit(), theirs.fit()
    assert fit.success and ref.success
    np.testing.assert_allclose(fit.variances, ref.variances, rtol=1e-6)


# ------------------------------------------------------------------ CLI --
@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", ["golden.bi.reml", "golden.bi.correlations"])
def test_golden_bivar_reml(tmp_path, cpu, name):
    main(["--bivar-reml", "--grm", str(GOLDEN / "golden"), "--bfile", str(GOLDEN / "cohort"),
          "--pheno", str(GOLDEN / "pheno2.txt"), "--pheno-cols", "1,2", "--mesh", "none",
          "--out", str(tmp_path / "golden.bi")])
    _diff_files(tmp_path / name, GOLDEN / name, rtol=2e-5)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """n = 120 x 200 SNPs; three traits sharing a genetic effect, trait 2
    missing for its last 15 individuals and trait 3 for its first 10 (so
    the per-trait individual sets differ); per-trait quantitative
    covariate files."""
    tmp = tmp_path_factory.mktemp("multi_cli")
    rng = np.random.default_rng(2024)
    n, m = 120, 200
    dosage = make_dosage(rng, m, n)
    bfile, data = make_plink(tmp, dosage)
    z = (dosage - dosage.mean(1, keepdims=True)) / dosage.std(1, keepdims=True)
    g = z.T @ rng.normal(size=m) * np.sqrt(0.6 / m)
    ids = [(ind.family_id, ind.individual_id) for ind in data.individuals]
    q1, q2 = rng.normal(size=n), rng.normal(size=n)
    ys = [1.0 + 0.3 * q1 + g + rng.normal(size=n) * 0.6,
          -0.5 * q2 + 0.8 * g + rng.normal(size=n) * 0.7,
          g + rng.normal(size=n)]
    with open(tmp / "pheno3.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            v2 = "NA" if i >= n - 15 else f"{ys[1][i]:.8g}"
            v3 = "-9" if i < 10 else f"{ys[2][i]:.8g}"
            fh.write(f"{fid} {iid} {ys[0][i]:.8g} {v2} {v3}\n")
    for name, q in (("q1.txt", q1), ("q2.txt", q2)):
        with open(tmp / name, "w") as fh:
            for (fid, iid), v in zip(ids, q):
                fh.write(f"{fid} {iid} {v:.6g}\n")
    (tmp / "init.txt").write_text("Var(GRM_p1) 0.5\nVar(E_p1) 0.4\n")
    return tmp, bfile


CASES = {
    "bivar_per_trait_sets_qcovars": ["--bivar-reml", "--pheno-cols", "1,2",
                                     "--qcovars", "{q1},{q2}"],
    "bivar_correlations_no_env": ["--bivar-reml", "--pheno-cols", "1,3", "--use-correlations",
                                  "--no-environment-cov", "--initial-h2s", "0.3", "0.6"],
    "multi_three_traits": ["--multi-reml", "--initial-variances", "{init}"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_multi_cli_matches_jax(cohort, tmp_path, cpu, case):
    tmp, bfile = cohort
    argv = ["--bfile", bfile, "--pheno", str(tmp / "pheno3.txt"), "--mesh", "none"]
    for arg in CASES[case]:
        argv.append(arg.format(**{k: str(tmp / f"{k}.txt") for k in ("q1", "q2", "init")}))
    outs = {}
    for side, run in (("jax", jax_main), ("torch", main)):
        (tmp_path / side).mkdir()
        try:
            run(argv + ["--out", str(tmp_path / side / "r"), "--checkpoint",
                        str(tmp_path / side / "ckpt")])
        finally:
            set_mesh_context(None)
        outs[side] = {p.name: p for p in (tmp_path / side).iterdir()
                      if p.suffix != ".log" and p.name != "ckpt"}
    assert sorted(outs["torch"]) == sorted(outs["jax"]) == ["r.correlations", "r.reml"]
    for name, path in outs["jax"].items():
        _diff_files(outs["torch"][name], path, rtol=2e-5)
