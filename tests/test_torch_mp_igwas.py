"""The port's multi-phenotype residuals and GWAS (`--mpresiduals`,
`--mpgwas`) and inverse GWAS (`--igwas`) held against the JAX package on
the CPU, in float64 on both sides: the functions to rtol 1e-8 or
tighter, the residuals of REML fits (which stop at relative variance
changes of 1e-5) to 1e-6 of their scale, the CLI's files against the golden files and the JAX CLI at
rtol 2e-5.

One deliberate departure is stated here: the igwas ML core takes its
per-step moments from `fused_refit_moments` (kernel K3 on the card, its
plain version on the CPU), where JAX computes them on XLA
(dissect_tpu/gwas/igwas.py:107-144).  On the CPU the K3 route equals
JAX's `_igwas_ml_core` to rtol 1e-8."""

import pathlib
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.gwas import igwas as jax_igwas
from dissect_tpu.gwas import mp as jax_mp
from dissect_tpu.io.covariate import Covariate as JaxCovariate
from dissect_tpu.io.labeled_matrix import LabeledMatrix as JaxLabeledMatrix
from dissect_tpu.io.phenotype import Phenotype as JaxPhenotype
from dissect_tpu.model.kernels import Kernel as JaxKernel
from dissect_tpu.model.kernels import KernelType as JaxKernelType
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis import dispatcher
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.gwas import igwas, mp
from dissect_tpu_torch.gwas import moments_kernels as mk
from dissect_tpu_torch.io.covariate import Covariate
from dissect_tpu_torch.io.grm_io import read_grm
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.reml.single import SingleREML
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
RTOL = 2e-5
EPS32 = float(np.finfo(np.float32).eps)
T = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


def _problem(seed, n=84, m=13, c=2):
    """Centered SNP rows, a GRM from 30 other SNPs (mean diagonal 1), its
    eigenpairs, and a design [1 | c - 1 normal columns]."""
    rng = np.random.default_rng(seed)
    d = make_dosage(rng, m + 30, n)
    z = (d - d.mean(1, keepdims=True)).astype(np.float64)
    k = z[m:].T @ z[m:] / 30.0
    k /= np.mean(np.diag(k))
    w, u = np.linalg.eigh(k)
    x = np.column_stack([np.ones(n)] + [rng.normal(size=n) for _ in range(c - 1)])
    return rng, z[:m], k, w, u, x


# ------------------------------------------------------------------- mp --
def test_mp_residuals_match_jax():
    rng, _, k, _, _, x = _problem(1, n=90, c=3)
    n = k.shape[0]
    keys = [f"F{i}@I{i}" for i in range(n)]
    ys = [rng.normal(size=n) + 0.3 * x[:, 1] for _ in range(3)]
    cov_args = dict(keys=keys, matrix=x, column_names=["mean", "quantitative_1", "quantitative_2"],
                    missing_keys=[], categories=[])
    # a phenotype missing a few individuals narrows the common set
    phen = lambda cls, j: cls(keys=keys[j:], values=ys[j][j:], column=j + 1)
    ours = mp.compute_mp_residuals(
        Kernel(name="GRM", type=KernelType.GRM, individual_keys=keys, matrix=T(k)),
        [phen(Phenotype, j) for j in range(3)], ["a", "b", "c"], Covariate(**cov_args))
    theirs = jax_mp.compute_mp_residuals(
        JaxKernel(name="GRM", type=JaxKernelType.GRM, individual_keys=keys,
                  matrix=jnp.asarray(k)),
        [phen(JaxPhenotype, j) for j in range(3)], ["a", "b", "c"], JaxCovariate(**cov_args))
    assert ours.row_labels == theirs.row_labels == keys[2:]
    assert ours.col_labels == theirs.col_labels
    scale = np.abs(theirs.values).max()
    np.testing.assert_allclose(ours.values, theirs.values, rtol=1e-6, atol=1e-6 * scale)


@pytest.mark.parametrize("center", [True, False])
def test_mp_gwas_matches_jax(center):
    rng = np.random.default_rng(2)
    z = make_dosage(rng, 40, 70).astype(np.float64)
    z = z - z.mean(1, keepdims=True)
    z[3] = 0.0  # a monomorphic row: xtx = 0 gives NaN effects in both
    lm_args = ([f"k{i}" for i in range(70)], ["p1", "p2"], rng.normal(size=(70, 2)))
    names = [f"s{i}" for i in range(40)]
    ours = mp.mp_gwas(T(z), names, LabeledMatrix(*lm_args), center=center)
    theirs = jax_mp.mp_gwas(z, names, JaxLabeledMatrix(*lm_args), center=center)
    assert ours.phenotype_names == theirs.phenotype_names
    for f in ("beta", "se", "t", "p"):
        np.testing.assert_allclose(getattr(ours, f), getattr(theirs, f), rtol=1e-10,
                                   atol=1e-14, equal_nan=True, err_msg=f)


# ---------------------------------------------------------------- igwas --
def test_igwas_ols_and_gls_cores_match_jax():
    rng, z, k, _, _, x = _problem(3)
    vi = np.linalg.inv(0.7 * k + 0.5 * np.eye(k.shape[0]))
    for a, b in zip(igwas._igwas_ols_core(T(z), T(x)), jax_igwas._igwas_ols_core(z, x)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)
    for a, b in zip(igwas._igwas_gls_core(T(z), T(x), T(vi)),
                    jax_igwas._igwas_gls_core(z, x, vi)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("c", [1, 2, 3])
def test_igwas_ml_core_through_k3_route_matches_jax(c):
    """The stated departure: the port's ML core takes its moments from K3's
    route (`fused_refit_moments`, the plain version on the CPU), JAX's
    from XLA.  In float64 the two agree to rtol 1e-8, and the port's core
    equals its own per-SNP formulation (`_igwas_ml_core_vmapped`) and
    JAX's."""
    _, z, _, w, u, x = _problem(4 + c, c=c)
    g_rot, x_rot = z @ u, u.T @ x
    var = z.var(axis=1, ddof=1)
    theta0s = np.column_stack([0.5 * var, 0.5 * var])
    calls = []

    def counting(*args):
        calls.append(args[3].shape[1])
        return mk.fused_refit_moments(*args)

    ours = igwas._igwas_ml_core(T(g_rot), T(x_rot), T(w), T(theta0s), 12, moments=counting)
    assert calls == [c] * 13  # 12 Fisher steps and the final quantities, s = x_rot
    theirs = jax_igwas._igwas_ml_core(
        jnp.asarray(g_rot), jnp.asarray(x_rot), jnp.asarray(w), jnp.asarray(theta0s), 12)
    oracle = igwas._igwas_ml_core_vmapped(T(g_rot), T(x_rot), T(w), T(theta0s), 12)
    jax_oracle = jax_igwas._igwas_ml_core_vmapped(
        jnp.asarray(g_rot), jnp.asarray(x_rot), jnp.asarray(w), jnp.asarray(theta0s), 12)
    for name, a, b, o, jo in zip(["b", "ai", "theta", "logl", "gn"], ours, theirs, oracle,
                                 jax_oracle):
        atol = 1e-10 if name == "gn" else 1e-12
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-8, atol=atol, err_msg=name)
        np.testing.assert_allclose(a.numpy(), o.numpy(), rtol=1e-7, atol=atol, err_msg=name)
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-8, atol=atol, err_msg=name)


@pytest.mark.parametrize("branch", ["ols", "ols_tested", "gls", "ml"])
def test_igwas_matches_jax(branch):
    rng, z, k, w, u, x = _problem(8)
    names = [f"s{i}" for i in range(z.shape[0])]
    kwargs = {}
    if branch == "ols_tested":
        kwargs = dict(test_x=rng.normal(size=(x.shape[0], 2)), test_names=["t1", "t2"])
    elif branch == "gls":
        kwargs = dict(v_inv=np.linalg.inv(0.6 * k + 0.4 * np.eye(k.shape[0])))
    elif branch == "ml":
        kwargs = dict(covariance=(w, u), initial_h2=0.4)
    ours = igwas.igwas(T(z), names, x, ["mean", "q1"],
                       **{key: (tuple(T(a) for a in v) if key == "covariance" else v)
                          for key, v in kwargs.items()})
    theirs = jax_igwas.igwas(z, names, x, ["mean", "q1"], **kwargs)
    assert ours.model == theirs.model and ours.n_base == theirs.n_base == 2
    assert ours.covariate_names == theirs.covariate_names
    for f in ("beta", "se", "p", "group_p", "converged"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-8, atol=1e-12, err_msg=f)


def test_igwas_refuses_tested_covariates_under_a_covariance():
    _, z, _, w, u, x = _problem(9)
    with pytest.raises(ValueError, match="igwas.cpp:70-76"):
        igwas.igwas(T(z), ["s"] * len(z), x, ["mean", "q1"], test_x=x[:, 1:],
                    test_names=["t"], covariance=(T(w), T(u)))


# ------------------------------------------------------------------ CLI --
@pytest.mark.parametrize("name", [
    "golden.mp.mpgwas", "golden.mp.multipheno.gwas.snps",
    "golden.ig.gwas.snps", "golden.ig.gwas.mean", "golden.ig.igwas",
])
def test_golden_mp_and_igwas(tmp_path, cpu, name):
    """The runs of tests/test_golden.py that wrote these files."""
    base = ["--bfile", str(GOLDEN / "cohort"), "--pheno", str(GOLDEN / "pheno.txt"),
            "--mesh", "none"]
    if name.startswith("golden.mp"):
        main(["--mpresiduals"] + base + ["--out", str(tmp_path / "golden.mp")])
        main(["--mpgwas"] + base + ["--out", str(tmp_path / "golden.mp")])
    else:
        main(["--igwas", "--bfile", str(GOLDEN / "cohort"), "--igwas-qcovar",
              str(GOLDEN / "testcovar.txt"), "--mesh", "none",
              "--out", str(tmp_path / "golden.ig")])
    _diff_files(tmp_path / name, GOLDEN / name, rtol=RTOL)


def test_golden_mp_residuals_within_the_float32_eigensolver_bound(tmp_path, cpu):
    """golden.mp.residuals.* was written by the JAX CLI, which
    diagonalizes the float32 GRM in float32 (ROADMAP.md, deliberate
    departures).  A backward-stable float32 eigensolver returns the exact
    eigenpairs of K + E with |E|_2 <= c n eps32 |K|_2; the residuals
    e = s2_E P y then move by at most (s2_G / s2_E) |E|_2 |e|_2 (P's norm
    is at most 1/s2_E).  The port's float64 residuals lie within that
    bound (c = 2) of the golden file; the mpgwas files built on them
    reproduce at rtol 2e-5 (test_golden_mp_and_igwas)."""
    base = ["--bfile", str(GOLDEN / "cohort"), "--pheno", str(GOLDEN / "pheno.txt"),
            "--mesh", "none"]
    main(["--mpresiduals"] + base + ["--out", str(tmp_path / "mp")])
    ours = LabeledMatrix.load(str(tmp_path / "mp.residuals"))
    ref = LabeledMatrix.load(str(GOLDEN / "golden.mp.residuals"))
    assert ours.row_labels == ref.row_labels and ours.col_labels == ref.col_labels
    grm = read_grm(str(GOLDEN / "golden"))
    k = grm["kernel"].astype(np.float64)
    keys = grm["individual_keys"]
    assert keys == ours.row_labels
    pheno = Phenotype(keys=keys, values=np.loadtxt(GOLDEN / "pheno.txt", usecols=2), column=1)
    null = SingleREML([Kernel(name="GRM", type=KernelType.GRM, individual_keys=keys,
                              matrix=T(k)).diagonalize()], pheno, device="cpu").compute()
    s2_g, s2_e = null.result.variances
    n = len(keys)
    bound = s2_g / s2_e * 2 * n * EPS32 * np.linalg.norm(k, 2) * np.linalg.norm(ours.values)
    err = np.linalg.norm(ours.values - ref.values)
    assert 0 < err <= bound, (err, bound)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """n = 110 individuals x 150 SNPs (1% missing): three phenotype
    columns, a discrete and a quantitative covariate, two tested
    covariates, a GRM of 400 other SNPs (none missing, so it is positive
    semi-definite), residuals written by the JAX CLI, and a residual list
    pairing two filesets with them."""
    tmp = tmp_path_factory.mktemp("mp_igwas_cli")
    rng = np.random.default_rng(2024)
    n, m = 110, 150
    dosage = make_dosage(rng, m, n, missing_rate=0.01)
    bfile, data = make_plink(tmp, dosage)
    half, _ = make_plink(tmp, dosage[:70], prefix="half")
    grm_set, _ = make_plink(tmp, make_dosage(rng, 400, n), prefix="grmset")
    ids = [(ind.family_id, ind.individual_id) for ind in data.individuals]
    z = np.where(dosage >= 0, dosage, 0).astype(np.float64)
    z = (z - z.mean(1, keepdims=True)) / z.std(1, keepdims=True)
    g = z.T @ rng.normal(size=m) * np.sqrt(0.5 / m)
    ys = [g + rng.normal(size=n) * 0.7, rng.normal(size=n), 0.5 * g + rng.normal(size=n)]
    rows = {
        "pheno.txt": [" ".join(f"{y[i]:.8g}" for y in ys) for i in range(n)],
        "covar.txt": ["M" if i % 3 else "F" for i in range(n)],
        "qcovar.txt": [f"{v:.6g}" for v in rng.uniform(20, 60, size=n)],
        "test.txt": [f"{a:.6g} {b:.6g}" for a, b in rng.normal(size=(n, 2))],
        "testd.txt": [f"c{i % 4}" for i in range(n)],
    }
    for name, values in rows.items():
        with open(tmp / name, "w") as fh:
            for (fid, iid), v in zip(ids, values):
                fh.write(f"{fid} {iid} {v}\n")
    jax_main(["--make-grm", "--bfile", grm_set, "--mesh", "none", "--out", str(tmp / "g")])
    jax_main(["--mpresiduals", "--bfile", bfile, "--pheno", str(tmp / "pheno.txt"),
              "--pheno-cols", "1,3", "--mesh", "none", "--out", str(tmp / "res")])
    set_mesh_context(None)
    (tmp / "rlist.txt").write_text(f"{bfile} {tmp / 'res'}.residuals\n"
                                   f"{half} {tmp / 'res'}.residuals\n")
    return tmp, bfile


CASES = {
    "mpresiduals": ["--mpresiduals", "{bfile}", "{pheno}", "--covar", "{covar.txt}",
                    "--qcovar", "{qcovar.txt}"],
    "mpresiduals_cols_grm": ["--mpresiduals", "--grm", "{g}", "{pheno}", "--pheno-cols", "3,1"],
    # both CLIs read the residuals the JAX CLI wrote
    "mpgwas": ["--mpgwas", "{bfile}", "--residuals", "{res.residuals}"],
    # tests/test_cli_parity2.py:315: one pass per (genotypes, residuals) pair
    "bfile_residuals_list": ["--mpgwas", "--bfile-residuals-list", "{rlist.txt}"],
    "igwas_ols": ["--igwas", "{bfile}", "--qcovar", "{qcovar.txt}", "--igwas-qcovar",
                  "{test.txt}"],
    "igwas_discrete": ["--igwas", "{bfile}", "--covar", "{covar.txt}", "--igwas-covar",
                       "{testd.txt}", "--igwas-qcovar", "{test.txt}"],
    "igwas_grm_ml": ["--igwas", "{bfile}", "--grm", "{g}", "--covar", "{covar.txt}",
                     "--qcovar", "{qcovar.txt}", "--initial-h2", "0.3"],
}


def _argv(case, tmp, bfile):
    return _expand(CASES[case], tmp, bfile)


def _expand(args, tmp, bfile):
    """An argv with the cohort's paths in place of its {placeholders}."""
    argv = []
    for arg in args:
        if arg == "{bfile}":
            argv += ["--bfile", bfile]
        elif arg == "{pheno}":
            argv += ["--pheno", str(tmp / "pheno.txt")]
        elif arg.startswith("{"):
            argv.append(str(tmp / arg[1:-1]))
        else:
            argv.append(arg)
    return argv + ["--mesh", "none"]


def _with_residuals(argv, out_dir):
    """argv without its `--residuals prefix` pair, after copying that
    LabeledMatrix to out_dir/r.residuals.*, where --mpgwas reads it."""
    if "--residuals" not in argv:
        return argv
    i = argv.index("--residuals")
    for ext in ("rowids", "colids", "dat"):
        shutil.copy(f"{argv[i + 1]}.{ext}", out_dir / f"r.residuals.{ext}")
    return argv[:i] + argv[i + 2:]


def _run_both(argv, tmp_path):
    """argv through the JAX CLI and the port's into tmp_path/{jax,torch}.
    Returns {side: {file name: path}} without the logs and the copied
    residuals."""
    copied = "--residuals" in argv
    outs = {}
    for side, run in (("jax", jax_main), ("torch", main)):
        (tmp_path / side).mkdir()
        try:
            run(_with_residuals(argv, tmp_path / side) + ["--out", str(tmp_path / side / "r")])
        finally:
            set_mesh_context(None)
        outs[side] = {p.name: p for p in (tmp_path / side).iterdir()
                      if p.suffix != ".log" and not (copied and ".residuals." in p.name)}
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert outs["jax"], "the JAX CLI wrote nothing"
    return outs


def _diff_outputs(outs, residual_bound=None):
    """Text files at rtol 2e-5; a LabeledMatrix's .dat payload as numbers
    (at rtol 2e-5, or within `residual_bound` in the 2-norm, see
    test_golden_mp_residuals_within_the_float32_eigensolver_bound)."""
    for name, path in outs["jax"].items():
        if name.endswith(".dat"):
            prefix = lambda p: str(p)[: -len(".dat")]
            ours = LabeledMatrix.load(prefix(outs["torch"][name]))
            ref = LabeledMatrix.load(prefix(path))
            assert ours.row_labels == ref.row_labels and ours.col_labels == ref.col_labels
            if residual_bound is None:
                np.testing.assert_allclose(ours.values, ref.values, rtol=RTOL, atol=1e-12)
            else:
                assert np.linalg.norm(ours.values - ref.values) <= residual_bound(ref.values)
        else:
            _diff_files(outs["torch"][name], path, rtol=RTOL)


def _float32_residual_bound(tmp):
    """The float32 eigensolver's bound on the residuals (see
    test_golden_mp_residuals_within_the_float32_eigensolver_bound), with
    s2_G / s2_E at most 10 here."""
    k = read_grm(str(tmp / "g"))["kernel"].astype(np.float64)
    scale = 10 * 2 * k.shape[0] * EPS32 * np.linalg.norm(k, 2)
    return lambda values: scale * np.linalg.norm(values)


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(cohort, tmp_path, cpu, case):
    tmp, bfile = cohort
    outs = _run_both(_argv(case, tmp, bfile), tmp_path)
    if case == "bfile_residuals_list":
        assert len([n for n in outs["torch"] if n.endswith(".mpgwas")]) == 2
    if case == "igwas_grm_ml":
        # SNPs outside the GRM: many genetic variances run to their floor
        unfitted = outs["torch"]["r.gwas.unfitted"].read_text().split()
        assert 0 < len(unfitted) < 150
    _diff_outputs(outs, _float32_residual_bound(tmp) if case.startswith("mpresiduals") else None)


@pytest.mark.parametrize("argv,match", [
    (["--igwas", "{bfile}"], "igwas.cpp:27-30"),
    (["--igwas", "{bfile}", "--grm", "{g}", "--igwas-qcovar", "{test.txt}"], "igwas.cpp:70-76"),
])
def test_igwas_error_cases_match_jax(cohort, tmp_path, cpu, argv, match):
    """No tested covariates without a GRM (igwas.cpp:27-30), and tested
    covariates under a GRM (igwas.cpp:70-76): both CLIs refuse alike."""
    tmp, bfile = cohort
    full = _expand(argv, tmp, bfile) + ["--out", str(tmp_path / "x")]
    for run in (jax_main, main):
        try:
            with pytest.raises(ValueError, match=match):
                run(full)
        finally:
            set_mesh_context(None)


@pytest.mark.parametrize("analysis", ["mpgwas", "igwas_ols", "igwas_grm_ml"])
def test_snp_chunks_concatenate_to_the_whole(cohort, tmp_path, cpu, monkeypatch, analysis):
    """GWAS_CHUNK_SNPS chunks (64 SNPs here, so 3 chunks with a ragged
    last one) write the files the unchunked run writes."""
    tmp, bfile = cohort
    argv = _argv(analysis, tmp, bfile)
    for tag, chunk in (("whole", dispatcher.GWAS_CHUNK_SNPS), ("chunked", 64)):
        monkeypatch.setattr(dispatcher, "GWAS_CHUNK_SNPS", chunk)
        (tmp_path / tag).mkdir()
        main(_with_residuals(argv, tmp_path / tag) + ["--out", str(tmp_path / tag / "r")])
    written = lambda tag: sorted(p.name for p in (tmp_path / tag).iterdir()
                                 if p.suffix != ".log" and ".residuals." not in p.name)
    assert written("whole") == written("chunked")
    for name in written("whole"):
        _diff_files(tmp_path / "chunked" / name, tmp_path / "whole" / name, rtol=1e-12)
