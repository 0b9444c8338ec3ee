"""The port's logistic GLM and GLMM, and its small workflows (simulation,
prediction, accuracy by SNP, covariate prediction, SNP statistics, group
effects and the HetVector container), held against the JAX package on
the CPU: the functions in float64 to rtol 1e-8 or tighter (the draws of
the simulation and of the GLMM chain are numpy's on both sides, from the
same seeds), and the CLI's files against the golden files and the JAX
CLI at rtol 2e-5."""

import pathlib

import numpy as np
import pytest
import torch

from dissect_tpu.analysis import accuracy as jax_accuracy
from dissect_tpu.analysis import group_effects as jax_ge
from dissect_tpu.analysis import predict as jax_predict
from dissect_tpu.analysis import simulate as jax_simulate
from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.glm import glmm as jax_glmm
from dissect_tpu.glm import logistic as jax_logistic
from dissect_tpu.io import covariate as jax_covariate
from dissect_tpu.io.bed import read_plink as jax_read_plink
from dissect_tpu.io.labeled_matrix import LabeledMatrix as JaxLabeledMatrix
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis import accuracy, group_effects, predict, simulate
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.glm import glmm, logistic
from dissect_tpu_torch.io import covariate
from dissect_tpu_torch.io.bed import read_plink
from dissect_tpu_torch.io.hetvector import HetVector
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
RTOL = 2e-5


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


def _assert_fields_equal(ours, theirs, fields, rtol=1e-10, atol=1e-12):
    for f in fields:
        a, b = getattr(ours, f), getattr(theirs, f)
        if isinstance(b, list):
            assert a == b, f
        else:
            np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                       np.asarray(b, dtype=np.float64),
                                       rtol=rtol, atol=atol, err_msg=f)


# ------------------------------------------------------------------ GLM --
def _logistic_data(seed, n=300):
    rng = np.random.default_rng(seed)
    x = np.column_stack([np.ones(n), rng.normal(size=n), rng.normal(size=n)])
    offset = rng.normal(size=n)
    eta = x @ [0.3, 1.1, -0.6] + offset
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float)
    return rng, x, offset, y


@pytest.mark.parametrize("with_offset", [False, True])
def test_fit_logistic_matches_jax(with_offset):
    rng, x, offset, y = _logistic_data(11)
    kwargs = dict(offset=offset) if with_offset else {}
    beta0 = rng.normal(size=3) * 0.1
    ours = logistic.fit_logistic(y, x, beta0=beta0, device="cpu", **kwargs)
    theirs = jax_logistic.fit_logistic(y, x, beta0=beta0, **kwargs)
    assert ours.success and theirs.success
    assert ours.n_iterations == theirs.n_iterations
    _assert_fields_equal(ours, theirs, ["betas", "se", "probabilities", "log_likelihood"])


def test_fit_logistic_stops_on_separation_like_jax():
    """A perfectly separated design diverges: both stop unsuccessful at
    the same step, or at max_iterations."""
    x = np.column_stack([np.ones(40), np.linspace(-1, 1, 40)])
    y = (x[:, 1] > 0).astype(float)
    ours = logistic.fit_logistic(y, x, max_iterations=8, device="cpu")
    theirs = jax_logistic.fit_logistic(y, x, max_iterations=8)
    assert not ours.success and not theirs.success
    assert ours.n_iterations == theirs.n_iterations
    np.testing.assert_allclose(ours.betas, theirs.betas, rtol=1e-8, atol=1e-12)


def _glmm_problem(seed, n=60):
    """Small enough (n = 60, V = 0.2 K + 0.1 I) that the chain's joint
    proposals are accepted now and then: the acceptance rate falls with n
    (the log-likelihood ratio sums n terms)."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(250, n))
    k = z.T @ z / 250
    u = np.linalg.cholesky(k + 1e-8 * np.eye(n)) @ rng.normal(size=n) * np.sqrt(0.2)
    x = np.column_stack([np.ones(n), rng.normal(size=n)])
    eta = x @ [-0.2, 0.8] + u
    y = (rng.random(n) < 1 / (1 + np.exp(-eta))).astype(float)
    return y, x, 0.2 * k + 0.1 * np.eye(n)


@pytest.mark.parametrize("seed", [7, 123])
def test_glmm_fit_matches_jax(seed):
    """The same numpy draws (default_rng(seed + it), normal then random)
    and the same accept/reject decisions: betas, SEs, posterior-mean
    random effects and the acceptance rate agree."""
    y, x, v = _glmm_problem(seed)
    fit_args = dict(n_outer=4, n_samples=30, burn_in=5)
    ours = glmm.GLMM(y, x, torch.as_tensor(v), seed=seed).fit(**fit_args)
    theirs = jax_glmm.GLMM(y, x, v, seed=seed).fit(**fit_args)
    assert ours.success and theirs.success
    assert ours.n_iterations == theirs.n_iterations
    assert ours.acceptance_rate == theirs.acceptance_rate
    assert 0.0 < ours.acceptance_rate < 1.0
    _assert_fields_equal(ours, theirs, ["betas", "betas_se", "random_effects"], rtol=1e-8,
                         atol=1e-10)


# ------------------------------------------------------------ workflows --
@pytest.fixture(scope="module")
def fileset(tmp_path_factory):
    """80 individuals x 60 SNPs, 2% missing, read by both packages."""
    tmp = tmp_path_factory.mktemp("workflows")
    rng = np.random.default_rng(99)
    dosage = make_dosage(rng, 60, 80, missing_rate=0.02)
    bfile, _ = make_plink(tmp, dosage)
    return tmp, bfile, read_plink(bfile, device="cpu"), jax_read_plink(bfile)


@pytest.mark.parametrize("binary", [False, True])
def test_simulate_phenotypes_matches_jax(fileset, binary):
    _, _, ours_data, jax_data = fileset
    effects = {"snp3": 0.5, "snp10": None, "snp44": -1.2, "absent": 2.0, "snp20": None}
    kw = dict(h2=0.4, binary=binary, prevalence=0.25, seed=5)
    ours = simulate.simulate_phenotypes(ours_data, dict(effects), **kw)
    theirs = jax_simulate.simulate_phenotypes(jax_data, dict(effects), **kw)
    assert ours.causal_effects == theirs.causal_effects
    assert (ours.n_cases, ours.n_controls) == (theirs.n_cases, theirs.n_controls)
    _assert_fields_equal(ours, theirs, ["individual_keys", "phenotypes", "genetic_effects",
                                        "environmental_effects"])


def _effects(data, rng, fmt):
    """SNP effects on allele2, on allele1 (flipped) and on neither
    (skipped), for every third SNP, in `fmt` ('plain' or 'gwas')."""
    lines = ["SNP ALLELE EFFECT"] if fmt == "plain" else \
        ["GROUP SNP ALLELE MEAN STDEV BETA"]
    for i, s in enumerate(data.snps[::3]):
        allele = (s.allele2, s.allele1, "T")[i % 3]
        eff = rng.normal()
        lines.append(f"{s.name} {allele} {eff:.6g}" if fmt == "plain"
                     else f"{s.name} {s.name} {allele} 0.5 0.4 {eff:.6g}")
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("fmt", ["plain", "gwas"])
def test_predict_and_accuracy_match_jax(fileset, fmt):
    tmp, _, ours_data, jax_data = fileset
    rng = np.random.default_rng(3)
    path = tmp / f"eff_{fmt}.txt"
    path.write_text(_effects(ours_data, rng, fmt))
    ours_eff = predict.read_snp_effects(str(path))
    theirs_eff = jax_predict.read_snp_effects(str(path))
    assert list(ours_eff) == list(theirs_eff)
    ours = predict.predict_phenotypes(ours_data, ours_eff)
    theirs = jax_predict.predict_phenotypes(jax_data, theirs_eff)
    assert (ours.n_snps_used, ours.n_flipped) == (theirs.n_snps_used, theirs.n_flipped)
    _assert_fields_equal(ours, theirs, ["individual_keys", "scores", "shifts"])
    y = rng.normal(size=ours_data.n_individuals) + 0.1 * ours.scores
    ours_acc = accuracy.compute_accuracy_by_snp(ours_data, ours_eff, y)
    theirs_acc = jax_accuracy.compute_accuracy_by_snp(jax_data, theirs_eff, y)
    _assert_fields_equal(ours_acc, theirs_acc, [
        "snp_names", "alleles", "effects", "loo_accuracies", "total_accuracy",
        "filtered_accuracy", "filtered_snps"])


def _covariate_effect_files(tmp):
    keys = [(f"F{i}", f"I{i}") for i in range(12)]
    cats = ["a", "b", "c", "z"]
    (tmp / "cov.txt").write_text("".join(
        f"{f} {i} {cats[j % 4] if j != 5 else 'NA'} {'x' if j % 2 else 'y'}\n"
        for j, (f, i) in enumerate(keys)))
    (tmp / "qcov.txt").write_text("".join(
        f"{f} {i} {0.5 * j:.3g} {'NA' if j == 7 else f'{1.0 - 0.1 * j:.3g}'}\n"
        for j, (f, i) in enumerate(keys)))
    # category 'z' of column 1 has no stored effect
    (tmp / "cov_eff.txt").write_text(
        "NAME BETA SE\ndiscrete_1_b 0.7 0.1\ndiscrete_1_c -0.4 0.1\ndiscrete_2_y 0.25 0.05\n")
    (tmp / "qcov_eff.txt").write_text("NAME BETA SE\nquantitative_1 1.5 0.2\n"
                                      "quantitative_2 -2.0 0.3\n")


@pytest.mark.parametrize("force", [False, True])
def test_load_effect_prediction_matches_jax(tmp_path, force):
    _covariate_effect_files(tmp_path)
    args = [str(tmp_path / n) for n in ("cov.txt", "qcov.txt", "cov_eff.txt", "qcov_eff.txt")]
    if not force:
        for fn in (covariate.load_effect_prediction, jax_covariate.load_effect_prediction):
            with pytest.raises(ValueError, match="force-use-unestimated-values"):
                fn(*args)
        ours = covariate.load_effect_prediction(None, *args[1:])
        theirs = jax_covariate.load_effect_prediction(None, *args[1:])
    else:
        ours = covariate.load_effect_prediction(*args, force_unestimated=True)
        theirs = jax_covariate.load_effect_prediction(*args, force_unestimated=True)
    assert list(ours) == list(theirs) and ours
    np.testing.assert_allclose(list(ours.values()), list(theirs.values()), rtol=1e-12)


def _effect_matrices(rng, n=25, groups=8):
    rows = [f"F{i}@I{i}" for i in range(n)]
    base = rng.normal(size=(n, 3))
    values = base @ rng.normal(size=(3, groups)) + 0.3 * rng.normal(size=(n, groups))
    cols = [f"G{j}" for j in range(groups)]
    return rows, cols, values


def test_group_effects_match_jax():
    """Correlations, covariances, the distance-aware filter, crossed
    correlations and the PCA of the individual covariances: loadings are
    held up to the sign of each column."""
    rng = np.random.default_rng(17)
    rows, cols, values = _effect_matrices(rng)
    ours = group_effects.GroupEffects(LabeledMatrix(rows, cols, values))
    theirs = jax_ge.GroupEffects(JaxLabeledMatrix(rows, cols, values))
    for method in ("correlations_between_groups", "covariances_between_individuals",
                   "covariances_between_groups"):
        a, b = getattr(ours, method)(), getattr(theirs, method)()
        assert (a.row_labels, a.col_labels) == (b.row_labels, b.col_labels)
        np.testing.assert_allclose(a.values, b.values, rtol=1e-12, atol=1e-14, err_msg=method)
    pos = lambda cls: {f"G{j}": cls(f"G{j}", "1" if j < 6 else "2", 1000.0 * j,
                                    1000.0 * j + 500) for j in range(8)}
    kept = ours.filter_correlated_groups(0.1, pos(group_effects.GroupPosition), 2500)
    kept_jax = theirs.filter_correlated_groups(0.1, pos(jax_ge.GroupPosition), 2500)
    assert kept.effects.col_labels == kept_jax.effects.col_labels
    assert len(kept.effects.col_labels) < 8
    rows2, cols2, values2 = _effect_matrices(rng, groups=5)
    cross = group_effects.crossed_correlations(
        ours, group_effects.GroupEffects(LabeledMatrix(rows2[3:], cols2, values2[3:])))
    cross_jax = jax_ge.crossed_correlations(
        theirs, jax_ge.GroupEffects(JaxLabeledMatrix(rows2[3:], cols2, values2[3:])))
    np.testing.assert_allclose(cross.values, cross_jax.values, rtol=1e-12, atol=1e-14)
    cov = ours.covariances_between_individuals()
    w, load = group_effects.pca_of_labeled_matrix(cov, 4, device="cpu")
    w_jax, load_jax = jax_ge.pca_of_labeled_matrix(
        JaxLabeledMatrix(cov.row_labels, cov.col_labels, cov.values), 4)
    np.testing.assert_allclose(w, np.asarray(w_jax), rtol=1e-10)
    assert load.col_labels == load_jax.col_labels == ["PC1", "PC2", "PC3", "PC4"]
    signs = np.sign(np.sum(load.values * load_jax.values, axis=0))
    np.testing.assert_allclose(load.values * signs, load_jax.values, rtol=1e-8, atol=1e-10)


def test_hetvector_alignment(tmp_path):
    """tests/test_more_cli.py's HetVector case, on the port's copy, and
    equal to the JAX container's matrices."""
    from dissect_tpu.io.covariate import read_covariates as jax_read_covariates
    from dissect_tpu.io.hetvector import HetVector as JaxHetVector

    rng = np.random.default_rng(12345)
    dosage = make_dosage(rng, 10, 6)
    prefix, _ = make_plink(tmp_path, dosage)
    data = read_plink(prefix, device="cpu")
    qc = tmp_path / "q.txt"
    with open(qc, "w") as fh:
        for i, ind in enumerate(data.individuals):
            fh.write(f"{ind.family_id} {ind.individual_id} {float(i)}\n")
    hv, hv_jax = HetVector(), JaxHetVector()
    hv.insert("geno", data)
    hv.insert("covar", covariate.read_covariates(quantitative_path=str(qc)))
    hv_jax.insert("geno", jax_read_plink(prefix))
    hv_jax.insert("covar", jax_read_covariates(quantitative_path=str(qc)))
    with pytest.raises(ValueError, match="already present"):
        hv.insert("geno", data)
    assert hv.names() == ["geno", "covar"]
    assert hv.keys_of("geno") == hv.keys_of("covar") == data.individual_keys
    keys = data.individual_keys[::-1][:4]
    g, c = hv.matrix_for("geno", keys), hv.matrix_for("covar", keys)
    assert g.shape == (4, 10) and c.shape == (4, 2)
    np.testing.assert_allclose(c[:, 1], [5.0, 4.0, 3.0, 2.0])
    np.testing.assert_allclose(g, hv_jax.matrix_for("geno", keys), rtol=1e-12)
    np.testing.assert_allclose(c, hv_jax.matrix_for("covar", keys), rtol=1e-12)


# ------------------------------------------------------------------ CLI --
@pytest.mark.parametrize("name", [
    "golden.sim.simulated.phenos", "golden.sim.simulated.effects",
    "golden.pred.predicted.phenos",
])
def test_golden_simulate_and_predict(tmp_path, cpu, name):
    """The runs of tests/test_golden.py that wrote these files."""
    if name.startswith("golden.sim"):
        main(["--simulate", "--bfile", str(GOLDEN / "cohort"), "--effect-sizes",
              str(GOLDEN / "causal.txt"), "--simu-h2", "0.6", "--random-seed", "7",
              "--mesh", "none", "--out", str(tmp_path / "golden.sim")])
    else:
        main(["--predict", "--bfile", str(GOLDEN / "cohort"), "--snp-effects",
              str(GOLDEN / "eff.txt"), "--mesh", "none", "--out", str(tmp_path / "golden.pred")])
    _diff_files(tmp_path / name, GOLDEN / name, rtol=RTOL)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """n = 100 individuals x 120 SNPs (1% missing): a case/control
    phenotype (1/2) from a liability with a genetic part, a quantitative
    phenotype, covariates and their stored effects, causal and SNP effect
    files, a random-effect category file, a GRM, group-effect matrices
    and group positions."""
    tmp = tmp_path_factory.mktemp("glm_cli")
    rng = np.random.default_rng(77)
    n, m = 100, 120
    dosage = make_dosage(rng, m, n, missing_rate=0.01)
    bfile, data = make_plink(tmp, dosage)
    ids = [(ind.family_id, ind.individual_id) for ind in data.individuals]
    z = np.where(dosage >= 0, dosage, 0).astype(np.float64)
    z = (z - z.mean(1, keepdims=True)) / z.std(1, keepdims=True)
    liability = z.T @ rng.normal(size=m) * np.sqrt(0.5 / m) + rng.normal(size=n) * 0.7
    case = np.where(liability > np.quantile(liability, 0.7), 2, 1)
    q = rng.normal(size=n)
    rows = {
        "cc.txt": [str(c) for c in case],
        "pheno.txt": [f"{v:.8g}" for v in liability + 0.3 * q],
        "qcovar.txt": [f"{v:.6g}" for v in q],
        "covar.txt": [("a", "b", "c")[i % 3] for i in range(n)],
        "re.txt": [f"g{i % 4}" for i in range(n)],
    }
    for name, values in rows.items():
        with open(tmp / name, "w") as fh:
            for (fid, iid), v in zip(ids, values):
                fh.write(f"{fid} {iid} {v}\n")
    (tmp / "causal.txt").write_text("".join(
        f"snp{i}\n" if i % 20 == 0 else f"snp{i} {rng.normal():.6g}\n" for i in range(0, m, 7)))
    (tmp / "eff.txt").write_text(_effects(data, rng, "plain"))
    (tmp / "cov_eff.txt").write_text("NAME BETA SE\ndiscrete_1_b 0.7 0.1\n"
                                     "discrete_1_c -0.3 0.1\n")
    (tmp / "qcov_eff.txt").write_text("NAME BETA SE\nquantitative_1 -1.25 0.2\n")
    jax_main(["--make-grm", "--bfile", bfile, "--mesh", "none", "--out", str(tmp / "g")])
    set_mesh_context(None)
    keys = [f"{f}@{i}" for f, i in ids]
    for tag, groups in (("e1", 6), ("e2", 5), ("e3", 4)):
        _, cols, values = _effect_matrices(rng, n=n, groups=groups)
        LabeledMatrix(keys, [f"{tag}{c}" for c in cols], values).save(str(tmp / tag))
    (tmp / "positions.txt").write_text("".join(
        f"e1G{j} {1 + j // 4} {800 * j} {800 * j + 300}\ne2G{j} 1 {700 * j} {700 * j + 200}\n"
        for j in range(6)))
    (tmp / "keep_groups.txt").write_text("".join(f"e1G{j}\n" for j in range(5)) + "e2G1\ne2G3\n")
    (tmp / "keep.txt").write_text("".join(f"F{i} I{i}\n" for i in range(0, n, 2)))
    return tmp, bfile


CASES = {
    "glmm": ["--glmm", "{bfile}", "--pheno", "{cc.txt}", "--qcovar", "{qcovar.txt}",
             "--random-seed", "3"],
    "glmm_grm_random_effects": ["--glmm", "--grm", "{g}", "--pheno", "{cc.txt}", "--covar",
                                "{covar.txt}", "--random-effects", "{re.txt}",
                                "--initial-h2", "0.3"],
    "simulate": ["--simulate", "{bfile}", "--effect-sizes", "{causal.txt}", "--simu-h2", "0.3",
                 "--random-seed", "11"],
    "simulate_binary": ["--simulate", "{bfile}", "--effect-sizes", "{causal.txt}",
                        "--simu-binary", "--prevalence", "0.2"],
    "predict": ["--predict", "{bfile}", "--snp-effects", "{eff.txt}"],
    "accuracy_by_snp": ["--accuracy-by-snp", "{bfile}", "--snp-effects", "{eff.txt}",
                        "--pheno", "{pheno.txt}"],
    "cov_predict": ["--cov-predict", "--covar", "{covar.txt}", "--qcovar", "{qcovar.txt}",
                    "--covar-effects", "{cov_eff.txt}", "--qcovar-effects", "{qcov_eff.txt}"],
    "snp_stats": ["--snp-stats", "{bfile}"],
    "effects": ["--effects", "--effects-files", "{e1}", "{e2}", "--num-eval", "3",
                "--groups-positions", "{positions.txt}", "--group-min-distance", "1500"],
    "effects_keep": ["--effects", "--effects-files", "{e1}", "{e2}", "--keep-groups",
                     "{keep_groups.txt}", "--keep", "{keep.txt}", "--num-eval", "4"],
    "effects_pair_files": ["--effects", "--effects-pair-files", "{e1}", "{e2}", "{e3}", "{e1}"],
}


def _expand(args, tmp, bfile):
    """An argv with the cohort's paths in place of its {placeholders}."""
    argv = []
    for arg in args:
        if arg == "{bfile}":
            argv += ["--bfile", bfile]
        elif arg.startswith("{"):
            argv.append(str(tmp / arg[1:-1]))
        else:
            argv.append(arg)
    return argv + ["--mesh", "none"]


def run_both(argv, tmp_path):
    """argv through the JAX CLI and the port's, every file the JAX CLI
    writes (its log aside) written by the port too and held at rtol 2e-5;
    a LabeledMatrix's binary .dat is held as numbers, its loadings (PCA
    eigenvectors, "pca.loadings") up to the sign of each column."""
    outs = {}
    for side, run in (("jax", jax_main), ("torch", main)):
        (tmp_path / side).mkdir()
        try:
            run(argv + ["--out", str(tmp_path / side / "r")])
        finally:
            set_mesh_context(None)
        outs[side] = {p.name: p for p in (tmp_path / side).iterdir() if p.suffix != ".log"}
    assert sorted(outs["torch"]) == sorted(outs["jax"])
    assert outs["jax"], "the JAX CLI wrote nothing"
    for name, path in outs["jax"].items():
        if not name.endswith(".dat"):
            _diff_files(outs["torch"][name], path, rtol=RTOL)
            continue
        ours = LabeledMatrix.load(str(outs["torch"][name])[:-4])
        ref = LabeledMatrix.load(str(path)[:-4])
        assert (ours.row_labels, ours.col_labels) == (ref.row_labels, ref.col_labels)
        values = ours.values
        if "pca.loadings" in name:
            values = values * np.sign(np.sum(values * ref.values, axis=0))
        np.testing.assert_allclose(values, ref.values, rtol=RTOL, atol=1e-10, err_msg=name)
    return outs


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(cohort, tmp_path, cpu, case):
    tmp, bfile = cohort
    outs = run_both(_expand(CASES[case], tmp, bfile), tmp_path)
    if case.startswith("effects") and case != "effects_pair_files":
        assert any("pca.loadings" in n for n in outs["torch"])


def test_cov_predict_refuses_an_unestimated_category_like_jax(cohort, tmp_path, cpu):
    """A category without a stored effect stops both CLIs unless
    --force-use-unestimated-values counts it as 0 (covariate.cpp:673-678)."""
    tmp, bfile = cohort
    (tmp_path / "cov_eff.txt").write_text("NAME BETA SE\ndiscrete_1_c 0.7 0.1\n")
    argv = _expand(CASES["cov_predict"], tmp, bfile)
    argv[argv.index(str(tmp / "cov_eff.txt"))] = str(tmp_path / "cov_eff.txt")
    for run in (jax_main, main):
        try:
            with pytest.raises(ValueError, match="force-use-unestimated-values"):
                run(argv + ["--out", str(tmp_path / "x")])
        finally:
            set_mesh_context(None)
    run_both(argv + ["--force-use-unestimated-values"], tmp_path)
