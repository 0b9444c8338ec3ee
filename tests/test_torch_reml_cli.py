"""The port's CLI (`python -m dissect_tpu_torch`, run in process on the
CPU with DISSECT_TPU_TORCH_DEVICE=cpu) on dense `--reml` and on the GWAS
routes that need a dense V, held against the stored golden files and
against the JAX CLI on the same inputs: every file the JAX CLI writes
(its log aside) is written by the port too, and `_diff_files` holds each
at rtol 2e-5, the golden tests' tolerance."""

import pathlib

import numpy as np
import pytest

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
RTOL = 2e-5


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", ["golden.reml", "golden.blue.mean", "golden.GRM.blup.snps"])
def test_golden_reml_blue_snp_blup(tmp_path, cpu, name):
    """`--reml --grm golden --blue --snp-blup`, the run of
    tests/test_golden.py that wrote these files."""
    main(["--reml", "--grm", str(GOLDEN / "golden"), "--blue", "--snp-blup",
          "--bfile", str(GOLDEN / "cohort"), "--pheno", str(GOLDEN / "pheno.txt"),
          "--mesh", "none", "--out", str(tmp_path / "golden")])
    _diff_files(tmp_path / name, GOLDEN / name, rtol=RTOL)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """n = 120 individuals x 200 SNPs (test_cli_parity2's recipe): a
    phenotype with a sex and a genetic effect, a discrete and a
    quantitative covariate, a 3-level random effect, residual weights, a
    GRM and a second SNP set with its own GRM."""
    tmp = tmp_path_factory.mktemp("reml_cli")
    rng = np.random.default_rng(12345)
    n, m = 120, 200
    dosage = make_dosage(rng, m, n)
    bfile, data = make_plink(tmp, dosage)
    half, _ = make_plink(tmp, dosage[:100], prefix="half")
    p2 = dosage.sum(1) / (2 * n)
    z = (dosage - 2 * p2[:, None]) / np.sqrt(2 * p2 * (1 - p2))[:, None]
    g = z.T @ (rng.normal(size=m) * np.sqrt(0.6 / m))
    sex = rng.integers(0, 2, size=n)
    y = 1.0 + 0.5 * sex + g + rng.normal(size=n) * np.sqrt(0.4)
    age = rng.uniform(30, 70, size=n)
    ids = [(ind.family_id, ind.individual_id) for ind in data.individuals]
    rows = {
        "pheno.txt": [f"{y[i]:.8g}" for i in range(n)],
        "covar.txt": ["M" if sex[i] else "F" for i in range(n)],
        "qcovar.txt": [f"{age[i]:.4g}" for i in range(n)],
        "re.txt": [f"g{i % 3}" for i in range(n)],
        "w.txt": [f"{w:.6g}" for w in rng.uniform(0.5, 2.0, size=n)],
    }
    for name, values in rows.items():
        with open(tmp / name, "w") as fh:
            for (fid, iid), v in zip(ids, values):
                fh.write(f"{fid} {iid} {v}\n")
    (tmp / "init.txt").write_text("Var(GRM) 0.5\nVar(E) 0.6\n")
    (tmp / "blist.txt").write_text(half + "\n")
    jax_main(["--make-grm", "--bfile", bfile, "--mesh", "none", "--out", str(tmp / "g")])
    jax_main(["--make-grm", "--bfile", half, "--mesh", "none", "--out", str(tmp / "gh")])
    set_mesh_context(None)
    (tmp / "pairs.txt").write_text(f"{bfile} {tmp / 'g'}\n{half} {tmp / 'gh'}\n")
    (tmp / "grms.txt").write_text(f"KA {tmp / 'g'} N\nKB {tmp / 'gh'} F {half}\n")
    return tmp, bfile


CASES = {
    # --reml --bfile with --random-effects/--gxe, reduced models and every
    # BLUE/BLUP output (tests/test_cli_parity2.py:232-300)
    "random_effects_gxe": [
        "--reml", "{bfile}", "--covar", "{covar.txt}", "--qcovar", "{qcovar.txt}",
        "--random-effects", "{re.txt}", "--gxe", "--write-blue-reduced", "--blue",
        "--indiv-blup", "--indiv-blup-error", "--snp-blup",
    ],
    "reduced_with_only": [
        "--reml", "{bfile}", "--random-effects", "{re.txt}", "--reduced-with-only", "GRM",
    ],
    "weights": ["--reml", "{bfile}", "--weights", "{w.txt}", "--blue", "--indiv-blup"],
    "blup_bfile_list": ["--reml", "{bfile}", "--snp-blup", "--blup-bfile-list", "{blist.txt}"],
    "initial_variances": ["--reml", "{bfile}", "--initial-variances", "{init.txt}", "--blue"],
    "epistasis_var": ["--reml", "{bfile}", "--epistasis-var", "--skip-test-reduced-models"],
    # named GRMs with their own SNP sources (tests/test_parity_closures.py:179)
    "grm_list": ["--reml", "--grm-list", "{grms.txt}", "--snp-blup",
                 "--skip-test-reduced-models", "--indiv-blup"],
    # the GWAS routes that need a dense V
    "gwas_random_effects": ["--gwas", "--grm", "{g}", "{bfile}", "--random-effects", "{re.txt}",
                            "--qcovar", "{qcovar.txt}"],
    "gwas_use_null_variances": ["--gwas", "--grm", "{g}", "{bfile}",
                                "--gwas-use-null-variances"],
    "bfile_grm_list": ["--gwas", "--bfile-grm-list", "{pairs.txt}"],
}


def _argv(case, tmp, bfile):
    argv = []
    for arg in CASES[case]:
        if arg == "{bfile}":
            argv += ["--bfile", bfile]
        elif arg.startswith("{"):
            argv.append(str(tmp / arg[1:-1]))
        else:
            argv.append(arg)
    return argv + ["--pheno", str(tmp / "pheno.txt"), "--mesh", "none"]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_matches_jax(cohort, tmp_path, cpu, case):
    tmp, bfile = cohort
    argv = _argv(case, tmp, bfile)
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
        _diff_files(outs["torch"][name], path, rtol=RTOL)


def test_regional_reml_names_its_roadmap_item(cohort, tmp_path, cpu):
    tmp, bfile = cohort
    with pytest.raises(NotImplementedError, match="item 6"):
        main(["--reml", "--bfile", bfile, "--pheno", str(tmp / "pheno.txt"),
              "--region-size", "100", "--out", str(tmp_path / "x")])
