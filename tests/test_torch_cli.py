"""The port's CLI (`python -m dissect_tpu_torch`, run in process on the
CPU with DISSECT_TPU_TORCH_DEVICE=cpu) on the golden cohort, diffed
against the stored golden files the JAX CLI reproduces
(tests/test_golden.py), with the same tolerances: text outputs at rtol
2e-5, the .grm.dat kernel at rtol 1e-6, counts exactly.
"""

import os
import pathlib

import numpy as np
import pytest

from dissect_tpu.runtime.options import Options as JaxOptions
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.io.grm_io import read_grm
from dissect_tpu_torch.runtime.options import Options
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
BASE = ["--bfile", str(GOLDEN / "cohort"), "--pheno", str(GOLDEN / "pheno.txt"),
        "--mesh", "none"]
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_cli")
    saved = os.environ.get("DISSECT_TPU_TORCH_DEVICE")
    os.environ["DISSECT_TPU_TORCH_DEVICE"] = "cpu"
    try:
        main(["--make-grm"] + BASE + ["--out", f"{out}/golden"])
        main(["--make-grm", "--diagonalize"] + BASE + ["--out", f"{out}/golden.diag"])
        main(["--gwas"] + BASE + ["--out", f"{out}/golden.ols"])
        main(["--gwas", "--grm", f"{out}/golden"] + BASE + ["--out", f"{out}/golden.mlm"])
    finally:
        if saved is None:
            os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)
        else:
            os.environ["DISSECT_TPU_TORCH_DEVICE"] = saved
    return out


@pytest.mark.parametrize("name", [
    "golden.grm.ids", "golden.grm.snps",
    "golden.ols.gwas.snps", "golden.ols.gwas.mean",
    "golden.ols.gwas.discrete", "golden.ols.gwas.quantitative",
    "golden.mlm.gwas.snps", "golden.mlm.gwas.mean",
    "golden.mlm.gwas.discrete", "golden.mlm.gwas.quantitative",
    "golden.mlm.gwas.unfitted",
])
def test_text_output_matches_golden(runs, name):
    _diff_files(runs / name, GOLDEN / name, rtol=2e-5)


def test_grm_dat_matches_golden(runs):
    new, old = read_grm(f"{runs}/golden"), read_grm(str(GOLDEN / "golden"))
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(new["counts"], old["counts"])
    raw_new = (runs / "golden.grm.dat").read_bytes()
    raw_old = (GOLDEN / "golden.grm.dat").read_bytes()
    assert raw_new[:14] == raw_old[:14], "binary .grm.dat header changed"


def test_grm_diag_is_the_exact_eigendecomposition(runs):
    """The port diagonalizes in float64: its .grm.diag holds the
    eigenpairs of the golden GRM to rtol 1e-6 (eigenvalues) and 1e-5
    sign-free (eigenvectors), the tolerances of tests/test_golden.py."""
    new = read_grm(f"{runs}/golden.diag")
    assert new["diagonalized"]
    w, v = np.linalg.eigh(read_grm(str(GOLDEN / "golden"))["kernel"])
    np.testing.assert_allclose(new["eigenvalues"], w, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.abs(new["eigenvectors"]), np.abs(v), rtol=1e-5, atol=1e-7)
    raw_new = (runs / "golden.diag.grm.dat").read_bytes()
    raw_old = (GOLDEN / "golden.diag.grm.dat").read_bytes()
    assert raw_new[:14] == raw_old[:14]


def test_grm_diag_matches_golden_to_float32_eigensolver_accuracy(runs):
    """golden.diag.grm.diag was written by the JAX CLI, which
    diagonalizes the float32 GRM in float32 (ROADMAP.md, deliberate departures): its
    eigenvalues carry a float32 solver's error, |dlam| <= c eps32 |K|,
    and its eigenvectors that error over the eigenvalue gap.  The port's
    float64 pairs agree with it within twice those bounds."""
    new, old = read_grm(f"{runs}/golden.diag"), read_grm(str(GOLDEN / "golden.diag"))
    scale = np.max(np.abs(old["eigenvalues"]))
    np.testing.assert_allclose(new["eigenvalues"], old["eigenvalues"], rtol=0,
                               atol=2 * EPS32 * scale)
    gap = np.min(np.diff(np.sort(old["eigenvalues"])))
    np.testing.assert_allclose(np.abs(new["eigenvectors"]), np.abs(old["eigenvectors"]),
                               rtol=0, atol=2 * EPS32 * scale / gap)


@pytest.mark.parametrize("argv", [
    ["--make-grm", "--bfile", "x", "--out", "o"],
    ["--gwas", "--grm", "g", "--bfile", "x", "--pheno", "p", "--qcovar", "q",
     "--covar", "c", "--no-gwas-retry-unfitted", "--zout"],
    ["--make-grm", "--diagonalize", "--grm-cutoff", "0.05", "--min-overlap-snps", "0.2",
     "--keep-zerostd-snps", "--mesh", "none"],
    ["--reml", "--grm", "g", "--pheno", "p", "--reml-maxit", "7", "--initial-h2", "0.3",
     "--use-ml", "--blue", "--snp-blup"],
])
def test_options_parse_like_jax(argv):
    """The port takes the same argv: both packages' Options give equal
    namespaces (the default --out prefix names the package)."""
    ours, theirs = Options.parse(argv), JaxOptions.parse(argv)
    assert ours.analysis == theirs.analysis
    a, b = vars(ours.args), vars(theirs.args)
    if "--out" not in argv:
        a.pop("out"), b.pop("out")
    assert a == b
    assert ours.reml_options() .__dict__ == {
        k: v for k, v in theirs.reml_options().__dict__.items() if k in ours.reml_options().__dict__
    }


@pytest.mark.parametrize("argv,item", [
    (["--mpgwas"] + BASE, "item 7"),
    (["--igwas", "--bfile", str(GOLDEN / "cohort"), "--igwas-qcovar",
      str(GOLDEN / "testcovar.txt")], "item 7"),
    (["--simulate", "--bfile", str(GOLDEN / "cohort"), "--effect-sizes",
      str(GOLDEN / "causal.txt")], "item 8"),
    (["--glmm", "--grm", str(GOLDEN / "golden"), "--bfile", str(GOLDEN / "cohort"),
      "--pheno", "{case_control}", "--mesh", "none"], "item 8"),
    (["--mpresiduals"] + BASE, "item 7"),
])
def test_unported_analyses_name_their_roadmap_item(tmp_path, monkeypatch, argv, item):
    """These analyses named their ROADMAP.md queue 1 item (7 or 8) until
    it ported them.  Each now runs and writes what the JAX CLI writes, at
    rtol 2e-5 (`--mpgwas` after `--mpresiduals` on each side; `--glmm` on
    the golden phenotype cut at its median into 1/2 case/control codes).
    The residual matrix `--mpresiduals` writes is binary, held in
    tests/test_torch_mp_igwas.py."""
    from dissect_tpu.analysis.dispatcher import main as jax_main
    from dissect_tpu.runtime.mesh import set_mesh_context

    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")
    rows = [ln.split() for ln in (GOLDEN / "pheno.txt").read_text().splitlines()]
    median = np.median([float(r[2]) for r in rows])
    (tmp_path / "cc.txt").write_text(
        "".join(f"{r[0]} {r[1]} {2 if float(r[2]) > median else 1}\n" for r in rows))
    argv = [str(tmp_path / "cc.txt") if a == "{case_control}" else a for a in argv]
    outs = {}
    for side, run in (("jax", jax_main), ("torch", main)):
        (tmp_path / side).mkdir()
        out = ["--out", str(tmp_path / side / "x")]
        try:
            if argv[0] == "--mpgwas":
                run(["--mpresiduals"] + argv[1:] + out)
            run(argv + out)
        finally:
            set_mesh_context(None)
        outs[side] = sorted(p.name for p in (tmp_path / side).iterdir() if p.suffix != ".log")
    assert outs["torch"] == outs["jax"] and outs["jax"], item
    for name in outs["jax"]:
        if not name.endswith(".dat"):
            _diff_files(tmp_path / "torch" / name, tmp_path / "jax" / name, rtol=2e-5)


def test_multi_device_mesh_is_refused(tmp_path, monkeypatch):
    """--mesh 2x2 needs 4 ranks, and outside a torchrun launch there is
    one: the error names the torchrun command that starts them."""
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 4"):
        main(["--make-grm"] + BASE[:-2] + ["--mesh", "2x2", "--out", str(tmp_path / "x")])
