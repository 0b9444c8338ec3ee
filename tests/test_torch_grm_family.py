"""The port's GRM family — Kernel transforms and constructors, GCTA gz
GRMs, LabeledMatrix, and the CLI's `--gcta-grms-gz`, `--grm-epi`,
`--make-grm-mr`, `--add-grms` and `--filter-matrix` — held against the
JAX package on the CPU.

Tolerances: host-side algebra on the same float64 inputs is compared
exactly or at rtol 1e-12; GRM files at rtol 1e-6 with counts exactly
(the golden .grm.dat tolerance), except the float64 GRM sum of
`--add-grms` at rtol 1e-10 (tests/test_more_cli.py:120); CLI text
outputs at rtol 2e-5 (tests/test_golden.py).
"""

import gzip
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.io import grm_io as jax_grm_io
from dissect_tpu.io.labeled_matrix import LabeledMatrix as JaxLabeledMatrix
from dissect_tpu.model import kernels as jk
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.io import grm_io
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.model import kernels as tk
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
PHENO = ["--pheno", str(GOLDEN / "pheno.txt")]
BFILE = ["--bfile", str(GOLDEN / "cohort"), "--mesh", "none"]


def both_clis(tmp_path, monkeypatch, argv_of):
    """Run the JAX CLI and the port's CLI (on the CPU) in process with
    argv_of(out_dir), each into its own directory; returns the two."""
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")
    dirs = []
    for side, fn in (("jax", jax_main), ("torch", main)):
        d = tmp_path / side
        d.mkdir()
        try:
            fn(argv_of(d))
        finally:
            set_mesh_context(None)
        dirs.append(d)
    return dirs


def assert_same_grm(ours, theirs, rtol=1e-6):
    new, old = grm_io.read_grm(str(ours)), jax_grm_io.read_grm(str(theirs))
    assert new["individual_keys"] == old["individual_keys"]
    assert new["snp_names"] == old["snp_names"]
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=rtol, atol=1e-9)
    np.testing.assert_array_equal(new["counts"], old["counts"])


def sym(rng, n, scale=0.1):
    a = rng.normal(size=(n, n)) * scale
    return a + a.T + np.eye(n)


KEYS = [f"F{i}@I{i}" for i in range(9)]


def pair(rng, keys=KEYS, counts=True, name="GRM"):
    """The same float64 GRM as a JAX Kernel and a port Kernel."""
    n = len(keys)
    k = sym(rng, n)
    c = np.floor(rng.uniform(50, 100, size=(n, n)))
    c = np.minimum(c, c.T)
    snps = [f"{name}snp{i}" for i in range(4)]
    j = jk.Kernel(name=name, type=jk.KernelType.GRM, individual_keys=list(keys),
                  matrix=jnp.asarray(k), counts=jnp.asarray(c) if counts else None,
                  snp_names=snps)
    t = tk.Kernel(name=name, type=tk.KernelType.GRM, individual_keys=list(keys),
                  matrix=torch.as_tensor(k), counts=torch.as_tensor(c) if counts else None,
                  snp_names=snps)
    return j, t


def assert_same_kernel(t, j, rtol=0.0):
    assert t.name == j.name and t.type.value == j.type.value
    assert t.individual_keys == j.individual_keys
    assert t.snp_names == j.snp_names
    np.testing.assert_allclose(t.dense().numpy(), np.asarray(j.dense()), rtol=rtol, atol=0)
    assert (t.counts is None) == (j.counts is None)
    if t.counts is not None:
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))


# ------------------------------------------------------ Kernel methods ---
def test_epistatic_matches_jax(rng):
    j, t = pair(rng)
    assert_same_kernel(t.epistatic(), j.epistatic())
    assert t.epistatic().counts is None


def test_epistatic_of_diagonalized_matches_jax(rng):
    j, t = pair(rng)
    ours = t.diagonalize().epistatic()
    theirs = j.diagonalize().epistatic()
    assert_same_kernel(ours, theirs, rtol=1e-10)


def test_interaction_matches_jax(rng):
    ja, ta = pair(rng)
    other = KEYS[3:] + ["F99@I99"]
    jb, tb = pair(rng, keys=other, name="E")
    assert_same_kernel(ta.interaction(tb), ja.interaction(jb))
    assert_same_kernel(ta.interaction(tb, name="named"), ja.interaction(jb, name="named"))


def test_slice_asymmetric_matches_jax(rng):
    j, t = pair(rng)
    rows, cols = [KEYS[5], KEYS[0]], [KEYS[8], KEYS[2], KEYS[5]]
    np.testing.assert_array_equal(t.slice_asymmetric(rows, cols).numpy(),
                                  j.slice_asymmetric(rows, cols))


@pytest.mark.parametrize("low,high", [(-0.2, 0.2), (-1.0, 0.1), (-0.1, 0.3)])
def test_keep_with_relatedness_outside_matches_jax(rng, low, high):
    j, t = pair(rng)
    assert_same_kernel(t.keep_with_relatedness_outside(low, high),
                       j.keep_with_relatedness_outside(low, high))


@pytest.mark.parametrize("subtract", [False, True])
def test_add_matches_jax(rng, subtract):
    ja, ta = pair(rng, name="A")
    jb, tb = pair(rng, name="B")
    assert_same_kernel(ta.add(tb, subtract=subtract), ja.add(jb, subtract=subtract), rtol=1e-12)


def test_add_refuses_what_jax_refuses(rng):
    ja, ta = pair(rng)
    _, tb = pair(rng, keys=KEYS[::-1])
    _, tc = pair(rng, counts=False)
    with pytest.raises(ValueError, match="identical individual"):
        ta.add(tb)
    with pytest.raises(ValueError, match="counts"):
        ta.add(tc)


# --------------------------------------------------------- constructors ---
def test_kernel_from_discrete_matches_jax():
    cats = ["a", "b", "a", "c", "b", "a"]
    keys = KEYS[:6]
    assert_same_kernel(tk.kernel_from_discrete("D", keys, cats, device="cpu"),
                       jk.kernel_from_discrete("D", keys, cats))


def test_kernel_from_multi_discrete_matches_jax():
    sets = [["a", "b"], ["b"], [], ["c", "a", "a"], ["d"]]
    keys = KEYS[:5]
    assert_same_kernel(tk.kernel_from_multi_discrete("MD", keys, sets, device="cpu"),
                       jk.kernel_from_multi_discrete("MD", keys, sets))


@pytest.mark.parametrize("length_scale", [None, 1.5])
def test_kernel_squared_exponential_matches_jax(rng, length_scale):
    coords = rng.normal(size=(7, 2))
    ours = tk.kernel_squared_exponential("SE", KEYS[:7], coords, length_scale, device="cpu")
    theirs = jk.kernel_squared_exponential("SE", KEYS[:7], coords, length_scale)
    assert_same_kernel(ours, theirs, rtol=1e-12)


def test_couples_kernel_matches_jax(rng):
    j, t = pair(rng)
    couples = {KEYS[i]: KEYS[i + 1] for i in range(0, 8, 2)}
    couples["F99@I99"] = KEYS[0]
    assert_same_kernel(tk.couples_kernel(t, couples), jk.couples_kernel(j, couples))
    few = {KEYS[0]: KEYS[1]}
    assert tk.couples_kernel(t, few) is None and jk.couples_kernel(j, few) is None


# ------------------------------------------------------------ file I/O ---
def test_gcta_grm_gz_round_trips_with_jax(tmp_path, rng):
    k = sym(rng, 6)
    c = np.full((6, 6), 37.0)
    keys = KEYS[:6]
    jax_grm_io.write_gcta_grm_gz(str(tmp_path / "j"), k, c, keys)
    grm_io.write_gcta_grm_gz(str(tmp_path / "t"), k, c, keys)
    for ext in (".grm.id", ".grm.gz"):
        opener = gzip.open if ext.endswith("gz") else open
        with opener(tmp_path / f"j{ext}", "rb") as a, opener(tmp_path / f"t{ext}", "rb") as b:
            assert a.read() == b.read()
    ours = grm_io.read_gcta_grm_gz(str(tmp_path / "j"))
    theirs = jax_grm_io.read_gcta_grm_gz(str(tmp_path / "j"))
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(np.asarray(ours[key]), np.asarray(theirs[key]))


def test_labeled_matrix_matches_jax(tmp_path, rng):
    values = rng.normal(size=(3, 4))
    rows, cols = ["r1", "r2", "r3"], ["c1", "c2", "c3", "c4"]
    JaxLabeledMatrix(rows, cols, values).save(str(tmp_path / "j"))
    LabeledMatrix(rows, cols, values).save(str(tmp_path / "t"))
    for ext in (".rowids", ".colids", ".dat"):
        assert (tmp_path / f"t{ext}").read_bytes() == (tmp_path / f"j{ext}").read_bytes()
    ours = LabeledMatrix.load(str(tmp_path / "j")).filter(["r3", "r1"], ["c4", "c2"])
    theirs = JaxLabeledMatrix.load(str(tmp_path / "j")).filter(["r3", "r1"], ["c4", "c2"])
    assert (ours.row_labels, ours.col_labels) == (theirs.row_labels, theirs.col_labels)
    np.testing.assert_array_equal(ours.values, theirs.values)
    np.testing.assert_array_equal(ours.center_columns().append_rows(ours).values,
                                  theirs.center_columns().append_rows(theirs).values)
    (tmp_path / "raw.txt").write_text("FID IID a b\nF1 I1 1 2\nF2 I2 3 4.5\n")
    raw_t, raw_j = LabeledMatrix.load_raw(str(tmp_path / "raw.txt"), 2), \
        JaxLabeledMatrix.load_raw(str(tmp_path / "raw.txt"), 2)
    assert raw_t.row_labels == raw_j.row_labels == ["F1@I1", "F2@I2"]
    np.testing.assert_array_equal(raw_t.values, raw_j.values)


# ------------------------------------------------------------------ CLI ---
def test_make_grm_from_gcta_gz_matches_jax_cli(tmp_path, monkeypatch):
    golden = jax_grm_io.read_grm(str(GOLDEN / "golden"))
    jax_grm_io.write_gcta_grm_gz(str(tmp_path / "gcta"), golden["kernel"], golden["counts"],
                                 golden["individual_keys"])
    jd, td = both_clis(tmp_path, monkeypatch, lambda d: [
        "--make-grm", "--gcta-grms-gz", str(tmp_path / "gcta"), "--mesh", "none",
        "--out", f"{d}/g"])
    assert_same_grm(td / "g", jd / "g")
    np.testing.assert_allclose(grm_io.read_grm(f"{td}/g")["kernel"], golden["kernel"],
                               rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("name", ["e.gwas.snps", "e.gwas.mean", "e.gwas.unfitted"])
def test_gwas_with_grm_epi_matches_jax_cli(tmp_path, monkeypatch, name):
    """--gwas --grm g --grm-epi: the mixed model on K .* K."""
    jd, td = both_clis(tmp_path, monkeypatch, lambda d: [
        "--gwas", "--grm", str(GOLDEN / "golden"), "--grm-epi"] + BFILE + PHENO
        + ["--out", f"{d}/e"])
    assert (td / name).exists() == (jd / name).exists()
    if (jd / name).exists():
        _diff_files(td / name, jd / name, rtol=2e-5)


def test_make_grm_with_grm_epi_names_the_missing_counts(tmp_path, monkeypatch):
    """A deliberate departure: the JAX CLI crashes writing the epistatic
    kernel's absent counts (IndexError, dissect_tpu/analysis/dispatcher.py:
    402-403); the port raises a ValueError that names them."""
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")
    argv = ["--make-grm", "--grm-epi", "--bgen", str(GOLDEN / "cohort.bgen"), "--mesh", "none"]
    try:
        with pytest.raises(IndexError):
            jax_main(argv + ["--out", str(tmp_path / "j")])
    finally:
        set_mesh_context(None)
    with pytest.raises(ValueError, match="no SNP counts"):
        main(argv + ["--out", str(tmp_path / "t")])
    assert not (tmp_path / "t.grm.dat").exists()


def test_make_grm_mr_matches_jax_cli(tmp_path, monkeypatch):
    jd, td = both_clis(tmp_path, monkeypatch, lambda d: [
        "--make-grm-mr"] + BFILE + ["--mostr-lower-thr", "-0.05", "--mostr-upper-thr", "0.05",
                                    "--cutoff-thrs", "0.9", "0.1", "--out", f"{d}/mr"])
    assert_same_grm(td / "mr", jd / "mr")
    assert_same_grm(td / "mr.mostRelated", jd / "mr.mostRelated")
    pick = lambda d: [ln.strip().replace(str(d), "OUT")
                      for ln in (d / "mr.log").read_text().splitlines()
                      if "when cutoff is" in ln or "most-related subset" in ln]
    assert pick(td) == pick(jd) and len(pick(td)) == 3


def test_add_grms_matches_jax_cli(tmp_path, monkeypatch, rng):
    n = 20
    for i, m in enumerate((30, 40)):
        _, data = make_plink(tmp_path, make_dosage(rng, m, n, missing_rate=0.05), prefix=f"p{i}")
        for s in data.snps:
            s.name = f"set{i}_{s.name}"
        k = jk.grm_from_plink(data, dtype=jnp.float64)
        jax_grm_io.write_grm(str(tmp_path / f"g{i}"), np.asarray(k.matrix), np.asarray(k.counts),
                             k.individual_keys, k.snp_names)
    (tmp_path / "list.txt").write_text(f"{tmp_path / 'g0'}\n{tmp_path / 'g1'}\n")
    jd, td = both_clis(tmp_path, monkeypatch, lambda d: [
        "--add-grms", "--grm-list", str(tmp_path / "list.txt"), "--out", f"{d}/sum"])
    assert_same_grm(td / "sum", jd / "sum", rtol=1e-10)
    assert len(grm_io.read_grm(f"{td}/sum")["snp_names"]) == 70


def test_filter_matrix_matches_jax_cli(tmp_path, monkeypatch, rng):
    JaxLabeledMatrix(["r1", "r2", "r3"], ["c1", "c2"], rng.normal(size=(3, 2))).save(
        str(tmp_path / "in"))
    (tmp_path / "rows.txt").write_text("r3\nr1\n")
    (tmp_path / "cols.txt").write_text("c2\n")
    jd, td = both_clis(tmp_path, monkeypatch, lambda d: [
        "--filter-matrix", "--imatrix", str(tmp_path / "in"),
        "--row-labels", str(tmp_path / "rows.txt"), "--col-labels", str(tmp_path / "cols.txt"),
        "--out", f"{d}/out"])
    for ext in (".rowids", ".colids", ".dat"):
        assert (td / f"out{ext}").read_bytes() == (jd / f"out{ext}").read_bytes()
