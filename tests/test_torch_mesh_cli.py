"""The port's CLI under torchrun on the CPU: the cases of
tests/test_cli_distributed.py and tests/test_gwas_sharded.py, run by the
port at `--mesh 2` and `--mesh 4` (gloo ranks, DISSECT_TPU_TORCH_DEVICE=cpu)
against the port at `--mesh none` and the JAX CLI at `--mesh 8
--force-distributed` on the 8 virtual CPU devices.

One torchrun launch per world size runs every analysis of that world in
sequence (this module is its worker: `python -m tests.test_torch_mesh_cli
<plan.json>`), so the ranks start once.  Tolerances: float64 fits and
their outputs at rtol 1e-8 (text files at their printed 2e-5), GRMs at
rtol 1e-5 of their values and counts exactly, GWAS files by the golden
rule (rtol 2e-5), and the JAX mesh runs at the tolerances of JAX's own
mesh-vs-single tests (REML 5e-4, p-values 1e-3, eigenvalues 1e-6).
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
LAUNCH_TIMEOUT_S = 240
N, M = 72, 60


def _plan(c, world):
    """(name, argv) of every analysis run at `world` ranks."""
    mesh = ["--mesh", str(world)]
    dist = mesh + ["--force-distributed"]
    par = mesh + ["--parallel-gwas"]
    base = ["--bfile", c["bfile"], "--pheno", c["pheno"]]
    plan = [
        ("grm", ["--make-grm", "--bfile", c["bfile"]] + dist),
        ("reml67", ["--reml", "--grm", c["g67"], "--pheno", c["pheno"], "--blue",
                    "--indiv-blup", "--indiv-blup-error"] + dist),
        ("mlm", ["--gwas", "--grm", c["g"]] + base + par),
        ("igwas", ["--igwas", "--bfile", c["bfile"], "--grm", c["g"]] + par),
        ("remlbfile", ["--reml", "--bfile", c["bfile"], "--pheno", c["pheno67"], "--weights",
                       c["weights"], "--blue", "--indiv-blup", "--indiv-blup-error"] + dist),
        ("rgwas", ["--rgwas", "--rgwas-group-size", "7", "--significance-threshold", "1e-3",
                   "--rgwas-thresholds", "0.2", "0.05"] + base + par),
    ]
    if world == 2:
        plan += [
            ("bivarbfile", ["--bivar-reml", "--bfile", c["bfile"], "--pheno", c["pheno2"]] + dist),
            ("reml", ["--reml", "--grm", c["g"], "--pheno", c["pheno"], "--blue",
                      "--indiv-blup"] + dist),
            ("block", ["--reml", "--grm", c["g"], "--pheno", c["pheno"],
                       "--default-block-size", "4"] + dist),
            ("bivar", ["--bivar-reml", "--grm", c["g"], "--pheno", c["pheno2"]] + dist),
            ("pca", ["--pca", "--grm", c["g"], "--num-eval", "10"] + dist),
            ("diag", ["--make-grm", "--diagonalize", "--bfile", c["bfile"]] + dist),
            ("null", ["--gwas", "--grm", c["g"]] + base + dist),
            ("ols", ["--gwas"] + base + par),
            ("grouped", ["--gwas", "--groups", c["groups"]] + base + par),
            ("grouped_effects", ["--gwas", "--groups", c["groups"], "--group-effects"]
             + base + par),
            ("rgwas_grm", ["--rgwas", "--grm", c["g"], "--rgwas-group-size", "10",
                           "--significance-threshold", "1e-2", "--rgwas-ratio", "0.05"]
             + base + par),
            ("mp", ["--mpresiduals", "--bfile", c["bfile"], "--pheno", c["pheno2"]] + mesh),
            ("mp", ["--mpgwas", "--bfile", c["bfile"]] + par),
        ]
    return plan


def _single(argv):
    """The same analysis at single-device semantics."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        if a == "--mesh":
            skip = True
            continue
        if a not in ("--force-distributed", "--parallel-gwas"):
            out.append(a)
    return out + ["--mesh", "none"]


# the fits on the GRM built row-sharded in line, held against a
# single-device fit of the same GRM (the launch's grm step, read back)
ON_MESH_GRM = ("remlbfile", "bivarbfile")


def _on_grm(argv, grm):
    """`argv` with its --bfile input replaced by the stored GRM `grm`."""
    i = argv.index("--bfile")
    return argv[:i] + ["--grm", grm] + argv[i + 2:]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The cohort (72 individuals, 60 SNPs, as tests/test_cli_distributed.py),
    its single-device GRMs, the torchrun launches at 2 and 4 ranks and
    the single-device port runs of every planned analysis."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from tests.conftest import make_dosage, make_plink

    tmp = tmp_path_factory.mktemp("mesh_cli")
    rng = np.random.default_rng(12345)
    d = make_dosage(rng, M, N)
    bfile, _ = make_plink(tmp, d, prefix="cohort")
    z = (d - d.mean(1, keepdims=True)) / (d.std(1, keepdims=True) + 1e-9)
    y = z[:12].sum(0) / np.sqrt(12) * 0.7 + rng.normal(size=N) * 0.7
    y2 = z[6:18].sum(0) / np.sqrt(12) * 0.6 + rng.normal(size=N) * 0.8
    (tmp / "pheno.txt").write_text("".join(f"F{i} I{i} {y[i]:.6f}\n" for i in range(N)))
    (tmp / "pheno2.txt").write_text(
        "".join(f"F{i} I{i} {y[i]:.6f} {y2[i]:.6f}\n" for i in range(N)))
    (tmp / "keep67.txt").write_text("".join(f"F{i} I{i}\n" for i in range(67)))
    (tmp / "pheno67.txt").write_text("".join(f"F{i} I{i} {y[i]:.6f}\n" for i in range(67)))
    w = rng.uniform(0.5, 1.5, size=N)
    (tmp / "weights.txt").write_text("".join(f"F{i} I{i} {w[i]:.6f}\n" for i in range(N)))
    (tmp / "groups.txt").write_text("".join(f"snp{i} g{i // 5}\n" for i in range(M)))
    c = dict(bfile=bfile, pheno=str(tmp / "pheno.txt"), pheno2=str(tmp / "pheno2.txt"),
             groups=str(tmp / "groups.txt"), g=str(tmp / "g"), g67=str(tmp / "g67"),
             pheno67=str(tmp / "pheno67.txt"), weights=str(tmp / "weights.txt"))
    saved = os.environ.get("DISSECT_TPU_TORCH_DEVICE")
    os.environ["DISSECT_TPU_TORCH_DEVICE"] = "cpu"
    try:
        main(["--make-grm", "--bfile", bfile, "--out", c["g"], "--mesh", "none"])
        main(["--make-grm", "--bfile", bfile, "--keep", str(tmp / "keep67.txt"),
              "--out", c["g67"], "--mesh", "none"])
        for world in (2, 4):
            plan = [(name, argv + ["--out", str(tmp / f"w{world}" / name)])
                    for name, argv in _plan(c, world)]
            (tmp / f"w{world}").mkdir()
            (tmp / "single").mkdir(exist_ok=True)
            path = tmp / f"plan{world}.json"
            path.write_text(json.dumps([argv for _, argv in plan]))
            env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(world), "-m", "tests.test_torch_mesh_cli", str(path)],
                cwd=str(REPO), env=env, capture_output=True, text=True,
                timeout=LAUNCH_TIMEOUT_S, stdin=subprocess.DEVNULL,
            )
            assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
            for name, argv in plan:
                if world != 2 and name not in ON_MESH_GRM:
                    continue
                single = _single(argv)
                if name in ON_MESH_GRM:
                    single = _on_grm(single, str(tmp / f"w{world}" / "grm"))
                    name = f"{name}{world}"
                single[single.index("--out") + 1] = str(tmp / "single" / name)
                main(single)
    finally:
        if saved is None:
            os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)
        else:
            os.environ["DISSECT_TPU_TORCH_DEVICE"] = saved
    return tmp, c


def _jax(c, tmp, name, argv):
    """The JAX CLI at --mesh 8 --force-distributed (the JAX mesh tests' DIST)."""
    from dissect_tpu.analysis.dispatcher import main as jax_main
    from dissect_tpu.runtime.mesh import set_mesh_context

    out = tmp / "jax" / name
    out.parent.mkdir(exist_ok=True)
    try:
        jax_main(_single(argv)[:-2] + ["--mesh", "8", "--force-distributed", "--out", str(out)])
    finally:
        set_mesh_context(None)
    return str(out)


def _reml_values(path):
    out = {}
    for line in open(path):
        parts = line.split()
        if len(parts) >= 3 and (parts[0].startswith("Var(") or parts[0].startswith("Covar(")
                                or "/" in parts[0] or parts[0] == "h2"):
            try:
                out[parts[0]] = (float(parts[1]), float(parts[2]))
            except ValueError:  # a label row
                continue
    return out


def _log(path):
    return open(path + ".log").read()


@pytest.mark.parametrize("world", [2, 4])
def test_grm_matches_single_device_and_jax_mesh(runs, world):
    from dissect_tpu_torch.io.grm_io import read_grm

    tmp, c = runs
    ours = read_grm(str(tmp / f"w{world}" / "grm"))
    assert f"Mesh: {world} ranks" in _log(str(tmp / f"w{world}" / "grm"))
    assert "GRM row-sharded" in _log(str(tmp / f"w{world}" / "grm"))
    single = read_grm(c["g"])
    np.testing.assert_allclose(ours["kernel"], single["kernel"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(ours["counts"], single["counts"])
    if world == 2:
        theirs = read_grm(_jax(c, tmp, "grm", _plan(c, 2)[0][1]))
        np.testing.assert_allclose(ours["kernel"], theirs["kernel"], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(ours["counts"], theirs["counts"])


@pytest.mark.parametrize("world", [2, 4])
def test_reml_pads_indivisible_n(runs, world):
    """N = 67 on 2 and 4 ranks (block 8 -> padded to 80 and 96): the
    fit, BLUE, BLUPs and BLUP errors equal the single-device fit."""
    from tests.test_golden import _diff_files

    tmp, c = runs
    ours, single = tmp / f"w{world}" / "reml67", tmp / "single" / "reml67"
    assert "Distributed REML: " + str(world) in _log(str(ours))
    a, b = _reml_values(f"{ours}.reml"), _reml_values(f"{single}.reml")
    assert a.keys() == b.keys() and "Var(GRM)" in a
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-8, err_msg=k)
    for suffix in (".GRM.blup.indiv", ".blue.mean"):
        _diff_files(pathlib.Path(f"{ours}{suffix}"), pathlib.Path(f"{single}{suffix}"), rtol=2e-5)
    if world == 2:
        theirs = _reml_values(_jax(c, tmp, "reml67", _plan(c, 2)[1][1]) + ".reml")
        np.testing.assert_allclose(a["Var(GRM)"], theirs["Var(GRM)"], rtol=5e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["reml", "block", "bivar"])
def test_reml_fits_match_single_device(runs, name):
    """Single-trait (auto block and --default-block-size 4) and the
    bivariate fit on 2 ranks."""
    tmp, _ = runs
    a = _reml_values(str(tmp / "w2" / name) + ".reml")
    b = _reml_values(str(tmp / "single" / name) + ".reml")
    assert a.keys() == b.keys() and len(a) >= 3
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-7, atol=1e-10, err_msg=k)
    if name == "block":
        assert "block 4" in _log(str(tmp / "w2" / name))


@pytest.mark.parametrize("name, world", [("remlbfile", 2), ("remlbfile", 4), ("bivarbfile", 2)])
def test_reml_on_the_row_sharded_grm_matches_single_device(runs, name, world):
    """--reml --bfile and --bivar-reml --bfile with the GRM built in line
    and kept row-sharded into the engine (67 of 72 individuals
    phenotyped, so the shards are refetched; --weights as a diagonal
    element): the fit, BLUEs, BLUPs and BLUP errors equal a
    single-device fit of the same GRM (the launch's grm step, read
    back), the fit at 1e-8."""
    from tests.test_golden import _diff_files

    tmp, _ = runs
    ours, single = tmp / f"w{world}" / name, tmp / "single" / f"{name}{world}"
    log = _log(str(ours))
    assert "GRM row-sharded" in log and "Distributed REML: " + str(world) in log
    assert "1 row-sharded kernel(s)" in log  # the GRM never went whole
    a, b = _reml_values(f"{ours}.reml"), _reml_values(f"{single}.reml")
    assert a.keys() == b.keys() and len(a) >= 3
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-8, atol=1e-12, err_msg=k)
    if name == "remlbfile":
        for suffix in (".GRM.blup.indiv", ".blue.mean"):
            _diff_files(pathlib.Path(f"{ours}{suffix}"), pathlib.Path(f"{single}{suffix}"),
                        rtol=2e-5)


def test_pca_full_solve_by_divide_and_conquer(runs):
    """--num-eval 10 of 72 takes the full solve: the D&C eigensolver on 2
    ranks, against the single-device eigh and JAX's D&C on its mesh."""
    tmp, c = runs
    ours = np.loadtxt(tmp / "w2" / "pca.pca.eigenvalues")
    np.testing.assert_allclose(ours, np.loadtxt(tmp / "single" / "pca.pca.eigenvalues"),
                               rtol=1e-6, atol=1e-8)
    theirs = np.loadtxt(_jax(c, tmp, "pca", dict(_plan(c, 2))["pca"]) + ".pca.eigenvalues")
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-8)


def test_diagonalized_grm_by_divide_and_conquer(runs):
    from dissect_tpu_torch.io.grm_io import read_grm

    tmp, _ = runs
    ours = read_grm(str(tmp / "w2" / "diag"))
    single = read_grm(str(tmp / "single" / "diag"))
    np.testing.assert_allclose(ours["eigenvalues"], single["eigenvalues"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(np.abs(ours["eigenvectors"].T @ single["eigenvectors"]),
                               np.eye(N), atol=1e-5)


@pytest.mark.parametrize("name, world", [
    ("null", 2), ("ols", 2), ("mlm", 2), ("mlm", 4), ("grouped", 2), ("mp", 2),
    ("igwas", 2), ("igwas", 4), ("rgwas", 2), ("rgwas", 4), ("rgwas_grm", 2),
    ("grouped_effects", 2),
])
def test_parallel_gwas_matches_single_device(runs, name, world):
    """--parallel-gwas for ols, mlm, grouped (with --group-effects), mp,
    igwas and rgwas (with and without --grm), and the null fit's
    distributed diagonalization: every output file equals the
    single-device run's by the golden rule, the group effects' matrix
    too."""
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
    from tests.test_golden import _diff_files

    tmp, _ = runs
    ours_dir, single_dir = tmp / f"w{world}", tmp / "single"
    names = sorted(p.name for p in ours_dir.iterdir()
                   if p.name.startswith(name + ".") and p.suffix != ".log")
    assert names == sorted(p.name for p in single_dir.iterdir()
                           if p.name.startswith(name + ".") and p.suffix != ".log")
    assert names
    for fname in names:
        if not fname.endswith(".dat"):
            _diff_files(ours_dir / fname, single_dir / fname, rtol=2e-5)
        elif fname.endswith(".effects.dat"):
            ours, single = (LabeledMatrix.load(str(d / fname[:-4])) for d in (ours_dir, single_dir))
            assert ours.row_labels == single.row_labels and ours.col_labels == single.col_labels
            np.testing.assert_allclose(ours.values, single.values, rtol=2e-5, atol=1e-12)
    if name == "grouped_effects":
        assert f"{name}.effects.dat" in names
    if name.startswith("rgwas"):
        assert len(open(ours_dir / f"{name}.rgwas").read().split()) > 1  # SNPs reported
    if name in ("ols", "mlm", "grouped", "mp", "igwas", "rgwas", "rgwas_grm", "grouped_effects"):
        log = _log(str(ours_dir / name))
        assert "sharded over" in log or name in ("mp", "igwas")


@pytest.mark.parametrize("name", ["rgwas", "rgwas_grm", "grouped_effects"])
def test_grouped_paths_match_the_jax_mesh(runs, name):
    """--rgwas (with and without --grm) and --group-effects under
    --parallel-gwas against the JAX CLI on its mesh: the same reported
    SNPs; the per-SNP and group p-values and the group effects at the
    tolerance of the mlm comparison (rtol 1e-3)."""
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix

    tmp, c = runs
    theirs = _jax(c, tmp, name, dict(_plan(c, 2))[name])
    ours = str(tmp / "w2" / name)
    if name.startswith("rgwas"):
        snps = [open(p + ".rgwas").read().split() for p in (ours, theirs)]
        assert snps[0] == snps[1] and len(snps[0]) > 1
        return
    cols = (8, 9)  # PV, GROUPPV
    p_ours = np.loadtxt(ours + ".multi.gwas.snps", skiprows=1, usecols=cols)
    p_theirs = np.loadtxt(theirs + ".multi.gwas.snps", skiprows=1, usecols=cols)
    np.testing.assert_allclose(p_ours, p_theirs, rtol=1e-3, atol=1e-8)
    e_ours, e_theirs = LabeledMatrix.load(ours + ".effects"), LabeledMatrix.load(theirs + ".effects")
    assert e_ours.col_labels == e_theirs.col_labels
    np.testing.assert_allclose(e_ours.values, e_theirs.values, rtol=1e-3, atol=1e-8)


def test_parallel_mlm_matches_the_jax_mesh(runs):
    tmp, c = runs
    theirs = _jax(c, tmp, "mlm", dict(_plan(c, 2))["mlm"])
    p_ours = np.loadtxt(tmp / "w2" / "mlm.gwas.snps", skiprows=1, usecols=(8,))
    p_theirs = np.loadtxt(theirs + ".gwas.snps", skiprows=1, usecols=(8,))
    np.testing.assert_allclose(p_ours, p_theirs, rtol=1e-3, atol=1e-8)


if __name__ == "__main__":
    # a torchrun worker: run every argv of the plan, in order
    from dissect_tpu_torch.analysis.dispatcher import main as _main

    for _argv in json.loads(pathlib.Path(sys.argv[1]).read_text()):
        _main(_argv)
