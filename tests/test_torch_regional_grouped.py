"""The port's regional REML and grouped/recursive GWAS held against the
JAX package on the CPU, in float64 on both sides: SNP groupings exactly,
joint OLS fits to rtol 1e-9, ML group refits, fitted variances and LRTs
to rtol 1e-6, and the CLI's files against the golden files and the JAX
CLI at rtol 2e-5.

One deliberate departure is stated here: the JAX package forms the whole
M x N float64 centred genotype matrix on the host and copies it per
bucket; the port uploads the raw dosages once (`CenteredRows`), centres
and rotates batches of groups on the device, and splits a bucket into
batches of groups.  The same numbers come out, whatever the batch size."""

import pathlib
from collections import OrderedDict

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import _centered_genotypes as jax_centered
from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.gwas import grouped as jax_grouped
from dissect_tpu.io import groups as jax_groups
from dissect_tpu.io.bed import IndividualInfo as JaxIndividualInfo
from dissect_tpu.io.bed import PlinkData as JaxPlinkData
from dissect_tpu.io.bed import SnpInfo as JaxSnpInfo
from dissect_tpu.io.phenotype import Phenotype as JaxPhenotype
from dissect_tpu.linalg.qr import dependent_columns as jax_dependent_columns
from dissect_tpu.reml import regional as jax_regional
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.gwas import grouped
from dissect_tpu_torch.io import groups
from dissect_tpu_torch.io.bed import IndividualInfo, PlinkData, SnpInfo, write_plink
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.linalg.qr import dependent_columns, dependent_columns_batched
from dissect_tpu_torch.reml import regional
from tests.conftest import make_dosage
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"


def _data(dosage, chrom=lambda i: "1", pos=lambda i: 1000 * i):
    """The same fileset as the port's and the JAX package's PlinkData."""
    m, n = dosage.shape
    out = []
    for snp_cls, ind_cls, data_cls, where in (
            (SnpInfo, IndividualInfo, PlinkData, {"device": "cpu"}),
            (JaxSnpInfo, JaxIndividualInfo, JaxPlinkData, {})):
        out.append(data_cls(
            snps=[snp_cls(chrom(i), f"snp{i}", 0.0, pos(i), "A", "C") for i in range(m)],
            individuals=[ind_cls(f"F{i}", f"I{i}") for i in range(n)],
            _dosage=dosage.copy(),
            **where,
        ))
    return out


# --------------------------------------------------------------- groups --
def test_groupings_are_the_jax_groupings(tmp_path):
    dosage = np.zeros((30, 2), np.int8)
    ours, theirs = _data(dosage, chrom=lambda i: "1" if i < 17 else "2", pos=lambda i: 150 * i)
    (tmp_path / "g.txt").write_text("".join(f"snp{i} G{i % 4}\n" for i in range(0, 30, 2)))
    (tmp_path / "genes.txt").write_text("A 1 0 900\nB 1 600 2000\nC 2 2500 4000\n")
    cases = [
        ("by_all", ()), ("by_ordered_fixed_size", (4,)), ("by_file_ordered_windows", (7,)),
        ("by_position", (1000, 400)), ("by_position", (700,)),
        ("by_group_file", (str(tmp_path / "g.txt"),)),
        ("by_gene_file", (str(tmp_path / "genes.txt"),)),
    ]
    for name, args in cases:
        got = getattr(groups, name)(ours, *args)
        assert isinstance(got, OrderedDict) and got, name
        assert list(got.items()) == list(getattr(jax_groups, name)(theirs, *args).items()), name
    with pytest.raises(ValueError):
        groups.by_position(ours, 100, 100)


# ------------------------------------------------------------------- qr --
def test_dependent_columns_match_jax():
    rng = np.random.default_rng(1)
    a = rng.normal(size=(40, 6))
    a[:, 4] = a[:, 0] - 2.0 * a[:, 2]
    b = rng.normal(size=(40, 6))
    for m in (a, b, np.zeros((40, 3))):
        np.testing.assert_array_equal(dependent_columns(m), jax_dependent_columns(jnp.asarray(m)))
    batched = dependent_columns_batched(torch.as_tensor(np.stack([a, b])))
    np.testing.assert_array_equal(batched[0], [4])
    assert batched[1].size == 0


# -------------------------------------------------------------- grouped --
@pytest.fixture(scope="module")
def problem():
    """n = 100 x 26 SNPs with 2% missing calls; SNP 25 is SNP 0 with its
    alleles swapped (a dependent column once centred); signal on the
    first four SNPs; a covariance from a kernel's eigenpairs with
    warm-start variances."""
    rng = np.random.default_rng(12345)
    n, m = 100, 26
    dosage = make_dosage(rng, m, n, missing_rate=0.02)
    dosage[25] = np.where(dosage[0] >= 0, 2 - dosage[0], -1)
    ours, theirs = _data(dosage)
    z = jax_centered(theirs)
    names = theirs.snp_names
    x = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = z[:4].sum(0) * 0.8 + 0.3 * x[:, 1] + rng.normal(size=n)
    kz = rng.normal(size=(300, n))
    lam, u = np.linalg.eigh(kz.T @ kz / 300)
    grouping = OrderedDict([("a", names[:8]), ("b", names[8:16]), ("c", names[16:22]),
                            ("d", names[22:24] + names[0:2] + names[25:26]), ("e", names[24:25])])
    return dict(ours=ours, theirs=theirs, z=z, names=names, y=y, x=x,
                covariance=(lam, u, (0.6, 0.9)), grouping=grouping, dosage=dosage)


def _rows(p):
    """The port's route: raw int8 rows and SNP means, centred per batch."""
    return grouped.CenteredRows(torch.as_tensor(p["dosage"]),
                                torch.as_tensor(p["ours"].stats().mean))


def test_centered_rows_are_the_jax_centred_genotypes(problem):
    rows = _rows(problem)
    idx = torch.as_tensor([[3, 0, 25], [7, 7, 1]])
    got = rows(idx).numpy()
    np.testing.assert_array_equal(got, problem["z"][idx.numpy()])


def _assert_groups(ours, theirs, rtol):
    assert list(ours) == list(theirs)  # bucket order, as the JAX package writes it
    for g in theirs:
        a, b = ours[g], theirs[g]
        assert a.snp_names == b.snp_names and a.dropped_snps == b.dropped_snps, g
        assert a.success == b.success, g
        for field in ("beta", "se", "p"):
            np.testing.assert_allclose(getattr(a, field), getattr(b, field), rtol=rtol,
                                       atol=1e-300, err_msg=f"{g} {field}")
        np.testing.assert_allclose([a.f_statistic, a.f_p_value, a.group_variance],
                                   [b.f_statistic, b.f_p_value, b.group_variance],
                                   rtol=rtol, err_msg=g)


@pytest.mark.parametrize("mixed", [False, True])
def test_grouped_gwas_matches_jax(problem, mixed):
    """OLS with the F-test, or ML group refits in the covariance
    eigenbasis with the chi2 LRT; the dependent SNP is dropped in its
    group; group effects as in JAX."""
    p = problem
    cov = p["covariance"] if mixed else None
    ours, eff = grouped.grouped_gwas(_rows(p), p["names"], p["grouping"], p["y"], p["x"],
                                     covariance=cov, compute_effects=True)
    theirs, jeff = jax_grouped.grouped_gwas(p["z"], p["names"], p["grouping"], p["y"], p["x"],
                                            covariance=cov, compute_effects=True)
    _assert_groups(ours, theirs, rtol=1e-6 if mixed else 1e-9)
    assert ours["d"].dropped_snps == ["snp25"]
    assert eff.row_labels == jeff.row_labels and eff.col_labels == jeff.col_labels
    np.testing.assert_allclose(eff.values, jeff.values, rtol=1e-6, atol=1e-10)


@pytest.mark.parametrize("mixed", [False, True])
def test_grouped_gwas_does_not_depend_on_the_batch(problem, mixed):
    """The memory departure: one group at a time, two at a time, and the
    default batch give the same answers; so does the JAX package's
    host float64 matrix handed to the port."""
    p = problem
    cov = p["covariance"] if mixed else None
    runs = [grouped.grouped_gwas(src, p["names"], p["grouping"], p["y"], p["x"],
                                 covariance=cov, group_batch=b)[0]
            for src, b in ((_rows(p), 1), (_rows(p), 2), (p["z"], None))]
    for other in runs[1:]:
        _assert_groups(other, runs[0], rtol=1e-12)


def test_flag_correlated_snps_matches_jax(problem):
    rng = np.random.default_rng(3)
    z = problem["z"][:5].copy()
    z[1] = z[0] * 0.999 + rng.normal(size=z.shape[1]) * 1e-4
    names = [f"s{i}" for i in range(5)]
    pv = np.array([1e-8, 1e-4, 0.5, 0.5, 0.5])
    assert grouped.flag_correlated_snps(z, names, pv) == \
        jax_grouped.flag_correlated_snps(z, names, pv) == ["s1"]
    assert grouped.flag_correlated_snps(z, names, pv, 0.05) == \
        jax_grouped.flag_correlated_snps(z, names, pv, 0.05)


def test_flag_correlated_in_groups_is_the_per_group_flag(problem):
    """The batched flags over every group equal the JAX dispatcher's
    per-group loop (dissect_tpu/analysis/dispatcher.py:1025-1034)."""
    p = problem
    results, _ = grouped.grouped_gwas(_rows(p), p["names"], p["grouping"], p["y"], p["x"])
    idx = {nm: i for i, nm in enumerate(p["names"])}
    for threshold in (0.99, 0.1, 0.05):
        want = set()
        for res in results.values():
            c = len(res.beta) - len(res.snp_names)
            want.update(jax_grouped.flag_correlated_snps(
                p["z"][[idx[s] for s in res.snp_names]], res.snp_names, res.p[c:], threshold))
        got = grouped.flag_correlated_in_groups(_rows(p), p["names"], results, threshold,
                                                group_batch=2)
        assert got == want


@pytest.mark.parametrize("kw", [
    dict(group_size=5, significance_threshold=1e-3),
    dict(group_size=4, significance_threshold=1e-2, iteration_thresholds=[0.3, 0.1],
         max_fit_ratio=0.05),
    dict(group_size=6, significance_threshold=1e-3, mixed=True),
])
def test_recursive_gwas_matches_jax(problem, kw):
    p = problem
    kw = dict(kw)
    cov = p["covariance"] if kw.pop("mixed", False) else None
    names = p["names"][:25]  # without the dependent SNP
    z = p["z"][:25]
    ours, res = grouped.recursive_gwas(_rows(p), names, p["y"], p["x"], covariance=cov, **kw)
    theirs, ref = jax_grouped.recursive_gwas(z, names, p["y"], p["x"], covariance=cov, **kw)
    assert ours == theirs and ours
    _assert_groups(res, ref, rtol=1e-6)


def _uneven_grouping(names):
    """Buckets of 5, 3, 2 and 1 groups by kept size (the size-5 group
    holds the dependent pair snp0/snp25, so it keeps 4 SNPs): every
    bucket splits unevenly over 2 and 3 ranks, some shares empty."""
    sizes = [1] * 5 + [2] * 3 + [3] * 2
    grouping, at = OrderedDict(), 1
    for i, size in enumerate(sizes):
        grouping[f"u{i}"] = names[at:at + size]
        at += size
    grouping["dep"] = [names[0], names[20], names[21], names[22], names[25]]
    return grouping


def _grouped_on_ranks(ctx, dosage, mean, names, grouping, y, x, covariance, rgwas_kw):
    """grouped_gwas (OLS and mixed, with effects), the correlated flags
    and recursive_gwas on this rank with `ctx`; the groups whose result
    this rank built (GroupResult made here, not received) and each
    recursive pass's grouping."""
    rows = grouped.CenteredRows(torch.as_tensor(dosage), torch.as_tensor(mean))
    made, passes = [], []
    real_init, real_grouped = grouped.GroupResult.__init__, grouped.grouped_gwas

    def init_spy(self, **kw):
        made[-1].append(kw["group"])
        real_init(self, **kw)

    def grouped_spy(*args, **kw):
        passes.append([list(v) for v in args[2].values()])
        return real_grouped(*args, **kw)

    grouped.GroupResult.__init__ = init_spy
    out = {}
    try:
        for name, cov in (("ols", None), ("mixed", covariance)):
            made.append([])
            out[name] = grouped.grouped_gwas(rows, names, grouping, y, x, covariance=cov,
                                             compute_effects=True, mesh_ctx=ctx)
        made.append([])
        out["flagged"] = grouped.flag_correlated_in_groups(rows, names, out["ols"][0], 0.1,
                                                           mesh_ctx=ctx)
        grouped.grouped_gwas = grouped_spy
        out["rgwas"] = grouped.recursive_gwas(rows, names[:25], y, x, mesh_ctx=ctx, **rgwas_kw)
    finally:
        grouped.GroupResult.__init__, grouped.grouped_gwas = real_init, real_grouped
    return out, made[:2], passes


@pytest.mark.parametrize("world", [2, 3])
def test_grouped_gwas_sharded_over_ranks(problem, tmp_path, world):
    """--parallel-gwas's grouped and recursive fits: each rank fits only
    its contiguous share of every size bucket (the buckets of 5, 3, 2
    and 1 groups split unevenly), and every rank returns the single-rank
    results in their order, the same effects and correlated flags at
    rtol 1e-12; recursive_gwas takes the same pass groupings and
    significant SNPs on every rank as on one."""
    from dissect_tpu_torch.runtime.mesh import MeshContext
    from tests.test_torch_mesh_runtime import run_ranks

    p = problem
    grouping = _uneven_grouping(p["names"])
    rgwas_kw = dict(group_size=4, significance_threshold=1e-2, iteration_thresholds=[0.3, 0.1])
    mean = p["ours"].stats().mean
    args = (p["dosage"], mean, p["names"], grouping, p["y"], p["x"], p["covariance"], rgwas_kw)
    single, _, single_passes = _grouped_on_ranks(None, *args)
    outs = run_ranks(_grouped_on_ranks, world, tmp_path, *args)
    for rank, (out, made, passes) in enumerate(outs):
        for name in ("ols", "mixed"):
            results, effects = out[name]
            want, want_effects = single[name]
            _assert_groups(results, want, rtol=1e-12)
            assert effects.col_labels == want_effects.col_labels == list(grouping)
            np.testing.assert_allclose(effects.values, want_effects.values, rtol=1e-12,
                                       atol=1e-300)
            buckets = OrderedDict()
            for g, res in want.items():
                buckets.setdefault(len(res.snp_names), []).append(g)
            assert sorted(len(v) for v in buckets.values()) == [1, 2, 3, 5]
            ctx = MeshContext(rank=rank, world=world)
            share = [g for gs in buckets.values() for g in gs[slice(*ctx.local_rows(len(gs)))]]
            assert made[["ols", "mixed"].index(name)] == share
        assert out["flagged"] == single["flagged"]
        assert out["rgwas"][0] == single["rgwas"][0] and out["rgwas"][0]
        _assert_groups(out["rgwas"][1], single["rgwas"][1], rtol=1e-12)
        assert passes == single_passes and len(passes) >= 2


# ------------------------------------------------------------- regional --
@pytest.fixture(scope="module")
def regional_problem():
    """n = 150 x 90 SNPs, signal concentrated in the first 30 SNPs."""
    rng = np.random.default_rng(20261016)
    n, m = 150, 90
    dosage = make_dosage(rng, m, n)
    ours, theirs = _data(dosage)
    z = jax_centered(theirs) / theirs.stats().std[:, None]
    y = z[:30].T @ rng.normal(size=30) * np.sqrt(0.6 / 30) + rng.normal(size=n) * 0.6
    y2 = z[:30].T @ rng.normal(size=30) * np.sqrt(0.4 / 30) + rng.normal(size=n) * 0.7
    keys = theirs.individual_keys
    grouping = groups.by_ordered_fixed_size(ours, 30)
    return dict(ours=ours, theirs=theirs, keys=keys, y=y, y2=y2, grouping=grouping)


def _assert_fit(a, b):
    assert a.result.success and b.result.success
    assert a.result.variance_names == b.result.variance_names
    np.testing.assert_allclose(a.result.variances, b.result.variances, rtol=1e-6)
    assert a.result.log_likelihood == pytest.approx(b.result.log_likelihood, rel=1e-9)


def _assert_lrts(a, b):
    assert [r["removed"] for r in a] == [r["removed"] for r in b]
    for ra, rb in zip(a, b):
        assert ra["df"] == rb["df"] and ra["converged"] == rb["converged"]
        np.testing.assert_allclose([ra["log_likelihood"], ra["lrt"], ra["p_value"]],
                                   [rb["log_likelihood"], rb["lrt"], rb["p_value"]],
                                   rtol=1e-6, atol=1e-9)


def test_compute_regional_matches_jax(regional_problem):
    r = regional_problem
    ours = regional.compute_regional(r["ours"], r["grouping"],
                                     Phenotype(r["keys"], r["y"], 1), device="cpu")
    theirs = jax_regional.compute_regional(r["theirs"], r["grouping"],
                                           JaxPhenotype(r["keys"], r["y"], 1))
    assert list(ours) == list(theirs) == list(r["grouping"])
    for g in theirs:
        assert ours[g]["n_snps"] == theirs[g]["n_snps"]
        assert ours[g]["proportion"] == theirs[g]["proportion"]
        _assert_fit(ours[g]["full"], theirs[g]["full"])
        _assert_lrts(ours[g]["lrts"], theirs[g]["lrts"])
    # the causal region's Regional-GRM is the one that matters
    first = next(iter(ours))
    assert ours[first]["lrts"][0]["p_value"] < 0.01


def test_compute_regional_multi_matches_jax(regional_problem):
    r = regional_problem
    grouping = OrderedDict(list(r["grouping"].items())[:2])
    mk = lambda cls: [cls(r["keys"], r["y"], 1), cls(r["keys"][20:], r["y2"][20:], 2)]
    ours = regional.compute_regional_multi(r["ours"], grouping, mk(Phenotype), device="cpu")
    theirs = jax_regional.compute_regional_multi(r["theirs"], grouping, mk(JaxPhenotype))
    for g in theirs:
        _assert_fit(ours[g]["full"], theirs[g]["full"])
        assert ours[g]["proportion"] == theirs[g]["proportion"]


def test_compute_multiple_groups_matches_jax(regional_problem):
    r = regional_problem
    full, lrts = regional.compute_multiple_groups(
        r["ours"], r["grouping"], Phenotype(r["keys"], r["y"], 1), device="cpu")
    ref, ref_lrts = jax_regional.compute_multiple_groups(
        r["theirs"], r["grouping"], JaxPhenotype(r["keys"], r["y"], 1))
    _assert_fit(full, ref)
    _assert_lrts(lrts, ref_lrts)


# ------------------------------------------------------------------ CLI --
@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")


GOLDEN_RUNS = {
    "golden.reg": ["--reml", "--groups", str(GOLDEN / "groups.txt")],
    "golden.grp": ["--gwas", "--groups", str(GOLDEN / "groups.txt")],
}


@pytest.mark.parametrize("name", ["golden.reg.regional", "golden.reg.lrt",
                                  "golden.grp.multi.gwas.snps"])
def test_golden_regional_and_grouped(tmp_path, cpu, name):
    prefix = name.rsplit(".", 1)[0] if name.startswith("golden.reg") else "golden.grp"
    main(GOLDEN_RUNS[prefix] + ["--bfile", str(GOLDEN / "cohort"), "--pheno",
                                str(GOLDEN / "pheno.txt"), "--mesh", "none",
                                "--out", str(tmp_path / prefix)])
    _diff_files(tmp_path / name, GOLDEN / name, rtol=2e-5)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """n = 120 x 60 SNPs: SNP 1 a near copy of SNP 0, both causal; SNP 54
    SNP 50 with its alleles swapped (dependent in its group); a
    quantitative covariate; groups of 5 and a GRM."""
    tmp = tmp_path_factory.mktemp("grouped_cli")
    rng = np.random.default_rng(77)
    n, m = 120, 60
    dosage = make_dosage(rng, m, n)
    dosage[1] = dosage[0]
    flip = rng.choice(n, size=8, replace=False)
    dosage[1, flip] = rng.integers(0, 3, size=8).astype(np.int8)
    dosage[54] = 2 - dosage[50]
    data, _ = _data(dosage, chrom=lambda i: "1" if i < 40 else "2")
    bfile = str(tmp / "coh")
    write_plink(bfile, data)
    z = (dosage - dosage.mean(1, keepdims=True)).astype(np.float64)
    q = rng.normal(size=n)
    y = 1.5 * z[0] + 1.5 * z[1] + 0.8 * z[20] + 0.4 * q + 0.3 * rng.normal(size=n)
    ids = [(i.family_id, i.individual_id) for i in data.individuals]
    for name, col in (("p.txt", y), ("q.txt", q)):
        with open(tmp / name, "w") as fh:
            for (fid, iid), v in zip(ids, col):
                fh.write(f"{fid} {iid} {v:.8g}\n")
    (tmp / "groups.txt").write_text("".join(f"snp{i} G{i // 5}\n" for i in range(m)))
    jax_main(["--make-grm", "--bfile", bfile, "--mesh", "none", "--out", str(tmp / "g")])
    set_mesh_context(None)
    return tmp, bfile


CASES = {
    "groups_ols": ["--gwas", "--groups", "{groups}", "--qcovar", "{q}", "--group-var",
                   "--group-effects", "--significance-threshold", "1e-3"],
    "groups_grm": ["--gwas", "--grm", "{g}", "--groups", "{groups}", "--group-var"],
    "group_all_correlated": ["--gwas", "--group-all", "--significance-threshold", "0.05",
                             "--snp-corr-threshold", "0.75"],
    "rgwas": ["--rgwas", "--rgwas-group-size", "7", "--significance-threshold", "1e-3",
              "--rgwas-thresholds", "0.2", "0.05", "--qcovar", "{q}"],
    "rgwas_grm": ["--rgwas", "--grm", "{g}", "--rgwas-group-size", "10",
                  "--significance-threshold", "1e-3", "--rgwas-ratio", "0.05"],
    "regional_region_size": ["--reml", "--region-size", "20", "--region-overlap", "5",
                             "--min-snps-region", "12"],
}


def _same_outputs(tmp_path, argv):
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
        if name.startswith("r.effects"):
            continue
        _diff_files(outs["torch"][name], path, rtol=2e-5)
    if "r.effects.dat" in outs["jax"]:
        ours, theirs = (LabeledMatrix.load(str(tmp_path / s / "r.effects")) for s in ("torch", "jax"))
        assert ours.row_labels == theirs.row_labels and ours.col_labels == theirs.col_labels
        np.testing.assert_allclose(ours.values, theirs.values, rtol=1e-6, atol=1e-10)
    return outs["torch"]


@pytest.mark.parametrize("case", list(CASES))
def test_grouped_cli_matches_jax(cohort, tmp_path, cpu, case):
    tmp, bfile = cohort
    argv = [a.format(groups=tmp / "groups.txt", q=tmp / "q.txt", g=tmp / "g") for a in CASES[case]]
    written = _same_outputs(tmp_path, argv + ["--bfile", bfile, "--pheno", str(tmp / "p.txt"),
                                              "--mesh", "none"])
    expect = {
        "groups_ols": {"r.multi.gwas.snps", "r.multi.gwas.unfitted", "r.effects.dat"},
        "group_all_correlated": {"r.gwas.correlatedSNPs"},
        "rgwas": {"r.rgwas"},
        "regional_region_size": {"r.regional", "r.lrt"},
    }.get(case, set())
    assert expect <= set(written)
