"""The port's multi-phenotype scan pass (`Analysis.mp_gwas_scan`) and the
SNP chunk rule it shares with every scan (`gwas_chunk_snps`), on the CPU.

The chunk follows N: GWAS_CHUNK_SNPS SNPs up to GWAS_CHUNK_INDIVIDUALS
individuals, fewer above, so that a chunk's (SNPs, N) float64
temporaries keep their size; an explicit `chunk=` wins.  Chunked scans
give the results of one chunk, and residuals moved to the device once
give the bits of the per-chunk upload they replace."""

import numpy as np
import pytest
import torch

from dissect_tpu_torch.analysis import dispatcher
from dissect_tpu_torch.analysis.dispatcher import (
    Analysis,
    _chunked_gwas,
    _map_snp_chunks,
    gwas_chunk_snps,
    main,
)
from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
from dissect_tpu_torch.gwas.mp import DeviceResiduals, MpGwasResults, mp_gwas
from dissect_tpu_torch.io.bed import IndividualInfo, PlinkData, SnpInfo, read_plink, write_plink
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.runtime.options import Options
from tests.conftest import make_dosage

CPU = torch.device("cpu")
FIELDS = ("beta", "se", "t", "p")


def cohort(tmp_path, n=70, m=45, p=3, seed=21):
    """A PLINK cohort with missing calls and a residual matrix over all
    but its first two individuals, saved where `--mpgwas --out r` reads."""
    rng = np.random.default_rng(seed)
    d = make_dosage(rng, m, n, missing_rate=0.03)
    data = PlinkData(
        snps=[SnpInfo(str(1 + i % 22), f"snp{i}", 0.0, 1000 + i, "A", "C") for i in range(m)],
        individuals=[IndividualInfo(f"F{i}", f"I{i}") for i in range(n)],
        _dosage=d, device="cpu")
    prefix = str(tmp_path / "cohort")
    write_plink(prefix, data)
    keys = data.individual_keys[2:]
    LabeledMatrix(keys, [f"pheno_{j + 1}" for j in range(p)],
                  rng.normal(size=(len(keys), p)) + 0.5).save(str(tmp_path / "r.residuals"))
    return prefix


def plink_data(prefix):
    """The cohort as read, and its SNP means."""
    data = read_plink(prefix, device="cpu")
    return data, data.stats().mean


# --- the chunk rule ----------------------------------------------------------
@pytest.mark.parametrize("n,snps", [
    (1, 65536), (1000, 65536), (20000, 65536), (20001, 65532), (40000, 32768),
    (452264, 2898), (10 ** 12, 1),
])
def test_the_chunk_follows_n(n, snps):
    assert gwas_chunk_snps(n) == snps


def test_a_chunks_float64_rows_keep_their_size_above_the_knee():
    whole = dispatcher.GWAS_CHUNK_SNPS * dispatcher.GWAS_CHUNK_INDIVIDUALS
    for n in (20001, 60000, 452264, 488377):
        assert whole - n < gwas_chunk_snps(n) * n <= whole


@pytest.mark.parametrize("chunk,sizes", [(None, [9] * 5), (7, [7] * 6 + [3]),
                                         (100, [45])])
def test_map_snp_chunks_takes_the_rule_unless_a_chunk_is_given(tmp_path, monkeypatch, chunk,
                                                                sizes):
    """At N = 70 the rule gives min(64, 640 // 70) = 9 SNPs here; an
    explicit chunk wins."""
    monkeypatch.setattr(dispatcher, "GWAS_CHUNK_SNPS", 64)
    monkeypatch.setattr(dispatcher, "GWAS_CHUNK_INDIVIDUALS", 10)
    data, mean = plink_data(cohort(tmp_path))
    seen = _map_snp_chunks(lambda z, names: (z.shape, list(names)), data, mean, CPU,
                           chunk=chunk)
    assert [s[0][0] for s in seen] == sizes
    assert all(s[0][1] == 70 for s in seen)
    assert sum((s[1] for s in seen), []) == data.snp_names


# --- chunked scans give one chunk's results -------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_mp_gwas_in_chunks_equals_one_chunk(tmp_path, dtype):
    prefix = cohort(tmp_path)
    data, mean = plink_data(prefix)
    lm = LabeledMatrix.load(str(tmp_path / "r.residuals"))
    data = data.filter(keep_individuals=lm.row_labels)
    mean = data.stats().mean
    residuals = DeviceResiduals.upload(lm.center_columns(), CPU, dtype)
    run = lambda z, names: mp_gwas(z.to(dtype), names, residuals)
    whole = MpGwasResults.concatenate(_map_snp_chunks(run, data, mean, CPU))
    parts = _map_snp_chunks(run, data, mean, CPU, chunk=8)
    assert len(parts) == 6
    chunked = MpGwasResults.concatenate(parts)
    assert chunked.snp_names == whole.snp_names == data.snp_names
    # float32 products of other shapes may sum in another order
    tol = dict(rtol=1e-12) if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-6)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(chunked, f), getattr(whole, f), err_msg=f, **tol)


def test_the_ml_refit_in_chunks_equals_one_chunk(tmp_path):
    prefix = cohort(tmp_path, n=64, m=40, seed=4)
    data, mean = plink_data(prefix)
    rng = np.random.default_rng(4)
    d = data.dosages().astype(np.float64)
    z = np.where(d < 0, 0.0, d - mean[:, None])
    w, u = np.linalg.eigh(z.T @ z / len(z) + 0.1 * np.eye(64))
    y = rng.normal(size=64) + z[:3].sum(0) * 0.3
    x = np.column_stack([np.ones(64), rng.normal(size=64)])
    solver = lambda g: mlm_gwas_ml_refit(g, y, x, w, u, (0.5, 0.5))
    whole, _ = _chunked_gwas(solver, data, mean, CPU, torch.float64)
    chunked, _ = _chunked_gwas(solver, data, mean, CPU, torch.float64, chunk=9)
    np.testing.assert_array_equal(chunked.converged, whole.converged)
    for f in ("snp_beta", "snp_se", "snp_p"):
        np.testing.assert_allclose(getattr(chunked, f), getattr(whole, f), rtol=1e-10,
                                   atol=1e-14, err_msg=f)


# --- residuals on the device once a pass ----------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_device_residuals_give_the_bits_of_the_per_chunk_upload(dtype):
    rng = np.random.default_rng(8)
    z = make_dosage(rng, 30, 90).astype(np.float64)
    g = torch.as_tensor(z - z.mean(1, keepdims=True)).to(dtype)
    lm = LabeledMatrix([f"k{i}" for i in range(90)], ["a", "b", "c", "d"],
                       rng.normal(size=(90, 4)) * 3 + 1).center_columns()
    names = [f"s{i}" for i in range(30)]
    old = mp_gwas(g, names, lm, center=False)
    new = mp_gwas(g, names, DeviceResiduals.upload(lm, CPU, dtype))
    assert new.phenotype_names == old.phenotype_names == ["a", "b", "c", "d"]
    assert new.snp_names == names
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(new, f), getattr(old, f), err_msg=f)
    # the LabeledMatrix route still centres its columns itself
    raw = LabeledMatrix(lm.row_labels, lm.col_labels, lm.values + 2.5)
    again = mp_gwas(g, names, raw)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(again, f), getattr(old, f), rtol=1e-9 if
                                   dtype == torch.float64 else 1e-4, err_msg=f)


# --- the public scan entry ------------------------------------------------------
def test_the_scan_is_what_mpgwas_writes(tmp_path, monkeypatch):
    """`mp_gwas_scan` returns the results and the filtered data whose
    files `--mpgwas` writes: the same arrays, every SNP, the residuals'
    individuals."""
    monkeypatch.setenv("DISSECT_TPU_TORCH_DEVICE", "cpu")
    prefix = cohort(tmp_path)
    argv = ["--mpgwas", "--bfile", prefix, "--out", str(tmp_path / "r")]
    res, data = Analysis(Options.parse(argv), CPU).mp_gwas_scan(str(tmp_path / "r.residuals"))
    assert data.n_individuals == 68 and data.n_snps == 45
    assert res.snp_names == data.snp_names
    assert res.phenotype_names == ["pheno_1", "pheno_2", "pheno_3"]
    main(argv)
    rows = [ln.split() for ln in (tmp_path / "r.mpgwas").read_text().splitlines()[1:]]
    assert len(rows) == 45 * 3
    written = np.array([[float(v) for v in r[2:]] for r in rows]).reshape(45, 3, 4)
    for k, f in enumerate(FIELDS):
        np.testing.assert_allclose(written[..., k], getattr(res, f), rtol=1e-5, err_msg=f)
