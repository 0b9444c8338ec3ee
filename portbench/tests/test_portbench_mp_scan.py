"""The multi-phenotype scan cell on the CPU: a whole run at a small N and
M (P stays the configuration's 778) reads correct; faults planted in the
program each read not correct; the reference's pieces (its t tail, its
`.dat` reader) against scipy and the program's writer; its flop count;
and neither the reference nor the unit loads the program or JAX."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import scipy.stats
import torch

from portbench import run as harness
from portbench.metrics._mp_scan import mp_scan_flops, mp_scan_mfu
from portbench.reference import mp_gwas as ref_mp

ROOT = Path(__file__).resolve().parents[2]
CELL = "geneatlas_mp_scan"
SEED = 2**31 + 2019
# small enough that a tail taken with n - 2 degrees of freedom moves
# -log10 p past the cell's limit; at least the configuration's 500
# causal SNPs
SMALL = {"n_individuals": 40, "n_snps": 600}


def run_small(trace=False):
    result, _ = harness.run_cell(ROOT, CELL, SEED, 0.0, trace, "cpu", overrides=SMALL)
    return result


def test_a_sound_run_is_correct_and_reads_its_program_metrics():
    result = run_small(trace=True)
    assert result["correct"], result["check"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["check"]) == {"beta_gap_se", "se_gap", "log10p_gap"}
    # no card: the device-trace metrics are left out
    assert set(result["metrics"]) == {"gwas_snps_per_s.mpgwas", "mp.stats_share",
                                      "mp.residuals_share", "io.parse_share.mpgwas"}
    for name in ("mp.stats_share", "mp.residuals_share", "io.parse_share.mpgwas"):
        assert 0 < result["metrics"][name]["value"] < 100, name


# --- faults planted in the program ------------------------------------------
def fault_residual_column_shifted(monkeypatch):
    """The last residual column moved down one individual as it is read."""
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix

    load = LabeledMatrix.load

    def shifted(prefix):
        lm = load(prefix)
        values = lm.values.copy()
        values[:, -1] = np.roll(values[:, -1], 1)
        return LabeledMatrix(lm.row_labels, lm.col_labels, values)

    monkeypatch.setattr(LabeledMatrix, "load", staticmethod(shifted))


def fault_chunk_dropped(monkeypatch):
    """Chunks of 100 SNPs, the second of them left out of the results."""
    from dissect_tpu_torch.analysis import dispatcher

    monkeypatch.setattr(dispatcher, "GWAS_CHUNK_SNPS", 100)
    chunks = dispatcher._map_snp_chunks

    def dropped(*args, **kw):
        parts = chunks(*args, **kw)
        return parts[:1] + parts[2:]

    monkeypatch.setattr(dispatcher, "_map_snp_chunks", dropped)


def fault_tail_df_one_less(monkeypatch):
    """The t tail taken with n - 2 degrees of freedom."""
    from dissect_tpu_torch.gwas import mp

    t_sf = mp.t_sf
    monkeypatch.setattr(mp, "t_sf", lambda df, x: t_sf(df - 1.0, x))


@pytest.mark.parametrize("fault", [fault_residual_column_shifted, fault_chunk_dropped,
                                   fault_tail_df_one_less])
def test_a_broken_program_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result = run_small()
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1


# --- the reference's pieces -------------------------------------------------------
@pytest.mark.parametrize("df", [3.0, 39.0, 999.0, 452263.0])
def test_the_reference_tail_is_scipys_two_sided_t(df):
    t = np.array([0.0, 0.3, -1.5, 2.0, -4.0, 8.0, 25.0, -60.0])
    expect = 2.0 * scipy.stats.t.sf(np.abs(t), df)
    np.testing.assert_allclose(ref_mp.t_two_sided(t, df), expect, rtol=1e-12, atol=0)


def test_the_reference_reads_the_programs_residual_file(tmp_path):
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix

    values = np.random.default_rng(5).normal(size=(13, 4))
    LabeledMatrix([f"k{i}" for i in range(13)], list("abcd"), values).save(str(tmp_path / "r"))
    np.testing.assert_array_equal(ref_mp.read_dat(tmp_path / "r.dat", 13), values)


def test_the_reference_meets_the_program_in_float64(tmp_path):
    """On the CPU the program runs in float64: it meets the reference to
    the last digits."""
    from portbench.cohort import make_cohort

    spec, config, traffic, unit_kind = harness.load_cell(ROOT, CELL, {"n_individuals": 90,
                                                                      "n_snps": 700})
    cohort = make_cohort(config, SEED, tmp_path / "cohort", "cpu")
    ctx = harness.Context(seed=SEED, device=torch.device("cpu"), workdir=tmp_path,
                          cohort=cohort)
    state = unit_kind.setup(ctx)
    done, out = unit_kind.unit(state, harness.tracing.Spans("cpu"))
    assert done == 700 and out["beta"].shape == (700, 778)
    ref = unit_kind.reference(ctx)
    for name, value in unit_kind.gaps([out], ref).items():
        assert value < 1e-9, name


def test_the_flops_of_a_pass():
    assert mp_scan_flops(1, 452264, 778) == 2 * 452264 * 778 + 2 * 452264
    assert mp_scan_flops(20000, 452264, 778) == pytest.approx(1.41e13, rel=1e-2)
    run = harness.Run(config={"n_individuals": 100, "n_phenotypes": 10},
                      traffic={"unit": "gwas_scan"}, setup_s=1.0, window_s=1.0, units=1,
                      work=10, peak_bytes=0, spans={}, counters={}, outputs=[],
                      trace={"window_s": 2.0})
    assert mp_scan_mfu(run) is None
    run.traffic = {"unit": "mp_scan"}
    assert mp_scan_mfu(run) == pytest.approx(100 * 10 * 2200 / (67e12 * 2.0))


# --- isolation --------------------------------------------------------------------------
def test_the_reference_and_the_unit_load_nothing_of_the_program():
    code = f"""
import importlib.util, json, sys
sys.path.insert(0, {str(ROOT)!r})
import portbench.reference.mp_gwas, portbench.metrics._mp_scan
for rel in ("portbench/units/mp_scan.py", "portbench/metrics/mfu.mpgwas.py"):
    spec = importlib.util.spec_from_file_location("m", {str(ROOT)!r} + "/" + rel)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"dissect_tpu_torch", "dissect_tpu", "jax", "jaxlib", "flax"}
