"""The readers of the program's own spans and counters: each on known
records, None where the program recorded no such span (as a program
without spans gives), and present in a traced run of each cell on the
CPU."""

import math

import pytest

from dissect_tpu_torch.runtime import timers as timers_module
from dissect_tpu_torch.runtime.timers import SpanRecord, timers
from portbench import run as harness
from portbench.tests.test_portbench_harness import SEED, SMALL

WINDOW_S = 4.0
# metric -> (cell, span read)
SHARES = {
    "io.parse_share.gwas": ("array_gwas_scan", "plink.read_text"),
    "gwas.pvalue_share": ("array_gwas_scan", "gwas.pvalues"),
    "grm.stats_share": ("array_make_grm", "grm.stats"),
    "reml.outputs_share": ("array_reml", "BLUE/BLUP"),
    "bgen.inflate_share": ("imputed_gwas_scan", "bgen.inflate"),
}
RATES = {"bgen.inflate_mb_per_s": "imputed_gwas_scan"}


def reader(name):
    return harness.load_module(harness.BENCH_DIR / "metrics" / f"{name}.py",
                               "portbench_metric_" + name.replace(".", "_"))


def window_run():
    return harness.Run(config={}, traffic={}, setup_s=1.0, window_s=WINDOW_S, units=2,
                       work=2, peak_bytes=0, spans={}, counters={}, outputs=[])


@pytest.fixture
def recorded():
    """Two spans of each name read, 0.3 s and 0.5 s, each with a 0.1 s
    child of another name, and 4e8 bytes inflated."""
    timers.reset()
    for name in [span for _, span in SHARES.values()]:
        for start, took in ((0, 300_000_000), (1_000_000_000, 500_000_000)):
            timers._records += [
                SpanRecord("child", name, start, start + 100_000_000, 1, 100_000_000),
                SpanRecord(name, None, start, start + took, 1, took - 100_000_000)]
    timers.counters["bgen.bytes_inflated"] = 400_000_000
    yield
    timers.reset()


@pytest.mark.parametrize("name", list(SHARES))
def test_a_share_is_its_spans_seconds_over_the_window(recorded, name):
    assert reader(name).read(window_run()) == pytest.approx(100.0 * 0.8 / WINDOW_S)


def test_the_inflate_rate_is_the_bytes_over_the_inflate_seconds(recorded):
    assert reader("bgen.inflate_mb_per_s").read(window_run()) == pytest.approx(400 / 0.8)


@pytest.mark.parametrize("name", list(SHARES) + list(RATES))
def test_no_span_reads_none(name):
    timers.reset()
    timers.counters["bgen.bytes_inflated"] = 1
    try:
        assert reader(name).read(window_run()) is None
    finally:
        timers.reset()


@pytest.mark.parametrize("name", list(SHARES) + list(RATES))
def test_a_program_without_span_records_reads_none(monkeypatch, name):
    """A program whose timers keep only phases, as before spans."""
    monkeypatch.setattr(timers_module, "timers", type("Timers", (), {"elapsed": {}})())
    assert reader(name).read(window_run()) is None


@pytest.mark.parametrize("cell", sorted({cell for cell, _ in SHARES.values()}))
def test_a_traced_run_reports_its_cells_program_metrics(cell):
    timers.reset()
    result, _ = harness.run_cell(harness.ROOT, cell, SEED, 0.0, True, "cpu",
                                 overrides=SMALL[cell])
    timers.reset()
    mine = {m for m, (c, _) in SHARES.items() if c == cell} | {
        m for m, c in RATES.items() if c == cell}
    theirs = set(SHARES) | set(RATES)
    assert mine <= set(result["metrics"])
    assert not (theirs - mine) & set(result["metrics"])
    for m in mine:
        assert math.isfinite(result["metrics"][m]["value"]) and result["metrics"][m]["value"] > 0
