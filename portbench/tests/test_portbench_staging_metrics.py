"""The reader of the PLINK staging counter, `io.gather_gb_per_s.gwas`
(bytes staged over the `plink.gather` seconds): on known records, None
where the program recorded no such counter (as a program without it
gives), and present in a traced run of array_gwas_scan on the CPU."""

import pytest

from dissect_tpu_torch.runtime import timers as timers_module
from dissect_tpu_torch.runtime.timers import SpanRecord, timers
from portbench import run as harness
from portbench.tests.test_portbench_harness import SEED, SMALL
from portbench.tests.test_portbench_program_spans import reader, window_run


@pytest.fixture
def fresh():
    timers.reset()
    yield
    timers.reset()


def test_the_gather_rate_is_the_bytes_staged_over_the_gather_seconds(fresh):
    for start, took in ((0, 200_000_000), (1_000_000_000, 300_000_000)):
        timers._records.append(SpanRecord("plink.gather", "plink.stats", start, start + took, 1,
                                          took))
    timers.counters["plink.bytes_staged"] = 2_000_000_000
    assert reader("io.gather_gb_per_s.gwas").read(window_run()) == pytest.approx(2.0 / 0.5)


def test_no_counter_reads_none(fresh):
    timers._records.append(SpanRecord("plink.gather", None, 0, 100, 1, 100))
    assert reader("io.gather_gb_per_s.gwas").read(window_run()) is None


def test_no_gather_span_reads_none(fresh):
    timers.counters["plink.bytes_staged"] = 10
    assert reader("io.gather_gb_per_s.gwas").read(window_run()) is None


def test_a_program_without_span_records_reads_none(monkeypatch):
    monkeypatch.setattr(timers_module, "timers", type("Timers", (), {"elapsed": {}})())
    assert reader("io.gather_gb_per_s.gwas").read(window_run()) is None


def test_a_traced_plink_scan_reports_the_gather_rate(fresh):
    result, _ = harness.run_cell(harness.ROOT, "array_gwas_scan", SEED, 0.0, True, "cpu",
                                 overrides=SMALL["array_gwas_scan"])
    metrics = result["metrics"]
    assert metrics["io.gather_gb_per_s.gwas"]["value"] > 0
