"""The reader of the PLINK text-parse counter, `io.parse_mb_per_s.gwas`
(.bim/.fam bytes parsed over the `plink.read_text` seconds): on known
records, None where the program recorded no such counter (as a program
without it gives), and present in a traced run of array_gwas_scan on the
CPU."""

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


def test_the_parse_rate_is_the_text_bytes_over_the_read_text_seconds(fresh):
    for start, took in ((0, 100_000_000), (1_000_000_000, 150_000_000)):
        timers._records.append(SpanRecord("plink.read_text", "plink.read", start, start + took,
                                          1, took))
    timers.counters["plink.text_bytes"] = 3_000_000
    timers.counters["plink.text_lines_fallback"] = 0
    assert reader("io.parse_mb_per_s.gwas").read(window_run()) == pytest.approx(3.0 / 0.25)


@pytest.mark.parametrize("recorded", ["span_alone", "counter_alone", "no_records"])
def test_the_parse_rate_without_its_span_or_counter_reads_none(fresh, monkeypatch, recorded):
    """As a program without the `plink.text_bytes` counter gives."""
    if recorded == "span_alone":
        timers._records.append(SpanRecord("plink.read_text", "plink.read", 0, 100, 1, 100))
    elif recorded == "counter_alone":
        timers.counters["plink.text_bytes"] = 10
    else:
        monkeypatch.setattr(timers_module, "timers", type("Timers", (), {"elapsed": {}})())
    assert reader("io.parse_mb_per_s.gwas").read(window_run()) is None


def test_a_traced_plink_scan_reports_the_parse_rate(fresh):
    result, _ = harness.run_cell(harness.ROOT, "array_gwas_scan", SEED, 0.0, True, "cpu",
                                 overrides=SMALL["array_gwas_scan"])
    assert result["metrics"]["io.parse_mb_per_s.gwas"]["value"] > 0
