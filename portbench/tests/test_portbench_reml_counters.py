"""The reader of the dense REML's triangular-inverse counter,
`reml.triangular_inverses_per_fit` (`spd.triangular_inverses` over the
window's fits): on known records, None off `reml_fit` units and where
the program recorded no such counter (as a program without it gives),
and in a traced run of array_reml on the CPU with the route's size
lowered under the cohort's N, one a fit's iteration and one for its
BLUEs and BLUPs."""

import pytest

from dissect_tpu_torch.linalg import spd
from dissect_tpu_torch.runtime import timers as timers_module
from dissect_tpu_torch.runtime.timers import timers
from portbench import run as harness
from portbench.tests.test_portbench_harness import SEED, SMALL
from portbench.tests.test_portbench_program_spans import reader

NAME = "reml.triangular_inverses_per_fit"


def fits_run(unit="reml_fit", fits=2):
    return harness.Run(config={}, traffic={"unit": unit}, setup_s=1.0, window_s=4.0,
                       units=fits, work=fits, peak_bytes=0, spans={}, counters={},
                       outputs=[{"iterations": 5}] * fits)


@pytest.fixture
def fresh():
    timers.reset()
    yield
    timers.reset()


def test_the_count_is_the_inverses_over_the_fits(fresh):
    timers.counters["spd.triangular_inverses"] = 13
    assert reader(NAME).read(fits_run()) == pytest.approx(6.5)


@pytest.mark.parametrize("case", ["other_unit", "no_counter", "no_summary"])
def test_the_count_reads_none_off_a_fit_or_without_its_counter(fresh, monkeypatch, case):
    timers.counters["spd.triangular_inverses"] = 13
    unit = "gwas_scan" if case == "other_unit" else "reml_fit"
    if case == "no_counter":
        timers.reset()
    elif case == "no_summary":
        monkeypatch.setattr(timers_module, "timers", type("Timers", (), {"elapsed": {}})())
    assert reader(NAME).read(fits_run(unit)) is None


def test_a_traced_reml_run_counts_one_inverse_an_evaluation(fresh, monkeypatch):
    monkeypatch.setattr(spd, "TRIANGULAR_INVERSE_MIN_N", 64)
    result, _ = harness.run_cell(harness.ROOT, "array_reml", SEED, 0.0, True, "cpu",
                                 overrides=SMALL["array_reml"])
    assert result["correct"], result["check"]
    metrics = result["metrics"]
    assert metrics[NAME]["value"] == metrics["reml.iters_per_fit"]["value"] + 1
