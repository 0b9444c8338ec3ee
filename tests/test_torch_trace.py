"""The port's spans, counters and phases (dissect_tpu_torch.runtime.timers).

With no profiler recording a span costs one flag test: no clock, no
card synchronization, no record.  Under `torch.profiler` each span is a
plain CPU operator of the profile (not a user annotation, which the
profiler would mirror onto the device's timeline), stamped on the
profiler's clock, with its parent, self time and the counters beside it.
Each instrumented path (the PLINK scan, dense REML, the GRM build, the
BGEN reader, the multi-phenotype scan) records the spans and parent links PERF.md §3 lists, and
gives bit for bit the results of an unprofiled run.
"""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from dissect_tpu_torch.analysis import dispatcher
from dissect_tpu_torch.analysis.dispatcher import Analysis, _chunked_gwas
from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
from dissect_tpu_torch.io import bgen, grm_io
from dissect_tpu_torch.io.bed import IndividualInfo, PlinkData, SnpInfo, read_plink, write_plink
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.linalg import spd
from dissect_tpu_torch.model.kernels import Kernel, KernelType, grm_from_plink
from dissect_tpu_torch.reml.single import SingleREML
from dissect_tpu_torch.runtime import timers as timers_module
from dissect_tpu_torch.runtime.options import Options
from dissect_tpu_torch.runtime.timers import Timers, timers
from tests.conftest import make_dosage

CPU = torch.device("cpu")


def profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh_timers():
    timers.reset()
    yield
    timers.reset()


def links():
    return {(r.name, r.parent) for r in timers.records}


# --- the facility ------------------------------------------------------------
def test_a_span_off_records_nothing_reads_no_clock_and_never_synchronizes(monkeypatch):
    calls = []
    for name in ("time_ns", "monotonic", "perf_counter"):
        monkeypatch.setattr(time, name, lambda name=name: calls.append(name) or 0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append("synchronize"))
    monkeypatch.setattr(timers_module, "_sync_cuda", lambda: calls.append("_sync_cuda"))

    @timers.span("decorated")
    def work(x):
        return x + 1

    with timers.span("outer"):
        with timers.span("inner"):
            assert work(1) == 2
        timers.count("things", 5)
    assert calls == []
    assert timers.records == []
    assert timers.summary() == {"spans": {}, "counters": {}}
    assert timers._local.stack == []


def test_spans_under_the_profiler_nest_time_and_count():
    @timers.span("child")
    def child():
        time.sleep(0.002)

    with profile() as prof:
        with timers.span("root"):
            child()
            with timers.span("child"):
                timers.count("rows", 7)
                time.sleep(0.002)
            timers.count("rows")
            time.sleep(0.002)
    timers.count("rows", 100)  # the profiler has stopped: not counted

    records = timers.records
    assert [(r.name, r.parent) for r in records] == [
        ("child", "root"), ("child", "root"), ("root", None)]
    assert {r.thread for r in records} == {threading.get_ident()}
    children, (root,) = records[:2], records[2:]
    for r in children:
        assert root.start_ns <= r.start_ns < r.end_ns <= root.end_ns
        assert r.self_ns == r.end_ns - r.start_ns
    covered = sum(r.end_ns - r.start_ns for r in children)
    assert root.self_ns == root.end_ns - root.start_ns - covered
    summary = timers.summary()
    assert summary["counters"] == {"rows": 8}
    assert summary["spans"]["child"]["count"] == 2
    assert summary["spans"]["child"]["seconds"] == pytest.approx(covered * 1e-9)
    assert summary["spans"]["root"]["self_seconds"] == pytest.approx(root.self_ns * 1e-9)

    events = {}
    for e in prof.profiler.kineto_results.events():
        events.setdefault(e.name(), []).append(e)
    for r in records:
        # the span's own profile event: a plain CPU operator, not a user
        # annotation, whose interval holds the span's stamps
        (own,) = [e for e in events[r.name]
                  if e.start_ns() <= r.start_ns and r.end_ns <= e.end_ns()]
        assert own.activity_type() == "cpu_op"
        assert not own.is_user_annotation()
        assert own.device_type() == torch.autograd.DeviceType.CPU

    timers.reset()
    assert timers.records == [] and timers.summary() == {"spans": {}, "counters": {}}


def test_a_phase_adds_to_elapsed_and_synchronizes_with_tracing_off(monkeypatch):
    syncs = []
    monkeypatch.setattr(timers_module, "_sync_cuda", lambda: syncs.append(1))
    t = Timers()
    with t.phase("Load"):
        pass
    first = t.elapsed["Load"]

    @t.timed("Load")
    def load():
        time.sleep(0.001)

    load()
    assert len(syncs) == 2
    assert t.elapsed["Load"] >= first + 0.001
    assert t.records == []


def test_a_phase_nested_in_one_of_its_name_counts_both(monkeypatch):
    clock = iter([0.0, 10.0, 15.0, 30.0])  # outer start, inner start, inner end, outer end
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    monkeypatch.setattr(timers_module, "_sync_cuda", lambda: None)
    t = Timers()
    with t.phase("GWAS"):
        with t.phase("GWAS"):
            pass
    assert t.elapsed == {"GWAS": 30.0 + 5.0}


def test_a_phase_is_a_span_while_recording():
    with profile():
        with timers.phase("REML"):
            with timers.span("reml.quantities"):
                pass
    assert links() == {("REML", None), ("reml.quantities", "REML")}
    assert "REML" in timers.elapsed


def test_threads_keep_their_own_parents_and_lose_no_count(monkeypatch):
    """More threads than cores, each nesting spans and counting, with a
    short switch interval.  The profiler records only the thread that
    started it, so every thread is told here that it records."""
    monkeypatch.setattr(timers_module, "_profiler_enabled", lambda: True)
    n_threads, rounds = 16, 200
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(rounds):
                with timers.span(f"t{i}"):
                    with timers.span(f"t{i}.child"):
                        timers.count("ticks")

        threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    summary = timers.summary()
    assert summary["counters"] == {"ticks": n_threads * rounds}
    assert links() == ({(f"t{i}", None) for i in range(n_threads)}
                       | {(f"t{i}.child", f"t{i}") for i in range(n_threads)})
    assert all(s["count"] == rounds for s in summary["spans"].values())


# --- the instrumented paths --------------------------------------------------
# a read_plink's counters: the .bed rows staged; under plink.read_text the
# .bim and .fam bytes parsed
PLINK_COUNTERS = {"plink.bytes_staged", "plink.text_bytes"}


def plink_cohort(tmp_path, n, m, seed):
    rng = np.random.default_rng(seed)
    d = make_dosage(rng, m, n, missing_rate=0.02)
    data = PlinkData(
        snps=[SnpInfo(str(1 + i % 22), f"snp{i}", 0.0, 1000 + i, "A", "C") for i in range(m)],
        individuals=[IndividualInfo(f"F{i}", f"I{i}") for i in range(n)],
        _dosage=d, device="cpu")
    prefix = str(tmp_path / "cohort")
    write_plink(prefix, data)
    return prefix, rng


def plink_scan(tmp_path):
    """read_plink -> filter -> stats -> _chunked_gwas over the ML refit,
    in three chunks, with SNPs refit a second time."""
    prefix, rng = plink_cohort(tmp_path, n=64, m=48, seed=5)
    base = read_plink(prefix, device="cpu")
    d = base.dosages().astype(np.float64)
    z = np.where(d < 0, 0.0, d - np.nanmean(np.where(d < 0, np.nan, d), axis=1, keepdims=True))
    w, u = np.linalg.eigh(z.T @ z / len(z) + 0.1 * np.eye(base.n_individuals))
    keep = base.individual_keys[4:]
    w, u = w[4:], np.linalg.qr(u[4:, 4:])[0]
    y = rng.normal(size=len(keep)) + z[:3, 4:].sum(0) * 0.3
    x = np.column_stack([np.ones(len(keep)), rng.normal(size=len(keep))])

    def run():
        data = read_plink(prefix, device="cpu").filter(keep_individuals=keep)
        stats = data.stats()
        solver = lambda g: mlm_gwas_ml_refit(g, y, x, w, u, (0.5, 0.5), n_iterations=2)
        res, _ = _chunked_gwas(solver, data, stats.mean, CPU, torch.float64, chunk=20)
        return {k: getattr(res, k) for k in ("snp_beta", "snp_se", "snp_p", "converged")}

    expect = {("plink.read", None), ("plink.open", "plink.read"),
              ("plink.read_text", "plink.read"), ("plink.filter", None), ("plink.stats", None),
              ("plink.gather", "plink.stats"), ("gwas.chunk", None),
              ("gwas.decode", "gwas.chunk"), ("plink.gather", "gwas.decode"),
              ("gwas.refit", "gwas.chunk"), ("gwas.rotate", "gwas.refit"),
              ("gwas.fisher", "gwas.refit"), ("gwas.readback", "gwas.refit"),
              ("gwas.retry", "gwas.refit"), ("gwas.fisher", "gwas.retry"),
              ("gwas.pvalues", "gwas.refit")}
    return run, expect, PLINK_COUNTERS


def dense_reml(tmp_path):
    """SingleREML.compute with BLUEs and BLUPs on one dense GRM."""
    rng = np.random.default_rng(11)
    n = 80
    d = make_dosage(rng, 200, n).astype(np.float64)
    zs = (d - d.mean(1, keepdims=True)) / d.std(1, keepdims=True)
    keys = [f"F{i}@I{i}" for i in range(n)]
    kern = Kernel(name="GRM", type=KernelType.GRM, individual_keys=keys,
                  matrix=torch.as_tensor(zs.T @ zs / len(zs)))
    pheno = Phenotype(keys=keys, values=zs[:20].T @ rng.normal(scale=0.2, size=20)
                      + rng.normal(size=n), column=1)

    def run():
        out = SingleREML([kern], pheno, device="cpu").compute(compute_blue=True,
                                                              compute_blup=True)
        return {"theta": out.result.variances, "logl": np.array(out.result.log_likelihood),
                "blue": out.blue, "blue_se": out.blue_se, "blup": out.blup["GRM"],
                "iterations": np.array(out.result.n_iterations)}

    expect = {("REML", None), ("reml.quantities", "REML"), ("BLUE/BLUP", None)}
    return run, expect, set()


def dense_reml_triangular(tmp_path, monkeypatch):
    """dense_reml with its V (N = 80) above a lowered size for the
    triangular inverse, in leaves of 16 rows: each evaluation counts one."""
    monkeypatch.setattr(spd, "TRIANGULAR_INVERSE_MIN_N", 64)
    monkeypatch.setattr(spd, "TRIANGULAR_LEAF", 16)
    monkeypatch.setattr(spd, "TRIANGULAR_ALIGN", 8)
    run, expect, _ = dense_reml(tmp_path)
    return run, expect, {"spd.triangular_inverses"}


def grm_build(tmp_path):
    """read_plink -> grm_from_plink -> sanitize, then the GRM written,
    read back and diagonalized."""
    prefix, _ = plink_cohort(tmp_path, n=40, m=70, seed=9)
    out = str(tmp_path / "grm")

    def run():
        kern = grm_from_plink(read_plink(prefix, device="cpu"), chunk_size=32,
                              device="cpu").sanitize()
        grm_io.write_grm(out, kern.matrix.numpy(), kern.counts.numpy(), kern.individual_keys,
                         kern.snp_names)
        back = grm_io.read_grm(out)
        diag = kern.diagonalize()
        return {"grm": kern.matrix.numpy(), "counts": kern.counts.numpy(),
                "read": back["kernel"], "eigenvalues": diag.eigenvalues.numpy()}

    expect = {("plink.read", None), ("plink.open", "plink.read"),
              ("plink.read_text", "plink.read"), ("grm.stats", None),
              ("plink.stats", "grm.stats"), ("plink.gather", "plink.stats"),
              ("grm.accumulate", None), ("plink.gather", "grm.accumulate"),
              ("grm.normalize", None), ("grm.sanitize", None), ("grm_io.read", None),
              ("eigen.diagonalize", None)}
    return run, expect, PLINK_COUNTERS


def bgen_read(tmp_path, monkeypatch):
    """read_bgen of a layout-2 8-bit zlib file in three batches."""
    monkeypatch.setattr(bgen, "_BATCH", 8)
    rng = np.random.default_rng(13)
    m, n = 20, 30
    p = rng.uniform(0.05, 0.5, size=(m, 1))
    dos = ((rng.random((m, n)) < p).astype(np.float32) + (rng.random((m, n)) < p))
    dos[rng.random((m, n)) < 0.05] = np.nan
    data = bgen.BgenData(
        snps=[SnpInfo(str(1 + i % 22), f"rs{i}", 0.0, 1000 + i, "A", "G") for i in range(m)],
        individuals=[IndividualInfo(f"S{i}", f"S{i}") for i in range(n)], dosages=dos)
    path = str(tmp_path / "imputed.bgen")
    bgen.write_bgen(path, data, bits=8, layout=2, compression="zlib")

    def run():
        return {"dosages": bgen.read_bgen(path, device="cpu").dosages.numpy()}

    expect = {("bgen.read", None), ("bgen.index", "bgen.read"), ("bgen.inflate", "bgen.read"),
              ("bgen.decode", "bgen.read")}
    return run, expect, {"bgen.bytes_inflated"}


def mp_scan(tmp_path, monkeypatch):
    """Analysis.mp_gwas_scan (`--mpgwas` without its files): the residual
    matrix over 60 of the 64 individuals, 30 SNPs in chunks of 12 (the
    chunk rule's cap, GWAS_CHUNK_SNPS, set to 12 for N = 60)."""
    monkeypatch.setattr(dispatcher, "GWAS_CHUNK_SNPS", 12)
    prefix, rng = plink_cohort(tmp_path, n=64, m=30, seed=17)
    keys = read_plink(prefix, device="cpu").individual_keys[4:]
    LabeledMatrix(keys, ["pheno_1", "pheno_2", "pheno_3"],
                  rng.normal(size=(60, 3))).save(str(tmp_path / "r.residuals"))
    analysis = Analysis(Options.parse(["--mpgwas", "--bfile", prefix,
                                       "--out", str(tmp_path / "r")]), CPU)

    def run():
        res, _ = analysis.mp_gwas_scan(str(tmp_path / "r.residuals"))
        return {k: getattr(res, k) for k in ("beta", "se", "t", "p")}

    expect = {("LoadGenotypes", None), ("plink.read", "LoadGenotypes"),
              ("plink.open", "plink.read"), ("plink.read_text", "plink.read"),
              ("mp.residuals", "LoadGenotypes"), ("plink.filter", "LoadGenotypes"),
              ("plink.stats", "LoadGenotypes"), ("plink.gather", "plink.stats"),
              ("GWAS", None), ("gwas.chunk", "GWAS"), ("gwas.decode", "gwas.chunk"),
              ("plink.gather", "gwas.decode"), ("mp.product", "gwas.chunk"),
              ("mp.readback", "gwas.chunk"), ("mp.stats", "gwas.chunk")}
    return run, expect, PLINK_COUNTERS | {"mp.tests", "mp.chunk_snps"}


# path -> (SNP rows, packed bytes a row: ceil(N / 4) for the file's N individuals)
STAGED = {"plink_scan": (48, 16), "grm_build": (70, 10), "mp_scan": (30, 16)}
PATHS = {"plink_scan": plink_scan, "dense_reml": dense_reml, "grm_build": grm_build,
         "bgen_read": bgen_read, "mp_scan": mp_scan,
         "dense_reml_triangular": dense_reml_triangular}
WITH_MONKEYPATCH = ("bgen_read", "mp_scan", "dense_reml_triangular")


@pytest.mark.parametrize("path", list(PATHS))
def test_a_profiled_path_records_its_spans_and_gives_the_same_results(tmp_path, monkeypatch,
                                                                      path):
    build = PATHS[path]
    run, expect, counters = (build(tmp_path, monkeypatch) if path in WITH_MONKEYPATCH
                             else build(tmp_path))
    plain = run()
    assert timers.records == [] and timers.summary()["counters"] == {}
    with profile():
        traced = run()
    assert links() == expect
    summary = timers.summary()
    assert set(summary["counters"]) == counters
    assert all(v > 0 for v in summary["counters"].values())
    for name, s in summary["spans"].items():
        assert 0 <= s["self_seconds"] <= s["seconds"] + 1e-9, name
    assert plain.keys() == traced.keys()
    for k in plain:
        np.testing.assert_array_equal(traced[k], plain[k], err_msg=k)
    if path in STAGED:
        # K5's pass and K4's each stage every row once (rows x bytes a row)
        rows, row_bytes = STAGED[path]
        assert summary["counters"]["plink.bytes_staged"] == 2 * rows * row_bytes
        # one read_plink: its .bim and .fam parsed once each
        text = sum((tmp_path / f"cohort.{ext}").stat().st_size for ext in ("bim", "fam"))
        assert summary["counters"]["plink.text_bytes"] == text
        assert summary["spans"]["plink.read_text"]["count"] == 1
    if path == "mp_scan":
        # 30 SNPs x 3 columns tested, in chunks of 12, 12 and 6; the chunk
        # counted once a pass
        assert summary["counters"] == {"plink.bytes_staged": 2 * 30 * 16, "mp.tests": 90,
                                       "mp.chunk_snps": 12, "plink.text_bytes": text}
        assert summary["spans"]["gwas.chunk"]["count"] == 3
        assert summary["spans"]["mp.residuals"]["count"] == 1
    elif path in STAGED:
        assert set(summary["counters"]) == PLINK_COUNTERS
    if path == "dense_reml_triangular":
        # every iteration's V and the BLUE/BLUP phase's
        assert summary["counters"] == {"spd.triangular_inverses": int(traced["iterations"]) + 1}
    if path == "bgen_read":
        # 20 variants in batches of 8; a layout-2 block of N = 30 samples
        # at 8 bits holds 10 + 3N bytes (BGEN v1.2: N, K, the ploidy
        # bounds, N ploidy bytes, phasing, bits, 2N probabilities)
        assert summary["spans"]["bgen.inflate"]["count"] == 3
        assert summary["counters"] == {"bgen.bytes_inflated": 20 * (10 + 3 * 30)}


def test_read_bgen_never_synchronizes_per_batch(tmp_path, monkeypatch):
    """With tracing off and a card that reports itself ready, the reader
    calls no synchronize (the batches' status read back waits on its own)."""
    run, _, _ = bgen_read(tmp_path, monkeypatch)
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: syncs.append(1))
    run()
    assert syncs == []
