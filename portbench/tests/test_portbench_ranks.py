"""A cell on several cards, rehearsed on gloo ranks on the CPU: each run's
rank 0 is a process of its own (as the driver starts it), which starts
the others.  The ranks run the same units and report the largest peak;
a rank that fails ends the run with no result and no process left; the
mesh REML cell is correct at a small N, and each fault it can have
makes it not correct; a one-card cell keeps its result line and starts
no process."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import torch
import torch.distributed as dist

from portbench import ranks as rank_group
from portbench.tests.test_portbench_harness import SEED, run_small

ROOT = Path(__file__).resolve().parents[2]
MESH = "array_reml_mesh4"
SMALL_MESH = {"n_individuals": 300, "n_snps": 2000, "n_causal": 40}
TINY = {"n_individuals": 40, "n_snps": 100, "n_causal": 20}
RUN_TIMEOUT_S = 300

RANK_0 = """
import json, sys
from pathlib import Path
sys.path.insert(0, {root!r})
from portbench import run as harness
result, _ = harness.run_cell(Path({bench!r}), {cell!r}, {seed!r}, {seconds!r}, False, "cpu",
                             overrides={overrides!r})
print(json.dumps(result))
"""

PROBE_UNIT = '''
"""A unit that counts itself: each rank appends a line a unit to
PROBE_DIR/units.<rank>; its peak reads 1000 (rank + 1) bytes; with
PROBE_FAIL=<rank> that rank raises in its second unit of the window;
with PROBE_FORBIDDEN=<rank> that rank imports a stub module named
`dissect_tpu` from PROBE_DIR/stub."""
import os
import sys
from pathlib import Path

from portbench import ranks


def setup(ctx):
    from dissect_tpu_torch.runtime.distributed import startup_runtime

    startup_runtime(str(ctx.world), ctx.device)
    rank = int(os.environ["RANK"])
    ranks.local_peak = lambda device: 1000 * (rank + 1)
    probe = Path(os.environ["PROBE_DIR"])
    (probe / f"pid.{rank}").write_text(str(os.getpid()))
    if os.environ.get("PROBE_FORBIDDEN") == str(rank):
        sys.path.insert(0, str(probe / "stub"))
        import dissect_tpu  # noqa: F401
    return {"rank": rank, "file": probe / f"units.{rank}", "n": 0}


def unit(state, spans):
    state["n"] += 1
    if os.environ.get("PROBE_FAIL") == str(state["rank"]) and state["n"] == 3:
        raise RuntimeError("a planted failure")
    with open(state["file"], "a") as fh:
        fh.write("unit\\n")
    return 1, {"rank": state["rank"]}


def finish(state, outputs):
    from dissect_tpu_torch.runtime.distributed import shutdown_runtime

    shutdown_runtime()


def reference(ctx):
    return {}


def gaps(outputs, ref):
    return {"probe_gap": 0.0}
'''

# each a planted fault of the mesh REML, applied on every rank in set-up
FAULTS = {
    "step_unchanged": '''
    from dissect_tpu_torch.reml.distributed_engine import DistributedREMLEngine

    quantities = DistributedREMLEngine._quantities

    def frozen(self, theta):
        out = dict(quantities(self, theta))
        out["grad"] = out["grad"] * 0
        return out

    DistributedREMLEngine._quantities = frozen
''',
    "half_batch": '''
    from dissect_tpu_torch.io.phenotype import Phenotype
    from dissect_tpu_torch.reml import single

    init = single.SingleREML.__init__

    def half(self, kernels, pheno, *args, **kw):
        keep = len(pheno.keys) // 2
        pheno = Phenotype(keys=pheno.keys[:keep], values=pheno.values[:keep],
                          column=pheno.column)
        init(self, kernels, pheno, *args, **kw)

    single.SingleREML.__init__ = half
''',
    "exchange_left_out": '''
    from dissect_tpu_torch.runtime.mesh import MeshContext

    MeshContext.all_reduce = lambda self, t: t
''',
    "variance_altered": '''
    from dissect_tpu_torch.reml import single

    compute = single.SingleREML.compute

    def altered(self, *args, **kw):
        out = compute(self, *args, **kw)
        out.result.variances = out.result.variances * (1.0 + 1e-4)
        return out

    single.SingleREML.compute = altered
''',
}

FAULTY_UNIT = '''
"""The mesh REML unit with a fault planted in the program on every rank."""
from portbench.units import reml_mesh
from portbench.units.reml_mesh import as_output, finish, gaps, reference, unit  # noqa: F401


def setup(ctx):
{fault}
    return reml_mesh.setup(ctx)
'''


def bench_root(tmp_path, cell, chips, traffic=None, unit_source=None):
    """A root of its own: BENCHMARK.json with `cell` taking `chips` (and
    `traffic`, whose unit is `unit_source`), beside the harness's files."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        if w["name"] == cell:
            w["chips"] = chips
            w["traffic"] = traffic or w["traffic"]
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg = next(c for c in bench["configs"] if c["name"] == entry["config"])
    (tmp_path / "portbench/configs").mkdir(parents=True)
    shutil.copy(ROOT / cfg["file"], tmp_path / cfg["file"])
    if traffic:
        (tmp_path / "portbench/traffic").mkdir()
        (tmp_path / "portbench/units").mkdir()
        (tmp_path / f"portbench/traffic/{traffic}.json").write_text(
            json.dumps({"unit": traffic, "traits": 4, "why": "a test"}))
        (tmp_path / f"portbench/units/{traffic}.py").write_text(unit_source)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_rank_0(root, cell, overrides, seconds=0.0, env=None):
    """Rank 0 of `cell` in a process of its own: (exit code, result or
    None, stderr)."""
    code = RANK_0.format(root=str(ROOT), bench=str(root), cell=cell, seed=SEED,
                         seconds=seconds, overrides=overrides)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=RUN_TIMEOUT_S, env={**os.environ, **(env or {})})
    lines = out.stdout.strip().splitlines()
    result = None
    if out.returncode == 0 and lines and lines[-1].startswith("{"):
        result = json.loads(lines[-1])
    return out.returncode, result, out.stderr


def alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    return True


@pytest.fixture
def probe_root(tmp_path):
    root = bench_root(tmp_path / "root", MESH, 2, traffic="probe", unit_source=PROBE_UNIT)
    (root / "portbench/limits").mkdir()
    (root / f"portbench/limits/{MESH}.json").write_text(json.dumps({"probe_gap": {"limit": 0}}))
    probe = tmp_path / "probe"
    probe.mkdir()
    return root, probe


def test_two_ranks_run_the_same_units_and_report_the_largest_peak(probe_root):
    root, probe = probe_root
    code, result, err = run_rank_0(root, MESH, TINY, seconds=1.0,
                                   env={"PROBE_DIR": str(probe)})
    assert code == 0 and result is not None, err[-4000:]
    counts = [len((probe / f"units.{r}").read_text().splitlines()) for r in (0, 1)]
    assert counts[0] == counts[1] == result["attempted"] + 1  # the warm unit and the window's
    assert result["attempted"] >= 2
    assert result["device"]["count"] == 2
    assert result["device"]["memory_peak_bytes"] == 2000
    assert result["correct"]


@pytest.mark.parametrize("failing", [1, 0])
def test_a_rank_that_raises_ends_the_run_with_no_result_and_no_process(probe_root, failing):
    root, probe = probe_root
    code, result, err = run_rank_0(root, MESH, TINY, seconds=5.0,
                                   env={"PROBE_DIR": str(probe), "PROBE_FAIL": str(failing)})
    assert code != 0 and result is None
    assert "a planted failure" in err
    pids = [int((probe / f"pid.{r}").read_text()) for r in (0, 1)]
    assert not any(alive(pid) for pid in pids)


def test_a_rank_that_loads_the_jax_package_ends_the_run_with_no_result(probe_root):
    root, probe = probe_root
    (probe / "stub").mkdir()
    (probe / "stub" / "dissect_tpu.py").write_text('"""A stand-in for the JAX package."""\n')
    code, result, err = run_rank_0(root, MESH, TINY, seconds=1.0,
                                   env={"PROBE_DIR": str(probe), "PROBE_FORBIDDEN": "1"})
    assert code != 0 and result is None
    assert "rank 1 loaded dissect_tpu" in err
    pids = [int((probe / f"pid.{r}").read_text()) for r in (0, 1)]
    assert not any(alive(pid) for pid in pids)


def test_the_mesh_reml_cell_is_correct_on_four_ranks():
    code, result, err = run_rank_0(ROOT, MESH, SMALL_MESH)
    assert code == 0 and result is not None, err[-4000:]
    assert result["correct"], result["check"]
    assert result["device"]["count"] == 4
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert {"reml_iteration_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_mesh_reml_is_not_correct(tmp_path, fault):
    source = FAULTY_UNIT.format(fault=FAULTS[fault])
    root = bench_root(tmp_path, MESH, 2, traffic="reml_mesh_faulty", unit_source=source)
    code, result, err = run_rank_0(root, MESH, SMALL_MESH)
    assert code == 0 and result is not None, err[-4000:]
    assert not result["correct"], result["check"]
    assert result["failed"] >= 1


def test_a_one_card_cell_keeps_its_result_line_and_starts_no_process(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a one-card cell started ranks")

    monkeypatch.setattr(rank_group, "Ranks", refuse)
    result = run_small("array_make_grm")
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert list(result["device"]) == ["platform", "kind", "count", "memory_peak_bytes"]
    assert result["device"]["count"] == 1
    assert not dist.is_initialized()


def test_the_solo_group_is_the_identity():
    solo = rank_group.start(ROOT, "array_reml", 1, 1, torch.device("cpu"), ROOT)
    assert solo.world == 1 and solo.largest(7) == 7 and solo.mean(2.5) == 2.5
    solo.tell(True)
    solo.close()
