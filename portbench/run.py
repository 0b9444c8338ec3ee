"""The benchmark of dissect_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of BENCHMARK.json names a configuration (a cohort: its file
under portbench/configs/) and a traffic mix (portbench/traffic/<mix>.json,
which names the kind of unit, portbench/units/<unit>.py).  A run:

1. Set-up: CUDA and the program's kernels (built with nvcc only the
   first time in a checkout), the cohort drawn on the card from the seed
   and written under TMPDIR, what the unit needs from earlier pipeline
   steps (prepared by the program's own functions), and one warm unit.
2. The window: whole units back to back, closed-loop, until `--seconds`
   have passed; the window ends with the last unit.
3. With the window closed and the program's state freed: the plain
   reference (portbench/reference/) works out the same results from the
   same inputs, and each number compared is held to its limit
   (portbench/limits/<cell>.json).
4. Output: the metrics the cell names (each read by its reader,
   portbench/metrics/<name>.py: the end-to-end ones with `--trace 0`,
   the per-layer ones with `--trace 1`, which profiles the window), as
   the last line of standard output; each compared number beside its
   limit as the last lines of standard error.

A cell whose `chips` is above 1 runs as that many processes, one a card,
in lockstep (portbench/ranks.py): this process is rank 0, which alone
reads the clock, is traced, checks and prints.

It exits with another code than 0, and prints no result, where there is
no CUDA card (or fewer than the cell's chips), where the program is
missing, where another rank ended with an error, or where JAX or the
JAX package was loaded.  Nothing here imports JAX or the JAX package.
"""

import time

START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import Counter  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from portbench import ranks as rank_group  # noqa: E402
from portbench import trace as tracing  # noqa: E402
from portbench.cohort import make_cohort  # noqa: E402

# top-level module names that may not be loaded in a run
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "dissect_tpu")


@dataclasses.dataclass
class Context:
    """What a unit's set-up and the reference are given."""

    seed: int
    device: torch.device
    workdir: Path
    cohort: object
    rank: int = 0
    world: int = 1


@dataclasses.dataclass
class Run:
    """What a metric reader reads: the run's clock, its spans, the
    program's counters over the window and, in a traced run, the trace."""

    config: dict
    traffic: dict
    setup_s: float
    window_s: float
    units: int
    work: int
    peak_bytes: int
    spans: dict
    counters: dict
    outputs: list
    trace: dict = None
    chips: int = 1


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find(root: Path, *parts) -> Path:
    """A benchmark file under `root`, else the one beside this harness."""
    here = root.joinpath(*parts)
    return here if here.exists() else BENCH_DIR.joinpath(*parts[1:])


def cell_spec(root: Path, name: str) -> dict:
    """The cell `name` of root/BENCHMARK.json, with its configuration,
    traffic, limits and metrics read from their files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in {root / 'BENCHMARK.json'}")
    cell = cells[name]
    config_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    applies = lambda m: name in m.get("workloads", [name])
    return {
        "cell": cell,
        "config": json.loads((root / config_entry["file"]).read_text()),
        "traffic": json.loads(find(root, "portbench", "traffic", cell["traffic"] + ".json")
                              .read_text()),
        "limits": json.loads(find(root, "portbench", "limits", name + ".json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
        "per_layer": [m for m in bench["per_layer"] if applies(m)],
    }


def counters():
    """The program's kernel launch counters, copied."""
    from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments
    from dissect_tpu_torch.io import genotype_kernels as gk
    from dissect_tpu_torch.linalg import grm_kernels

    return {
        "k1": grm_kernels.grm_fused_triangle_update.launches,
        "k3": fused_refit_moments.launches,
        "k3_rows": Counter(fused_refit_moments.launches_by_rows),
        "k4_rows": Counter(gk.bed_decode.launches_by_rows),
        "k6": gk.bgen_decode_l2.launches,
    }


def counter_delta(after, before):
    return {k: (after[k] - before[k]) for k in after}


def nvidia_smi():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def load_cell(root: Path, name: str, overrides=None):
    """(spec, configuration, traffic, unit kind) of cell `name`."""
    spec = cell_spec(Path(root), name)
    config = {**spec["config"], **(overrides or {})}
    traffic = spec["traffic"]
    unit_kind = load_module(find(Path(root), "portbench", "units", traffic["unit"] + ".py"),
                            "portbench_unit_" + traffic["unit"])
    return spec, config, traffic, unit_kind


def prepare(device: torch.device) -> None:
    """The program's kernels (built only the first time in a checkout)
    and its precision settings."""
    from dissect_tpu_torch.runtime.dtypes import configure_precision

    if device.type == "cuda":
        from dissect_tpu_torch.runtime import cuda_lib

        torch.cuda.set_device(device)
        for lib, info in cuda_lib.build_all().items():
            built = "cached" if info["ptxas"] == "cached" else f"built in {info['seconds']:.1f} s"
            print(f"portbench: kernel {lib} {built}", file=sys.stderr)
    configure_precision()


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool, device,
             overrides=None):
    """Run cell `name` once on `device` (rank 0's, where the cell takes
    more than one chip).  Returns (result, compared): the result line's
    object and {number: (value, limit)}.  `overrides` replaces
    configuration values (the CPU tests' small cohorts)."""
    spec, config, traffic, unit_kind = load_cell(root, name, overrides)
    device = torch.device(device)
    on_card = device.type == "cuda"
    prepare(device)
    workdir = Path(tempfile.mkdtemp(prefix="portbench-", dir=os.environ.get("TMPDIR")))
    group = rank_group.Solo()
    try:
        group = rank_group.start(Path(root), name, seed, spec["cell"]["chips"], device, workdir,
                                 overrides, trace)
        cohort = make_cohort(config, seed, workdir / "cohort", device,
                             n_traits=traffic.get("traits", 1))
        group.publish(cohort)
        ctx = Context(seed=seed, device=device, workdir=workdir, cohort=cohort,
                      world=group.world)
        reset_peak(device)
        spans = tracing.Spans(device)
        state = unit_kind.setup(ctx)
        unit_kind.unit(state, spans)  # the warm unit
        setup_s = time.monotonic() - START

        before = counters()
        profile = tracing.profiler() if trace else contextlib.nullcontext()
        outputs, work, ends = [], 0, []
        with profile:
            with torch.profiler.record_function(tracing.WINDOW):
                t0 = time.monotonic()
                while True:
                    group.tell(True)
                    done, out = unit_kind.unit(state, spans)
                    work += done
                    outputs.append(out)
                    ends.append(time.monotonic())
                    if ends[-1] - t0 >= seconds:
                        break
                t1 = ends[-1]
                group.tell(False)
        run = Run(
            config=config, traffic=traffic, setup_s=setup_s,
            window_s=t1 - t0, units=len(outputs), work=work,
            peak_bytes=group.largest(rank_group.local_peak(device)),
            spans=spans.seconds(since=t0), counters=counter_delta(counters(), before),
            outputs=outputs, trace=tracing.read_trace(profile) if trace else None,
            chips=group.world,
        )
        busy_s = run.trace["busy_s"] if run.trace else 0.0
        if trace and group.world > 1:  # the device's busy seconds: the mean over the cards
            busy_s = group.mean(busy_s)
        if hasattr(unit_kind, "finish"):
            unit_kind.finish(state, outputs)
        del state, profile
        group.close()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t2 = time.monotonic()
        compared, failed = check(unit_kind, ctx, outputs, spec["limits"])
        units = [round(b - a, 3) for a, b in zip([t0] + ends, ends)]
        print(f"portbench: set-up {setup_s:.3f} s, window {t1 - t0:.3f} s, units {units}, "
              f"check {time.monotonic() - t2:.3f} s", file=sys.stderr)
    except BaseException:
        group.close(failed=True)
        raise
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    for entry in spec["per_layer" if trace else "end_to_end"]:
        reader = load_module(find(Path(root), "portbench", "metrics", entry["name"] + ".py"),
                             "portbench_metric_" + entry["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    result = {
        "correct": all(v <= lim for v, lim in compared.values()),
        "attempted": run.units,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
            "count": run.chips,
            "memory_peak_bytes": run.peak_bytes,
        },
    }
    if run.trace is not None:
        result["device"]["busy_s"] = busy_s
        result["device"]["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in compared.items()}
    return result, compared


def run_rank(run: dict) -> int:
    """Rank r > 0 of a cell on several cards (portbench/ranks.py): the
    set-up, the warm unit and every unit rank 0 calls for, then the
    peak (and, traced, the busy seconds) to rank 0; no result.  Exits
    with an error where this rank loaded JAX or the JAX package."""
    peer = rank_group.Peer(run)
    _, _, traffic, unit_kind = load_cell(run["root"], run["name"], run["overrides"])
    prepare(peer.device)
    cohort = peer.cohort()
    ctx = Context(seed=run["seed"], device=peer.device, workdir=peer.workdir, cohort=cohort,
                  rank=peer.rank, world=peer.world)
    reset_peak(peer.device)
    spans = tracing.Spans(peer.device)
    state = unit_kind.setup(ctx)
    outputs = [unit_kind.unit(state, spans)[1]]  # the warm unit
    profile = tracing.profiler() if run["trace"] else contextlib.nullcontext()
    with profile:
        go = peer.hear()  # the window opens with rank 0's first word
        with torch.profiler.record_function(tracing.WINDOW):
            while go:
                outputs.append(unit_kind.unit(state, spans)[1])
                go = peer.hear()
    peer.largest(rank_group.local_peak(peer.device))
    if run["trace"]:
        trace = tracing.read_trace(profile)
        peer.mean(trace["busy_s"] if trace else 0.0)
    if hasattr(unit_kind, "finish"):
        unit_kind.finish(state, outputs)
    del state
    peer.close()
    loaded = forbidden_loaded()
    if loaded:  # rank 0 then sees this rank end with an error and prints no result
        print(f"portbench: rank {peer.rank} loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    return 0


def check(unit_kind, ctx, outputs, limits):
    """Each compared number over the window's units beside its limit, and
    the count of units that broke a limit.  A number that is not finite,
    or that has no limit, fails.  A reference that takes `outputs` is
    given the window's (to refit only what the window fitted)."""
    if "outputs" in inspect.signature(unit_kind.reference).parameters:
        ref = unit_kind.reference(ctx, outputs=outputs)
    else:
        ref = unit_kind.reference(ctx)
    numbers = {}
    failed = 0
    for out in outputs:
        gaps = unit_kind.gaps([out], ref)
        bad = False
        for k, v in gaps.items():
            limit = limits.get(k, {}).get("limit", -math.inf)
            value = v if math.isfinite(v) else math.inf
            numbers[k] = max(numbers.get(k, 0.0), value)
            bad |= not value <= limit
        failed += bad
    compared = {k: (v, limits.get(k, {}).get("limit", -math.inf)) for k, v in numbers.items()}
    return compared, failed


def forbidden_loaded():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    if rank_group.RANK_ENV in os.environ:  # a rank that rank 0 started
        return run_rank(rank_group.peer_run())
    args = p.parse_args(argv)

    spec = cell_spec(ROOT, args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    print(f"portbench: {nvidia_smi()}", file=sys.stderr)
    with contextlib.redirect_stdout(sys.stderr):  # the program logs to stdout
        result, compared = run_cell(ROOT, args.workload, args.seed, args.seconds,
                                    bool(args.trace), "cuda:0")
    loaded = forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    for k, (v, lim) in compared.items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
