"""The control of a cell's correctness check, on the card at the cell's
own size: the plain reference put in the program's place, one precision
below what the configuration states (TF32 products for float32 stages,
float32 for float64 ones), held against the float64 reference by the
cell's own comparison.  Its numbers set the upper readings of the
cell's limits (portbench/limits/<cell>.json); it has to come out not
correct.  The benchmark's runs do not run it.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import tempfile
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH_DIR.parent))

import torch  # noqa: E402

from portbench import run as harness  # noqa: E402
from portbench.cohort import make_cohort  # noqa: E402


def control_readings(root, name, seed, device, overrides=None):
    """{number: control's value} and {number: limit} for one seed."""
    spec = harness.cell_spec(Path(root), name)
    config = {**spec["config"], **(overrides or {})}
    unit_kind = harness.load_module(
        harness.find(Path(root), "portbench", "units", spec["traffic"]["unit"] + ".py"),
        "portbench_unit_" + spec["traffic"]["unit"])
    with tempfile.TemporaryDirectory(prefix="portbench-control-") as tmp:
        cohort = make_cohort(config, seed, Path(tmp) / "cohort", device,
                             n_traits=spec["traffic"].get("traits", 1))
        ctx = harness.Context(seed=seed, device=torch.device(device), workdir=Path(tmp),
                              cohort=cohort)
        ref = unit_kind.reference(ctx)
        low = unit_kind.reference(ctx, control=True)
    numbers = unit_kind.gaps(unit_kind.as_output(low), ref)
    limits = {k: spec["limits"].get(k, {}).get("limit", -math.inf) for k in numbers}
    return numbers, limits


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in (int(s) for s in args.seeds.split(",")):
        numbers, limits = control_readings(harness.ROOT, args.workload, seed, "cuda:0")
        failed = [k for k, v in numbers.items() if not v <= limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numbers,
                          "limits": limits, "fails": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
