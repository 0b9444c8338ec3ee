"""Peak device memory of versions of the D&C eigensolver (dissect_tpu_torch/linalg/dc_eigen.py) on two ranks sharing one card.

    python3 eigh_memory.py [--n N,N,...] NAME=DIR ...    # from the repository root

Each DIR holds a version of the `dissect_tpu_torch` package (this tree
is ".", a parent commit's is unpacked by `git archive <commit>
dissect_tpu_torch | tar -x -C DIR`).  For each version, one launch of
two torchrun ranks (gloo, both on cuda:0, as chip_smoke.py's mesh phase
runs them) builds at each N the same float32 GRM-like matrix Z Z^T / M
(Z an N x 2N standard normal draw, seeded) and calls that version's
`distributed_eigh` on it as its `Kernel.diagonalize` did: a version
whose solver takes RowShards gets each rank's float32 rows; an older one
gets the whole float32 matrix on every rank beside the rows that the
kernel keeps.  The call is measured as chip_smoke.py's `measured_solver`
measures it: the memory allocated at entry, then the peak of
`torch.cuda.max_memory_allocated` inside the call (the entry's tensors
included), each in GB and in planes of N^2 * 8 bytes, and the call's
seconds.  Rank 0 holds the eigenvalues against `torch.linalg.eigvalsh`
of the same matrix in float64.  Prints one JSON line per version, rank
and N, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
RANKS = 2
SEED = 20240601


def worker(plan_path):
    """One rank: measure the version's solver at every N of the plan and
    write this rank's records to <plan>.rank<r>.json."""
    plan = json.loads(Path(plan_path).read_text())
    sys.path.insert(0, str(Path(plan["code"]).resolve()))
    import torch

    from dissect_tpu_torch.linalg import dc_eigen
    from dissect_tpu_torch.runtime.distributed import startup_runtime
    from dissect_tpu_torch.runtime.dtypes import configure_precision
    from dissect_tpu_torch.runtime.mesh import RowShards

    configure_precision()
    device = torch.device("cuda:0")
    torch.cuda.set_device(device)
    ctx = startup_runtime(str(RANKS), device)
    takes_rows = "RowShards" in str(inspect.signature(dc_eigen.distributed_eigh).parameters["a"])
    records = []
    for n in plan["n"]:
        gen = torch.Generator(device=device).manual_seed(SEED + n)
        z = torch.randn((n, 2 * n), generator=gen, dtype=torch.float32, device=device)
        grm = (z @ z.T) / (2 * n)
        del z
        lo, hi = ctx.local_rows(n)
        rows = RowShards(grm[lo:hi].clone(), n, ctx)
        whole = None if takes_rows else grm
        del grm
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        at_entry = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        w, v = dc_eigen.distributed_eigh(rows if takes_rows else whole, ctx=ctx)
        torch.cuda.synchronize(device)
        seconds = time.monotonic() - t0
        peak = torch.cuda.max_memory_allocated(device)
        del v
        plane = n * n * 8
        rec = {"version": plan["name"], "rank": ctx.rank, "n": n,
               "input": "rows" if takes_rows else "whole", "seconds": seconds,
               "peak_gb": peak / 1e9, "at_entry_gb": at_entry / 1e9,
               "peak_planes": peak / plane, "at_entry_planes": at_entry / plane,
               "interior_planes": (peak - at_entry) / plane}
        whole = rows.whole().to(torch.float64)  # collective: every rank
        del rows
        if ctx.rank == 0:
            ref = torch.linalg.eigvalsh(whole)
            rec["eigenvalue_err"] = float(torch.max(torch.abs(w.to(ref) - ref)) / torch.max(ref))
        del whole, w
        torch.cuda.empty_cache()
        records.append(rec)
    Path(f"{plan_path}.rank{ctx.rank}.json").write_text(json.dumps(records))
    import torch.distributed as dist

    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=lambda s: [int(n) for n in s.split(",")], default=[4_096, 10_000])
    ap.add_argument("--timeout", type=float, default=1_500.0)
    ap.add_argument("versions", nargs="+", metavar="NAME=DIR")
    args = ap.parse_args()
    # the ranks share cuda:0, so the port's runtime picks gloo
    env = dict(os.environ, DISSECT_TPU_TORCH_DEVICE="cuda:0", OMP_NUM_THREADS="4")
    failed = False
    with tempfile.TemporaryDirectory(dir=REPO) as tmp:
        for spec in args.versions:
            name, code = spec.split("=", 1)
            plan_path = Path(tmp) / f"{name}.json"
            plan_path.write_text(json.dumps({"name": name, "code": str(Path(code).resolve()),
                                             "n": args.n}))
            proc = subprocess.run(
                [sys.executable, "-m", "torch.distributed.run", "--standalone",
                 "--nproc-per-node", str(RANKS), str(Path(__file__).resolve()), "--worker",
                 str(plan_path)],
                cwd=str(REPO), env=env, capture_output=True, text=True, timeout=args.timeout,
                stdin=subprocess.DEVNULL)
            if proc.returncode != 0:
                failed = True
                print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
                continue
            for r in range(RANKS):
                for rec in json.loads(Path(f"{plan_path}.rank{r}.json").read_text()):
                    print(json.dumps(rec), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--worker":
        worker(sys.argv[2])
    else:
        main()
