"""Run start-up: the torchrun launch, the process group and the mesh.

Port of dissect_tpu/runtime/distributed.py.  The reference constructs
its Communicator before anything else (main.cpp:57); JAX initializes
`jax.distributed` and builds a global Mesh.  The port runs one process
per device under `torchrun` (`python -m torch.distributed.run`), which
sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT:

  * `--mesh auto` means the world size; `--mesh N` must equal it and
    `--mesh RxC` must multiply to it; `--mesh none` keeps
    single-device semantics on every rank (only rank 0 writes);
  * outside a torchrun launch the world is one rank, and a mesh of more
    devices is an error that names the torchrun command;
  * the transport is NCCL when every rank has its own card, and gloo
    when ranks share one device (DISSECT_TPU_TORCH_DEVICE names it for
    all ranks; NCCL refuses two ranks on one GPU) or run on the CPU.

Whether an analysis then uses the mesh is decided by `use_distributed`:
above --distributed-threshold individuals, under --force-distributed,
or when the caller forces it (--parallel-gwas).

Departure from JAX: its `allow_single_device` routes REML on ONE
accelerator through the sharded engine for that engine's on-device
float64 endgame.  Every fit of the port is float64 from its first
iteration, so one device keeps the single-device engine
(`use_distributed` has no such argument).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Tuple

import torch

from dissect_tpu_torch.runtime.device import DEVICE_ENV
from dissect_tpu_torch.runtime.mesh import (
    MeshContext,
    get_mesh_context,
    near_square_factors,
    set_mesh_context,
)

# a rank that waits longer than this in one collective stops with an
# error instead of hanging: a peer raised, or the host is overloaded
COLLECTIVE_TIMEOUT_S = 600

def torchrun_command(n: int) -> str:
    return (
        f"python -m torch.distributed.run --nproc-per-node {n} "
        "-m dissect_tpu_torch --mesh " + str(n) + " ..."
    )


def launch_env() -> Tuple[int, int]:
    """(rank, world size) of a torchrun launch, else (0, 1)."""
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def parse_mesh_spec(spec: Optional[str], world: int) -> Optional[Tuple[int, int]]:
    """--mesh grammar against the launch's world size: 'auto' (all
    ranks, near-square grid — the Communicator's nProcRows x nProcCols
    factoring), 'none' (single-device semantics), 'RxC' or 'N'.
    Returns the (rows, cols) grid, or None for 'none'."""
    if spec is None or spec == "auto":
        return near_square_factors(world)
    if spec == "none":
        return None
    if "x" in spec:
        rows, cols = (int(t) for t in spec.split("x", 1))
    else:
        rows, cols = near_square_factors(int(spec))
    n = rows * cols
    if n == world:
        return rows, cols
    if world == 1:
        raise ValueError(
            f"--mesh {spec} needs {n} ranks, one per device; launch them with "
            + torchrun_command(n)
        )
    raise ValueError(f"--mesh {spec} needs {n} ranks, the launch has {world}")


def choose_backend(device: torch.device) -> str:
    """NCCL when each rank has its own card, else gloo."""
    if device.type == "cuda" and not os.environ.get(DEVICE_ENV, "").strip():
        return "nccl"
    return "gloo"


def startup_runtime(spec: Optional[str], device: torch.device) -> Optional[MeshContext]:
    """Build this rank's MeshContext (and the process group of a
    multi-rank launch) and make it the run's context.  Returns None for
    --mesh none.  A failed init raises: no rank carries on alone."""
    rank, world = launch_env()
    shape = parse_mesh_spec(spec, world)
    if shape is None or world == 1:
        ctx = MeshContext(rank=rank, world=1, device=device)
        set_mesh_context(ctx)
        return None if shape is None else ctx
    import torch.distributed as dist

    backend = choose_backend(device)
    if not dist.is_initialized():
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        dist.init_process_group(
            backend,
            init_method="env://",
            rank=rank,
            world_size=world,
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S),
            **kwargs,
        )
    ctx = MeshContext(
        rank=rank,
        world=world,
        device=device,
        shape=shape,
        backend=backend,
    )
    set_mesh_context(ctx)
    # one start-up barrier while the ranks are interpreter-start-up
    # seconds apart (JAX's _warm_collectives)
    ctx.barrier()
    return ctx


def mesh_summary(ctx: MeshContext) -> str:
    """The log line naming the mesh and its transport."""
    if ctx.backend == "nccl":
        why = "one card per rank"
    elif ctx.device.type == "cuda":
        why = f"the ranks share {ctx.device}"
    else:
        why = "CPU ranks"
    return (
        f"Mesh: {ctx.world} ranks, grid {ctx.shape[0]}x{ctx.shape[1]}, "
        f"transport {ctx.backend} ({why})"
    )


def shutdown_runtime(failed: bool = False) -> None:
    """Forget the run's context.  A failed run also leaves the process
    group, so that peers waiting in a collective fail at once instead of
    at the timeout; a finished one keeps the group for the next run in
    the same process (a group destroyed and initialized again over the
    same launch store reads its predecessor's stale addresses)."""
    set_mesh_context(None)
    if failed:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def use_distributed(args, n_individuals: int, force: bool = False) -> Optional[MeshContext]:
    """The mesh to run this analysis on, or None for the single-device
    path: engaged above --distributed-threshold individuals, under
    --force-distributed, or when the caller forces it (--parallel-gwas,
    the SNP-axis sharding of gwas.cpp:557-687)."""
    ctx = get_mesh_context()
    if ctx is None or ctx.world <= 1:
        return None
    if force or getattr(args, "force_distributed", False):
        return ctx
    if n_individuals >= getattr(args, "distributed_threshold", 16384):
        return ctx
    return None
