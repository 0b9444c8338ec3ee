"""A cell on more than one card: one process, a rank, a card.

The harness's own process is rank 0, on the first device.  For a cell
whose `chips` is above 1 it starts ranks 1 .. chips - 1 from the same
script (`python portbench/run.py`), rank r on `cuda:r` (or on the CPU,
where rank 0 is), with the environment torchrun gives (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and `PORTBENCH_RANK`, which names
the run for them.  The unit's set-up builds the process group through
the program's own start-up, as the CLI does.  From there the ranks keep
in lockstep:

* rank 0 draws the cohort and writes it once; the others wait until its
  description (`cohort.pkl`, written last, by a rename) is there and
  read the files it names;
* every rank runs the set-up, the warm unit and each unit of the window:
  before each unit of the window rank 0 says, in one broadcast over the
  group, whether to run another, so every rank runs the same units;
* after the window the ranks reduce their peaks (and busy seconds) over
  the group, tear the group down, and all but rank 0 exit, with an error
  where one loaded JAX or the JAX package; rank 0 alone checks and
  prints.

A rank that ends before rank 0 has closed the run ends rank 0 at once,
with no result (a watchdog thread).  No rank outlives rank 0: it kills
the others on every way out, and each dies with it.

With one card there is no process and no group: `Solo` answers every
call as the identity.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import pickle
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import torch

RANK_ENV = "PORTBENCH_RANK"
COHORT_FILE = "cohort.pkl"
# a rank waits this long for rank 0's cohort, and rank 0 this long for
# the ranks to exit once the group is down
WAIT_S = 600.0
EXIT_WAIT_S = 120.0
# rank 0's exit code when another rank ended first
RANK_FAILED = 5
LAUNCH_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def local_peak(device: torch.device) -> int:
    """This process's peak of allocated device memory since its reset."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when its parent ends (Linux),
    and exit now if the parent has already ended."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        sys.exit(RANK_FAILED)


class Solo:
    """One card: no other process and no group."""

    rank = 0
    world = 1

    def publish(self, cohort) -> None:
        pass

    def tell(self, go: bool) -> None:
        pass

    def largest(self, value: int) -> int:
        return value

    def mean(self, value: float) -> float:
        return value

    def close(self, failed: bool = False) -> None:
        pass


class _Group:
    """The collectives of the harness itself, over the group the
    program's start-up built: small integers and floats, on the card
    under NCCL, on the host under gloo."""

    rank: int
    world: int
    device: torch.device

    def _flag_device(self) -> torch.device:
        import torch.distributed as dist

        return self.device if dist.get_backend() == "nccl" else torch.device("cpu")

    def _broadcast(self, value: int) -> int:
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64, device=self._flag_device())
        dist.broadcast(t, src=0)
        return int(t.item())

    def largest(self, value: int) -> int:
        """The largest `value` over the ranks, on every rank (rank 0 logs
        each rank's)."""
        import torch.distributed as dist

        t = torch.tensor([int(value)], dtype=torch.int64, device=self._flag_device())
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        values = [int(v.item()) for v in parts]
        if self.rank == 0:
            print(f"portbench: peak bytes by rank {values}", file=sys.stderr, flush=True)
        return max(values)

    def mean(self, value: float) -> float:
        """The mean of `value` over the ranks, on every rank."""
        import torch.distributed as dist

        t = torch.tensor([float(value)], dtype=torch.float64, device=self._flag_device())
        dist.all_reduce(t)
        return t.item() / self.world

    def _leave_group(self) -> None:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


class Ranks(_Group):
    """Rank 0's side: it starts the other ranks, watches them, speaks
    first before each unit and closes the run."""

    def __init__(self, root: Path, name: str, seed: int, world: int, device: torch.device,
                 workdir: Path, overrides=None, trace: bool = False):
        self.rank, self.world, self.device = 0, world, device
        self.workdir = workdir
        self.closing = False
        self.saved = {k: os.environ.get(k) for k in LAUNCH_KEYS}
        launch = {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
                  "MASTER_PORT": str(free_port())}
        os.environ.update(launch, RANK="0", LOCAL_RANK="0")
        run = {"root": str(root), "name": name, "seed": seed, "device": device.type,
               "workdir": str(workdir), "overrides": overrides or {}, "trace": trace,
               "parent": os.getpid()}
        script = Path(__file__).resolve().parent / "run.py"
        self.procs = []
        try:
            for r in range(1, world):
                env = {**os.environ, **launch, "RANK": str(r), "LOCAL_RANK": str(r),
                       RANK_ENV: json.dumps(run)}
                # a rank's stdout is the program's log: onto stderr, so that
                # rank 0's result stays the last line of stdout
                self.procs.append(subprocess.Popen([sys.executable, str(script)], env=env,
                                                   stdout=2, cwd=os.getcwd()))
        except BaseException:
            self.close(failed=True)
            raise
        self.watchdog = threading.Thread(target=self._watch, name="portbench-ranks",
                                         daemon=True)
        self.watchdog.start()

    def _watch(self) -> None:
        """End rank 0, with no result, as soon as another rank ends before
        the run is closed: rank 0 may be waiting for it in a collective."""
        while not self.closing:
            for r, p in enumerate(self.procs, start=1):
                code = p.poll()
                if code is not None and not self.closing:
                    print(f"portbench: rank {r} exited with code {code} before the run "
                          "was closed; no result", file=sys.stderr, flush=True)
                    self._kill()
                    shutil.rmtree(self.workdir, ignore_errors=True)
                    os._exit(RANK_FAILED)
            time.sleep(0.2)

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def publish(self, cohort) -> None:
        """Write what the other ranks need of the cohort: its files and
        traits, without the genotype arrays only the reference reads."""
        light = dataclasses.replace(cohort, packed=None, probs=None)
        tmp = self.workdir / (COHORT_FILE + ".tmp")
        tmp.write_bytes(pickle.dumps(light))
        tmp.rename(self.workdir / COHORT_FILE)

    def tell(self, go: bool) -> None:
        """Tell the other ranks whether to run another unit."""
        self._broadcast(int(go))

    def close(self, failed: bool = False) -> None:
        """Leave the group and wait for the other ranks to exit (kill them
        on failure).  Raises if one did not end cleanly."""
        if self.closing:
            return
        self.closing = True
        try:
            if failed:
                self._kill()
                return
            self._leave_group()
            bad = []
            for r, p in enumerate(self.procs, start=1):
                try:
                    code = p.wait(timeout=EXIT_WAIT_S)
                except subprocess.TimeoutExpired:
                    code = "none (killed)"
                if code != 0:
                    bad.append(f"rank {r}: {code}")
            if bad:
                self._kill()
                raise RuntimeError("ranks did not end cleanly: " + ", ".join(bad))
        finally:
            for k, v in self.saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v


class Peer(_Group):
    """Rank r's side, r > 0, in a process rank 0 started."""

    def __init__(self, run: dict):
        self.rank = int(os.environ["RANK"])
        self.world = int(os.environ["WORLD_SIZE"])
        # card r where rank 0 is on a card, else the CPU
        on_card = run["device"] == "cuda"
        self.device = torch.device("cuda", self.rank) if on_card else torch.device("cpu")
        self.workdir = Path(run["workdir"])

    def cohort(self):
        """Rank 0's cohort, once it has written it."""
        path = self.workdir / COHORT_FILE
        deadline = time.monotonic() + WAIT_S
        while not path.exists():
            if time.monotonic() > deadline:
                raise TimeoutError(f"rank {self.rank}: no cohort from rank 0 in {WAIT_S} s")
            time.sleep(0.1)
        return pickle.loads(path.read_bytes())

    def hear(self) -> bool:
        """Rank 0's word: whether to run another unit."""
        return bool(self._broadcast(0))

    def close(self) -> None:
        self._leave_group()


def start(root: Path, name: str, seed: int, chips: int, device: torch.device, workdir: Path,
          overrides=None, trace: bool = False):
    """Rank 0's handle on the run: `Solo` for one card, else `Ranks`,
    with the other ranks started."""
    if chips <= 1:
        return Solo()
    return Ranks(root, name, seed, chips, device, workdir, overrides, trace)


def peer_run() -> dict:
    """The run this process is a rank of (rank 0 set `PORTBENCH_RANK`)."""
    run = json.loads(os.environ[RANK_ENV])
    die_with_parent(run["parent"])
    return run
