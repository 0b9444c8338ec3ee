"""The rank grid of a multi-device run, and its collectives.

Port of dissect_tpu/runtime/mesh.py.  JAX drives every device of a
`Mesh` from one process; PyTorch's idiom is one process (rank) per
device, launched by `torchrun`, so a MeshContext here is this rank's
view of the run: its rank, the world size, its device, the near-square
(rows, cols) grid the reference's BLACS layout would use
(communicator.cpp:66-103), and the collectives.

Every collective of the port goes through `MeshContext.broadcast`,
`all_reduce` and `all_gather`, the three that both NCCL and gloo
implement, and `reduce_scatter_rows`, so the transport lives here and
nowhere else.  gloo takes CUDA tensors for all four (chip_smoke.py's
mesh phase checks it on the card on every run), so no collective is
staged through host tensors by the port; gloo copies through host
memory itself.

A context without a process group (`backend` None, a world of one) runs
every collective as the identity, so the row-sharded algorithms run
(and are tested) in one process.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

def near_square_factors(n: int) -> Tuple[int, int]:
    """Factor n into (rows, cols) with rows <= cols, rows maximal <= sqrt(n)."""
    rows = 1
    for d in range(1, math.isqrt(n) + 1):
        if n % d == 0:
            rows = d
    return rows, n // rows


def split_bounds(n: int, parts: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) ranges of ceil(n / parts) rows; the last
    ranges absorb the remainder and may be short or empty."""
    per = -(-n // parts) if parts else n
    return [(min(r * per, n), min((r + 1) * per, n)) for r in range(parts)]


@dataclasses.dataclass
class MeshContext:
    """This rank's place in the run, and the run's collectives.

    `shape` is the logical (rows, cols) grid; the row-sharded engines
    (blocked Cholesky, distributed eigensolver, REML) use all `world`
    ranks as one row axis, as JAX's `MeshContext.flat` does."""

    rank: int = 0
    world: int = 1
    device: torch.device = dataclasses.field(default_factory=lambda: torch.device("cpu"))
    shape: Tuple[int, int] = (1, 1)
    backend: Optional[str] = None  # None for a world of one

    @property
    def is_root(self) -> bool:
        return self.rank == 0

    def row_bounds(self, n: int) -> List[Tuple[int, int]]:
        """Every rank's contiguous [start, stop) rows of an n-row array."""
        return split_bounds(n, self.world)

    def local_rows(self, n: int) -> Tuple[int, int]:
        return self.row_bounds(n)[self.rank]

    # --- collectives -------------------------------------------------------
    @staticmethod
    def _in_place(t: torch.Tensor, call) -> torch.Tensor:
        """Run an in-place collective on `t` through a contiguous buffer:
        the transports read memory in order, so a strided tensor (a LAPACK
        result is column-major) would arrive transposed."""
        buf = t if t.is_contiguous() else t.contiguous()
        call(buf)
        if buf is not t:
            t.copy_(buf)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """`t` from rank `src` on every rank (in place; returned)."""
        if self.backend is None:
            return t
        import torch.distributed as dist

        return self._in_place(t, lambda buf: dist.broadcast(buf, src))

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of `t` over the ranks, on every rank (in place; returned)."""
        if self.backend is None:
            return t
        import torch.distributed as dist

        return self._in_place(t, dist.all_reduce)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's `t` (one shape on all ranks), concatenated along
        dim 0 in rank order."""
        if self.backend is None:
            return t
        import torch.distributed as dist

        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(parts, t)
        return torch.cat(parts, dim=0)

    def all_gather_rows(self, local: torch.Tensor, n: int) -> torch.Tensor:
        """The full n-row array from each rank's `row_bounds(n)` rows:
        short shards are padded to one shape for the gather and trimmed."""
        per = -(-n // self.world)
        if local.shape[0] < per:
            pad = local.new_zeros((per - local.shape[0],) + tuple(local.shape[1:]))
            local = torch.cat([local, pad], dim=0)
        return self.all_gather(local)[:n]

    def reduce_scatter_rows(self, blocks: Sequence[torch.Tensor]) -> torch.Tensor:
        """This rank's rows of a sum over the ranks: `blocks[r]` is this
        rank's term of rank r's rows (`row_bounds`, so the blocks may be
        uneven), and rank r gets the sum of every rank's `blocks[r]`:
        one reduce-scatter."""
        if self.backend is None:
            return blocks[0]
        import torch.distributed as dist

        out = torch.empty_like(blocks[self.rank])
        dist.reduce_scatter(out, [b.contiguous() for b in blocks])
        return out

    def row_blocks(self, local: torch.Tensor, n: int):
        """(start, stop, rows) of every rank's block of a row-sharded (n,
        cols) matrix whose rows lie as `row_bounds(n)` places them, each
        broadcast from its owner in turn: beside its own a rank holds one
        block at a time.  Every rank must run the loop to its end."""
        for r, (lo, hi) in enumerate(self.row_bounds(n)):
            if hi == lo:  # an empty shard: nothing to send
                continue
            blk = local if r == self.rank else local.new_empty((hi - lo, local.shape[1]))
            yield lo, hi, self.broadcast(blk, r)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable `obj`, in rank order: the pickles are
        all-gathered as byte tensors (padded to the longest).  Only
        bytes that the ranks of this run wrote are unpickled."""
        if self.backend is None:
            return [obj]
        import pickle

        raw = torch.frombuffer(bytearray(pickle.dumps(obj)), dtype=torch.uint8)
        sizes = self.all_gather(torch.tensor([raw.numel()], device=self.device)).tolist()
        buf = torch.zeros(max(sizes), dtype=torch.uint8, device=self.device)
        buf[: raw.numel()] = raw.to(self.device)
        parts = self.all_gather(buf[None]).cpu()
        return [pickle.loads(parts[r, : sizes[r]].numpy().tobytes()) for r in range(self.world)]

    def barrier(self):
        """A one-element all-reduce: the start-up barrier of a multi-rank run."""
        self.all_reduce(torch.zeros(1, device=self.device))


@dataclasses.dataclass
class RowShards:
    """An (n, n_cols) matrix held in contiguous row blocks over the ranks
    of a MeshContext: `local` holds this rank's rows `ctx.local_rows(n)`.
    The multi-rank GRM stays in this form from its build to the
    row-sharded REML engine and the divide-and-conquer eigensolver, whose
    eigenvectors come back in it, so no rank holds the whole N x N matrix
    unless a step needs it whole (`whole`: the GRM writers, the
    multi-trait slices, the per-SNP refits' eigenbasis; `to_root_host`
    gathers it to rank 0's host memory instead)."""

    local: torch.Tensor
    n: int
    ctx: MeshContext

    ndim = 2

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.local.shape[1])

    @property
    def device(self) -> torch.device:
        return self.local.device

    @property
    def dtype(self) -> torch.dtype:
        return self.local.dtype

    def map(self, fn) -> "RowShards":
        """An elementwise function of the matrix, shard by shard."""
        return RowShards(fn(self.local), self.n, self.ctx)

    def whole(self) -> torch.Tensor:
        """The whole matrix on every rank (an all-gather)."""
        return self.ctx.all_gather_rows(self.local, self.n)

    def to_root_host(self) -> Optional[np.ndarray]:
        """Collective: the whole matrix as a host array on rank 0 and None
        on the others, moved one row block at a time, so no device holds
        it whole."""
        out = None
        for lo, hi, blk in self.ctx.row_blocks(self.local, self.n):
            if self.ctx.rank == 0:
                host = blk.cpu().numpy()
                if out is None:
                    out = np.empty((self.n, self.local.shape[1]), dtype=host.dtype)
                out[lo:hi] = host
        return out

    def take(self, requests) -> List[torch.Tensor]:
        """Collective: for each (rows, cols) of this rank's `requests`,
        the block M[rows][:, cols] (cols None: every column).  Each
        rank's shard is broadcast in turn, so beside its own a rank holds
        one shard at a time; every rank calls this, with any requests."""
        reqs, outs = [], []
        for rows, cols in requests:
            rows = torch.as_tensor(rows, dtype=torch.long, device=self.device)
            if cols is not None:
                cols = torch.as_tensor(cols, dtype=torch.long, device=self.device)
            width = self.local.shape[1] if cols is None else cols.numel()
            reqs.append((rows, cols))
            outs.append(self.local.new_empty((rows.numel(), width)))
        for lo, hi, shard in self.ctx.row_blocks(self.local, self.n):
            for out, (rows, cols) in zip(outs, reqs):
                hit = torch.nonzero((rows >= lo) & (rows < hi)).flatten()
                if hit.numel():
                    blk = shard[rows[hit] - lo]
                    out[hit] = blk if cols is None else blk[:, cols]
        return outs


# --- the run's context (the reference's global `communicator` singleton,
#     main.cpp:51) --------------------------------------------------------------

_MESH_CONTEXT: Optional[MeshContext] = None


def set_mesh_context(ctx: Optional[MeshContext]) -> None:
    global _MESH_CONTEXT
    _MESH_CONTEXT = ctx


def get_mesh_context() -> Optional[MeshContext]:
    return _MESH_CONTEXT


def is_root() -> bool:
    """True on the rank that writes the log and result files (rank 0, or
    any single-process run)."""
    return _MESH_CONTEXT is None or _MESH_CONTEXT.is_root
