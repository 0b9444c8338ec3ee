"""Row-sharded blocked Cholesky, triangular solves and the SPD inverse.

Port of dissect_tpu/linalg/distributed.py, the replacement of the
reference's pdpotrf_/pdpotri_/pdpotrs_ (matrix.cpp:3080-3153).  An
(N, N) matrix is sharded by contiguous row blocks over the ranks of a
MeshContext: rank r holds rows [r N/W, (r + 1) N/W), and N is a multiple
of W * block.  A right-looking blocked factorization runs one Python
loop over elimination steps; each step

  1. broadcasts the b x b diagonal block from the rank that owns it
     (every rank factors it redundantly),
  2. solves the local trailing panel rows against L_kk^T,
  3. all-gathers the panel's trailing rows and updates the trailing
     part of the local rows with local products.

Load balance comes from the interleaved elimination order: step k
eliminates column block sigma(k) = (k mod G) * (n_blocks / G) + k // G,
so with G = W consecutive steps cycle across the ranks' shards and
every rank keeps about the same number of trailing rows (the role of
ScaLAPACK's block-cyclic layout, communicator.cpp:82-96).  Eliminating
an SPD matrix in any symmetric order is exact; the inverse comes back
in the caller's coordinates and log|A| is order-invariant.  With G = 1
the factor is an ordinary lower-triangular matrix.

Each step touches only the trailing rows and columns (the blocks
eliminated after it): a rank's trailing rows are one suffix of its shard
when the interleave is 1 or the world (one suffix per interleave group
otherwise), only those rows of the panel are all-gathered, and the
trailing update is one (n_trail, b) @ (b, run) product per run of
trailing columns.  The factor, trtri and lauum so do about N^3/3, N^3/3
and N^3/2 multiply-adds over the ranks, and the two all-gathers move
about N^2/2 entries each.  (JAX's static shapes make it update and
gather the whole masked (N, b) panel every step; a Python loop of eager
products need not.)

`spd_inverse_logdet_cyclic` runs Cholesky -> in-place trtri -> in-place
lauum over ONE (n_loc, N) buffer.  Everything runs in float64 (the
card's float64 tensor cores; the JAX package's TPU workarounds — the
fused single-loop form and the solve-against-identity branch for small
N — do not apply to a Python loop of eager products).

The products of row-sharded operands whose rows lie as
`MeshContext.row_bounds` places them (even or not) broadcast one rank's
row block at a time (`MeshContext.row_blocks`): A B (`sharded_matmul`),
A B^T (`sharded_matmul_t`) and (X + X^T)/2 (`symmetrized`); the Gram product
A^T B ends row-sharded through one reduce-scatter (`gram_rows`).  No
rank holds more than its own rows and one other rank's block.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dissect_tpu_torch.runtime.mesh import MeshContext


def elimination_steps(n_blocks: int, interleave: int) -> np.ndarray:
    """es[b]: the step at which column block b is eliminated (the inverse
    of sigma): es(b) = (b mod nbpg) * G + b // nbpg."""
    nbpg = n_blocks // interleave
    b = np.arange(n_blocks)
    return (b % nbpg) * interleave + b // nbpg


def sigma(k: int, n_blocks: int, interleave: int) -> int:
    """The column block eliminated at step k."""
    nbpg = n_blocks // interleave
    return (k % interleave) * nbpg + k // interleave


def pick_interleave(n: int, n_dev: int, block: int) -> int:
    """Largest balanced interleave factor: n_dev when the shapes allow
    (n divisible by n_dev * block), else 1."""
    if n_dev > 1 and n % (n_dev * block) == 0 and (n // block) % n_dev == 0:
        return n_dev
    return 1


class _Geometry:
    """Per-rank step bookkeeping of one (N, N) row-sharded operand."""

    def __init__(self, a_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int):
        n_loc, n = a_loc.shape
        if n != n_loc * ctx.world or n_loc % block:
            raise ValueError(
                f"N={n} must be {ctx.world} ranks x {n_loc} rows, a multiple of block {block}"
            )
        self.n_blocks = n // block
        if self.n_blocks % interleave:
            raise ValueError(
                f"n_blocks={self.n_blocks} must be divisible by interleave={interleave}"
            )
        self.ctx, self.block, self.interleave = ctx, block, interleave
        self.n, self.n_loc = n, n_loc
        self.row0 = ctx.rank * n_loc
        # es of each rank's blocks, (world, n_loc / block)
        self.es_blocks = elimination_steps(self.n_blocks, interleave).reshape(ctx.world, -1)
        es_cols = np.repeat(self.es_blocks.ravel(), block)
        dev = a_loc.device
        self.es_rows = torch.as_tensor(es_cols[self.row0 : self.row0 + n_loc], device=dev)
        self.es_cols = torch.as_tensor(es_cols, device=dev)

    def step(self, k: int):
        """(col0, owner rank, local row of the diagonal block, owns)."""
        col0 = sigma(k, self.n_blocks, self.interleave) * self.block
        owner = col0 // self.n_loc
        return col0, owner, col0 - self.row0, owner == self.ctx.rank

    def runs(self, k: int, rank: int, strict: bool = True):
        """The contiguous local row ranges [(start, stop)] of `rank`'s
        blocks eliminated after step k (at or after it unless `strict`):
        one suffix of the shard when the interleave is 1 or the world,
        one suffix per interleave group otherwise."""
        es = self.es_blocks[rank]
        keep = np.concatenate([[False], es > k if strict else es >= k, [False]])
        edges = np.flatnonzero(np.diff(keep.astype(np.int8)))
        return [(int(a) * self.block, int(e) * self.block) for a, e in zip(edges[::2], edges[1::2])]

    def diag_block(self, a_loc: torch.Tensor, k: int) -> torch.Tensor:
        """The b x b diagonal block of step k, broadcast from its owner."""
        col0, owner, k0, owns = self.step(k)
        b = self.block
        if owns:
            blk = a_loc[k0 : k0 + b, col0 : col0 + b].clone()
        else:
            blk = torch.empty((b, b), dtype=a_loc.dtype, device=a_loc.device)
        return self.ctx.broadcast(blk, owner)

    def gather_trailing(self, panel: torch.Tensor, k: int):
        """Every rank's trailing rows (es > k) of an (n_loc, b) panel:
        [(first global row, last global row + 1, rows)], one entry per
        run.  The ranks' packed rows are all-gathered at the longest
        rank's count, so only the trailing part crosses ranks."""
        all_runs = [self.runs(k, r) for r in range(self.ctx.world)]
        counts = [sum(e - s for s, e in runs) for runs in all_runs]
        width = max(counts)
        if width == 0:
            return []
        buf = panel.new_zeros((width, panel.shape[1]))
        off = 0
        for s, e in all_runs[self.ctx.rank]:
            buf[off : off + e - s] = panel[s:e]
            off += e - s
        gathered = self.ctx.all_gather(buf)
        parts = []
        for r, runs in enumerate(all_runs):
            off = r * width
            for s, e in runs:
                parts.append((r * self.n_loc + s, r * self.n_loc + e, gathered[off : off + e - s]))
                off += e - s
        return parts


def distributed_cholesky(
    a_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int = 1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cholesky factor (in place over `a_loc`) and log|A| of a
    row-sharded SPD matrix.  With interleave = 1 the factor is
    lower-triangular; with G > 1 it is triangular in elimination-step
    space (entry (r, c) nonzero iff es(r) >= es(c)) and only the
    interleave-aware solves, trtri and lauum below read it.  A matrix
    that is not positive definite gives a NaN log-determinant."""
    geo = _Geometry(a_loc, ctx, block, interleave)
    b = block
    logdet = torch.zeros((), dtype=a_loc.dtype, device=a_loc.device)
    failed = torch.zeros((), dtype=torch.int32, device=a_loc.device)
    for k in range(geo.n_blocks):
        col0, _, k0, owns = geo.step(k)
        l_kk, info = torch.linalg.cholesky_ex(geo.diag_block(a_loc, k))
        failed = failed + info
        logdet = logdet + 2.0 * torch.sum(torch.log(torch.diagonal(l_kk)))
        if owns:
            a_loc[k0 : k0 + b, col0 : col0 + b] = l_kk
        mine = geo.runs(k, ctx.rank)
        for s, e in mine:
            a_loc[s:e, col0 : col0 + b] = torch.linalg.solve_triangular(
                l_kk.T, a_loc[s:e, col0 : col0 + b], upper=True, left=False
            )
        for c0, c1, rows in geo.gather_trailing(a_loc[:, col0 : col0 + b], k):
            for s, e in mine:
                a_loc[s:e, c0:c1].addmm_(a_loc[s:e, col0 : col0 + b], rows.T, alpha=-1.0)
    a_loc.mul_(geo.es_cols[None, :] <= geo.es_rows[:, None])
    logdet = torch.where(failed > 0, torch.full_like(logdet, float("nan")), logdet)
    return a_loc, logdet


def distributed_triangular_solve(
    l_loc: torch.Tensor, b_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int = 1
) -> torch.Tensor:
    """X with L X = B for a row-sharded factor from `distributed_cholesky`
    (same interleave); B row-sharded (n_loc, nrhs), not modified.  Each
    step the owner of the diagonal block solves it and broadcasts X_k."""
    geo = _Geometry(l_loc, ctx, block, interleave)
    b = block
    b_loc = b_loc.clone()
    x_loc = torch.zeros_like(b_loc)
    for k in range(geo.n_blocks):
        col0, owner, k0, owns = geo.step(k)
        if owns:
            x_k = torch.linalg.solve_triangular(
                l_loc[k0 : k0 + b, col0 : col0 + b], b_loc[k0 : k0 + b], upper=False
            )
            x_loc[k0 : k0 + b] = x_k
        else:
            x_k = torch.empty((b, b_loc.shape[1]), dtype=b_loc.dtype, device=b_loc.device)
        ctx.broadcast(x_k, owner)
        for s, e in geo.runs(k, ctx.rank):
            b_loc[s:e] -= l_loc[s:e, col0 : col0 + b] @ x_k
    return x_loc


def distributed_triangular_solve_t(
    l_loc: torch.Tensor, b_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int = 1
) -> torch.Tensor:
    """X with L^T X = B (backward substitution in elimination order, last
    step first): x_k = L_kk^-T (b_k - sum_{es_j > k} L[j, cols_k]^T x_j),
    the sum a local (b, n_trailing) x (n_trailing, nrhs) product
    all-reduced."""
    geo = _Geometry(l_loc, ctx, block, interleave)
    b = block
    x_loc = torch.zeros_like(b_loc)
    for k in reversed(range(geo.n_blocks)):
        col0, _, k0, owns = geo.step(k)
        acc = b_loc.new_zeros((b, b_loc.shape[1]))
        for s, e in geo.runs(k, ctx.rank):
            acc.addmm_(l_loc[s:e, col0 : col0 + b].T, x_loc[s:e])
        acc = ctx.all_reduce(acc)
        if owns:
            x_loc[k0 : k0 + b] = torch.linalg.solve_triangular(
                l_loc[k0 : k0 + b, col0 : col0 + b].T, b_loc[k0 : k0 + b] - acc, upper=True
            )
    return x_loc


def distributed_trtri(
    l_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int = 1
) -> torch.Tensor:
    """W = L^-1 in place over a row-sharded factor (the pdtrtri step of
    pdpotri_).  LAPACK's blocked dtrtri, last step first: the blocks with
    es > k already hold their inverse, so W[trail, k] = -W[trail, trail]
    L[trail, k] L_kk^-1, and the diagonal block inverts in place.  One
    all-gather of the panel's trailing rows per step."""
    geo = _Geometry(l_loc, ctx, block, interleave)
    b = block
    eye = torch.eye(b, dtype=l_loc.dtype, device=l_loc.device)
    for k in reversed(range(geo.n_blocks)):
        col0, _, k0, owns = geo.step(k)
        l_kk = geo.diag_block(l_loc, k)
        parts = geo.gather_trailing(l_loc[:, col0 : col0 + b], k)
        for s, e in geo.runs(k, ctx.rank):
            upd = l_loc.new_zeros((e - s, b))
            for c0, c1, rows in parts:
                upd.addmm_(l_loc[s:e, c0:c1], rows)
            l_loc[s:e, col0 : col0 + b] = torch.linalg.solve_triangular(
                l_kk, -upd, upper=False, left=False
            )
        if owns:
            l_loc[k0 : k0 + b, col0 : col0 + b] = torch.linalg.solve_triangular(
                l_kk, eye, upper=False
            )
    return l_loc


def distributed_lauum_full(
    w_loc: torch.Tensor, ctx: MeshContext, block: int, interleave: int = 1
) -> torch.Tensor:
    """R = W^T W, both triangles, in place over a row-sharded inverse
    factor from `distributed_trtri` (the pdlauum step of pdpotri_).  Row
    panels in elimination order: R[rows_k, :] = W[es >= k, cols_k]^T
    W[es >= k, :] reads only rows not yet overwritten; one (b, N)
    all-reduce per step."""
    geo = _Geometry(w_loc, ctx, block, interleave)
    b = block
    for k in range(geo.n_blocks):
        col0, _, k0, owns = geo.step(k)
        r_panel = w_loc.new_zeros((b, geo.n))
        for s, e in geo.runs(k, ctx.rank, strict=False):
            r_panel.addmm_(w_loc[s:e, col0 : col0 + b].T, w_loc[s:e])
        r_panel = ctx.all_reduce(r_panel)
        if owns:
            w_loc[k0 : k0 + b] = r_panel
    return w_loc


def spd_inverse_logdet_cyclic(
    v_loc: torch.Tensor, ctx: MeshContext, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A^-1 rows, log|A|) of a row-sharded SPD matrix in the caller's
    coordinates, in place over `v_loc`: interleaved blocked Cholesky ->
    in-place trtri -> in-place full lauum (pdpotrf_ + pdpotri_)."""
    g = pick_interleave(v_loc.shape[1], ctx.world, block)
    l_loc, logdet = distributed_cholesky(v_loc, ctx, block, interleave=g)
    w_loc = distributed_trtri(l_loc, ctx, block, interleave=g)
    return distributed_lauum_full(w_loc, ctx, block, interleave=g), logdet


def spd_solve_cyclic(
    a_loc: torch.Tensor, b_loc: torch.Tensor, ctx: MeshContext, block: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A^-1 B rows, log|A|) via the interleaved factorization (in place
    over `a_loc`) and forward + backward blocked solves."""
    g = pick_interleave(a_loc.shape[1], ctx.world, block)
    l_loc, logdet = distributed_cholesky(a_loc, ctx, block, interleave=g)
    y = distributed_triangular_solve(l_loc, b_loc, ctx, block, interleave=g)
    return distributed_triangular_solve_t(l_loc, y, ctx, block, interleave=g), logdet


def sharded_matmul(a_loc: torch.Tensor, b_loc: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Local rows of A @ B for row-sharded A (n_loc, K) and B (K, n_b),
    B's rows placed by `ctx.row_bounds(K)` (equal blocks when the world
    divides K, else the last blocks short): each rank's block of B is
    broadcast in turn and multiplied into the matching column block of
    A, so no rank ever holds more than one block of B (SUMMA over the
    row axis)."""
    out = a_loc.new_zeros((a_loc.shape[0], b_loc.shape[1]))
    for lo, hi, blk in ctx.row_blocks(b_loc, a_loc.shape[1]):
        out.addmm_(a_loc[:, lo:hi], blk)
    return out


def sharded_matmul_t(a_loc: torch.Tensor, b_loc: torch.Tensor, n_b: int, ctx: MeshContext) -> torch.Tensor:
    """Local rows of A @ B^T for row-sharded A (n_loc, K) and B (n_b, K):
    B's blocks broadcast in turn, each giving a column block of the
    result."""
    out = a_loc.new_empty((a_loc.shape[0], n_b))
    for lo, hi, blk in ctx.row_blocks(b_loc, n_b):
        out[:, lo:hi] = a_loc @ blk.T
    return out


def symmetrized(x_loc: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Local rows of (X + X^T) / 2 for a row-sharded square X: the rows
    of X^T are X's columns, taken from each rank's block in turn."""
    r0, r1 = ctx.local_rows(x_loc.shape[1])
    out = 0.5 * x_loc
    for lo, hi, blk in ctx.row_blocks(x_loc, x_loc.shape[1]):
        out[:, lo:hi].add_(blk[:, r0:r1].T, alpha=0.5)
    return out


def gram_rows(a_loc: torch.Tensor, b_loc: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    """Local rows (`ctx.local_rows(k)`) of A^T B for row-sharded A (m, k)
    and B (m, j): each rank forms its term of every rank's rows, and one
    reduce-scatter sums them, so no rank holds the whole k x j product."""
    k = a_loc.shape[1]
    return ctx.reduce_scatter_rows([a_loc[:, lo:hi].T @ b_loc for lo, hi in ctx.row_bounds(k)])
