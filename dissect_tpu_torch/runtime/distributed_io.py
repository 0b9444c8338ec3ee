"""Multi-rank data movement: SNP-row shards, gathers, the sharded GRM.

Port of dissect_tpu/runtime/distributed_io.py.  The reference reads
BED block-rows per MPI process and scatters them over the BLACS grid
(readBEDFile, genotype.cpp:548-787); JAX has every host memmap the same
.bed and decode only its own SNP rows.  Here every rank opens the same
genotype file and decodes only its own rows:

  * `shard_snp_rows` / `snp_row_index`: a rank's slice of an (M, ...)
    per-SNP block, M padded to a multiple of the world size by
    repeating the last row (a well-conditioned duplicate, not a
    singular zero row), as JAX's `shard_snp_rows` pads;
  * `to_host`: the all-gather back to the full array, trimmed to M;
  * `stream_grm_sharded`: each rank decodes its SNP rows of each chunk,
    the chunk is all-gathered (the first time genotypes cross ranks),
    and each rank adds its contiguous row block of Z^T Z and O^T O into
    an (n_loc, N) float32 shard.  JAX computes this product with XLA's
    dot, not its Pallas kernel (dissect_tpu/linalg/syrk.py:57-68), so
    the shard's product is `torch.matmul` in float32 with TF32 off
    (runtime/dtypes.py:configure_precision); the 0/1 counts are exact.

Departure from JAX: the GRM is row-sharded over all ranks, not tiled
P('i', 'j') over the grid.  Every entry is the same sum; only which
rank holds it differs.  The dispatcher keeps the shards as RowShards
(runtime/mesh.py), 8 N^2 / world bytes a rank for the kernel and its
counts, into the row-sharded REML engine; a step that needs the GRM
whole gathers it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from dissect_tpu_torch.linalg.syrk import standardize_chunk
from dissect_tpu_torch.runtime.mesh import MeshContext


def snp_shard_bounds(n_snps: int, process_index: int, process_count: int) -> Tuple[int, int]:
    """The [start, stop) SNP-row range rank `process_index` is responsible
    for: contiguous ceil-sized shards, the last ranks absorb the
    remainder (the block-row segments of genotype.cpp:639-707)."""
    per = math.ceil(n_snps / process_count)
    start = min(process_index * per, n_snps)
    return start, min(start + per, n_snps)


def snp_row_index(m: int, ctx: MeshContext) -> np.ndarray:
    """Global row of each of this rank's M_pad / world rows, where M is
    padded to a multiple of the world by repeating row M - 1."""
    per = -(-m // ctx.world)
    rows = np.arange(ctx.rank * per, (ctx.rank + 1) * per)
    return np.minimum(rows, m - 1)


def shard_snp_rows(z, ctx: MeshContext):
    """This rank's rows of an (M, ...) per-SNP block (numpy or tensor),
    padded as `snp_row_index` says.  Returns (local rows, M)."""
    m = z.shape[0]
    idx = snp_row_index(m, ctx)
    if isinstance(z, torch.Tensor):
        return z[torch.as_tensor(idx, device=z.device)], m
    return np.asarray(z)[idx], m


def to_host(local, m: int, ctx: Optional[MeshContext]) -> np.ndarray:
    """The full (M, ...) host array from every rank's `shard_snp_rows`
    slice (an all-gather, trimmed to M); float64 for float input.
    Without a context the local rows are the whole array."""
    t = torch.as_tensor(local)
    if ctx is not None and ctx.world > 1:
        flag = t.dtype == torch.bool  # gathered as bytes
        t = ctx.all_gather(t.to(device=ctx.device, dtype=torch.uint8 if flag else t.dtype))[:m]
        t = t.bool() if flag else t
    out = t.detach().cpu().numpy()
    return out.astype(np.float64) if out.dtype.kind == "f" else out


def gather_snp_fields(res, m: int, ctx: MeshContext):
    """A per-SNP results dataclass from this rank's `shard_snp_rows`
    slice to all M SNPs: every array field that leads with the local
    row count is all-gathered and trimmed (in place; returned)."""
    n_local = -(-m // ctx.world)
    for field in dataclasses.fields(res):
        v = getattr(res, field.name)
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n_local:
            setattr(res, field.name, to_host(v, m, ctx).astype(v.dtype, copy=False))
    return res


def decode_snp_shard(data, start: int, stop: int, ctx: MeshContext) -> torch.Tensor:
    """This rank's padded rows of the chunk [start, stop) of `data`,
    decoded from the genotype file alone, on the data's device (K4 on the
    rank's card for PLINK data)."""
    idx = start + snp_row_index(stop - start, ctx)
    lo, hi = int(idx[0]), int(idx[-1]) + 1
    rows = data.decode_rows(lo, hi)
    return rows[torch.as_tensor(idx - lo, device=rows.device)]


def stream_grm_sharded(
    data,
    ctx: MeshContext,
    mean: np.ndarray,
    inv_std: np.ndarray,
    chunk_size: int = 2048,
    flat_normalization: bool = False,
):
    """This rank's rows `ctx.local_rows(N)` of the float32 GRM and its
    SNP counts, streamed over SNP chunks (kernel.cpp:92-109 on the grid).

    `mean`, `inv_std`: the per-SNP standardization (monomorphic SNPs
    already removed).  Each global chunk holds `chunk_size` rows rounded
    down to a multiple of the world; a rank decodes its contiguous
    share (padded with all-missing rows past the end), the shares are
    all-gathered, and the rank multiplies its column block of Z by Z."""
    n, m = data.n_individuals, data.n_snps
    device = ctx.device
    r0, r1 = ctx.local_rows(n)
    kernel = torch.zeros((r1 - r0, n), dtype=torch.float32, device=device)
    counts = torch.zeros_like(kernel)
    per = max(chunk_size // ctx.world, 1)
    g = per * ctx.world
    for start in range(0, m, g):
        s = min(start + ctx.rank * per, m)
        e = min(s + per, m)
        block = data.decode_rows(s, e).to(device)  # int8 hard calls or float dosages
        rows = torch.full((per, n), -1, dtype=block.dtype, device=device)
        if block.is_floating_point():
            rows.fill_(float("nan"))
        rows[: e - s] = block
        dosage = ctx.all_gather(rows)
        stop = min(start + g, m)
        mu, istd = np.zeros(g), np.ones(g)  # the padding rows are all missing
        mu[: stop - start], istd[: stop - start] = mean[start:stop], inv_std[start:stop]
        z, observed = standardize_chunk(
            dosage, torch.as_tensor(mu, device=device), torch.as_tensor(istd, device=device),
            torch.float32,
        )
        kernel += z[:, r0:r1].T @ z
        counts += observed[:, r0:r1].T @ observed
    if flat_normalization:
        counts = torch.full_like(counts, float(m))
    normalized = kernel / torch.where(counts == 0, torch.ones_like(counts), counts)
    return normalized, counts
