"""K1 — the fused int8-standardize + triangle-only dual syrk — K2 — the
triangle-only syrk of a float operand — and the packed lower-triangle
tile layout both write.

Port of dissect_tpu/linalg/pallas_syrk.py (`grm_fused_triangle_update`,
`syrk_triangle_packed`, `syrk_triangle`, `_pair_maps`, `packed_shape`,
`unpack_triangle`).  The packed layout is kept at the boundary:
(T*BN, BN) float32 buffers, tile t = output tile (imap[t], jmap[t]) in
the order (0,0), (1,0), (1,1), (2,0), ..., so the port's buffers compare
tile for tile with the JAX kernels' at the same `block_n`.  BN is a
layout unit here; the CUDA kernels (csrc/grm_syrk.cu, csrc/syrk_packed.cu)
choose their own 128 x 128 work tiles inside it.

Each wrapper launches its CUDA kernel for tensors on the card and runs
its plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from dissect_tpu_torch.linalg.syrk import grm_update
from dissect_tpu_torch.runtime import cuda_lib


def _pair_maps(nt: int):
    pairs = [(i, j) for i in range(nt) for j in range(i + 1)]
    imap = np.asarray([p[0] for p in pairs], dtype=np.int64)
    jmap = np.asarray([p[1] for p in pairs], dtype=np.int64)
    return pairs, imap, jmap


def packed_shape(n: int, block_n: int = 512) -> Tuple[int, int]:
    """Shape of the packed tile buffer for an n-column operand."""
    nt = -(-n // block_n)
    return (nt * (nt + 1) // 2 * block_n, block_n)


def pack_triangle(full: torch.Tensor, block_n: int = 512) -> torch.Tensor:
    """Full (n, n) -> packed (T*BN, BN) lower-triangle tiles (zero-padded
    to whole tiles); the inverse of `unpack_triangle`."""
    n = full.shape[0]
    nt = -(-n // block_n)
    np_ = nt * block_n
    if np_ != n:
        full = torch.nn.functional.pad(full, (0, np_ - n, 0, np_ - n))
    _, imap, jmap = _pair_maps(nt)
    tiles4 = full.reshape(nt, block_n, nt, block_n).permute(0, 2, 1, 3)
    idx_i = torch.as_tensor(imap, device=full.device)
    idx_j = torch.as_tensor(jmap, device=full.device)
    return tiles4[idx_i, idx_j].reshape(-1, block_n)


def unpack_triangle(tiles: torch.Tensor, n: int, block_n: int = 512) -> torch.Tensor:
    """(T*BN, BN) packed lower-triangle tiles -> full symmetric (n, n), as
    one gather over the packed tile index."""
    nt = -(-n // block_n)
    np_ = nt * block_n
    pairs, _, _ = _pair_maps(nt)
    tiles = tiles.reshape(len(pairs), block_n, block_n)
    tile_idx = np.zeros((nt, nt), dtype=np.int64)
    needs_t = np.zeros((nt, nt), dtype=bool)
    for ti, (i, j) in enumerate(pairs):
        tile_idx[i, j] = ti
        tile_idx[j, i] = ti
        needs_t[j, i] = i != j
    full4 = tiles[torch.as_tensor(tile_idx, device=tiles.device)]
    full4 = torch.where(
        torch.as_tensor(needs_t, device=tiles.device)[:, :, None, None],
        full4.transpose(2, 3),
        full4,
    )
    sym = full4.permute(0, 2, 1, 3).reshape(np_, np_)
    return sym[:n, :n]


def plain_grm_fused_triangle_update(
    dosage, mean, inv_std, kernel_tiles, counts_tiles, block_n: int = 512
):
    """The plain version of K1: the full-square float32 step
    (`grm_update`: Z^T Z and O^T O), its lower tiles gathered and added
    in place."""
    n = dosage.shape[1]
    zero = torch.zeros((n, n), dtype=torch.float32, device=dosage.device)
    kern, cnt = grm_update(zero, zero, dosage, mean, inv_std)
    kernel_tiles += pack_triangle(kern, block_n)
    counts_tiles += pack_triangle(cnt, block_n)
    return kernel_tiles, counts_tiles


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, dosage on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# K1's launch geometry (csrc/grm_syrk.cu): 128 x 128 output sub-tiles,
# 32 SNP rows per shared-memory stage; a block computes one sub-tile of
# one product.
K1_SUB_TILE = 128
K1_ROWS_PER_STAGE = 32
K1_ROLE_Z, K1_ROLE_COUNTS = 0, 1


def grm_stages(m: int) -> int:
    """K1's shared-memory stages over an m-row chunk (the last one ragged,
    its missing rows masked as missing genotypes)."""
    return -(-m // K1_ROWS_PER_STAGE)


def grm_work_items(n: int, block_n: int) -> np.ndarray:
    """K1's work list: one int32 row (t, ti, tj, a0, b0, role, mirror, 0)
    per thread block, i.e. per 128 x 128 sub-tile (local offsets a0, b0)
    of packed tile t = (ti, tj) and per product (role: Z^T Z on the FMA
    pipes, or the O^T O counts on the int8 tensor cores).  The Z^T Z items
    come first: they are the long ones.

    Sub-tiles wholly past n are left out: they would add zeros.  On a
    diagonal tile only the sub-tiles with a0 >= b0 are listed; those with
    a0 > b0 carry mirror = 1 and also add their transpose at (b0, a0), so
    every entry of every packed tile is added exactly once per product."""
    nt = -(-n // block_n)
    sub = range(0, block_n, K1_SUB_TILE)
    _, imap, jmap = _pair_maps(nt)
    items = [
        (t, ti, tj, a0, b0, role, int(ti == tj and a0 > b0), 0)
        for role in (K1_ROLE_Z, K1_ROLE_COUNTS)
        for t, (ti, tj) in enumerate(zip(imap.tolist(), jmap.tolist()))
        for a0 in sub
        for b0 in sub
        if ti * block_n + a0 < n and tj * block_n + b0 < n and not (ti == tj and a0 < b0)
    ]
    return np.asarray(items, dtype=np.int32).reshape(-1, 8)


_WORK_CACHE = {}


def _work_on(device, n, block_n):
    key = (str(device), n, block_n)
    work = _WORK_CACHE.get(key)
    if work is None:
        work = torch.as_tensor(grm_work_items(n, block_n)).to(device)
        _WORK_CACHE[key] = work
    return work


def grm_fused_triangle_update(
    dosage, mean, inv_std, kernel_tiles, counts_tiles, block_n: int = 512
):
    """One streaming-GRM step: adds the lower-triangle tiles of Z^T Z and
    O^T O of the int8 chunk (-1 = missing) to the packed float32 buffers
    IN PLACE, and returns them.

    On the card this launches csrc/grm_syrk.cu (or raises); only tensors
    on the CPU take the plain version."""
    if dosage.device.type == "cpu":
        return plain_grm_fused_triangle_update(
            dosage, mean, inv_std, kernel_tiles, counts_tiles, block_n
        )
    if dosage.device.type != "cuda":
        raise ValueError(f"no GRM kernel for device {dosage.device}")
    if dosage.dim() != 2:
        raise ValueError("dosage must be (m, n)")
    m, n = dosage.shape
    device = dosage.device
    _check("dosage", dosage, torch.int8, (m, n), device)
    _check("mean", mean, torch.float32, (m,), device)
    _check("inv_std", inv_std, torch.float32, (m,), device)
    shape = packed_shape(n, block_n)
    _check("kernel_tiles", kernel_tiles, torch.float32, shape, device)
    _check("counts_tiles", counts_tiles, torch.float32, shape, device)
    if m == 0:
        return kernel_tiles, counts_tiles
    kernel = _entry("grm_syrk", "grm_fused_triangle_update", 7, 6)
    work = _work_on(device, n, block_n)
    stages = grm_stages(m)
    # the observed mask packed 32 rows to a word, one word per column
    bits = torch.empty((stages, n), dtype=torch.int32, device=device)
    vec = (n % 16 == 0 and block_n % 16 == 0 and dosage.data_ptr() % 16 == 0
           and kernel_tiles.data_ptr() % 16 == 0)
    with torch.cuda.device(device):
        rc = kernel(
            dosage.data_ptr(), mean.data_ptr(), inv_std.data_ptr(),
            kernel_tiles.data_ptr(), counts_tiles.data_ptr(), work.data_ptr(), bits.data_ptr(),
            m, n, block_n, work.shape[0], stages, int(vec), cuda_lib.stream_handle(device),
        )
    if rc != 0:
        raise RuntimeError(f"grm_fused_triangle_update: CUDA error {rc}")
    grm_fused_triangle_update.launches += 1
    return kernel_tiles, counts_tiles


grm_fused_triangle_update.launches = 0


def plain_syrk_triangle_packed(z, block_n: int = 512):
    """The plain version of K2: the full square Z^T Z in float32, its
    lower tiles gathered into a fresh packed buffer."""
    return pack_triangle(z.T @ z, block_n)


def syrk_triangle_packed(z, block_n: int = 512):
    """K2: the lower-triangle tiles of Z^T Z for an already standardized
    float32 (m, N) operand, written into a FRESH packed (T*BN, BN) float32
    buffer in `_pair_maps` order.  Diagonal tiles hold the whole BN x BN
    block, and entries whose row or column is past N are 0, so the buffer
    equals dissect_tpu's `syrk_triangle_packed` tile for tile.

    On the card this launches csrc/syrk_packed.cu (or raises); only
    tensors on the CPU take the plain version."""
    if z.device.type == "cpu":
        return plain_syrk_triangle_packed(z, block_n)
    if z.device.type != "cuda":
        raise ValueError(f"no syrk_triangle_packed kernel for device {z.device}")
    if z.dim() != 2:
        raise ValueError("z must be (m, n)")
    m, n = z.shape
    _check("z", z, torch.float32, (m, n), z.device)
    if (-(-block_n // 128)) ** 2 > 65535:
        raise ValueError(f"block_n {block_n} too large for the kernel's grid")
    shape = packed_shape(n, block_n)
    out = torch.empty(shape, dtype=torch.float32, device=z.device)
    kernel = _entry("syrk_packed", "syrk_triangle_packed", 2, 4)
    with torch.cuda.device(z.device):
        rc = kernel(
            z.data_ptr(), out.data_ptr(), m, n, block_n, shape[0] // block_n,
            cuda_lib.stream_handle(z.device),
        )
    if rc != 0:
        raise RuntimeError(f"syrk_triangle_packed: CUDA error {rc}")
    syrk_triangle_packed.launches += 1
    return out


syrk_triangle_packed.launches = 0


def syrk_triangle(z, block_n: int = 512):
    """Full symmetric Z^T Z (float32) computing only lower-triangle tiles."""
    return unpack_triangle(syrk_triangle_packed(z, block_n), z.shape[1], block_n)


def _entry(library: str, function: str, n_pointers: int, n_ints: int):
    """The C entry point `function` of csrc/<library>.cu, typed: its
    pointers, then its ints, then the stream; it returns the CUDA error."""
    fn = getattr(cuda_lib.load(library), function)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_pointers + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
    return fn
