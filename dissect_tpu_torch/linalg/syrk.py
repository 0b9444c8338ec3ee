"""Symmetric rank-k accumulation — the GRM hot loop.

Parity: Matrix::multiply(Z, 'T', Z, 'N') -> pdsyrk_ (matrix.cpp:2682),
consumed by the GRM build kernel = Z^T Z, N = missings^T missings
(kernel.cpp:92-109).  Port of dissect_tpu/linalg/syrk.py.

Raw dosage chunks (M_chunk, N), decoded on the device (K4 for PLINK
hard calls; BGEN dosages are resident there), stream into it; the
standardization (d - 2p)/sqrt(2p(1-p)), missing -> 0
(genotype.cpp:888-970), fuses into the products for int8 hard calls
(kernel K1) and runs before them for float imputed dosages (kernel K2).
The accumulator keeps the lower-triangle tiles PACKED across chunks and
mirrors them once at `finalize`: on the card every chunk goes through
K1 or K2 (linalg/grm_kernels.py), on the CPU through their plain
versions, which give the same packed buffers.
"""

from __future__ import annotations

import torch


def standardize_chunk(dosage, mean, inv_std, dtype):
    """GCTA standardization of an (M, N) chunk: z = (d - 2p)/std.

    `mean` = 2 p2 and `inv_std` are per-SNP (M,) vectors; missing maps
    to 0 so it contributes nothing to the Gram matrix (parity:
    genotype.cpp:943-961).  Integer chunks (PLINK hard calls) mark
    missing as -1; float chunks (imputed dosages) mark missing as NaN.
    Returns (Z, observed) both in `dtype`."""
    if dosage.is_floating_point():
        finite = torch.isfinite(dosage)
        observed = finite.to(dtype)
        d = torch.where(finite, dosage, torch.zeros_like(dosage)).to(dtype)
    else:
        observed = (dosage >= 0).to(dtype)
        d = dosage.to(dtype)
    z = observed * (d - mean[:, None].to(dtype)) * inv_std[:, None].to(dtype)
    return z, observed


def grm_update(kernel, counts, dosage, mean, inv_std, compute_dtype=torch.float32):
    """One dense accumulation step: kernel += Z_c^T Z_c, counts += O_c^T O_c.

    The full-square form of the step, which K1's plain version packs;
    the accumulator below runs the packed triangle form (K1) instead."""
    z, observed = standardize_chunk(dosage, mean, inv_std, compute_dtype)
    kernel = kernel + (z.T @ z).to(kernel.dtype)
    counts = counts + (observed.T @ observed).to(counts.dtype)
    return kernel, counts


def grm_update_packed(kernel_tiles, counts_tiles, dosage, mean, inv_std, block_n: int = 512):
    """Packed-triangle accumulation step for float (imputed, NaN =
    missing) dosages: only the lower-triangle tiles of Z_c^T Z_c and
    O_c^T O_c are computed, by kernel K2 on the card (two calls, one on Z
    and one on the observed mask O), and ADDED IN PLACE to the packed
    float32 buffers, which are returned.

    Port of dissect_tpu/linalg/syrk.py:75-91 at the compute dtype its
    accumulator passes, float32 (syrk.py:114,121), not the function's
    bf16 default."""
    from dissect_tpu_torch.linalg.grm_kernels import syrk_triangle_packed

    z, observed = standardize_chunk(dosage, mean, inv_std, torch.float32)
    kernel_tiles += syrk_triangle_packed(z.contiguous(), block_n)
    counts_tiles += syrk_triangle_packed(observed.contiguous(), block_n)
    return kernel_tiles, counts_tiles


class grm_accumulator:
    """Streaming GRM builder: feed (chunk, N) dosage blocks, finalize to
    the full (kernel, counts).

    The caller feeds decoded chunks (device tensors from `decode_rows`,
    or host arrays, moved to `device`); each `update` is one step into
    the packed float32 tiles on `device` — int8 hard calls (-1 = missing)
    through K1, float imputed dosages (NaN = missing) through K2 — and
    `finalize` unpacks once (genotype.cpp:639-707, kernel.cpp:92-109)."""

    def __init__(self, n_individuals: int, device="cuda", block_n: int = 512):
        from dissect_tpu_torch.linalg.grm_kernels import packed_shape

        self.n = n_individuals
        self.block_n = block_n
        self.device = torch.device(device)
        shape = packed_shape(n_individuals, block_n)
        self.kernel = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.counts = torch.zeros(shape, dtype=torch.float32, device=self.device)

    def update(self, dosage, mean, inv_std):
        from dissect_tpu_torch.linalg.grm_kernels import grm_fused_triangle_update

        dosage = torch.as_tensor(dosage, device=self.device)
        as_f32 = lambda v: torch.as_tensor(v, device=self.device).to(torch.float32).contiguous()
        if dosage.is_floating_point():  # imputed dosages: two K2 passes
            grm_update_packed(
                self.kernel, self.counts, dosage, as_f32(mean), as_f32(inv_std),
                block_n=self.block_n,
            )
            return self
        grm_fused_triangle_update(
            dosage.to(torch.int8).contiguous(), as_f32(mean), as_f32(inv_std),
            self.kernel, self.counts, block_n=self.block_n,
        )
        return self

    def finalize(self):
        from dissect_tpu_torch.linalg.grm_kernels import unpack_triangle

        return (
            unpack_triangle(self.kernel, self.n, self.block_n),
            unpack_triangle(self.counts, self.n, self.block_n),
        )
