"""The plain GRM: K = Z^T Z / O^T O over standardized genotype rows.

Z holds (d - 2p) / std per SNP with missing calls as 0, and O is the
observed mask, so each entry is the mean over the SNPs observed in both
individuals (DISSECT's Kernel from genotypes, as GCTA defines the GRM).
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference.genotypes import as_float, row_stats


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 (the control) or in full float32."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def standardized(rows: torch.Tensor, hard_calls: bool, dtype=torch.float64):
    """(Z, O) of a block of genotype rows, in `dtype`."""
    mean, std = row_stats(rows, hard_calls)
    d, observed = as_float(rows)
    inv = torch.where(std > 0, 1.0 / std, torch.zeros_like(std))
    z = torch.where(observed, (d - mean[:, None]) * inv[:, None], torch.zeros_like(d))
    return z.to(dtype), observed.to(dtype)


def grm(row_blocks, n: int, hard_calls: bool, device, dtype=torch.float64, tf32=False):
    """(K, counts) from an iterable of genotype row blocks on `device`,
    accumulated in `dtype` (float64; the control passes float32 with
    TF32 products)."""
    kern = torch.zeros((n, n), dtype=dtype, device=device)
    counts = torch.zeros((n, n), dtype=torch.float64, device=device)
    with matmul_precision(tf32):
        for rows in row_blocks:
            z, o = standardized(rows.to(device), hard_calls, dtype)
            kern.addmm_(z.T, z)
            o64 = o.to(torch.float64)
            counts.addmm_(o64.T, o64)
    return kern.to(torch.float64) / counts.clamp_min(1.0), counts
