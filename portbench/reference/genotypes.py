"""Genotype rows as the reference reads them, and their standardization."""

from __future__ import annotations

import torch


def decode_bed(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(m, ceil(n/4)) uint8 .bed rows -> (m, n) int8 dosages of allele 2,
    -1 = missing (0b00 -> 0, 0b01 -> missing, 0b10 -> 1, 0b11 -> 2)."""
    lut = torch.tensor([0, -1, 1, 2], dtype=torch.int8, device=packed.device)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3
    return lut[codes.reshape(packed.shape[0], -1)[:, :n].long()]


def as_float(rows: torch.Tensor, dtype=torch.float64):
    """(dosage, observed) in `dtype`, missing (-1 or NaN) as 0 and False."""
    if rows.is_floating_point():
        observed = torch.isfinite(rows)
    else:
        observed = rows >= 0
    d = torch.where(observed, rows.to(dtype), torch.zeros((), dtype=dtype, device=rows.device))
    return d, observed


def row_stats(rows: torch.Tensor, hard_calls: bool):
    """Per-SNP (mean, std) in float64: the mean dosage 2p over observed
    calls; std sqrt(2p(1-p)) for hard calls, the sample std of the
    observed dosages for imputed ones (DISSECT's standardization)."""
    d, observed = as_float(rows)
    count = observed.sum(1).clamp_min(1).to(torch.float64)
    mean = d.sum(1) / count
    if hard_calls:
        p = mean / 2.0
        std = torch.sqrt(2.0 * p * (1.0 - p))
    else:
        dev = torch.where(observed, d - mean[:, None], torch.zeros_like(d))
        std = torch.sqrt((dev * dev).sum(1) / (count - 1).clamp_min(1))
    return mean, std


def centered(rows: torch.Tensor, mean: torch.Tensor, dtype=torch.float64):
    """Rows minus their mean, missing as 0."""
    d, observed = as_float(rows, torch.float64)
    return torch.where(observed, d - mean[:, None], torch.zeros_like(d)).to(dtype)


# SNP rows per block the reference reads: bounds its float64 temporaries
BLOCK_ROWS = 4096


def cohort_rows(cohort, start: int, stop: int, device) -> torch.Tensor:
    """The cohort's genotype rows [start, stop) as written: int8 hard
    calls (PLINK) or float64 dosages (BGEN), on `device`."""
    if cohort.kind == "plink":
        return decode_bed(torch.as_tensor(cohort.packed[start:stop], device=device), cohort.n)
    from portbench.cohort import dosage_from_probs

    return dosage_from_probs(torch.as_tensor(cohort.probs[start:stop], device=device))


def cohort_blocks(cohort, device):
    """The cohort's genotype rows, BLOCK_ROWS at a time."""
    for start in range(0, cohort.m, BLOCK_ROWS):
        yield cohort_rows(cohort, start, min(start + BLOCK_ROWS, cohort.m), device)
