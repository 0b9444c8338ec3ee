"""The multi-phenotype scan (`--mpgwas`) by its definition, for the check.

DISSECT's computeGLMWithoutCovarianceMultiplePhenos (gwasmp.cpp:399-527):
every SNP x every residual column is a scalar regression without
covariates on the column-centred residuals, with the SNP's dosages
centred on their observed mean and missing calls set to 0:

    b = X'y / X'X,   SSE = y'y - b X'y,   SE = sqrt(SSE / (n - 1) / X'X),
    t = b / SE,      p = 2 P(T > |t|),  T Student's t with n - 1 degrees of freedom.

Plain PyTorch in float64 on the cohort as written and on the residual
matrix read back from its `.dat` file; the tail is scipy's `stdtr`.
The control (`control=True`) takes the genotypes and the residuals to
float32 and runs the three products in TF32, one precision below the
float32 the configuration states.  Each is a matrix product: X'y, and
X'X and y'y as the diagonals of X X' and y'y.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from scipy.special import stdtr

from portbench.reference import genotypes as ref_genotypes

# SNP rows a block: at N = 452,264 the decode's int64 codes and the
# float64 rows of 1,024 SNPs take about 3.7 GB each
MP_BLOCK_ROWS = 1024
# bytes before the column-major float64 payload of a `.dat` file
DAT_HEADER_BYTES = 14


def read_dat(path, n_rows: int) -> np.ndarray:
    """(n_rows, columns) float64 from a labelled matrix's `.dat` file:
    a 14-byte header, then the values column by column."""
    payload = np.fromfile(path, dtype=np.float64, offset=DAT_HEADER_BYTES)
    return payload.reshape(-1, n_rows).T


def t_two_sided(t: np.ndarray, df: float) -> np.ndarray:
    """2 P(T > |t|) for Student's T with `df` degrees of freedom, float64."""
    return 2.0 * stdtr(df, -np.abs(t))


@contextlib.contextmanager
def tf32_products(enabled: bool):
    """Float32 matrix products on the TF32 tensor cores where the device
    has them, or not, within the block."""
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def mp_gwas(cohort, residuals: np.ndarray, device, control: bool = False,
            block_rows: int = MP_BLOCK_ROWS) -> dict:
    """{"beta", "se", "p"}, each (M, P) float64, of every SNP of the
    cohort against every column of `residuals` ((n, P), rows in the
    cohort's order)."""
    dtype = torch.float32 if control else torch.float64
    host = lambda v: v.to(torch.float64).cpu().numpy()
    y = torch.as_tensor(residuals, device=device, dtype=torch.float64)
    y = (y - y.mean(0, keepdim=True)).to(dtype)
    with tf32_products(control):
        yty = host(torch.diagonal(y.T @ y))
    df = cohort.n - 1.0
    hard = cohort.kind == "plink"
    out = {k: [] for k in ("beta", "se", "p")}
    for start in range(0, cohort.m, block_rows):
        rows = ref_genotypes.cohort_rows(cohort, start, min(start + block_rows, cohort.m), device)
        mean, _ = ref_genotypes.row_stats(rows, hard)
        g = ref_genotypes.centered(rows, mean, dtype)
        del rows
        with tf32_products(control):
            xtx, xty = host(torch.diagonal(g @ g.T)), host(g @ y)
        del g
        beta = xty / xtx[:, None]
        se = np.sqrt((yty[None, :] - beta * xty) / df / xtx[:, None])
        out["beta"].append(beta)
        out["se"].append(se)
        out["p"].append(t_two_sided(beta / se, df))
    return {k: np.concatenate(v) for k, v in out.items()}
