"""Peaks of one NVIDIA H100 SXM and the least time its work could take.

The kernel bounds are a frozen copy of `chip_smoke.py`'s (`bound_ms`,
`k1_bound` ... `bgen_bound`): the operations and bytes each kernel
needs, from its shapes, over the card's peaks.  The flop counts of a
whole scan pass, a REML fit and a GRM build are the work the algorithm
needs, from the same shapes.  Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the 700 W power limit
PEAK_FP32_FLOPS = 67e12         # float32 outside the tensor cores
PEAK_FP64_TENSOR_FLOPS = 67e12  # float64 on the tensor cores (DMMA)
PEAK_FP64_FLOPS = 34e12         # float64 outside the tensor cores
PEAK_INT8_OPS = 1979e12         # int8 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12      # HBM3

# the refit's Fisher steps a pass takes: 15 steps and the final moments,
# and twice the steps for the warm-started retry (gwas/mlm.py)
REFIT_LAUNCHES = 16
RETRY_LAUNCHES = 31


def bound_ms(n_bytes, fp32_flops, int8_ops=0):
    """The least time the card could take: the largest of the bytes at the
    memory rate and each pipe's operations at its peak rate."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(fp32_flops / PEAK_FP32_FLOPS, int8_ops / PEAK_INT8_OPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def packed_shape(n, block_n=512):
    """Rows and columns of the packed lower-triangle tile buffer."""
    nt = -(-n // block_n)
    return nt * (nt + 1) // 2 * block_n, block_n


def needed_entries(n, block_n):
    """GRM entries one K1 call must compute: the whole of each off-diagonal
    tile, and the lower triangle of each diagonal tile (its strict upper
    half is the transpose).  Sums to n(n+1)/2."""
    nt = -(-n // block_n)
    imap, jmap = np.tril_indices(nt)
    rows = np.minimum(block_n, n - imap * block_n)
    cols = np.minimum(block_n, n - jmap * block_n)
    entries = np.where(imap == jmap, rows * (rows + 1) // 2, rows * cols)
    return int(entries.sum())


def k1_bound(m, n, block_n=512):
    """K1: Z^T Z on the float32 pipes and the exact 0/1 counts O^T O on the
    int8 tensor cores, each over the lower triangle's entries; the int8
    chunk read, both packed buffers read and written."""
    entries = needed_entries(n, block_n)
    rows, cols = packed_shape(n, block_n)
    n_bytes = m * n + 2 * m * 4 + 2 * 2 * rows * cols * 4
    return bound_ms(n_bytes, 2 * m * entries, 2 * m * entries)


def k2_bound(m, n, block_n=512):
    """K2: Z^T Z in float32 over the lower triangle; z read, tiles written."""
    rows, cols = packed_shape(n, block_n)
    return bound_ms(4 * m * n + 4 * rows * cols, 2 * m * needed_entries(n, block_n))


def k3_bound(m, n, q, k_feats):
    """K3: one FMA per output column per element of g, all in float32."""
    total = 2 * k_feats + 3 * q + 3
    n_bytes = 4 * (m * n + 2 * m + n + n * q + n * k_feats + m * total)
    return bound_ms(n_bytes, 2 * total * m * n)


def k4_bound(m, n, n_out=None):
    """K4: the packed rows read, the int8 dosages written, the int32
    individual index read when there is one."""
    cols = 0 if n_out is None else 4 * n_out
    return bound_ms(m * ((n + 3) // 4) + m * (n if n_out is None else n_out) + cols, 0)


def k5_bound(m, n, n_out=None):
    """K5: the packed rows read, 4 int64 counts a row written, the index
    read when there is one."""
    return bound_ms(m * ((n + 3) // 4) + 32 * m + (0 if n_out is None else 4 * n_out), 0)


def bgen_bound(n_bytes, n_variants, n_samples):
    """K6, K7: the blocks' bytes, their int64 offsets and lengths read;
    the float32 dosages and int32 statuses written."""
    return bound_ms(n_bytes + 16 * n_variants + 4 * n_variants * n_samples + 4 * n_variants, 0)


def layout2_block_bytes(n):
    """Uncompressed bytes of one 8-bit layout-2 probability block: N, the
    allele count, the ploidy range, a ploidy byte a sample, phasing and
    bit depth, two probabilities a sample."""
    return 10 + 3 * n


def refit_shape(c):
    """(q, K) of the refit's moments for c fixed-effect columns: q = c + 1
    shared columns [X | y], K = 2 q(q+1)/2 + 3 feature columns."""
    q = c + 1
    return q, q * (q + 1) + 3


def k3_flops(rows, n, q, k_feats):
    """K3's float32 flops for one launch over `rows` SNPs."""
    return 2 * (2 * k_feats + 3 * q + 3) * rows * n


def scan_flops(m, n, c, k3_rows):
    """A scan pass's needed float32 flops: the rotation g @ u of every SNP
    (2 M N^2) and K3's moments at each launch's rows (`k3_rows`, one
    entry per launch)."""
    q, k_feats = refit_shape(c)
    return 2 * m * n * n + sum(k3_flops(r, n, q, k_feats) for r in k3_rows)


def reml_iteration_flops(n, c):
    """One dense AI-REML iteration's needed float64 flops at N individuals
    and c fixed effects: the SPD inverse of V (Cholesky n^3/3, inverse from
    the factor 2n^3/3), and the (n, n) products the iteration forms with
    it: V^-1 X, K V^-1 X (2 n^2 c each), P y, K P y, tr(V^-1 K) (2 n^2
    each) and P applied to the two columns of the AI matrix (4 n^2)."""
    return n ** 3 + 4 * n * n * c + 10 * n * n


def reml_fit_flops(n, c, iterations):
    """A fit's needed float64 flops: its iterations, and the quantities at
    the fitted variances that the BLUEs and BLUPs come from."""
    return (iterations + 1) * reml_iteration_flops(n, c)


def grm_flops(m, n):
    """A GRM build's needed float32 flops: Z^T Z over the lower triangle."""
    return 2 * m * n * (n + 1) // 2


# --- shares read from a run (portbench/metrics/) ----------------------------
# Kernel names in the device trace, by kernel (csrc/*.cu of the program)
TRACE_NAMES = {
    "k1": ("grm_fused_kernel", "mask_bits_kernel"),
    "k3": ("moments_kernel", "sum_splits_kernel"),
    "k4": ("bed_flat_kernel", "bed_rows_kernel", "bed_gather_kernel"),
    "k6": ("bgen_kernel", "bgen_fixup_kernel"),
}


def fixed_effects(config):
    """Columns of the fixed effects: the mean and the quantitative covariates."""
    return 1 + len(config["qcovar_effects"])


def share(bound_s, seconds):
    """A bound's share of a measured time, in percent; None without a time."""
    return None if not seconds else 100.0 * bound_s / seconds


def kernel_share(run, kernel, bound_s):
    """`bound_s` over the kernel's device seconds in the traced window."""
    from portbench.trace import kernel_seconds

    if run.trace is None or not bound_s:
        return None
    return share(bound_s, kernel_seconds(run.trace, *TRACE_NAMES[kernel]))


def k3_share(run):
    n = run.config["n_individuals"]
    q, k_feats = refit_shape(fixed_effects(run.config))
    bound = sum(k3_bound(rows, n, q, k_feats)[0] * count
                for rows, count in run.counters["k3_rows"].items())
    return kernel_share(run, "k3", bound / 1e3)


def k4_share(run):
    n = run.config["n_individuals"]
    bound = sum(k4_bound(rows, n)[0] * count for rows, count in run.counters["k4_rows"].items())
    return kernel_share(run, "k4", bound / 1e3)


def k6_share(run):
    n, variants = run.config["n_individuals"], run.work
    if run.counters["k6"] == 0:
        return None
    return kernel_share(run, "k6", bgen_bound(variants * layout2_block_bytes(n), variants, n)[0] / 1e3)


def k1_share(run, chunk=2048):
    n, m = run.config["n_individuals"], run.config["n_snps"]
    if run.counters["k1"] == 0:
        return None
    per_build = sum(k1_bound(min(chunk, m - s), n)[0] for s in range(0, m, chunk))
    return kernel_share(run, "k1", run.units * per_build / 1e3)


def retried_snps(run):
    """SNPs the refit fitted a second time over the window, from K3's
    launches by row count: every SNP takes REFIT_LAUNCHES launches, each
    retried one RETRY_LAUNCHES more."""
    rows = sum(r * count for r, count in run.counters["k3_rows"].items())
    return (rows - REFIT_LAUNCHES * run.work) / RETRY_LAUNCHES


def traced_window(run):
    return None if run.trace is None else run.trace["window_s"]


def mfu(flops, peak, seconds):
    return None if not seconds else 100.0 * flops / (peak * seconds)


def retry_share(run):
    """Percent of the SNPs tested that the refit fitted a second time."""
    if run.counters["k3"] == 0 or not run.work:
        return None
    return 100.0 * retried_snps(run) / run.work


def scan_mfu(run):
    """A scan's needed float32 flops (every SNP's rotation into the
    eigenbasis, K3's moments at its launches' rows) over the traced
    window at the card's float32 peak, in percent."""
    if run.counters["k3"] == 0:
        return None
    rows = [r for r, count in run.counters["k3_rows"].items() for _ in range(count)]
    flops = scan_flops(run.work, run.config["n_individuals"], fixed_effects(run.config), rows)
    return mfu(flops, PEAK_FP32_FLOPS, traced_window(run))
