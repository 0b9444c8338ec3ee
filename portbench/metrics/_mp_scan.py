"""The float32 flops a multi-phenotype scan needs, from its shapes.

Each SNP tested against P residual columns of N individuals needs its
row of X'y (2 N P flops) and its X'X (2 N); the columns' y'y is worked
out once a chunk, which the count leaves out (it is under 0.1% of the
work for any chunk of more than 1,000 SNPs at P = 778).
"""

from portbench.rooflines import PEAK_FP32_FLOPS, mfu, traced_window


def mp_scan_flops(snps: int, n: int, p: int) -> int:
    """The float32 flops of `snps` SNPs tested against `p` columns."""
    return snps * (2 * n * p + 2 * n)


def mp_scan_mfu(run):
    """The window's needed flops over the traced window at the card's
    float32 peak, in percent; None outside a multi-phenotype scan."""
    if run.traffic["unit"] != "mp_scan":
        return None
    flops = mp_scan_flops(run.work, run.config["n_individuals"], run.config["n_phenotypes"])
    return mfu(flops, PEAK_FP32_FLOPS, traced_window(run))
