"""A multi-phenotype scan's needed float32 flops, (2 N P + 2 N) a SNP
tested, over the traced window at the card's float32 peak, in percent
(`_mp_scan.mp_scan_mfu`)."""

from portbench.metrics._mp_scan import mp_scan_mfu


def read(run):
    return mp_scan_mfu(run)
