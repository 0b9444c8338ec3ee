"""A scan's needed float32 flops over the traced window at the card's
float32 peak, in percent (`rooflines.scan_mfu`)."""

from portbench.rooflines import scan_mfu


def read(run):
    return scan_mfu(run)
