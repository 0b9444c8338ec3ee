"""K4 (csrc/bed_decode.cu) in the scan cells: its bound at each launch's
rows over its device seconds in the trace, in percent."""

from portbench.rooflines import k4_share


def read(run):
    return k4_share(run)
