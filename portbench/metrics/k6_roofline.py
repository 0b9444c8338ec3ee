"""K6 (csrc/bgen_decode.cu): its bound over the window's layout-2 blocks
over its device seconds in the trace, in percent."""

from portbench.rooflines import k6_share


def read(run):
    return k6_share(run)
