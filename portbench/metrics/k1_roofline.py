"""K1 (csrc/grm_syrk.cu): its bound for each chunk of a build over its
device seconds in the trace, in percent."""

from portbench.rooflines import k1_share


def read(run):
    return k1_share(run)
