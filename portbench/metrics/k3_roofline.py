"""K3 (csrc/refit_moments.cu): its bound at each launch's rows over its
device seconds in the trace, in percent."""

from portbench.rooflines import k3_share


def read(run):
    return k3_share(run)
