"""SNPs the refit fitted a second time over the SNPs tested, in percent:
an exact count from K3's launches by row count."""

from portbench.rooflines import retry_share


def read(run):
    return retry_share(run)
