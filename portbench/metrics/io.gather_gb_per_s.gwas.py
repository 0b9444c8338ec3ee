"""Packed .bed bytes staged on the host a second (10^9 bytes): the
counter `plink.bytes_staged` over the seconds of the `plink.gather`
spans (each block's staging into a pinned buffer and its upload)."""

from portbench.metrics._program import counter, span_seconds


def read(run):
    seconds, staged = span_seconds("plink.gather"), counter("plink.bytes_staged")
    if not seconds or staged is None:
        return None
    return staged / seconds / 1e9
