"""Uncompressed BGEN bytes the host inflated a second (10^6 bytes), the
counter `bgen.bytes_inflated` over the seconds of the `bgen.inflate`
spans."""

from portbench.metrics._program import counter, span_seconds


def read(run):
    seconds, inflated = span_seconds("bgen.inflate"), counter("bgen.bytes_inflated")
    if not seconds or inflated is None:
        return None
    return inflated / seconds / 1e6
