"""PLINK text parsed a second (10^6 bytes): the counter `plink.text_bytes`
(the .bim and .fam bytes of every `read_plink`) over the seconds of the
`plink.read_text` spans."""

from portbench.metrics._program import counter, span_seconds


def read(run):
    seconds, parsed = span_seconds("plink.read_text"), counter("plink.text_bytes")
    if not seconds or parsed is None:
        return None
    return parsed / seconds / 1e6
