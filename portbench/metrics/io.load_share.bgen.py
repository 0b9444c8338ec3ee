"""Share of the window in LoadGenotypes (the reader, the individual
filter, the statistics), from the benchmark's span around those calls."""

from portbench.trace import span_share


def read(run):
    return span_share(run, "LoadGenotypes")
