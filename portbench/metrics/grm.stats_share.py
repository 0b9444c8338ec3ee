"""Share of the window in the program's `grm.stats` span: K5's counts
brought to the host, the statistics, the mean and 1/std formed there."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "grm.stats")
