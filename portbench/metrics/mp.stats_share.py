"""Share of the window in the program's `mp.stats` spans: each chunk's
effects, SEs, t statistics and t tails, worked out on the host."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "mp.stats")
