"""Share of rank 0's traced window in which no kernel or copy ran on its
card."""

from portbench.trace import idle_share


def read(run):
    return idle_share(run.trace)
