"""Share of the traced window in which no kernel or copy ran on the card."""

from portbench.trace import idle_share


def read(run):
    return idle_share(run.trace)
