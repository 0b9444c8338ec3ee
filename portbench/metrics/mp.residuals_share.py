"""Share of the window in the program's `mp.residuals` span: the residual
matrix read, filtered, centred and moved to the card, once a pass."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "mp.residuals")
