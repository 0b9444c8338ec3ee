"""Share of the window in the program's `BLUE/BLUP` span: the post-fit
quantities, BLUEs and BLUPs, from an idle card (the REML phase
synchronizes at its end) to their read back."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "BLUE/BLUP")
