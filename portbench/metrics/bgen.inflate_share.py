"""Share of the window in the program's `bgen.inflate` spans: the host's
zlib inflate of each batch of BGEN blocks."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "bgen.inflate")
