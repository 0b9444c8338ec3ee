"""Share of the window in the program's `DistributedInverse` span: the
row-sharded Cholesky, triangular inverse and product of each iteration,
panel exchanges included, on rank 0."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "DistributedInverse")
