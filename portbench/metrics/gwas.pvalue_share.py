"""Share of the window in the program's `gwas.pvalues` span: the reduced
null fit, the chi-square tails and the results of each refit chunk, on
the host."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "gwas.pvalues")
