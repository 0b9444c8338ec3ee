"""Share of the window in the program's `plink.read_text` span: the `.bim`
and `.fam` parse of every `read_plink` of a multi-phenotype scan."""

from portbench.metrics._program import program_share


def read(run):
    return program_share(run, "plink.read_text")
