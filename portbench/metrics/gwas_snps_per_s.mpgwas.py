"""SNPs tested over the window's seconds in a multi-phenotype scan, each
SNP against every residual column."""


def read(run):
    return run.work / run.window_s if run.traffic["unit"] == "mp_scan" else None
