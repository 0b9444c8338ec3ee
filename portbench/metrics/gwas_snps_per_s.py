"""SNPs tested over the window's seconds."""


def read(run):
    return run.work / run.window_s if run.traffic["unit"] == "gwas_scan" else None
