"""SNPs tested over the window's seconds, in a scan whose host inflate
makes the rate too unsteady to hold to a bound end to end."""


def read(run):
    return run.work / run.window_s if run.traffic["unit"] == "gwas_scan" else None
