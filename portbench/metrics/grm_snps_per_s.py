"""SNPs folded into the N x N GRM per second."""


def read(run):
    return run.work / run.window_s if run.traffic["unit"] == "grm_build" else None
