"""Set-up seconds: loading, the kernels' build where it happens, the
cohort, what the unit needs from earlier pipeline steps, the warm unit."""


def read(run):
    return run.setup_s
