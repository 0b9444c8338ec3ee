"""Peak device memory of the program's calls (set-up and window), GB."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes else None
