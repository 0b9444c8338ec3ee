"""Share of rank 0's traced window in NCCL kernels (device operations
whose name holds `nccl`): the exchanges between the cards."""


def read(run):
    if run.trace is None:
        return None
    seconds = sum(s for name, s in run.trace["kernel_s"].items() if "nccl" in name.lower())
    return 100.0 * seconds / run.trace["window_s"] if seconds else None
