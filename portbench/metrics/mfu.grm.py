"""The window's builds' needed float32 flops (Z^T Z over the lower
triangle) over the traced window at the card's float32 peak, in percent."""

from portbench import rooflines as rl


def read(run):
    if run.traffic["unit"] != "grm_build":
        return None
    flops = run.units * rl.grm_flops(run.config["n_snps"], run.config["n_individuals"])
    return rl.mfu(flops, rl.PEAK_FP32_FLOPS, rl.traced_window(run))
