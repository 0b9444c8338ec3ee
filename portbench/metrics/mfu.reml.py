"""The window's fits' needed float64 flops (each iteration's SPD inverse
and products, and the fitted quantities) over the traced window at the
card's float64 tensor-core peak, in percent."""

from portbench import rooflines as rl


def read(run):
    if run.traffic["unit"] != "reml_fit":
        return None
    n, c = run.config["n_individuals"], rl.fixed_effects(run.config)
    flops = sum(rl.reml_fit_flops(n, c, out["iterations"]) for out in run.outputs)
    return rl.mfu(flops, rl.PEAK_FP64_TENSOR_FLOPS, rl.traced_window(run))
