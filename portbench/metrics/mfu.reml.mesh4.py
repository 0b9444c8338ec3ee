"""The window's fits' needed float64 flops (`rooflines.reml_fit_flops`,
the count `mfu.reml` takes, whatever implements it) over the peak of
all the cards the fit is sharded over (chips x the float64 tensor-core
peak) for rank 0's traced window, in percent."""

from portbench import rooflines as rl


def read(run):
    if run.traffic["unit"] != "reml_mesh":
        return None
    n, c = run.config["n_individuals"], rl.fixed_effects(run.config)
    flops = sum(rl.reml_fit_flops(n, c, out["iterations"]) for out in run.outputs)
    return rl.mfu(flops, run.chips * rl.PEAK_FP64_TENSOR_FLOPS, rl.traced_window(run))
