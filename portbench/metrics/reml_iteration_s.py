"""Window seconds over the AI-REML iterations of the window's fits, each
fit's final evaluation (the quantities at its variances, which the BLUEs
and BLUPs come from) counted as one more: the time of one iteration, a
distributed inverse and its products, whatever the data's iterations."""


def read(run):
    if run.traffic["unit"] != "reml_mesh":
        return None
    return run.window_s / sum(out["iterations"] + 1 for out in run.outputs)
