"""REML iterations to convergence, the mean over the window's fits."""


def read(run):
    if run.traffic["unit"] != "reml_fit":
        return None
    return sum(out["iterations"] for out in run.outputs) / len(run.outputs)
