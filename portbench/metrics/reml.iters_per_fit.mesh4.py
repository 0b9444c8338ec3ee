"""AI-REML iterations to convergence of the row-sharded fits, the mean
over the window's fits: the count that `reml_iteration_s` divides by, so
that a change in it shows in the mesh cell."""


def read(run):
    if run.traffic["unit"] != "reml_mesh":
        return None
    return sum(out["iterations"] for out in run.outputs) / len(run.outputs)
