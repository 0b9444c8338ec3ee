"""Window seconds over the converged REML fits completed in it."""


def read(run):
    if run.traffic["unit"] != "reml_fit":
        return None
    fits = sum(out["success"] for out in run.outputs)
    return run.window_s / fits if fits else None
