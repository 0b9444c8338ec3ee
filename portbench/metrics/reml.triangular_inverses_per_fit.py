"""Inverses of V formed from its factor by trtri and lauum (the program's
`spd.triangular_inverses` counter), the mean over the window's fits: a
fit's iterations and the evaluation its BLUEs and BLUPs read, so
`reml.iters_per_fit` + 1 where every V takes that route.  None where the
program has no such counter."""

from portbench.metrics._program import counter


def read(run):
    if run.traffic["unit"] != "reml_fit":
        return None
    n = counter("spd.triangular_inverses")
    return None if n is None else n / len(run.outputs)
