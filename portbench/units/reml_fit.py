"""Dense REML fits, as `--reml --blue --indiv-blup` runs each.

Set-up builds the GRM as the CLI builds it in line (`load_reml_kernels`
from the genotypes) and reads the traffic's phenotype columns.  A unit
is one `SingleREML(...).compute(...)`, built as the dispatcher's
`_reml_one` builds it, from the default start values, with BLUEs and
individual BLUPs; the units take the columns in turn.  A fit's
iterations depend on its data, so a window of many different traits
measures the mean time to a solution, where one trait would make the
seed choose between, say, 6 and 7 iterations for the whole run.

The check recomputes the GRM and each trait's fit with the plain
reference and holds every unit's variances, log-likelihood, BLUEs and
BLUPs against its trait's.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import grm as ref_grm
from portbench.reference import mixed_model as ref_mm
from portbench.reference.genotypes import cohort_blocks


def setup(ctx):
    from dissect_tpu_torch.analysis.dispatcher import Analysis
    from dissect_tpu_torch.runtime.options import Options

    options = Options.parse(["--reml", *ctx.cohort.argv, "--blue", "--indiv-blup",
                             "--out", str(ctx.workdir / "reml")])
    analysis = Analysis(options, ctx.device)
    kernels, _ = analysis.load_reml_kernels()
    phenos = analysis.load_phenotypes(list(range(1, len(ctx.cohort.traits) + 1)))
    return {"analysis": analysis, "kernels": kernels, "phenos": phenos, "next": 0,
            "covar": analysis.load_covariate(phenos[0].keys)}


def unit(state, spans):
    from dissect_tpu_torch.reml.single import SingleREML

    analysis = state["analysis"]
    a = analysis.args
    trait = state["next"] % len(state["phenos"])
    state["next"] += 1
    with spans.span("REML"):
        sreml = SingleREML(state["kernels"], state["phenos"][trait], state["covar"],
                           analysis.options.reml_options(), device=analysis.device)
        out = sreml.compute(compute_blue=True, compute_blup=a.indiv_blup,
                            compute_blup_errors=a.indiv_blup_error)
    r = out.result
    blup = out.blup[state["kernels"][0].name] if out.blup else None
    return 1, {
        "trait": trait,
        "success": bool(r.success),
        "theta": np.asarray(r.variances, dtype=float),
        "logl": float(r.log_likelihood),
        "iterations": int(r.n_iterations),
        "blue": out.blue,
        "blue_se": out.blue_se,
        "blup": blup,
    }


def reference(ctx, control=False):
    """Each trait's fit by the plain reference on the plain GRM: float64,
    or float32 throughout for the control (the configuration states
    float64).  Returns one dict a trait."""
    cohort, device = ctx.cohort, ctx.device
    dtype = torch.float32 if control else torch.float64
    kern, _ = ref_grm.grm(cohort_blocks(cohort, device), cohort.n, cohort.kind == "plink", device)
    lam, u = torch.linalg.eigh(kern.to(dtype))
    del kern
    x_rot = u.T @ torch.as_tensor(cohort.design(), device=device, dtype=dtype)
    fits = []
    for y in cohort.traits:
        fit = ref_mm.reml_diagonal(lam, u.T @ torch.as_tensor(y, device=device, dtype=dtype),
                                   x_rot, dtype=dtype)
        host = lambda t: t.to(torch.float64).cpu().numpy()
        fits.append({
            "theta": host(fit["theta"]),
            "logl": float(fit["logl"]),
            "blue": host(fit["blue"]),
            "blue_se": host(fit["blue_se"]),
            "blup": host(fit["theta"][0] * (u @ (lam * fit["py"]))),
        })
    return fits


def as_output(ref):
    """A reference result as the units' outputs (the control's readings)."""
    return [{"trait": t, "success": True, **fit} for t, fit in enumerate(ref)]


def gaps(outputs, ref):
    """The widest gap over every fit of the window: of a variance relative
    to the reference's, of the log-likelihood, of a BLUE in units of its
    reference SE and of a BLUP relative to the reference's largest.  A
    fit that failed reads infinite."""
    worst = {"variance_gap": 0.0, "logl_gap": 0.0, "blue_gap_se": 0.0, "blup_gap": 0.0}
    for out in outputs:
        r = ref[out["trait"]]
        if (not out["success"] or out["blue"] is None or out["blup"] is None
                or out["blup"].shape != r["blup"].shape):
            return {k: float("inf") for k in worst}
        for name, value in (
            ("variance_gap", np.abs(out["theta"] / r["theta"] - 1.0).max()),
            ("logl_gap", abs(out["logl"] - r["logl"])),
            ("blue_gap_se", (np.abs(out["blue"] - r["blue"]) / r["blue_se"]).max()),
            ("blup_gap", np.abs(out["blup"] - r["blup"]).max() / np.abs(r["blup"]).max()),
        ):
            worst[name] = max(worst[name], float(np.nan_to_num(value, nan=np.inf)))
    return worst
