"""Dense REML fits with the covariance row-sharded over the cards, as
`--reml --blue --indiv-blup --mesh <ranks>` runs each at biobank N.

Every rank runs this unit, in lockstep (portbench/ranks.py).  Set-up
starts the program's run on the launch (`startup_runtime`: the process
group, NCCL with one card a rank), then builds the GRM as the CLI does in
line: `load_reml_kernels` computes it row-sharded over the ranks.  A unit
is one `SingleREML(...).compute(...)`, built as the dispatcher's
`_reml_one` builds it on a mesh (the row-sharded engine and its
distributed blocked Cholesky), from the default start values, with BLUEs
and individual BLUPs; the units take the phenotype columns in turn, so
the warm unit fits trait 0 and the window goes on from trait 1.  The
mesh is engaged by `--force-distributed` as well, so that it runs at
the CPU tests' small N as it runs above the program's threshold.

The check (rank 0, once the other ranks have ended) builds the GRM with
the plain reference on one card and refits each trait the window fitted
with the plain dense fit (portbench/reference/dense_reml.py), from the
program's variances (the optimum does not depend on the start), and
holds every unit to it by `reml_fit`'s comparison, less the BLUEs' gap
(below).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import dense_reml
from portbench.reference.genotypes import cohort_blocks
from portbench.units import reml_fit


def setup(ctx):
    from dissect_tpu_torch.analysis.dispatcher import Analysis
    from dissect_tpu_torch.runtime.distributed import startup_runtime, use_distributed
    from dissect_tpu_torch.runtime.options import Options

    options = Options.parse(["--reml", *ctx.cohort.argv, "--blue", "--indiv-blup",
                             "--mesh", str(ctx.world), "--force-distributed",
                             "--out", str(ctx.workdir / "reml")])
    startup_runtime(options.args.mesh, ctx.device)
    analysis = Analysis(options, ctx.device)
    kernels, _ = analysis.load_reml_kernels()
    phenos = analysis.load_phenotypes(list(range(1, len(ctx.cohort.traits) + 1)))
    return {"analysis": analysis, "kernels": kernels, "phenos": phenos, "next": 0,
            "covar": analysis.load_covariate(phenos[0].keys),
            "mesh": use_distributed(analysis.args, kernels[0].n)}


def unit(state, spans):
    from dissect_tpu_torch.reml.single import SingleREML

    analysis = state["analysis"]
    a = analysis.args
    trait = state["next"] % len(state["phenos"])
    state["next"] += 1
    with spans.span("REML"):
        sreml = SingleREML(state["kernels"], state["phenos"][trait], state["covar"],
                           analysis.options.reml_options(), device=analysis.device,
                           mesh=state["mesh"], distributed_block=a.default_block_size)
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


def gaps(outputs, ref):
    """`reml_fit`'s gaps without `blue_gap_se`: at N = 60,000 the float32
    control reads that gap within 1.2 times of what the program reads,
    so no limit on it separates the two.  A fit without BLUEs still
    reads infinite on every gap."""
    worst = reml_fit.gaps(outputs, ref)
    del worst["blue_gap_se"]
    return worst


def finish(state, outputs):
    """Forget the program's run on the launch (the harness tears the
    group down)."""
    from dissect_tpu_torch.runtime.distributed import shutdown_runtime

    shutdown_runtime()


def reference(ctx, control=False, outputs=None):
    """The fit of each trait the window fitted (every trait without
    `outputs`), by the plain dense reference on the plain GRM on one
    card: float64, or float32 throughout the fit for the control (the
    configuration states float64).  Starts from the program's variances
    for the trait where it has finite positive ones, else from the
    default.  Returns {trait: fit}."""
    cohort, device = ctx.cohort, ctx.device
    dtype = torch.float32 if control else torch.float64
    if outputs is None:
        traits, starts = range(len(cohort.traits)), {}
    else:
        traits = sorted({out["trait"] for out in outputs})
        starts = {out["trait"]: out["theta"] for out in reversed(outputs)}
    kern = dense_reml.grm(cohort_blocks(cohort, device), cohort.n, cohort.kind == "plink",
                          device).to(dtype)
    plane = torch.empty_like(kern)
    x = cohort.design()
    host = lambda t: t.to(torch.float64).cpu().numpy()
    fits = {}
    for t in traits:
        fit = dense_reml.reml_dense(kern, plane, cohort.traits[t], x, start=starts.get(t))
        fits[t] = {"theta": host(fit["theta"]), "logl": float(fit["logl"]),
                   "blue": host(fit["blue"]), "blue_se": host(fit["blue_se"]),
                   "blup": host(fit["blup"]), "steps": fit["steps"]}
    del kern, plane
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return fits


def as_output(ref):
    """A reference result as the units' outputs (the control's readings)."""
    return [{"trait": t, "success": True, **fit} for t, fit in ref.items()]
