"""One GRM build, as `--make-grm` runs it before writing the files.

A unit is `Analysis.load_grm` on the genotypes: the reader, K5's
statistics, K4 and K1 over every chunk of SNPs, the normalization and
the sanitize step.  The 3.2 GB of files `--make-grm` writes are not
written.

Every unit hands back a sample of its rows (drawn from the seed), and
the last unit its whole matrix; the check holds them against the plain
float64 GRM.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import grm as ref_grm
from portbench.reference.genotypes import cohort_blocks

# GRM rows each unit hands back for the check
SAMPLE_ROWS = 64


def setup(ctx):
    from dissect_tpu_torch.analysis.dispatcher import Analysis
    from dissect_tpu_torch.runtime.options import Options

    options = Options.parse(["--make-grm", *ctx.cohort.argv, "--out", str(ctx.workdir / "grm")])
    rng = np.random.default_rng(ctx.seed)
    rows = np.sort(rng.choice(ctx.cohort.n, size=min(SAMPLE_ROWS, ctx.cohort.n), replace=False))
    return {"analysis": Analysis(options, ctx.device), "rows": rows, "last": None}


def unit(state, spans):
    state["last"] = None
    with spans.span("ComputeGRM"):
        kern = state["analysis"].load_grm()
        idx = torch.as_tensor(state["rows"], device=kern.matrix.device)
        sample = (kern.matrix[idx].double().cpu().numpy(), kern.counts[idx].double().cpu().numpy())
    state["last"] = kern
    return len(kern.snp_names), {"rows": sample, "idx": state["rows"], "n": kern.n}


def finish(state, outputs):
    """The last unit's whole matrix and counts, moved to the host once the
    window has closed."""
    kern = state.pop("last")
    outputs[-1]["whole"] = (kern.matrix.double().cpu().numpy(), kern.counts.double().cpu().numpy())


def reference(ctx, control=False):
    """The plain GRM and counts: float64, or TF32 products for the
    control (the configuration states float32)."""
    cohort, device = ctx.cohort, ctx.device
    kern, counts = ref_grm.grm(cohort_blocks(cohort, device), cohort.n, cohort.kind == "plink", device,
                               dtype=torch.float32 if control else torch.float64, tf32=control)
    return {"kernel": kern.cpu().numpy(), "counts": counts.cpu().numpy()}


def as_output(ref):
    """A reference result as the units' outputs (the control's readings)."""
    n = ref["kernel"].shape[0]
    return [{"rows": (ref["kernel"][:1], ref["counts"][:1]), "idx": np.arange(1), "n": n,
             "whole": (ref["kernel"], ref["counts"])}]


def gaps(outputs, ref):
    """The widest gap over every unit's sampled rows and the last unit's
    whole matrix: of a diagonal entry, of an off-diagonal entry, and of
    a count of SNPs two individuals share (exact)."""
    worst = {"diag_gap": 0.0, "offdiag_gap": 0.0, "count_gap": 0.0}

    def hold(kern, counts, idx):
        ref_k, ref_c = ref["kernel"][idx], ref["counts"][idx]
        diff = np.nan_to_num(np.abs(kern - ref_k), nan=np.inf)
        on_diag = np.zeros(diff.shape, dtype=bool)
        on_diag[np.arange(len(idx)), idx] = True
        worst["diag_gap"] = max(worst["diag_gap"], float(diff[on_diag].max()))
        worst["offdiag_gap"] = max(worst["offdiag_gap"], float(diff[~on_diag].max()))
        worst["count_gap"] = max(worst["count_gap"], float(np.abs(counts - ref_c).max()))

    for out in outputs:
        if out["n"] != ref["kernel"].shape[0]:
            return {k: float("inf") for k in worst}
        hold(*out["rows"], out["idx"])
        if "whole" in out:
            hold(*out["whole"], np.arange(out["n"]))
    return worst
