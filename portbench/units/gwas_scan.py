"""One genome scan, as `--gwas --grm` runs it once its covariance is ready.

Set-up builds the covariance as the dispatcher's `_gwas_covariance`
does: the GRM from the genotypes (`grm_from_plink`, sanitized as
`load_grm` sanitizes it), its float64 eigendecomposition and the null
REML on the diagonal fast path.  A unit is `make_gwas` from
LoadGenotypes (the reader, the individual filter, the statistics) to
the end of its GWAS phase (the dispatcher's `_chunked_gwas` over the
ML refit it builds); no output file is written.

The check recomputes the GRM, its eigendecomposition, the null fit and
every SNP's refit with the plain reference, and holds each unit's
per-SNP effects, SEs and p-values against them.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import genotypes as ref_genotypes
from portbench.reference import grm as ref_grm
from portbench.reference import mixed_model as ref_mm


def setup(ctx):
    from dissect_tpu_torch.analysis.dispatcher import Analysis
    from dissect_tpu_torch.io.ids import intersection_keeping_order
    from dissect_tpu_torch.model.kernels import grm_from_plink
    from dissect_tpu_torch.runtime.options import Options

    options = Options.parse(["--gwas", *ctx.cohort.argv, "--out", str(ctx.workdir / "gwas")])
    a = options.args
    analysis = Analysis(options, ctx.device)
    data = analysis.load_genotype()
    kern = grm_from_plink(data, flat_normalization=a.grm_flat_norm,
                          drop_monomorphic=a.keep_zerostd_snps, device=ctx.device)
    kern = kern.sanitize(a.min_overlap_snps)
    pheno = analysis.load_phenotypes()[0]
    covar = analysis.load_covariate(pheno.keys)
    common = intersection_keeping_order(kern.individual_keys, pheno.keys, covar.keys,
                                        data.individual_keys)
    del data
    lam, u, (vg, ve) = analysis._gwas_covariance([kern], common, pheno, covar)
    pm = pheno.as_dict()
    return {
        "analysis": analysis,
        "common": common,
        "y": np.array([pm[k] for k in common]),
        "x": covar.filter_individuals(common).matrix,
        "covariance": (lam, u, (vg, ve)),
    }


def unit(state, spans):
    from dissect_tpu_torch.analysis.dispatcher import _chunked_gwas
    from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
    from dissect_tpu_torch.runtime.dtypes import bulk_dtype

    analysis = state["analysis"]
    lam, u, null = state["covariance"]
    with spans.span("LoadGenotypes"):
        data = analysis.load_genotype()
        data = data.filter(keep_individuals=state["common"])
        stats = data.stats()
    y, x = state["y"], state["x"]
    retry = analysis.args.gwas_retry_unfitted
    solver = lambda z: mlm_gwas_ml_refit(z, y, x, lam, u, null, retry_unfitted=retry)
    with spans.span("GWAS"):
        res, _ = _chunked_gwas(solver, data, stats.mean, analysis.device,
                               bulk_dtype(analysis.device))
    return data.n_snps, {"beta": res.snp_beta, "se": res.snp_se, "p": res.snp_p}


def reference(ctx, control=False):
    """Every SNP's effect, SE and p-value by the plain reference: float64
    (the control: each stage one precision below what the configuration
    states, TF32 for the float32 GRM and rotation, float32 for the
    float64 eigendecomposition and null fit)."""
    cohort, device = ctx.cohort, ctx.device
    hard = cohort.kind == "plink"
    lo = torch.float32 if control else torch.float64
    kern, _ = ref_grm.grm(ref_genotypes.cohort_blocks(cohort, device), cohort.n, hard, device,
                          dtype=torch.float32 if control else torch.float64, tf32=control)
    lam, u = torch.linalg.eigh(kern.to(lo))
    del kern
    y = torch.as_tensor(cohort.traits[0], device=device, dtype=lo)
    x = torch.as_tensor(cohort.design(), device=device, dtype=lo)
    y_rot, x_rot = u.T @ y, u.T @ x
    theta0 = ref_mm.reml_diagonal(lam, y_rot, x_rot, dtype=lo)["theta"]
    out = {k: [] for k in ("beta", "se", "p")}
    for rows in ref_genotypes.cohort_blocks(cohort, device):
        mean, _ = ref_genotypes.row_stats(rows, hard)
        g = ref_genotypes.centered(rows, mean)
        if control:
            g_rot = ref_mm.rotate(g, u, torch.float32, tf32=True)
        else:
            g_rot = ref_mm.rotate(g, u)
        fit = ref_mm.ml_refit(g_rot, y_rot, x_rot, lam, theta0,
                              dtype=torch.float32 if control else torch.float64)
        for k in out:
            out[k].append(fit[k].to(torch.float64).cpu().numpy())
    return {k: np.concatenate(v) for k, v in out.items()}


def as_output(ref):
    """A reference result as the units' outputs (the control's readings)."""
    return [{k: ref[k] for k in ("beta", "se", "p")}]


def gaps(outputs, ref):
    """The compared numbers over every unit of the window: the widest gap
    of a SNP's effect in units of its reference SE, of its SE relative to
    the reference's, and of its -log10 p relative to the reference's (at
    least 1).  Every SNP tested counts, those the refit reports unfitted
    too: a refit that stops short of the optimum shows in its numbers."""
    tiny = np.finfo(float).tiny
    r_log = -np.log10(np.maximum(ref["p"], tiny))
    worst = {"beta_gap_se": 0.0, "se_gap": 0.0, "log10p_gap": 0.0}
    for out in outputs:
        p_log = -np.log10(np.maximum(out["p"], tiny))
        for name, value in (
            ("beta_gap_se", np.abs(out["beta"] - ref["beta"]) / ref["se"]),
            ("se_gap", np.abs(out["se"] / ref["se"] - 1.0)),
            ("log10p_gap", np.abs(p_log - r_log) / np.maximum(r_log, 1.0)),
        ):
            worst[name] = max(worst[name], float(np.nan_to_num(value, nan=np.inf).max()))
    return worst
