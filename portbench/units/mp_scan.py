"""One multi-phenotype scan pass, as `--mpgwas` runs it, without its files.

Set-up draws the residual matrix that `--mpresiduals` would have written
(the configuration's `assumed.residuals`): `n_phenotypes` traits made
the cohort's way on the device from the seed, each less its least
squares fit on the mean and the cohort's two covariates, written with
the program's own `LabeledMatrix.save` to `<out>.residuals.*`.  The
harness hands a unit the cohort alone, so the number of columns and the
trait recipe are read from the configuration file (UNIT_CONFIG).

A unit is `Analysis.mp_gwas_scan`: the residual load (read, filter,
centre, one upload), LoadGenotypes (the reader, the individual filter,
K5's statistics), then every chunk of SNPs against every residual
column, to the concatenated results.  The CLI's writers (M x P lines of
text) are left out.

The check recomputes every (SNP, column) effect, SE and p-value with
the plain reference (`reference/mp_gwas.py`) from the genotypes as
written and the residual file as written, and holds every unit to it.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench.cohort import generator
from portbench.reference import genotypes as ref_genotypes
from portbench.reference import mp_gwas as ref_mp

UNIT_CONFIG = Path(__file__).resolve().parents[1] / "configs" / "ukb_geneatlas_n452k.json"
# the residual stream's seed, apart from the cohort's stream of the same seed
RESIDUAL_STREAM = 0x6D70


def unit_config() -> dict:
    return json.loads(UNIT_CONFIG.read_text())


def residual_columns(cohort, config: dict, seed: int, device) -> np.ndarray:
    """(n, P) float64: P traits from one set of `n_causal` SNPs of the
    cohort (standardized, missing as 0), each with its own normal
    effects scaled to h2 and its own noise, plus the intercept and the
    covariates' effects; then each less its float64 least squares fit on
    the cohort's design (the mean and the two covariates)."""
    gen = generator((seed + RESIDUAL_STREAM) % (1 << 63), device)
    n_traits, n, h2 = config["n_phenotypes"], cohort.n, config["h2"]
    causal = torch.randperm(cohort.m, generator=gen, device=device)[: config["n_causal"]]
    packed = cohort.packed[causal.sort().values.cpu().numpy()]
    d, observed = ref_genotypes.as_float(
        ref_genotypes.decode_bed(torch.as_tensor(packed, device=device), n))
    mu = d.sum(1, keepdim=True) / observed.sum(1, keepdim=True)
    z = torch.where(observed, (d - mu) / d.std(1, keepdim=True), torch.zeros_like(d))
    del d, observed
    effects = torch.randn((n_traits, z.shape[0]), generator=gen, device=device,
                          dtype=torch.float64)
    y = effects @ z
    del z
    y *= math.sqrt(h2) / y.std(1, keepdim=True)
    y += math.sqrt(1.0 - h2) * torch.randn((n_traits, n), generator=gen, device=device,
                                           dtype=torch.float64)
    x = torch.as_tensor(cohort.design(), device=device, dtype=torch.float64)
    fixed = torch.tensor([config["intercept"], *config["qcovar_effects"]], device=device,
                         dtype=torch.float64)
    y += (x @ fixed)[None, :]
    y = y.T  # (n, P)
    coef = torch.linalg.solve(x.T @ x, x.T @ y)
    return (y - x @ coef).cpu().numpy()


def setup(ctx):
    from dissect_tpu_torch.analysis.dispatcher import Analysis
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
    from dissect_tpu_torch.runtime.options import Options

    options = Options.parse(["--mpgwas", *ctx.cohort.argv, "--out", str(ctx.workdir / "mp")])
    analysis = Analysis(options, ctx.device)
    scan = analysis.mp_gwas_scan  # a program without the public scan ends the run here
    config = unit_config()
    values = residual_columns(ctx.cohort, config, ctx.seed, ctx.device)
    keys = analysis.load_genotype().individual_keys
    prefix = options.args.out + ".residuals"
    LabeledMatrix(keys, [f"pheno_{j + 1}" for j in range(values.shape[1])], values).save(prefix)
    return {"scan": scan, "residuals": prefix}


def unit(state, spans):
    with spans.span("MpGwas"):
        res, data = state["scan"](state["residuals"])
    return data.n_snps, {"beta": res.beta, "se": res.se, "p": res.p}


def reference(ctx, control=False):
    """Every (SNP, column) effect, SE and p-value by the plain reference,
    from the residual file set-up wrote (the control: TF32 products).
    Without a set-up (`control.py` runs none) the same residuals are
    drawn again from the seed."""
    path = ctx.workdir / "mp.residuals.dat"
    if path.exists():
        residuals = ref_mp.read_dat(path, ctx.cohort.n)
    else:
        residuals = residual_columns(ctx.cohort, unit_config(), ctx.seed, ctx.device)
    return ref_mp.mp_gwas(ctx.cohort, residuals, ctx.device, control=control)


def as_output(ref):
    """A reference result as the units' outputs (the control's readings)."""
    return [{k: ref[k] for k in ("beta", "se", "p")}]


def gaps(outputs, ref):
    """The compared numbers over every (SNP, column) pair of every unit:
    the widest gap of an effect in units of its reference SE, of an SE
    relative to the reference's, and of a -log10 p relative to the
    reference's (at least 1).  A unit whose results are not the
    reference's shape (a chunk left out) reads infinite."""
    tiny = np.finfo(float).tiny
    r_log = -np.log10(np.maximum(ref["p"], tiny))
    worst = {"beta_gap_se": 0.0, "se_gap": 0.0, "log10p_gap": 0.0}
    for out in outputs:
        if any(np.shape(out[k]) != ref[k].shape for k in ("beta", "se", "p")):
            return {k: np.inf for k in worst}
        p_log = -np.log10(np.maximum(out["p"], tiny))
        for name, value in (
            ("beta_gap_se", np.abs(out["beta"] - ref["beta"]) / ref["se"]),
            ("se_gap", np.abs(out["se"] / ref["se"] - 1.0)),
            ("log10p_gap", np.abs(p_log - r_log) / np.maximum(r_log, 1.0)),
        ):
            worst[name] = max(worst[name], float(np.nan_to_num(value, nan=np.inf).max()))
    return worst
