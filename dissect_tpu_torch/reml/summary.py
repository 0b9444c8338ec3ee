"""REML result writers — .reml / .blue.* / .blup.indiv files.

Parity: REML::computeSummary (reml.cpp:2761-2922) — variances with SEs
from the AI inverse, per-group total variance and heritabilities with
the GCTA ratio-variance delta SE; computeBLUE output files
(reml.cpp:2924-2981); computeIndividualsBLUP .blup.indiv files
(reml.cpp:2983-3096).  Port of dissect_tpu/reml/summary.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dissect_tpu_torch.model.covariance import CovarianceModel, EffectType, ParameterType
from dissect_tpu_torch.reml.engine import REMLResult
from dissect_tpu_torch.runtime.log import result_open


@dataclasses.dataclass
class GroupSummary:
    group: str
    total_variance: float
    total_variance_se: float
    # (variance name, h2, se) per genetic variance in the group
    heritabilities: List[Tuple[str, float, float]]


def group_summaries(model: CovarianceModel, result: REMLResult) -> List[GroupSummary]:
    """Per-group Var(total) and h2 with the reference's ratio-variance SE
    (reml.cpp:2838-2906)."""
    theta, ai = result.variances, result.ai_inverse
    groups: Dict[str, Dict[str, list]] = {}
    for i, v in enumerate(model.variances):
        if v.type != ParameterType.VARIANCE:
            continue
        g = groups.setdefault(v.group, {"genetic": [], "env": []})
        if v.effect == EffectType.ENVIRONMENT:
            g["env"].append(i)
        elif v.effect == EffectType.GENETIC:
            g["genetic"].append(i)
    out = []
    for group, idxs in groups.items():
        if not idxs["env"]:
            continue
        env = idxs["env"][0]
        genetic = idxs["genetic"]
        total = theta[env] + sum(theta[i] for i in genetic)
        var_total = ai[env, env]
        for gi in genetic:
            var_total += ai[gi, env] + ai[env, gi]
            for gj in genetic:
                var_total += ai[gi, gj]
        herits = []
        for gi in genetic:
            gvar = theta[gi]
            cov = ai[gi, env] + sum(ai[gi, gj] for gj in genetic)
            h2 = gvar / total
            varh2 = (
                ai[gi, gi] / gvar**2 + var_total / total**2 - 2.0 * cov / (gvar * total)
            ) * h2**2
            herits.append(
                (model.variances[gi].name, h2, float(np.sqrt(max(varh2, 0.0))))
            )
        out.append(
            GroupSummary(
                group=group,
                total_variance=float(total),
                total_variance_se=float(np.sqrt(max(var_total, 0.0))),
                heritabilities=herits,
            )
        )
    return out


def _us(name: str) -> str:
    """spacetab2underscore parity."""
    return name.replace(" ", "_").replace("\t", "_")


def write_reml_summary(
    path: str,
    model: CovarianceModel,
    result: REMLResult,
    use_ml: bool = False,
    field_width: int = 20,
):
    """Write the .reml (or .ml) summary file (computeSummary layout)."""
    fname = path + (".ml" if use_ml else ".reml")
    with result_open(fname) as fh:
        for w in result.warnings:
            fh.write(f"#  WARNING: {w}\n")
        if result.warnings:
            fh.write("\n")
        fh.write("#  Summary results:\n#-----------------------------\n\n")
        for i, name in enumerate(result.variance_names):
            se = np.sqrt(max(result.ai_inverse[i, i], 0.0))
            fh.write(
                f"{_us(name)}{result.variances[i]:{field_width}.6g}{se:{field_width}.6g}\n"
            )
        for gs in group_summaries(model, result):
            fh.write(f"\n# {gs.group}:\n\n")
            fh.write(
                f"Var({gs.group}){gs.total_variance:{field_width}.6g}"
                f"{gs.total_variance_se:{field_width}.6g}\n"
            )
            for name, h2, se in gs.heritabilities:
                fh.write(
                    f"{_us(name)}/Var({gs.group}){h2:{field_width}.6g}"
                    f"{se:{field_width}.6g}\n"
                )
        fh.write("\n#  AI Matrix inverse:\n#-----------------------------\n\n")
        names = result.variance_names
        fh.write(" " * 15 + "".join(f"{n:>15s}" for n in names) + "\n")
        for i, name in enumerate(names):
            row = "".join(
                f"{result.ai_inverse[i, j]:15.6g}" for j in range(i + 1)
            )
            fh.write(f"{name:>15s}{row}\n")
        fh.write("\n")
    return fname


def write_blue(
    path: str,
    beta: np.ndarray,
    se: np.ndarray,
    column_names: Sequence[str],
    pheno_suffix: str = "",
):
    """Write .blue.mean/.blue.discrete/.blue.quantitative
    (computeBLUE, reml.cpp:2952-2979)."""
    kinds = {"mean": [], "discrete": [], "quantitative": []}
    for i, name in enumerate(column_names):
        if name.startswith("discrete"):
            kinds["discrete"].append((name, i))
        elif name.startswith("quantitative"):
            kinds["quantitative"].append((name, i))
        else:
            kinds["mean"].append((name, i))
    for kind, entries in kinds.items():
        fname = f"{path}{pheno_suffix}.blue.{kind}"
        with result_open(fname) as fh:
            fh.write("NAME BETA STD\n")
            for name, i in entries:
                fh.write(f"{name} {beta[i]:.8g} {se[i]:.8g}\n")


def write_blup_indiv(
    path: str,
    sub_name: str,
    individual_keys: Sequence[str],
    blup: np.ndarray,
    errors: Optional[np.ndarray] = None,
    pheno_suffix: str = "",
):
    """Write .<name>.blup.indiv (reml.cpp:3036-3053)."""
    fname = f"{path}.{_us(sub_name)}{pheno_suffix}.blup.indiv"
    with result_open(fname) as fh:
        fh.write("FID IID BLUP" + (" STD\n" if errors is not None else "\n"))
        for i, key in enumerate(individual_keys):
            fid, iid = key.split("@", 1)
            line = f"{fid} {iid} {blup[i]:.8g}"
            if errors is not None:
                line += f" {errors[i]:.8g}"
            fh.write(line + "\n")
    return fname
