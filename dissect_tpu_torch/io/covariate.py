"""Covariate design-matrix construction.

Parity: covariate.{h,cpp} — discrete (--covar) and quantitative
(--qcovar) covariate files combine into a fixed-effects design matrix X
with layout

    [ mean column(s) | discrete indicators | quantitative values ]

Discrete columns expand category -> 0/1 indicators with the FIRST
category dropped (reestructureDiscreteCovariateUsingDifferences,
covariate.h:119-131), so effects are relative to that category.
Individuals with any missing covariate are tracked
(individualIdsWithMissingData, covariate.h:48) and excluded.  For
multi-trait models each trait gets its own mean column
(nMeans/idxThisMean, covariate.h:74-76) — handled by the REML layer via
block-diagonal X assembly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from dissect_tpu_torch.io.phenotype import MISSING_TOKENS


def _read_table(path: str) -> Dict[str, List[str]]:
    """FID@IID -> covariate token list (header with leading FID skipped)."""
    table: Dict[str, List[str]] = {}
    with open(path) as fh:
        for line_no, line in enumerate(fh):
            parts = line.split()
            if not parts:
                continue
            if line_no == 0 and parts[0].upper() == "FID":
                continue
            key = parts[0] + "@" + parts[1]
            if key in table:
                raise ValueError(f"{path}: duplicated individual {key}")
            table[key] = parts[2:]
    return table


@dataclasses.dataclass
class Covariate:
    """The fixed-effects design matrix for one trait."""

    keys: List[str]  # individuals with complete covariate data
    matrix: np.ndarray  # (n, c) float64 incl. leading mean column
    column_names: List[str]
    missing_keys: List[str]  # individuals dropped due to missing data
    # category tables per discrete column, for cross-trait synchronization
    # (syncronizeDiscreteCovariateCategoriesWith, covariate.h:95)
    categories: List[List[str]]

    @property
    def n(self) -> int:
        return len(self.keys)

    @property
    def n_columns(self) -> int:
        return self.matrix.shape[1]

    def filter_individuals(self, keep_keys: Sequence[str]) -> "Covariate":
        index = {k: i for i, k in enumerate(self.keys)}
        idx = [index[k] for k in keep_keys]
        return Covariate(
            keys=list(keep_keys),
            matrix=self.matrix[idx],
            column_names=self.column_names,
            missing_keys=self.missing_keys,
            categories=self.categories,
        )


def load_effect_prediction(
    discrete_path: Optional[str],
    quantitative_path: Optional[str],
    covar_effects_path: Optional[str],
    qcovar_effects_path: Optional[str],
    force_unestimated: bool = False,
) -> Dict[str, float]:
    """Per-individual covariate phenotype contribution from stored
    effects (Covariate::loadEffectPrediction, covariate.cpp:624-713;
    --cov-predict workflow analysis.cpp:436-456).

    Effects files are 'NAME BETA STD' tables as written by our BLUE
    writers (summary.write_blue): discrete names `discrete_<col>_<cat>`
    (the first/base category of each column has effect 0),
    quantitative names `quantitative_<col>`.  An individual whose
    category has no stored effect errors unless `force_unestimated`
    (--force-use-unestimated-values, covariate.cpp:673-678)."""

    def read_effects(path):
        table: Dict[str, float] = {}
        if not path:
            return table
        with open(path) as fh:
            for line_no, line in enumerate(fh):
                parts = line.split()
                if not parts or (line_no == 0 and parts[0].upper() == "NAME"):
                    continue
                table[parts[0]] = float(parts[1])
        return table

    disc_eff = read_effects(covar_effects_path)
    # column -> {category: effect}
    disc_by_col: Dict[int, Dict[str, float]] = {}
    for name, beta in disc_eff.items():
        if not name.startswith("discrete_"):
            continue
        _, col, cat = name.split("_", 2)
        disc_by_col.setdefault(int(col), {})[cat] = beta
    quant_eff = read_effects(qcovar_effects_path)
    quant_by_col = {
        int(name.split("_", 1)[1]): beta
        for name, beta in quant_eff.items()
        if name.startswith("quantitative_")
    }

    disc = _read_table(discrete_path) if discrete_path else {}
    quant = _read_table(quantitative_path) if quantitative_path else {}
    keys = list(disc) if disc else list(quant)

    # base (first) categories per column carry effect 0, as in the BLUE
    # design matrix where the first category is dropped
    bases: Dict[int, str] = {}
    if disc:
        n_disc = len(next(iter(disc.values())))
        for c in range(n_disc):
            cats = sorted(
                {disc[k][c] for k in disc if disc[k][c] not in MISSING_TOKENS}
            )
            if cats:
                bases[c + 1] = cats[0]

    result: Dict[str, float] = {}
    for k in keys:
        value = 0.0
        ok = True
        if disc:
            for c, tok in enumerate(disc[k], start=1):
                if tok in MISSING_TOKENS:
                    ok = False
                    break
                table = disc_by_col.get(c, {})
                if tok in table:
                    value += table[tok]
                elif tok != bases.get(c) and not force_unestimated:
                    raise ValueError(
                        f"discrete covariate key {tok} (column {c}) has no "
                        "stored effect; use --force-use-unestimated-values "
                        "to count it as 0 (covariate.cpp:673-678)"
                    )
        if ok and quant and k in quant:
            for c, tok in enumerate(quant[k], start=1):
                if tok in MISSING_TOKENS:
                    ok = False
                    break
                value += float(tok) * quant_by_col.get(c, 0.0)
        if ok:
            result[k] = value
    return result


def read_covariates(
    discrete_path: Optional[str] = None,
    quantitative_path: Optional[str] = None,
    default_keys: Optional[Sequence[str]] = None,
    categories: Optional[List[List[str]]] = None,
    include_mean: bool = True,
) -> Covariate:
    """Build the design matrix from optional discrete + quantitative files.

    With no files, X is a single mean column over `default_keys`
    (parity: Covariate constructor with emptyIndividualIds).
    `categories` overrides the per-column category order, for category
    synchronization across traits.  `include_mean=False` omits the
    leading mean column (the reference's testing-covariate parse with
    zero mean columns, igwas.cpp:134-140 / covariate.h:119-131).
    """
    disc = _read_table(discrete_path) if discrete_path else None
    quant = _read_table(quantitative_path) if quantitative_path else None

    if disc is None and quant is None:
        if default_keys is None:
            raise ValueError("need default_keys when no covariate files given")
        keys = list(default_keys)
        return Covariate(
            keys=keys,
            matrix=np.ones((len(keys), 1), dtype=np.float64),
            column_names=["mean"],
            missing_keys=[],
            categories=[],
        )

    # individual universe: intersection of provided files, ordered by first file
    sources = [t for t in (disc, quant) if t is not None]
    keys = [k for k in sources[0] if all(k in s for s in sources[1:])]

    n_disc = len(next(iter(disc.values()))) if disc else 0
    n_quant = len(next(iter(quant.values()))) if quant else 0

    # determine categories for each discrete column (sorted for determinism)
    if categories is None:
        categories = []
        for c in range(n_disc):
            seen = sorted(
                {disc[k][c] for k in keys if disc[k][c] not in MISSING_TOKENS}
            )
            categories.append(seen)

    good_keys: List[str] = []
    missing_keys: List[str] = []
    rows: List[List[float]] = []
    for k in keys:
        row: List[float] = [1.0] if include_mean else []
        ok = True
        for c in range(n_disc):
            tok = disc[k][c]
            if tok in MISSING_TOKENS or tok not in categories[c]:
                ok = False
                break
            # first category dropped -> len(cats)-1 indicators
            for cat in categories[c][1:]:
                row.append(1.0 if tok == cat else 0.0)
        if ok:
            for c in range(n_quant):
                tok = quant[k][c]
                if tok in MISSING_TOKENS:
                    ok = False
                    break
                row.append(float(tok))
        if ok:
            good_keys.append(k)
            rows.append(row)
        else:
            missing_keys.append(k)

    names = ["mean"] if include_mean else []
    for c in range(n_disc):
        for cat in categories[c][1:]:
            names.append(f"discrete_{c + 1}_{cat}")
    for c in range(n_quant):
        names.append(f"quantitative_{c + 1}")

    return Covariate(
        keys=good_keys,
        matrix=np.asarray(rows, dtype=np.float64).reshape(len(good_keys), len(names)),
        column_names=names,
        missing_keys=missing_keys,
        categories=categories,
    )
