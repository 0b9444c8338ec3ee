"""Phenotype file loading.

Parity: phenotype.{h,cpp} — a whitespace table with columns
FID IID pheno1 [pheno2 ...]; missing values are "-9" or "NA"
(phenotype.h:30-61).  An optional header line starting with FID is
skipped.  The selected column becomes a host float64 vector aligned by
FID@IID key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

MISSING_TOKENS = {"-9", "NA", "na", "-9.0", "nan", "NaN"}


@dataclasses.dataclass
class Phenotype:
    keys: List[str]  # FID@IID, file order
    values: np.ndarray  # (n,) float64, missing already removed
    column: int  # 1-based phenotype column used

    @property
    def n(self) -> int:
        return len(self.keys)

    def as_dict(self) -> Dict[str, float]:
        return dict(zip(self.keys, self.values))

    def variance(self) -> float:
        """Sample variance (parity: computePhenotypeVariance, phenotype.h:57)."""
        return float(np.var(self.values, ddof=1))


def _is_header(parts: List[str]) -> bool:
    return parts[0].upper() == "FID"


def read_phenotype(path: str, column: int = 1) -> Phenotype:
    """Read phenotype column `column` (1-based among phenotype columns).

    Individuals with a missing value in that column are dropped
    (parity: phenotype.cpp missing handling).
    """
    keys: List[str] = []
    values: List[float] = []
    seen = set()
    with open(path) as fh:
        for line_no, line in enumerate(fh):
            parts = line.split()
            if not parts:
                continue
            if line_no == 0 and _is_header(parts):
                continue
            if len(parts) < 2 + column:
                raise ValueError(
                    f"{path}:{line_no + 1}: expected >= {2 + column} columns"
                )
            key = parts[0] + "@" + parts[1]
            if key in seen:
                raise ValueError(f"{path}: duplicated individual {key}")
            seen.add(key)
            tok = parts[1 + column]
            if tok in MISSING_TOKENS:
                continue
            keys.append(key)
            values.append(float(tok))
    return Phenotype(keys=keys, values=np.asarray(values, dtype=np.float64), column=column)


def n_phenotype_columns(path: str) -> int:
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if parts and not _is_header(parts):
                return len(parts) - 2
    return 0
