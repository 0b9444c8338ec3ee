"""Heterogeneous data container (a copy of dissect_tpu/io/hetvector.py).

Parity: hetvector.{h,cpp} — a name -> (genotype | covariate) container
returning the named element's matrix aligned to a requested individual
list (hetvector.h:34-51); used by experimental multi-source paths.
"""

from __future__ import annotations

from typing import Dict, List, Union

import numpy as np

from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.io.covariate import Covariate


class HetVector:
    """Named heterogeneous elements with individual-aligned extraction."""

    def __init__(self):
        self._elements: Dict[str, Union[PlinkData, Covariate]] = {}

    def insert(self, name: str, element: Union[PlinkData, Covariate]):
        if name in self._elements:
            raise ValueError(f"element {name} already present")
        self._elements[name] = element

    def names(self) -> List[str]:
        return list(self._elements)

    def keys_of(self, name: str) -> List[str]:
        el = self._elements[name]
        return el.individual_keys if isinstance(el, PlinkData) else el.keys

    def matrix_for(self, name: str, individual_keys: List[str]) -> np.ndarray:
        """The element's (n, features) matrix aligned to `individual_keys`
        (hetvector.h:42-51): standardized genotype columns for genotype
        elements, the design matrix for covariates."""
        el = self._elements[name]
        if isinstance(el, PlinkData):
            sub = el.filter(keep_individuals=individual_keys)
            stats = sub.stats()
            dosage = sub.dosages()
            observed = (dosage >= 0).astype(np.float64)
            std = np.where(stats.std == 0, 1.0, stats.std)  # monomorphic -> 0s
            z = observed * (dosage - stats.mean[:, None]) / std[:, None]
            return z.T  # (n, M)
        return el.filter_individuals(individual_keys).matrix
