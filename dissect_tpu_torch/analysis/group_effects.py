"""Group-effects analysis.

Parity: groupeffects.{h,cpp} + the effects workflow
(analysis.cpp:262-415): load per-group effect LabeledMatrices
(individuals x groups, emitted by grouped GWAS with --group-effects),
compute cross-group correlations and cross-individual covariances,
filter highly correlated group pairs that are positionally close
(GroupAttributes::getDistance, groupeffects.h:42-64;
filterCorrelatedGroups, groupeffects.h:81), and run PCA on the
individual-covariance matrix (PCAGenTemp, pcagentemp.{h,cpp}).
Port of dissect_tpu/analysis/group_effects.py: host numpy, but for the
eigendecomposition, which runs in float64 on a device (the port's
`eigh_full`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.linalg.eigen import eigh_full


@dataclasses.dataclass
class GroupPosition:
    """Parity: GroupAttributes (groupeffects.h:31-64)."""

    name: str
    chromosome: str
    min_position: float
    max_position: float

    def distance(self, other: "GroupPosition") -> Optional[float]:
        """None across chromosomes; 0 when the spans overlap."""
        if self.chromosome != other.chromosome:
            return None
        if self.min_position <= other.max_position and other.min_position <= self.max_position:
            return 0.0
        return min(
            abs(self.max_position - other.min_position),
            abs(self.min_position - other.max_position),
        )


class GroupEffects:
    """Effects matrix (individuals x groups) with cross-analyses."""

    def __init__(self, effects: LabeledMatrix):
        self.effects = effects

    @staticmethod
    def load(prefixes: Sequence[str]) -> "GroupEffects":
        """Load and column-concatenate per-chromosome effect files
        (GroupEffects(fns, row), groupeffects.h:73)."""
        lm = LabeledMatrix.load(prefixes[0])
        for prefix in prefixes[1:]:
            nxt = LabeledMatrix.load(prefix)
            if nxt.row_labels != lm.row_labels:
                nxt = nxt.filter(keep_rows=lm.row_labels)
            lm = LabeledMatrix(
                lm.row_labels,
                lm.col_labels + nxt.col_labels,
                np.hstack([lm.values, nxt.values]),
            )
        return GroupEffects(lm)

    def correlations_between_groups(self) -> LabeledMatrix:
        """Group x group correlation matrix (computeCorrelations(column))."""
        v = self.effects.values
        centered = v - v.mean(axis=0, keepdims=True)
        norms = np.linalg.norm(centered, axis=0)
        norms[norms == 0] = 1.0
        corr = (centered.T @ centered) / np.outer(norms, norms)
        return LabeledMatrix(self.effects.col_labels, self.effects.col_labels, corr)

    def covariances_between_individuals(self) -> LabeledMatrix:
        """Individual x individual covariance (computeCovariances(row))."""
        v = self.effects.values
        centered = v - v.mean(axis=1, keepdims=True)
        cov = centered @ centered.T / max(v.shape[1] - 1, 1)
        return LabeledMatrix(self.effects.row_labels, self.effects.row_labels, cov)

    def covariances_between_groups(self) -> LabeledMatrix:
        """Group x group covariance (computeCovariances(column))."""
        v = self.effects.values
        centered = v - v.mean(axis=0, keepdims=True)
        cov = centered.T @ centered / max(v.shape[0] - 1, 1)
        return LabeledMatrix(self.effects.col_labels, self.effects.col_labels, cov)

    def filter_correlated_groups(
        self,
        threshold: float,
        positions: Dict[str, GroupPosition],
        min_distance: float,
    ) -> "GroupEffects":
        """Drop one group of each highly-correlated pair closer than
        `min_distance` bp (filterCorrelatedGroups, groupeffects.h:81)."""
        corr = self.correlations_between_groups()
        labels = corr.col_labels
        drop = set()
        c = corr.values
        for i in range(len(labels)):
            if labels[i] in drop:
                continue
            for j in range(i + 1, len(labels)):
                if labels[j] in drop or abs(c[i, j]) <= threshold:
                    continue
                pi, pj = positions.get(labels[i]), positions.get(labels[j])
                if pi is None or pj is None:
                    continue
                d = pi.distance(pj)
                if d is not None and d < min_distance:
                    drop.add(labels[j])
        kept = [l for l in labels if l not in drop]
        return GroupEffects(self.effects.filter(keep_cols=kept))


def read_group_positions(path: str) -> Dict[str, GroupPosition]:
    """'GROUP CHR MINPOS MAXPOS' rows (getGroupPositions)."""
    out: Dict[str, GroupPosition] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if len(parts) >= 4:
                out[parts[0]] = GroupPosition(
                    parts[0], parts[1], float(parts[2]), float(parts[3])
                )
    return out


def crossed_correlations(
    g1: "GroupEffects", g2: "GroupEffects"
) -> LabeledMatrix:
    """Group x group correlations ACROSS two effect sets on shared
    individuals (the --effects-pair-files branch,
    analysis.cpp:388-415): column-standardize both matrices and form
    E1s^T E2s / n."""
    common = [k for k in g1.effects.row_labels if k in set(g2.effects.row_labels)]
    e1 = g1.effects.filter(keep_rows=common)
    e2 = g2.effects.filter(keep_rows=common)

    def _std(v):
        c = v - v.mean(axis=0, keepdims=True)
        s = c.std(axis=0)
        s[s == 0] = 1.0
        return c / s

    corr = _std(e1.values).T @ _std(e2.values) / len(common)
    return LabeledMatrix(e1.col_labels, e2.col_labels, corr)


def pca_of_labeled_matrix(
    lm: LabeledMatrix, n_components: int = 20, device="cuda"
) -> Tuple[np.ndarray, LabeledMatrix]:
    """PCA of an arbitrary symmetric LabeledMatrix (PCAGenTemp,
    pcagentemp.h:39-48): eigendecompose in float64 on `device`, keep the
    top components.  Each loading column is defined up to its sign."""
    w, v = eigh_full(torch.as_tensor(lm.values, device=device))
    w = w.cpu().numpy()[::-1]
    v = v.cpu().numpy()[:, ::-1]
    k = min(n_components, len(w))
    loadings = LabeledMatrix(
        lm.row_labels, [f"PC{i + 1}" for i in range(k)], v[:, :k]
    )
    return w[:k], loadings
