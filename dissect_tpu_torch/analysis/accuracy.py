"""Prediction accuracy by SNP — leave-one-SNP-out polygenic accuracy
(a copy of dissect_tpu/analysis/accuracy.py).

Parity: accuracybysnp.{h,cpp} (experimental in the reference): for
every effect SNP, the polygenic score minus that SNP's contribution is
row-standardized and correlated with the standardized phenotype
(computeAccuracies, accuracybysnp.cpp:67-214); SNPs whose removal
raises accuracy beyond mean + scale*std thresholds are iteratively
filtered, scanning the scale from 3 downward in 0.1 steps until
accuracy stops improving (accuracyFilteringAt,
accuracybysnp.cpp:260-303).  Output: .snps.accuracies with columns
SNP ALLELE STDEV MEAN EFFECT CORR DELTA.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from dissect_tpu_torch.analysis.predict import SnpEffect, predict_phenotypes
from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.runtime.log import output_open


@dataclasses.dataclass
class AccuracyResult:
    snp_names: List[str]
    alleles: List[str]
    effects: np.ndarray
    loo_accuracies: np.ndarray  # accuracy of the score with the SNP removed
    total_accuracy: float
    filtered_accuracy: float
    filtered_snps: List[str]

    def write(self, prefix: str, stats):
        with output_open(prefix + ".snps.accuracies", "w") as fh:
            fh.write("SNP ALLELE STDEV MEAN EFFECT CORR DELTA\n")
            for i, snp in enumerate(self.snp_names):
                fh.write(
                    f"{snp} {self.alleles[i]} {stats.std[i]:.14g} "
                    f"{stats.mean[i]:.14g} {self.effects[i]:.14g} "
                    f"{self.loo_accuracies[i]:.14g} "
                    f"{self.total_accuracy - self.loo_accuracies[i]:.14g}\n"
                )


def _accuracy(pred: np.ndarray, y_std: np.ndarray) -> float:
    p = pred / np.std(pred)
    return float(p @ y_std / len(y_std))


def compute_accuracy_by_snp(
    data: PlinkData,
    effects: Dict[str, SnpEffect],
    phenotype_values: np.ndarray,
) -> AccuracyResult:
    """data/phenotype already aligned to the same individuals."""
    base = predict_phenotypes(data, effects)
    y_std = phenotype_values / np.std(phenotype_values)
    total = _accuracy(base.scores, y_std)

    # per-SNP contribution matrix (M, n): effect*dosage + shift, missing -> 0
    name_to_idx = {s.name: i for i, s in enumerate(data.snps)}
    used = [n for n in effects if n in name_to_idx]
    dosage = data.dosages()[[name_to_idx[n] for n in used]]
    observed = (dosage >= 0).astype(np.float64)
    eff = np.empty(len(used))
    shift = np.empty(len(used))
    for k, n in enumerate(used):
        se = effects[n]
        snp = data.snps[name_to_idx[n]]
        if se.allele == snp.allele2:
            eff[k], shift[k] = se.effect, 0.0
        else:
            eff[k], shift[k] = -se.effect, 2.0 * se.effect
    contrib = observed * (
        np.where(dosage >= 0, dosage, 0) * eff[:, None] + shift[:, None]
    )
    loo = base.scores[None, :] - contrib  # (M, n)
    loo = loo - loo.mean(axis=1, keepdims=True)
    stds = loo.std(axis=1, ddof=1)
    stds[stds == 0] = 1.0
    loo_acc = (loo / stds[:, None]) @ y_std / len(y_std)

    # threshold scan (accuracyFilteringAt)
    mean, std = loo_acc.mean(), loo_acc.std(ddof=1)
    scale, best, best_snps = 3.0, total, list(used)
    prev = total
    while scale > 0:
        threshold = mean + std * scale
        keep = [n for k, n in enumerate(used) if loo_acc[k] < threshold]
        if not keep:
            break
        sub_effects = {n: effects[n] for n in keep}
        pred = predict_phenotypes(data.filter(keep_snps=keep), sub_effects)
        acc = _accuracy(pred.scores, y_std)
        if acc < prev:
            break
        if acc > best:
            best, best_snps = acc, keep
        prev = acc
        scale -= 0.1

    return AccuracyResult(
        snp_names=used,
        alleles=[data.snps[name_to_idx[n]].allele2 for n in used],
        effects=np.array([effects[n].effect for n in used]),
        loo_accuracies=np.asarray(loo_acc),
        total_accuracy=total,
        filtered_accuracy=best,
        filtered_snps=best_snps,
    )
