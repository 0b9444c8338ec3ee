"""Polygenic phenotype prediction (a copy of dissect_tpu/analysis/predict.py).

Parity: predictphenotype.{h,cpp} — polygenic score y_hat = G' effects
with allele-flip handling via a per-SNP shift column and the coding
correction (predictPhenotypes, predictphenotype.cpp): missing genotypes
contribute nothing; observed genotypes contribute effect * dosage +
shift.  Effect files in REML-BLUP (.blup.snps: SNP ALLELE MEAN BLUP...)
or GWAS (.gwas.snps: GROUP SNP ALLELE MEAN STDEV BETA ...) format
(loadREMLEffect/loadGWASEffect, predictphenotype.h:77-79).
Multi-file accumulation mirrors addMoreEffects.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from dissect_tpu_torch.io.bed import PlinkData


@dataclasses.dataclass
class SnpEffect:
    name: str
    allele: str  # the allele the effect is counted on
    effect: float
    mean: float = 0.0  # reported mean dosage in the training data


def read_snp_effects(path: str, fmt: str = "auto") -> Dict[str, SnpEffect]:
    """Read a SNP-effect table.

    Formats: 'blup' = .blup.snps (SNP ALLELE BLUP STDEV MEAN NBLUP,
    loadREMLEffect column order, predictphenotype.cpp), 'gwas' =
    .gwas.snps (GROUP SNP ALLELE MEAN STDEV BETA ...), 'plain' =
    (SNP ALLELE EFFECT).  'auto' sniffs the header.
    """
    effects: Dict[str, SnpEffect] = {}
    with open(path) as fh:
        lines = [ln.split() for ln in fh if ln.strip()]
    if not lines:
        raise ValueError(f"{path} is empty")
    header = [tok.upper() for tok in lines[0]]
    body = lines[1:] if any(h in ("SNP", "BETA", "BLUP", "GROUP") for h in header) else lines
    if fmt == "auto":
        if header[:2] == ["GROUP", "SNP"]:
            fmt = "gwas"
        elif "BLUP" in header or header[:2] == ["SNP", "ALLELE"] and len(header) > 3:
            fmt = "blup"
        else:
            fmt = "plain"
    for parts in body:
        if fmt == "gwas":
            name, allele, mean, effect = parts[1], parts[2], float(parts[3]), float(parts[5])
        elif fmt == "blup":
            name, allele, effect, mean = parts[0], parts[1], float(parts[2]), float(parts[4])
        else:
            name, allele, effect, mean = parts[0], parts[1], float(parts[2]), 0.0
        if name in effects:
            raise ValueError(f"SNP {name} repeated in {path}")
        effects[name] = SnpEffect(name=name, allele=allele, effect=effect, mean=mean)
    return effects


@dataclasses.dataclass
class PredictionResult:
    individual_keys: List[str]
    scores: np.ndarray
    shifts: np.ndarray
    n_snps_used: int
    n_flipped: int

    def write(self, prefix: str):
        with open(prefix + ".predicted.phenos", "w") as fh:
            fh.write("FID IID PREDICTION SHIFT\n")
            for key, s, sh in zip(self.individual_keys, self.scores, self.shifts):
                fid, iid = key.split("@", 1)
                fh.write(f"{fid} {iid} {s:.8g} {sh:.8g}\n")


def predict_phenotypes(
    data: PlinkData,
    effects: Dict[str, SnpEffect],
    accumulate: Optional[PredictionResult] = None,
) -> PredictionResult:
    """Score individuals: sum over effect SNPs of effect * dosage(allele).

    When the genotype's allele2 differs from the effect allele the
    dosage flips (2 - d): effect stays on its own allele — the
    reference's shift-column mechanism.  Missing genotypes contribute 0
    (and no shift), as in the missings-matrix products.
    """
    name_to_idx = {s.name: i for i, s in enumerate(data.snps)}
    used_idx: List[int] = []
    eff_list: List[float] = []
    shift_list: List[float] = []
    n_flipped = 0
    for name, se in effects.items():
        i = name_to_idx.get(name)
        if i is None:
            continue
        snp = data.snps[i]
        if se.allele == snp.allele2:
            eff, shift = se.effect, 0.0
        elif se.allele == snp.allele1:
            # dosage of allele1 = 2 - dosage(allele2): effect*(2-d)
            eff, shift = -se.effect, 2.0 * se.effect
            n_flipped += 1
        else:
            continue  # allele mismatch: skip
        used_idx.append(i)
        eff_list.append(eff)
        shift_list.append(shift)
    if not used_idx:
        raise ValueError("no effect SNPs overlap the genotype file")

    dosage = data.dosages()[used_idx]
    observed = (dosage >= 0).astype(np.float64)
    d = np.where(dosage >= 0, dosage, 0).astype(np.float64)
    scores = d.T @ np.asarray(eff_list) + observed.T @ np.asarray(shift_list)
    shifts = observed.T @ np.asarray(shift_list)
    if accumulate is not None:
        if accumulate.individual_keys != data.individual_keys:
            raise ValueError("accumulating predictions over different individuals")
        scores = scores + accumulate.scores
        shifts = shifts + accumulate.shifts
    return PredictionResult(
        individual_keys=data.individual_keys,
        scores=scores,
        shifts=shifts,
        n_snps_used=len(used_idx),
        n_flipped=n_flipped,
    )
