"""Phenotype simulation (a copy of dissect_tpu/analysis/simulate.py).

Parity: simulatephenotype.{h,cpp} — y_genetic = G' effects over causal
SNPs using the reference's internal coding (missing -> 0, else
dosage + 1, parseSNPbyte genotype.cpp:741-787); environment variance
var_e = var(y_g) (1 - h2)/h2 (simulatephenotype.cpp:203); binary traits
threshold at the (1 - prevalence) quantile, case = 2 / control = 1
(simulatephenotype.cpp:225-249).  Effects without a value in the causal
file are drawn N(0,1) (simulatephenotype.cpp:118-121).  Outputs
.simulated.effects / .simulated.phenos / .simulated.blups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from dissect_tpu_torch.io.bed import PlinkData
from dissect_tpu_torch.io.ids import order_as_template
from dissect_tpu_torch.runtime.log import output_open


@dataclasses.dataclass
class SimulationResult:
    individual_keys: List[str]
    phenotypes: np.ndarray  # (n,) quantitative or 1/2 binary codes
    genetic_effects: np.ndarray
    environmental_effects: np.ndarray
    causal_effects: Dict[str, float]
    n_cases: int = 0
    n_controls: int = 0

    def write(self, prefix: str):
        with output_open(prefix + ".simulated.effects", "w") as fh:
            for snp, eff in self.causal_effects.items():
                fh.write(f"{snp} {eff:.8g}\n")
        with output_open(prefix + ".simulated.phenos", "w") as fh:
            for key, y in zip(self.individual_keys, self.phenotypes):
                fid, iid = key.split("@", 1)
                fh.write(f"{fid} {iid} {y:.8g}\n")
        with output_open(prefix + ".simulated.blups", "w") as fh:
            for key, g, e in zip(
                self.individual_keys, self.genetic_effects, self.environmental_effects
            ):
                fid, iid = key.split("@", 1)
                fh.write(f"{fid} {iid} {g:.8g} {e:.8g}\n")


def simulate_phenotypes(
    data: PlinkData,
    causal_effects: Dict[str, Optional[float]],
    h2: float,
    binary: bool = False,
    prevalence: float = 0.1,
    seed: int = 1,
) -> SimulationResult:
    """Simulate phenotypes from causal SNP effects.

    `causal_effects` maps SNP name -> effect (None draws N(0,1), parity
    with the blank-effect path).  SNPs absent from the genotypes are
    skipped with the reference's warning semantics.
    """
    rng = np.random.default_rng(seed)
    present = set(data.snp_names)
    effects: Dict[str, float] = {}
    for snp, eff in causal_effects.items():
        if snp not in present:
            continue
        effects[snp] = float(rng.normal()) if eff is None else float(eff)
    if not effects:
        raise ValueError("no causal SNPs overlap the genotype file")
    causal_ids = order_as_template(list(effects), data.snp_names)

    sub = data.filter(keep_snps=causal_ids)
    dosage = sub.dosages()
    # reference internal coding: missing -> 0, else dosage + 1
    coded = np.where(dosage >= 0, dosage + 1.0, 0.0)
    eff_vec = np.array([effects[s] for s in causal_ids])
    y_genetic = coded.T @ eff_vec

    var_g = np.var(y_genetic, ddof=1)
    var_e = var_g * (1.0 - h2) / h2
    env = rng.normal(0.0, np.sqrt(var_e), size=len(y_genetic))
    y = y_genetic + env

    n_cases = n_controls = 0
    if binary:
        n = len(y)
        n_controls_target = int(n * (1.0 - prevalence))
        if n_controls_target == 0:
            raise ValueError("prevalence too high / population too small")
        s = np.sort(y)
        threshold = 0.5 * (s[n_controls_target] + s[n_controls_target - 1])
        binary_y = np.where(y > threshold, 2.0, 1.0)
        n_cases = int((binary_y == 2).sum())
        n_controls = int((binary_y == 1).sum())
        y = binary_y

    return SimulationResult(
        individual_keys=data.individual_keys,
        phenotypes=y,
        genetic_effects=y_genetic,
        environmental_effects=env,
        causal_effects={s: effects[s] for s in causal_ids},
        n_cases=n_cases,
        n_controls=n_controls,
    )


def read_causal_snps(path: str) -> Dict[str, Optional[float]]:
    """Parse the --effects file: 'SNP [effect]' per line."""
    out: Dict[str, Optional[float]] = {}
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] in out:
                raise ValueError(f"SNP {parts[0]} repeated in {path}")
            out[parts[0]] = float(parts[1]) if len(parts) > 1 else None
    return out
