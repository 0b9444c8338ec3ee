"""Single-trait REML driver, diagonalized-kernel branch.

Parity: singlereml.{h,cpp} — intersect individuals with phenotype and
covariates (GRM order is load-bearing, reml.cpp:344-374), build the
covariance model, fit, and summarize (SingleREML::compute,
singlereml.cpp:56-228).  Port of the diagonal branch of
dissect_tpu/reml/single.py (:115-128, :130-233): y and X rotate into the
kernel's eigenbasis on the device, in float64, and V becomes diagonal.
Dense kernels, BLUE and BLUP come with the dense --reml slice
(ROADMAP.md, queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch

from dissect_tpu_torch.io.covariate import Covariate, read_covariates
from dissect_tpu_torch.io.ids import intersection_keeping_order
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.covariance import ParameterType
from dissect_tpu_torch.model.kernels import Kernel
from dissect_tpu_torch.reml.builders import build_variance_model, initial_residual_variance
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions, REMLResult


@dataclasses.dataclass
class SummaryRow:
    name: str
    value: float
    std_error: float


@dataclasses.dataclass
class SingleREMLOutput:
    result: REMLResult
    individual_keys: List[str]
    variances: List[SummaryRow]
    heritabilities: List[SummaryRow]  # h2 per genetic kernel + total


def heritability_with_se(
    theta: np.ndarray, ai_inv: np.ndarray, genetic_idx: Sequence[int], all_var_idx: Sequence[int]
):
    """h2 = sum(genetic)/sum(all variances) with delta-method SE from the
    AI inverse (computeSummary's propagated h2 SE, reml.cpp:2761-2922)."""
    g = float(theta[list(genetic_idx)].sum())
    tot = float(theta[list(all_var_idx)].sum())
    h2 = g / tot
    d = np.zeros(len(theta))
    for i in all_var_idx:
        if i in genetic_idx:
            d[i] = (tot - g) / tot**2
        else:
            d[i] = -g / tot**2
    se = float(np.sqrt(max(d @ ai_inv @ d, 0.0)))
    return h2, se


class SingleREML:
    """Fit y = X b + u + e with u ~ N(0, s2_g K), K given by its eigenpairs."""

    def __init__(
        self,
        kernels: Sequence[Kernel],
        phenotype: Phenotype,
        covariate: Optional[Covariate] = None,
        options: Optional[REMLOptions] = None,
        device="cuda",
    ):
        self.options = options or REMLOptions()
        self.device = torch.device(device)
        if len(kernels) != 1 or not kernels[0].diagonalized:
            raise NotImplementedError(
                "only the single diagonalized-kernel REML is ported "
                "(dense REML: ROADMAP.md queue 1, item 2)"
            )
        kern = kernels[0]
        if covariate is None:
            covariate = read_covariates(default_keys=phenotype.keys)
        # individual intersection, GRM-ordered (reml.cpp:262-387)
        common = intersection_keeping_order(
            kern.individual_keys, phenotype.keys, covariate.keys
        )
        if len(common) == 0:
            raise ValueError("no common individuals between inputs")
        if kern.individual_keys != common:
            raise ValueError(
                "diagonalized kernel individuals must already match "
                "the analysis set (diagonalize after intersection)"
            )
        self.individual_keys = common
        self.kernels = [kern]
        pheno_map = phenotype.as_dict()
        y = np.array([pheno_map[k] for k in common], dtype=np.float64)
        x = covariate.filter_individuals(common).matrix
        # diagonalized fast path (reml.cpp:449-557): rotate y and X into
        # the eigenbasis, where V is diagonal
        u = kern.eigenvectors.to(device=self.device, dtype=torch.float64)
        self.y = u.T @ torch.as_tensor(y, device=self.device)
        self.x = u.T @ torch.as_tensor(x, dtype=torch.float64, device=self.device)

    def compute(self, initial_theta: Optional[np.ndarray] = None) -> SingleREMLOutput:
        pheno_var = initial_residual_variance(
            self.y.cpu().numpy(), self.x.cpu().numpy()
        )
        kern = self.kernels[0]
        model = build_variance_model(
            [kern.eigenvalues.to(torch.float64).cpu()],
            [kern.name],
            [pheno_var],
            [self.options.initial_h2],
            n_traits=1,
            diagonal=True,
        )
        engine = REMLEngine(model, self.y, self.x, self.options, device=self.device)
        result = engine.fit(initial_theta)

        theta = result.variances
        # only VARIANCE-type parameters enter Var(P)
        var_idx = [
            i
            for i, v in enumerate(model.variances)
            if v.type == ParameterType.VARIANCE
        ]
        genetic_idx = model.genetic_variance_indices()
        rows = [
            SummaryRow(nm, float(theta[i]), result.std_error(nm))
            for i, nm in enumerate(result.variance_names)
        ]
        herit = []
        for gi in genetic_idx:
            h2, se = heritability_with_se(theta, result.ai_inverse, [gi], var_idx)
            herit.append(SummaryRow(f"{result.variance_names[gi]}/Var(P)", h2, se))
        h2, se = heritability_with_se(theta, result.ai_inverse, genetic_idx, var_idx)
        herit.append(SummaryRow("h2", h2, se))
        self.engine = engine
        self.model = model
        return SingleREMLOutput(
            result=result,
            individual_keys=self.individual_keys,
            variances=rows,
            heritabilities=herit,
        )
