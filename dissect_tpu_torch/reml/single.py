"""Single-trait REML front end.

Parity: singlereml.{h,cpp} — intersect individuals with phenotype and
covariates (GRM order is load-bearing, reml.cpp:344-374), build the
covariance model, fit, and emit summary/BLUE/BLUP outputs
(SingleREML::compute, singlereml.cpp:56-228).  Port of
dissect_tpu/reml/single.py: with a `mesh` of more than one rank a dense
fit runs the row-sharded DistributedREMLEngine
(reml/distributed_engine.py), its Cholesky panel `distributed_block`
wide (--default-block-size).

Two branches:
  dense      any number of kernels, each an (n, n) matrix upcast once to
             float64 on the device; y and X stay as they are;
  diagonal   one diagonalized kernel: y and X rotate into its eigenbasis
             on the device, in float64, and V becomes diagonal
             (reml.cpp:449-557).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dissect_tpu_torch.io.covariate import Covariate, read_covariates
from dissect_tpu_torch.io.ids import intersection_keeping_order
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.covariance import ParameterType
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.reml.builders import build_variance_model, initial_residual_variance
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions, REMLResult, _host
from dissect_tpu_torch.runtime.timers import timers


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
    blue: Optional[np.ndarray] = None
    blue_se: Optional[np.ndarray] = None
    blup: Optional[Dict[str, np.ndarray]] = None
    blup_errors: Optional[Dict[str, np.ndarray]] = None
    residuals: Optional[np.ndarray] = None


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
    """Fit y = X b + sum_i u_i + e with u_i ~ N(0, s2_i K_i)."""

    def __init__(
        self,
        kernels: Sequence[Kernel],
        phenotype: Phenotype,
        covariate: Optional[Covariate] = None,
        options: Optional[REMLOptions] = None,
        environmental_weights: Optional[Phenotype] = None,
        scale_weights: bool = True,
        device="cuda",
        mesh=None,
        distributed_block: Optional[int] = None,
    ):
        self.options = options or REMLOptions()
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.distributed_block = distributed_block
        if covariate is None:
            covariate = read_covariates(default_keys=phenotype.keys)
        # individual intersection, GRM-ordered (reml.cpp:262-387)
        common = intersection_keeping_order(
            kernels[0].individual_keys, phenotype.keys, covariate.keys
        )
        if environmental_weights is not None:
            # --weights joins the intersection (reml.cpp:354-357)
            common = intersection_keeping_order(common, environmental_weights.keys)
        for kern in kernels[1:]:
            common = intersection_keeping_order(common, kern.individual_keys)
        if len(common) == 0:
            raise ValueError("no common individuals between inputs")
        self.individual_keys = common
        self.kernels = [k.filter_individuals(common) if not k.diagonalized else k
                        for k in kernels]
        pheno_map = phenotype.as_dict()
        y = np.array([pheno_map[k] for k in common], dtype=np.float64)
        x = np.asarray(covariate.filter_individuals(common).matrix, dtype=np.float64)
        self.environmental_weights = None
        if environmental_weights is not None:
            wmap = environmental_weights.as_dict()
            w = np.array([wmap[k] for k in common], dtype=np.float64)
            if scale_weights:
                # scale to mean 1 (scaleEnvironmentalWeightTrace,
                # reml.cpp:420-432; disabled by --no-scale-weights)
                w = w * (len(w) / w.sum())
            self.environmental_weights = w

        put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=self.device)
        # diagonalized single-kernel fast path (reml.cpp:449-557):
        # rotate y and X into the eigenbasis, V becomes diagonal
        self.diagonal = len(self.kernels) == 1 and self.kernels[0].diagonalized
        self.eigenvectors = None
        if self.diagonal:
            kern = self.kernels[0]
            if kern.individual_keys != common:
                raise ValueError(
                    "diagonalized kernel individuals must already match "
                    "the analysis set (diagonalize after intersection)"
                )
            self.eigenvectors = kern.whole().eigenvectors.to(device=self.device, dtype=torch.float64)
            self.y = self.eigenvectors.T @ put(y)
            self.x = self.eigenvectors.T @ put(x)
        else:
            self.y, self.x = put(y), put(x)

    def _dense_matrices(self, kernels: Sequence[Kernel]) -> list:
        """Each kernel's dense matrix, upcast once to float64 on the
        device.  On a mesh it stays as it is, row-sharded or whole: the
        row-sharded engine upcasts only each rank's rows."""
        if self.mesh is not None:
            return [k.matrix if k.sharded else k.dense().to(self.device) for k in kernels]
        return [k.dense().to(device=self.device, dtype=torch.float64) for k in kernels]

    def compute(
        self,
        initial_theta: Optional[np.ndarray] = None,
        compute_blue: bool = True,
        compute_blup: bool = False,
        compute_blup_errors: bool = False,
        compute_residuals: bool = False,
        weights: Optional[Sequence[float]] = None,
        initial_variances: Optional[dict] = None,
        checkpoint_path: Optional[str] = None,
    ) -> SingleREMLOutput:
        pheno_var = initial_residual_variance(_host(self.y), _host(self.x))
        if self.diagonal:
            mats = [self.kernels[0].eigenvalues.to(device=self.device, dtype=torch.float64)]
        else:
            mats = self._dense_matrices(self.kernels)
        names = [k.name for k in self.kernels]
        # squared-exponential kernels carry squared distances and a fitted
        # alpha0 parameter (initial = 1/mean(D), the
        # expKernelParameterInitialFactor/elementsAverage rule,
        # reml.cpp:1024-1028)
        parameter_kernels = {
            k.name: self.options.exp_kernel_initial_factor / max(float(torch.mean(m)), 1e-12)
            for k, m in zip(self.kernels, mats)
            if k.type == KernelType.SQUARED_EXPONENTIAL and not self.diagonal
        }
        model = build_variance_model(
            mats,
            names,
            [pheno_var],
            [self.options.initial_h2],
            weights=weights,
            n_traits=1,
            diagonal=self.diagonal,
            parameter_kernels=parameter_kernels,
            parameter_unfix_after=self.options.parameter_unfix_after,
            environmental_weights=self.environmental_weights,
        )
        if initial_variances is not None:
            # --initial-variances / subsample seeding by name
            # (setVarianceInitialValuesFromFile, covariancematrix.cpp:1689)
            theta0 = model.initial_theta()
            vnames = model.variance_names()
            for nm, val in initial_variances.items():
                if nm in vnames:
                    theta0[vnames.index(nm)] = val
            initial_theta = theta0
        engine = self._make_engine(model)
        with timers.phase("REML"):
            result = engine.fit(initial_theta, checkpoint_path=checkpoint_path)

        theta = result.variances
        # only VARIANCE-type parameters enter Var(P) (not covariances or
        # inside-matrix parameters)
        var_idx = [
            i for i, v in enumerate(model.variances) if v.type == ParameterType.VARIANCE
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

        out = SingleREMLOutput(
            result=result,
            individual_keys=self.individual_keys,
            variances=rows,
            heritabilities=herit,
        )
        back = lambda u: u if self.eigenvectors is None else _host(
            self.eigenvectors @ torch.as_tensor(u, dtype=torch.float64, device=self.device)
        )  # back-rotation out of the eigenbasis (reml.cpp:3030+)
        with timers.phase("BLUE/BLUP"):
            if result.success and compute_blue:
                out.blue, out.blue_se = engine.compute_blue()
            if result.success and compute_blup:
                out.blup = {
                    k.name: back(engine.compute_blup_individuals(k.name)) for k in self.kernels
                }
                if compute_blup_errors and self.eigenvectors is None:
                    out.blup_errors = {}
                    for kern in self.kernels:
                        err = engine.compute_blup_errors(kern.name)
                        if err is not None:
                            out.blup_errors[kern.name] = err
            if result.success and compute_residuals:
                out.residuals = back(engine.residuals())
        self.engine = engine
        self.model = model
        return out

    def _make_engine(self, model, y=None, x=None, options=None):
        y = self.y if y is None else y
        x = self.x if x is None else x
        options = self.options if options is None else options
        if self.mesh is not None and not self.diagonal:
            from dissect_tpu_torch.reml.distributed_engine import DistributedREMLEngine

            return DistributedREMLEngine(
                model, y, x, self.mesh, options, block=self.distributed_block
            )
        return REMLEngine(model, y, x, options, device=self.device)

    def subsample_prefit(
        self,
        n_replicates: int,
        proportion: float = 0.2,
        seed: int = 1,
        minimum: int = 100,
    ) -> Optional[dict]:
        """Estimate starting variances from REML fits on random
        subsamples (computeREMLInSubsample intent, singlereml.cpp:549-630
        — disabled in the reference; here functional): fitted variances
        are averaged across replicates.  The draws are numpy's
        `default_rng(seed)`, as in the JAX package, so both pick the same
        individuals."""
        n = len(self.individual_keys)
        size = max(int(n * proportion), minimum)
        if 3 * minimum > n or size >= n:
            return None  # too few individuals (singlereml.cpp:555-561)
        rng = np.random.default_rng(seed)
        sums: Dict[str, float] = {}
        count = 0
        for _ in range(n_replicates):
            idx = np.sort(rng.choice(n, size=size, replace=False))
            keys = [self.individual_keys[i] for i in idx]
            kernels = [k.filter_individuals(keys) for k in self.kernels]
            rows = torch.as_tensor(idx, device=self.device)
            y, x = self.y[rows], self.x[rows]
            model = build_variance_model(
                self._dense_matrices(kernels),
                [k.name for k in kernels],
                [initial_residual_variance(_host(y), _host(x))],
                [self.options.initial_h2],
            )
            res = self._make_engine(model, y, x).fit()
            if res.success:
                count += 1
                for nm, v in zip(res.variance_names, res.variances):
                    sums[nm] = sums.get(nm, 0.0) + v
        if count == 0:
            return None
        return {nm: s / count for nm, s in sums.items()}

    def compute_with_reduced_models(
        self,
        elements_to_test: Optional[Sequence[str]] = None,
        include_blue: bool = False,
        **kwargs,
    ):
        """Full fit, then refit with each named sub-covariance removed and
        report LRTs (computeREMLWithReducedModels, reml.cpp:1301-1400;
        p = 0.5 * chi2_sf, results.cpp:38-52).  Reduced fits start from
        the full-model estimates with the EM first step disabled
        (reml.cpp:1319-1333)."""
        from dissect_tpu_torch.reml.reduced import reduced_model_lrts

        full = self.compute(**kwargs)
        if not full.result.success:
            return full, []
        if elements_to_test is None:
            elements_to_test = [k.name for k in self.kernels]
        with timers.phase("REML"):
            lrts = reduced_model_lrts(
                self.model, self.y, self.x, self.options, full.result,
                elements_to_test, include_blue=include_blue,
                engine_factory=self._make_engine,
            )
        return full, lrts
