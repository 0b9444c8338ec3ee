"""Multi-trait (bivariate/multivariate) REML front end.

Parity: multireml.{h,cpp} — same kernels across traits, multi-column
phenotypes, per-trait covariate files combined block-diagonally
(reml.cpp:540-590), genetic covariances or correlations across traits
(multireml.cpp:57-137), per-trait individual sets with asymmetric kernel
blocks (reml.cpp:262-387, 790-877).  The LRT between full and
reduced/fixed models follows compareREMLs (multireml.h:71) with
p = 0.5 * chi2_sf (results.cpp:38-52).  Port of dissect_tpu/reml/multi.py:
every fit runs in float64 on `device`, the kernel blocks moved there
once; with a `mesh` of more than one rank the (Tn, Tn) covariance stays
row-sharded through the whole fit (reml/distributed_engine.py).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from scipy.stats import chi2

from dissect_tpu_torch.io.covariate import Covariate, read_covariates
from dissect_tpu_torch.io.ids import indices_of, intersection_keeping_order
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.covariance import CovarianceModel, VarianceTransform
from dissect_tpu_torch.model.kernels import Kernel
from dissect_tpu_torch.reml.builders import (
    build_variance_model,
    build_variance_model_asymmetric,
    initial_residual_variance,
)
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions, REMLResult
from dissect_tpu_torch.reml.single import SummaryRow
from dissect_tpu_torch.runtime.timers import timers


@dataclasses.dataclass
class MultiREMLOutput:
    result: REMLResult
    individual_keys: List[str]
    variances: List[SummaryRow]
    correlations: List[SummaryRow]  # genetic/environmental correlations + SE
    blue: Optional[np.ndarray] = None
    blue_se: Optional[np.ndarray] = None


def lrt_p_value(log_l_full: float, log_l_reduced: float, df: int = 1) -> float:
    """p = 0.5 * P(chi2_df > LRT) (Results::compare, results.cpp:38-52)."""
    lrt = max(2.0 * (log_l_full - log_l_reduced), 0.0)
    return 0.5 * float(chi2.sf(lrt, df))


def correlation_from_covariance(
    theta: np.ndarray,
    ai_inv: np.ndarray,
    cov_idx: int,
    var1_idx: int,
    var2_idx: int,
):
    """r = cov/sqrt(v1 v2) with delta-method SE (computeSummary's
    correlation propagation, reml.cpp:2761-2922)."""
    c, v1, v2 = theta[cov_idx], theta[var1_idx], theta[var2_idx]
    denom = np.sqrt(v1 * v2)
    r = c / denom
    d = np.zeros(len(theta))
    d[cov_idx] = 1.0 / denom
    d[var1_idx] = -0.5 * c / (denom * v1)
    d[var2_idx] = -0.5 * c / (denom * v2)
    se = float(np.sqrt(max(d @ ai_inv @ d, 0.0)))
    return float(r), se


class MultiREML:
    """Fit T traits jointly with cross-trait genetic (and environmental)
    covariances."""

    def __init__(
        self,
        kernels: Sequence[Kernel],
        phenotypes: Sequence[Phenotype],
        covariates: Optional[Sequence[Optional[Covariate]]] = None,
        options: Optional[REMLOptions] = None,
        use_correlations: bool = False,
        environmental_covariance: bool = True,
        device="cuda",
        mesh=None,
        distributed_block: Optional[int] = None,
    ):
        self.options = options or REMLOptions()
        self.use_correlations = use_correlations
        self.environmental_covariance = environmental_covariance
        self.device = torch.device(device)
        self.mesh = mesh if mesh is not None and mesh.world > 1 else None
        self.distributed_block = distributed_block
        self.n_traits = len(phenotypes)
        if covariates is None:
            covariates = [None] * self.n_traits
        covariates = [
            c if c is not None else read_covariates(default_keys=p.keys)
            for c, p in zip(covariates, phenotypes)
        ]

        kernel_keys = kernels[0].individual_keys
        for kern in kernels[1:]:
            kernel_keys = intersection_keeping_order(kernel_keys, kern.individual_keys)
        # per-trait individual sets in kernel order (the reference's
        # commonIndividualsInGRMOrder per trait, reml.cpp:262-387)
        self.trait_keys = []
        for p, c in zip(phenotypes, covariates):
            common_t = intersection_keeping_order(kernel_keys, p.keys, c.keys)
            if not common_t:
                raise ValueError("a trait has no common individuals")
            self.trait_keys.append(common_t)
        self.uniform = all(ks == self.trait_keys[0] for ks in self.trait_keys)
        self.trait_sizes = [len(ks) for ks in self.trait_keys]
        # flattened analysis individuals (trait-major)
        self.individual_keys = (
            self.trait_keys[0] if self.uniform else [k for ks in self.trait_keys for k in ks]
        )
        if self.uniform:
            self.kernels = [k.filter_individuals(self.trait_keys[0]) for k in kernels]
        else:
            self.kernels = list(kernels)  # sliced per block at model build

        ys = []
        for p, keys in zip(phenotypes, self.trait_keys):
            pm = p.as_dict()
            ys.append(np.array([pm[k] for k in keys], dtype=np.float64))
        self.ys = ys
        self.y = np.concatenate(ys)

        xs = [c.filter_individuals(keys).matrix for c, keys in zip(covariates, self.trait_keys)]
        c_tot = sum(x.shape[1] for x in xs)
        self.x = np.zeros((sum(self.trait_sizes), c_tot), dtype=np.float64)
        row = col = 0
        for x in xs:
            self.x[row : row + x.shape[0], col : col + x.shape[1]] = x
            row += x.shape[0]
            col += x.shape[1]
        self.xs = xs

    def build_model(
        self,
        weights: Optional[Sequence[float]] = None,
        initial_h2s: Optional[Sequence[float]] = None,
    ) -> CovarianceModel:
        """The joint covariance model, its matrices float64 on the device:
        build_variance_model when every trait has the same individuals,
        else asymmetric kernel blocks K[S_t, S_u] with the environmental
        covariance only where individuals overlap (reml.cpp:790-877)."""
        pheno_vars = [initial_residual_variance(y, x) for y, x in zip(self.ys, self.xs)]
        if initial_h2s is not None:
            # per-trait initial h2 (--initial-h2s, options.cpp:617-620)
            if len(initial_h2s) != self.n_traits:
                raise ValueError(
                    f"--initial-h2s needs {self.n_traits} values, got {len(initial_h2s)}"
                )
            h2s = list(initial_h2s)
        else:
            h2s = [self.options.initial_h2] * self.n_traits
        # on a mesh the kernels stay as they are, row-sharded or whole:
        # the row-sharded engine upcasts only each rank's rows
        dtype = torch.float64 if self.mesh is None else None
        put = lambda t: t.to(device=self.device, dtype=dtype)
        if self.uniform:
            return build_variance_model(
                [k.matrix if k.sharded and self.mesh is not None else put(k.dense())
                 for k in self.kernels],
                [k.name for k in self.kernels],
                pheno_vars,
                h2s,
                weights=weights,
                n_traits=self.n_traits,
                use_correlations=self.use_correlations,
                environmental_covariance=self.environmental_covariance,
            )
        kernel_blocks = {}
        for kern in self.kernels:
            kernel_blocks[kern.name] = {
                (t, u): put(kern.slice_asymmetric(self.trait_keys[t], self.trait_keys[u]))
                for t in range(self.n_traits)
                for u in range(t, self.n_traits)
            }
        env_cross = {}
        if self.environmental_covariance:
            for t in range(self.n_traits):
                for u in range(t + 1, self.n_traits):
                    shared = intersection_keeping_order(self.trait_keys[t], self.trait_keys[u])
                    if not shared:
                        continue
                    rows = torch.as_tensor(indices_of(shared, self.trait_keys[t]))
                    cols = torch.as_tensor(indices_of(shared, self.trait_keys[u]))
                    mat = torch.zeros(
                        (self.trait_sizes[t], self.trait_sizes[u]),
                        dtype=torch.float64, device=self.device,
                    )
                    mat[rows.to(self.device), cols.to(self.device)] = 1.0
                    env_cross[(t, u)] = mat
        return build_variance_model_asymmetric(
            kernel_blocks, pheno_vars, h2s, self.trait_sizes, env_cross,
            weights=weights, use_correlations=self.use_correlations,
        )

    def _make_engine(self, model, y=None, x=None, options=None):
        y = self.y if y is None else y
        x = self.x if x is None else x
        options = self.options if options is None else options
        if self.mesh is not None:
            from dissect_tpu_torch.reml.distributed_engine import DistributedREMLEngine

            return DistributedREMLEngine(
                model, y, x, self.mesh, options, block=self.distributed_block
            )
        return REMLEngine(model, y, x, options, device=self.device)

    def compute(
        self,
        initial_theta: Optional[np.ndarray] = None,
        compute_blue: bool = True,
        weights: Optional[Sequence[float]] = None,
        initial_h2s: Optional[Sequence[float]] = None,
        initial_variances: Optional[dict] = None,
        checkpoint_path: Optional[str] = None,
    ) -> MultiREMLOutput:
        model = self.build_model(weights, initial_h2s)
        names = [k.name for k in self.kernels]
        if initial_variances is not None:
            # --initial-variances seeding by name — the multi-trait
            # analog of singlereml's restart-from-artifact boundary
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
        rows = [
            SummaryRow(nm, float(theta[i]), result.std_error(nm))
            for i, nm in enumerate(result.variance_names)
        ]
        correlations: List[SummaryRow] = []
        vn = result.variance_names
        if not self.use_correlations:
            for kname in names + ["E"]:
                for j in range(self.n_traits):
                    for l in range(j + 1, self.n_traits):
                        cov_name = f"Covar({kname}_p{j + 1}-{l + 1})"
                        if cov_name not in vn:
                            continue
                        r, se = correlation_from_covariance(
                            theta,
                            result.ai_inverse,
                            vn.index(cov_name),
                            vn.index(f"Var({kname}_p{j + 1})"),
                            vn.index(f"Var({kname}_p{l + 1})"),
                        )
                        correlations.append(SummaryRow(f"Cor({kname}_p{j + 1}-{l + 1})", r, se))
        else:
            for i, nm in enumerate(vn):
                if nm.startswith("Cor("):
                    correlations.append(SummaryRow(nm, float(theta[i]), result.std_error(nm)))

        out = MultiREMLOutput(
            result=result,
            individual_keys=self.individual_keys,
            variances=rows,
            correlations=correlations,
        )
        if result.success and compute_blue:
            with timers.phase("BLUE/BLUP"):
                out.blue, out.blue_se = engine.compute_blue()
        self.engine = engine
        self.model = model
        return out

    def compute_with_reduced_models(
        self,
        elements_to_test: Optional[Sequence[str]] = None,
        **kwargs,
    ):
        """Full multi-trait fit + reduced-model LRTs per sub-covariance
        (computeREMLWithReducedModels, reml.cpp:1301-1400)."""
        from dissect_tpu_torch.reml.reduced import reduced_model_lrts

        full = self.compute(**kwargs)
        if not full.result.success:
            return full, []
        if elements_to_test is None:
            elements_to_test = [k.name for k in self.kernels]
        with timers.phase("REML"):
            lrts = reduced_model_lrts(
                self.model, self.y, self.x, self.options, full.result, elements_to_test,
                engine_factory=self._make_engine,
            )
        return full, lrts

    def compute_with_fixed_correlation(
        self,
        kernel_name: str,
        fixed_value: float,
        traits: tuple = (1, 2),
        full_output: Optional[MultiREMLOutput] = None,
    ):
        """Refit with the cross-trait correlation of `kernel_name` fixed
        and LRT against the full model (--fix-correlation,
        options.h:117-118; restrictedCovariances loop,
        reml.cpp:1370-1460; p = 0.5 * chi2_1).

        The fixed correlation folds into the cross element's constant
        factor: element = r_fixed * sqrt(Var_p1 Var_p2) * K, and the
        free Cor/Covar parameter is removed.  The rebuilt model keeps the
        per-trait sizes (the JAX package rebuilds it uniform,
        dissect_tpu/reml/multi.py:353, which only an asymmetric model
        notices: its blocks then fail the shape check)."""
        if full_output is None:
            full_output = self.compute(compute_blue=False)
        if not full_output.result.success:
            return full_output, None

        j, l = traits
        cov_name = (
            f"Cor({kernel_name}_p{j}-{l})"
            if self.use_correlations
            else f"Covar({kernel_name}_p{j}-{l})"
        )
        model = self.model
        reduced = model.delete_subcovariance("__none__")  # deep copy
        # remove the covariance/correlation parameter and re-express the
        # cross element with the fixed value folded into the factor
        if cov_name not in reduced._variance_index:
            raise ValueError(f"{cov_name} not in model")
        element_name = f"{kernel_name}_{j}_{l}"
        for e in reduced.elements:
            if e.name == element_name:
                e.factor = fixed_value
                e.variance_factors = [
                    (f"Var({kernel_name}_p{j})", VarianceTransform.SQRT),
                    (f"Var({kernel_name}_p{l})", VarianceTransform.SQRT),
                ]
        # drop the now-unused parameter by rebuilding without it
        kept = [v for v in reduced.variances if v.name != cov_name]
        rebuilt = CovarianceModel(
            reduced.n, reduced.n_traits, reduced.diagonal, trait_sizes=reduced.trait_sizes
        )
        rebuilt.group_magnitudes = dict(reduced.group_magnitudes)
        for v in kept:
            rebuilt.insert_variance(v.name, v.group, v.type, v.effect, v.initial_value)
        for nm, m in reduced.matrices.items():
            rebuilt.insert_matrix(nm, m)
        for e in reduced.elements:
            ne = rebuilt.insert_element(
                e.subcovariance_id, e.name, e.matrix_name, e.block, e.factor
            )
            ne.variance_factors = [(vn, t) for vn, t in e.variance_factors if vn != cov_name]
        # seed from the full fit
        full_theta = dict(zip(full_output.result.variance_names, full_output.result.variances))
        init = np.array(
            [full_theta.get(nm, v.initial_value)
             for nm, v in zip(rebuilt.variance_names(), rebuilt.variances)]
        )
        opts = dataclasses.replace(self.options, first_step_em=False)
        res = self._make_engine(rebuilt, options=opts).fit(init)
        lrt = {
            "fixed": cov_name,
            "value": fixed_value,
            "log_likelihood": res.log_likelihood,
            "lrt": max(2.0 * (full_output.result.log_likelihood - res.log_likelihood), 0.0),
            "p_value": lrt_p_value(full_output.result.log_likelihood, res.log_likelihood, 1)
            if res.success
            else float("nan"),
            "converged": res.success,
        }
        return full_output, lrt
