"""Multi-phenotype pipeline: residual precomputation + massive GWAS.

Parity:
  * MPResiduals (mpresiduals.{h,cpp}): diagonalize the GRM once
    (one eigendecomposition), rotate every phenotype and the covariates
    by U^T (mpresiduals.cpp:86-94), run per-phenotype REML with the
    diagonal-V O(n) fast path (mpresiduals.cpp:103-156), emit residuals
    e = s2_E * Py rotated back by U, saved as a LabeledMatrix
    (.rowids/.colids/.dat).
  * mpgwas (gwasmp.cpp): per-SNP x per-phenotype scalar OLS on the
    column-centered residual matrix: b = X'y/X'X, SSE = y'y - b X'y,
    MSE = SSE/(n-1), t with df = n-1
    (computeGLMWithoutCovarianceMultiplePhenos, gwasmp.cpp:399-527).

Port of dissect_tpu/gwas/mp.py without its `mesh` arguments (multi-GPU
is ROADMAP.md queue 1 item 9).  The eigendecomposition, the rotations
and the REML fits run in float64 on the kernel's device (the JAX CLI
diagonalizes its float32 GRM in float32: ROADMAP.md, deliberate
departures); the (M, P) effect matrix is one genotype x residual product
in the genotypes' dtype.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from dissect_tpu_torch.io.covariate import Covariate, read_covariates
from dissect_tpu_torch.io.ids import intersection_keeping_order
from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix
from dissect_tpu_torch.io.phenotype import Phenotype
from dissect_tpu_torch.model.kernels import Kernel
from dissect_tpu_torch.reml.builders import build_variance_model, initial_residual_variance
from dissect_tpu_torch.reml.engine import REMLEngine, REMLOptions, _host
from dissect_tpu_torch.runtime.stats import t_sf
from dissect_tpu_torch.runtime.timers import timers
from dissect_tpu_torch.runtime.log import output_open


def compute_mp_residuals(
    kernel: Kernel,
    phenotypes: Sequence[Phenotype],
    phenotype_names: Optional[Sequence[str]] = None,
    covariate: Optional[Covariate] = None,
    options: Optional[REMLOptions] = None,
    mesh=None,
) -> LabeledMatrix:
    """Per-phenotype REML residuals in the GRM eigenbasis (with a `mesh`
    of more than one rank, diagonalized by the divide-and-conquer
    solver).

    Individuals = intersection of the kernel, every phenotype column and
    the covariates, in kernel order.  Everything runs on the kernel's
    device in float64.  Returns residuals as a LabeledMatrix
    (individuals x phenotypes)."""
    options = options or REMLOptions()
    if phenotype_names is None:
        phenotype_names = [f"pheno_{i + 1}" for i in range(len(phenotypes))]
    common = kernel.individual_keys
    for p in phenotypes:
        common = intersection_keeping_order(common, p.keys)
    if covariate is None:
        covariate = read_covariates(default_keys=common)
    common = intersection_keeping_order(common, covariate.keys)
    if not common:
        raise ValueError("no common individuals")
    n = len(common)

    with timers.phase("DiagonalizeGRM"):
        kern = kernel.filter_individuals(common).diagonalize(mesh=mesh)
    u = kern.whole().eigenvectors.to(torch.float64)
    lam = kern.eigenvalues.to(torch.float64)
    put = lambda a: torch.as_tensor(a, dtype=torch.float64, device=u.device)
    x_rot = u.T @ put(covariate.filter_individuals(common).matrix)
    x_rot_h = _host(x_rot)

    residuals = np.zeros((n, len(phenotypes)))
    for j, p in enumerate(phenotypes):
        with timers.phase("REML"):
            pm = p.as_dict()
            y_rot = u.T @ put(np.array([pm[k] for k in common]))
            pheno_var = initial_residual_variance(_host(y_rot), x_rot_h)
            model = build_variance_model(
                [lam], [kern.name], [pheno_var], [options.initial_h2], diagonal=True
            )
            engine = REMLEngine(model, y_rot, x_rot, options, device=u.device)
            result = engine.fit()
            if not result.success:
                raise RuntimeError(f"REML failed for phenotype {phenotype_names[j]}")
            residuals[:, j] = _host(u @ put(engine.residuals()))
    return LabeledMatrix(list(common), list(phenotype_names), residuals)


@dataclasses.dataclass
class MpGwasResults:
    snp_names: List[str]
    phenotype_names: List[str]
    beta: np.ndarray  # (M, P)
    se: np.ndarray
    t: np.ndarray
    p: np.ndarray

    def write(self, prefix: str):
        """One .mpgwas table: SNP PHENO BETA SE T PV (reference layout
        storeResultsMultiplePhenotype, gwasmp.cpp)."""
        with output_open(prefix + ".mpgwas", "w") as fh:
            fh.write("SNP PHENO BETA SE T PV\n")
            for i, snp in enumerate(self.snp_names):
                for j, pheno in enumerate(self.phenotype_names):
                    fh.write(
                        f"{snp} {pheno} {self.beta[i, j]:.8g} "
                        f"{self.se[i, j]:.8g} {self.t[i, j]:.6g} "
                        f"{self.p[i, j]:.6g}\n"
                    )

    @staticmethod
    def concatenate(parts: Sequence["MpGwasResults"]) -> "MpGwasResults":
        """Per-chunk results joined along the SNP axis."""
        cat = lambda attr: np.concatenate([getattr(p, attr) for p in parts])
        return MpGwasResults(
            snp_names=sum((p.snp_names for p in parts), []),
            phenotype_names=parts[0].phenotype_names,
            beta=cat("beta"), se=cat("se"), t=cat("t"), p=cat("p"),
        )


@dataclasses.dataclass
class DeviceResiduals:
    """Residual columns on the compute device in its bulk dtype, with their
    labels: what mp_gwas reads of a LabeledMatrix, moved there once for
    every chunk of a pass."""

    values: torch.Tensor  # (n, P)
    col_labels: List[str]

    @classmethod
    def upload(cls, residuals: LabeledMatrix, device, dtype) -> "DeviceResiduals":
        """The matrix's values as they are (center them first), in one copy."""
        return cls(torch.as_tensor(residuals.values).to(device=device, dtype=dtype),
                   list(residuals.col_labels))


def _mp_core(g, y):
    xtx = torch.einsum("mi,mi->m", g, g)
    xty = g @ y  # (M, P)
    yty = torch.einsum("ip,ip->p", y, y)
    return xtx, xty, yty


def mp_gwas(
    genotypes: torch.Tensor,
    snp_names: Sequence[str],
    residuals: Union[LabeledMatrix, DeviceResiduals],
    center: bool = True,
) -> MpGwasResults:
    """Batched per-SNP x per-phenotype scalar regressions on residuals.

    genotypes: (M, n) centered dosage rows (missing -> 0) on the compute
    device, in its bulk dtype, aligned to the residuals' rows.  A
    LabeledMatrix is centered (unless `center` is False) and goes there
    in the same dtype on every call; DeviceResiduals are taken as they
    are, already centered on that device in that dtype.  The tests run
    in float64.

    Spans (runtime/timers.py): mp.product (X'X, X'y, y'y on the device),
    mp.readback (the three to the host: waits for the device), mp.stats
    (effects, SEs, t and the t tails on the host); counter mp.tests
    (SNP x phenotype tests)."""
    g = genotypes
    if isinstance(residuals, LabeledMatrix):
        lm = residuals.center_columns() if center else residuals
        residuals = DeviceResiduals.upload(lm, g.device, g.dtype)
    y = residuals.values
    n = y.shape[0]
    with timers.span("mp.product"):
        products = _mp_core(g, y)
    with timers.span("mp.readback"):
        xtx, xty, yty = (_host(v) for v in products)

    with timers.span("mp.stats"):
        bad = xtx <= 0
        xtx_safe = np.where(bad, np.inf, xtx)
        beta = xty / xtx_safe[:, None]
        df = n - 1.0
        sse = yty[None, :] - beta * xty
        mse = sse / df
        se = np.sqrt(mse / xtx_safe[:, None])
        t = beta / se
        p = 2.0 * t_sf(df, np.abs(t))
    timers.count("mp.tests", beta.size)
    return MpGwasResults(
        snp_names=list(snp_names),
        phenotype_names=list(residuals.col_labels),
        beta=beta,
        se=se,
        t=t,
        p=p,
    )
