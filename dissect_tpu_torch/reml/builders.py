"""Covariance-model builders for single- and multi-trait REML.

Parity: REML::prepare — single-trait raw path (reml.cpp:920-1131) and
the multi-trait kernel/variance/element construction
(reml.cpp:592-917, 727-917).  Sub-covariance ids follow the reference's
naming: kernels are "K_1".."K_k" (or their given names), the
environmental identity is "E".

Port of dissect_tpu/reml/builders.py.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from dissect_tpu_torch.model.covariance import (
    CovarianceModel,
    DiagonalMatrix,
    EffectType,
    ParameterType,
    VarianceTransform,
)
from dissect_tpu_torch.runtime.mesh import RowShards


def initial_residual_variance(y: np.ndarray, x: np.ndarray) -> float:
    """Var of OLS residuals y - X beta_hat (computeInitialVariance,
    reml.cpp:1100-1131); falls back to var(y) if X'X is singular."""
    try:
        beta, *_ = np.linalg.lstsq(x, y, rcond=None)
        resid = y - x @ beta
    except np.linalg.LinAlgError:
        resid = y
    return float(np.var(resid, ddof=1))


def build_variance_model(
    kernel_matrices: Sequence,
    kernel_names: Sequence[str],
    phenotype_variances: Sequence[float],
    heritabilities: Sequence[float],
    weights: Optional[Sequence[float]] = None,
    n_traits: int = 1,
    diagonal: bool = False,
    use_correlations: bool = False,
    environmental_covariance: bool = True,
    parameter_kernels: Optional[Dict[str, float]] = None,
    parameter_unfix_after: int = 8,
    environmental_weights: Optional[np.ndarray] = None,
) -> CovarianceModel:
    """Assemble the CovarianceModel for k kernels x T traits.

    Variance naming and initial values mirror reml.cpp:727-917:
      Var(K_i_pj)          = phenoVar_j * h2_j * w_i         (genetic)
      Covar(K_i_pj-pk)     = 0.5*sqrt(init_j * init_k)        (genetic)
        [or Cor(...) = 0.5 with sqrt-transformed variances]
      Var(E_pj)            = phenoVar_j * (1 - h2_j)          (environment)
      Covar(E_pj-pk)       = 0.5*sqrt(initE_j * initE_k)      (environment)
    Single-trait names drop the _pj suffix (reml.cpp:1056-1062).

    `parameter_kernels` maps squared-exponential kernel names to their
    initial alpha0 (expKernelParameterInitialFactor / elementsAverage,
    reml.cpp:1024-1028); their stored matrices hold squared distances D
    and evaluate as exp(-alpha*D), with the parameter fixed for the
    first `parameter_unfix_after` Newton steps
    (remlStepsToUnfixExpKernelParameter, options.cpp:143).

    Kernel matrices may be tensors on a device, or RowShards in a
    multi-rank run; the environmental identity (or diag of
    `environmental_weights`) is made on the first kernel's device, in
    float64, and kept as a DiagonalMatrix beside row-sharded kernels.
    """
    parameter_kernels = parameter_kernels or {}
    k = len(kernel_matrices)
    n = np.shape(kernel_matrices[0])[0]
    if weights is None:
        weights = [1.0 / k] * k
    model = CovarianceModel(n=n, n_traits=n_traits, diagonal=diagonal)

    for name, mat in zip(kernel_names, kernel_matrices):
        model.insert_matrix(name, mat)
    first = kernel_matrices[0]
    device = first.device if isinstance(first, (torch.Tensor, RowShards)) else torch.device("cpu")
    # row-sharded kernels (a multi-rank run): E stays its diagonal
    compact = any(isinstance(m, RowShards) for m in kernel_matrices)
    if environmental_weights is not None:
        # per-individual residual weights: E = diag(w) (--weights,
        # reml.cpp:334-446).  Incompatible with the eigenrotated
        # diagonal fast path (diag(w) is not diagonal in the eigenbasis)
        if diagonal:
            raise ValueError(
                "environmental weights cannot be combined with a "
                "diagonalized kernel"
            )
        w = torch.as_tensor(np.asarray(environmental_weights, dtype=np.float64), device=device)
        identity = DiagonalMatrix(w) if compact else torch.diag(w)
    elif diagonal:
        identity = torch.ones(n, dtype=torch.float64, device=device)
    elif compact:
        identity = DiagonalMatrix(torch.ones(n, dtype=torch.float64, device=device))
    else:
        identity = torch.eye(n, dtype=torch.float64, device=device)
    model.insert_matrix("E", identity)

    # variance groups (reml.cpp:737-745)
    for j in range(n_traits):
        model.insert_variance_group(f"Phenotype_{j + 1}", phenotype_variances[j])
        for l in range(j + 1, n_traits):
            model.insert_variance_group(
                f"Phenotype_{j + 1}_{l + 1}",
                0.5 * np.sqrt(phenotype_variances[j] * phenotype_variances[l]),
            )

    def suffix(j):
        return "" if n_traits == 1 else f"_p{j + 1}"

    # genetic variances (reml.cpp:750-780, 1056)
    for i, kname in enumerate(kernel_names):
        for j in range(n_traits):
            model.insert_variance(
                f"Var({kname}{suffix(j)})",
                f"Phenotype_{j + 1}",
                ParameterType.VARIANCE,
                EffectType.GENETIC,
                phenotype_variances[j] * heritabilities[j] * weights[i],
            )
        if kname in parameter_kernels:
            idx = model.insert_variance(
                f"alpha0({kname})",
                "Phenotype_1",
                ParameterType.PARAMETER,
                EffectType.OTHER,
                parameter_kernels[kname],
            )
            model.variances[idx].unfix_after = parameter_unfix_after
        for j in range(n_traits):
            for l in range(j + 1, n_traits):
                deps = [f"Var({kname}_p{j + 1})", f"Var({kname}_p{l + 1})"]
                if not use_correlations:
                    init = 0.5 * np.sqrt(
                        phenotype_variances[j]
                        * heritabilities[j]
                        * weights[i]
                        * phenotype_variances[l]
                        * heritabilities[l]
                        * weights[i]
                    )
                    model.insert_variance(
                        f"Covar({kname}_p{j + 1}-{l + 1})",
                        f"Phenotype_{j + 1}_{l + 1}",
                        ParameterType.COVARIANCE,
                        EffectType.GENETIC,
                        init,
                        deps,
                    )
                else:
                    model.insert_variance(
                        f"Cor({kname}_p{j + 1}-{l + 1})",
                        f"Phenotype_{j + 1}_{l + 1}",
                        ParameterType.CORRELATION,
                        EffectType.GENETIC,
                        0.5,
                    )

    # environmental variances (reml.cpp:784-810, 1062)
    for j in range(n_traits):
        model.insert_variance(
            f"Var(E{suffix(j)})",
            f"Phenotype_{j + 1}",
            ParameterType.VARIANCE,
            EffectType.ENVIRONMENT,
            phenotype_variances[j] * (1.0 - heritabilities[j]),
        )
    for j in range(n_traits):
        for l in range(j + 1, n_traits):
            if not environmental_covariance:
                continue
            deps = [f"Var(E_p{j + 1})", f"Var(E_p{l + 1})"]
            if not use_correlations:
                init = 0.5 * np.sqrt(
                    phenotype_variances[j]
                    * (1.0 - heritabilities[j])
                    * phenotype_variances[l]
                    * (1.0 - heritabilities[l])
                )
                model.insert_variance(
                    f"Covar(E_p{j + 1}-{l + 1})",
                    f"Phenotype_{j + 1}_{l + 1}",
                    ParameterType.COVARIANCE,
                    EffectType.ENVIRONMENT,
                    init,
                    deps,
                )
            else:
                model.insert_variance(
                    f"Cor(E_p{j + 1}-{l + 1})",
                    f"Phenotype_{j + 1}_{l + 1}",
                    ParameterType.CORRELATION,
                    EffectType.ENVIRONMENT,
                    0.5,
                )

    # elements (reml.cpp:812-877)
    for i, kname in enumerate(kernel_names):
        for j in range(n_traits):
            e = model.insert_element(kname, f"{kname}_{j + 1}", kname, (j, j))
            model.append_variance_to_element(
                e.name, f"Var({kname}{suffix(j)})", VarianceTransform.NOCHANGE
            )
            if kname in parameter_kernels:
                model.append_parameter_to_element(e.name, f"alpha0({kname})")
            for l in range(j + 1, n_traits):
                e = model.insert_element(
                    kname, f"{kname}_{j + 1}_{l + 1}", kname, (j, l)
                )
                if not use_correlations:
                    model.append_variance_to_element(
                        e.name,
                        f"Covar({kname}_p{j + 1}-{l + 1})",
                        VarianceTransform.NOCHANGE,
                    )
                else:
                    model.append_variance_to_element(
                        e.name,
                        f"Cor({kname}_p{j + 1}-{l + 1})",
                        VarianceTransform.NOCHANGE,
                    )
                    model.append_variance_to_element(
                        e.name, f"Var({kname}_p{j + 1})", VarianceTransform.SQRT
                    )
                    model.append_variance_to_element(
                        e.name, f"Var({kname}_p{l + 1})", VarianceTransform.SQRT
                    )
    for j in range(n_traits):
        e = model.insert_element("E", f"E_{j + 1}", "E", (j, j))
        model.append_variance_to_element(
            e.name, f"Var(E{suffix(j)})", VarianceTransform.NOCHANGE
        )
        for l in range(j + 1, n_traits):
            if not environmental_covariance:
                continue
            e = model.insert_element("E", f"E_{j + 1}_{l + 1}", "E", (j, l))
            if not use_correlations:
                model.append_variance_to_element(
                    e.name,
                    f"Covar(E_p{j + 1}-{l + 1})",
                    VarianceTransform.NOCHANGE,
                )
            else:
                model.append_variance_to_element(
                    e.name, f"Cor(E_p{j + 1}-{l + 1})", VarianceTransform.NOCHANGE
                )
                model.append_variance_to_element(
                    e.name, f"Var(E_p{j + 1})", VarianceTransform.SQRT
                )
                model.append_variance_to_element(
                    e.name, f"Var(E_p{l + 1})", VarianceTransform.SQRT
                )
    return model


def build_variance_model_asymmetric(
    kernel_blocks: "Dict[str, Dict[Tuple[int, int], torch.Tensor]]",
    phenotype_variances: Sequence[float],
    heritabilities: Sequence[float],
    trait_sizes: Sequence[int],
    env_cross_blocks: "Dict[Tuple[int, int], torch.Tensor]",
    weights: Optional[Sequence[float]] = None,
    use_correlations: bool = False,
) -> CovarianceModel:
    """Multi-trait model with DIFFERING per-trait individual sets.

    kernel_blocks: kernel name -> {(t, u): K[S_t, S_u]} for t <= u (the
    asymmetric kernel blocks of reml.cpp:812-877).  env_cross_blocks:
    {(t, u): indicator matrix of shared individuals} — the environmental
    covariance exists only where individuals overlap
    (computeEnvironmentalCovariances, reml.cpp:790-810); pairs with no
    overlap are omitted.  Variance naming matches build_variance_model.
    The blocks may be tensors on a device; the environmental identities
    are made on the first kernel block's device, in float64.
    """
    n_traits = len(trait_sizes)
    names = list(kernel_blocks)
    k = len(names)
    if weights is None:
        weights = [1.0 / k] * k
    model = CovarianceModel(trait_sizes[0], n_traits, diagonal=False, trait_sizes=trait_sizes)
    first = next(iter(kernel_blocks[names[0]].values()))
    device = first.device if isinstance(first, torch.Tensor) else torch.device("cpu")

    for kname, blocks in kernel_blocks.items():
        for (t, u), mat in blocks.items():
            model.insert_matrix(f"{kname}__{t}_{u}", mat)
    for t in range(n_traits):
        model.insert_matrix(
            f"E__{t}_{t}", torch.eye(trait_sizes[t], dtype=torch.float64, device=device)
        )
    for (t, u), mat in env_cross_blocks.items():
        model.insert_matrix(f"E__{t}_{u}", mat)

    for j in range(n_traits):
        model.insert_variance_group(f"Phenotype_{j + 1}", phenotype_variances[j])
        for l in range(j + 1, n_traits):
            model.insert_variance_group(
                f"Phenotype_{j + 1}_{l + 1}",
                0.5 * np.sqrt(phenotype_variances[j] * phenotype_variances[l]),
            )

    for i, kname in enumerate(names):
        for j in range(n_traits):
            model.insert_variance(
                f"Var({kname}_p{j + 1})",
                f"Phenotype_{j + 1}",
                ParameterType.VARIANCE,
                EffectType.GENETIC,
                phenotype_variances[j] * heritabilities[j] * weights[i],
            )
        for j in range(n_traits):
            for l in range(j + 1, n_traits):
                if (j, l) not in kernel_blocks[kname]:
                    continue
                deps = [f"Var({kname}_p{j + 1})", f"Var({kname}_p{l + 1})"]
                if not use_correlations:
                    init = 0.5 * np.sqrt(
                        phenotype_variances[j] * heritabilities[j] * weights[i]
                        * phenotype_variances[l] * heritabilities[l] * weights[i]
                    )
                    model.insert_variance(
                        f"Covar({kname}_p{j + 1}-{l + 1})",
                        f"Phenotype_{j + 1}_{l + 1}",
                        ParameterType.COVARIANCE,
                        EffectType.GENETIC,
                        init,
                        deps,
                    )
                else:
                    model.insert_variance(
                        f"Cor({kname}_p{j + 1}-{l + 1})",
                        f"Phenotype_{j + 1}_{l + 1}",
                        ParameterType.CORRELATION,
                        EffectType.GENETIC,
                        0.5,
                    )
    for j in range(n_traits):
        model.insert_variance(
            f"Var(E_p{j + 1})",
            f"Phenotype_{j + 1}",
            ParameterType.VARIANCE,
            EffectType.ENVIRONMENT,
            phenotype_variances[j] * (1.0 - heritabilities[j]),
        )
    for j in range(n_traits):
        for l in range(j + 1, n_traits):
            if (j, l) not in env_cross_blocks:
                continue
            deps = [f"Var(E_p{j + 1})", f"Var(E_p{l + 1})"]
            if not use_correlations:
                init = 0.5 * np.sqrt(
                    phenotype_variances[j] * (1.0 - heritabilities[j])
                    * phenotype_variances[l] * (1.0 - heritabilities[l])
                )
                model.insert_variance(
                    f"Covar(E_p{j + 1}-{l + 1})",
                    f"Phenotype_{j + 1}_{l + 1}",
                    ParameterType.COVARIANCE,
                    EffectType.ENVIRONMENT,
                    init,
                    deps,
                )
            else:
                model.insert_variance(
                    f"Cor(E_p{j + 1}-{l + 1})",
                    f"Phenotype_{j + 1}_{l + 1}",
                    ParameterType.CORRELATION,
                    EffectType.ENVIRONMENT,
                    0.5,
                )

    def cross_variances(e_name, prefix, j, l):
        """The cross element's covariance, or its correlation times the
        square roots of both traits' variances."""
        if not use_correlations:
            model.append_variance_to_element(
                e_name, f"Covar({prefix}_p{j + 1}-{l + 1})", VarianceTransform.NOCHANGE
            )
            return
        model.append_variance_to_element(
            e_name, f"Cor({prefix}_p{j + 1}-{l + 1})", VarianceTransform.NOCHANGE
        )
        model.append_variance_to_element(e_name, f"Var({prefix}_p{j + 1})", VarianceTransform.SQRT)
        model.append_variance_to_element(e_name, f"Var({prefix}_p{l + 1})", VarianceTransform.SQRT)

    for i, kname in enumerate(names):
        for j in range(n_traits):
            e = model.insert_element(kname, f"{kname}_{j + 1}", f"{kname}__{j}_{j}", (j, j))
            model.append_variance_to_element(
                e.name, f"Var({kname}_p{j + 1})", VarianceTransform.NOCHANGE
            )
            for l in range(j + 1, n_traits):
                if (j, l) not in kernel_blocks[kname]:
                    continue
                e = model.insert_element(
                    kname, f"{kname}_{j + 1}_{l + 1}", f"{kname}__{j}_{l}", (j, l)
                )
                cross_variances(e.name, kname, j, l)
    for j in range(n_traits):
        e = model.insert_element("E", f"E_{j + 1}", f"E__{j}_{j}", (j, j))
        model.append_variance_to_element(e.name, f"Var(E_p{j + 1})", VarianceTransform.NOCHANGE)
        for l in range(j + 1, n_traits):
            if (j, l) not in env_cross_blocks:
                continue
            e = model.insert_element("E", f"E_{j + 1}_{l + 1}", f"E__{j}_{l}", (j, l))
            cross_variances(e.name, "E", j, l)
    return model
