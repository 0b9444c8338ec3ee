"""Carry the JAX package's state into the port's objects.

The system has no learned weights: its state is data — the packed GRM
tiles of a streaming build, a Kernel's matrix and counts or its
eigenpairs, fitted REML variances — and the genotype data itself.  Each
function here takes that state as numpy arrays (what `np.asarray` gives
for a jax.Array, or what the JAX package writes to disk) and returns the
port's object (on `device`, where it holds tensors), so a run can start
mid-pipeline from state the JAX package produced.  Nothing here imports
the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dissect_tpu_torch.io.bed import IndividualInfo, SnpInfo
from dissect_tpu_torch.io.bgen import BgenData
from dissect_tpu_torch.linalg.grm_kernels import packed_shape
from dissect_tpu_torch.linalg.syrk import grm_accumulator
from dissect_tpu_torch.model.covariance import (
    CovarianceModel,
    EffectType,
    ParameterType,
    VarianceTransform,
)
from dissect_tpu_torch.model.kernels import Kernel, KernelType
from dissect_tpu_torch.runtime.dtypes import GRM_DTYPE


def bgen_data_from_state(snps: Sequence, individuals: Sequence, dosages) -> BgenData:
    """The port's BgenData from a JAX BgenData's fields: its SnpInfo and
    IndividualInfo records (any objects with those attribute names) and
    its (M, N) dosages as a numpy array, kept as float32 with NaN =
    missing."""
    snp_fields = [f.name for f in dataclasses.fields(SnpInfo)]
    ind_fields = [f.name for f in dataclasses.fields(IndividualInfo)]
    dosages = np.asarray(dosages, dtype=np.float32)
    if dosages.shape != (len(snps), len(individuals)):
        raise ValueError(
            f"dosages have shape {dosages.shape}, expected ({len(snps)}, {len(individuals)})"
        )
    return BgenData(
        snps=[SnpInfo(**{f: getattr(s, f) for f in snp_fields}) for s in snps],
        individuals=[IndividualInfo(**{f: getattr(i, f) for f in ind_fields}) for i in individuals],
        dosages=dosages,
    )


def grm_accumulator_from_packed(kernel_tiles, counts_tiles, n: int, block_n: int,
                                device="cuda") -> grm_accumulator:
    """A streaming GRM accumulator resumed from packed (T*BN, BN) tiles in
    `_pair_maps` order (dissect_tpu/linalg/pallas_syrk.py), e.g. the
    buffers of `grm_fused_triangle_update` or of a triangle-mode
    `grm_accumulator`."""
    acc = grm_accumulator(n, device=device, block_n=block_n)
    for name, tiles in (("kernel", kernel_tiles), ("counts", counts_tiles)):
        tiles = np.array(tiles, dtype=np.float32)
        if tiles.shape != packed_shape(n, block_n):
            raise ValueError(
                f"{name} tiles have shape {tiles.shape}, expected "
                f"{packed_shape(n, block_n)} for n={n}, block_n={block_n}"
            )
        getattr(acc, name).copy_(torch.as_tensor(tiles, dtype=torch.float32))
    return acc


def kernel_from_state(
    individual_keys: Sequence[str],
    matrix=None,
    counts=None,
    eigenvalues=None,
    eigenvectors=None,
    snp_names: Sequence[str] = (),
    name: str = "GRM",
    device="cuda",
) -> Kernel:
    """A GRM Kernel from a JAX Kernel's matrix and counts (kept in the
    GRM dtype, float32), or from its eigenpairs (kept in float64)."""
    n = len(individual_keys)
    if (matrix is None) == (eigenvalues is None):
        raise ValueError("give either matrix (and counts) or eigenvalues and eigenvectors")
    put = lambda a, dtype: torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)
    if matrix is not None:
        if np.shape(matrix) != (n, n):
            raise ValueError(f"matrix shape {np.shape(matrix)} != ({n}, {n})")
        return Kernel(
            name=name,
            type=KernelType.GRM,
            individual_keys=list(individual_keys),
            snp_names=list(snp_names),
            matrix=put(matrix, GRM_DTYPE),
            counts=None if counts is None else put(counts, GRM_DTYPE),
        )
    if np.shape(eigenvalues) != (n,) or np.shape(eigenvectors) != (n, n):
        raise ValueError("eigenpairs do not match the individual count")
    return Kernel(
        name=name,
        type=KernelType.GRM,
        individual_keys=list(individual_keys),
        snp_names=list(snp_names),
        diagonalized=True,
        eigenvalues=put(eigenvalues, torch.float64),
        eigenvectors=put(eigenvectors, torch.float64),
    )


def reml_theta(variance_names: Sequence[str], variances,
               order: Optional[Sequence[str]] = None) -> np.ndarray:
    """REML variances (a JAX REMLResult's `variance_names`/`variances`)
    as a float64 vector in the order `order` names (default: as given),
    e.g. a port model's `variance_names()` to start its fit there."""
    values = dict(zip(variance_names, np.asarray(variances, dtype=np.float64)))
    if len(values) != len(variance_names):
        raise ValueError("repeated variance names")
    order = list(variance_names) if order is None else list(order)
    missing = [nm for nm in order if nm not in values]
    if missing:
        raise ValueError(f"no value for variances {missing}")
    return np.array([values[nm] for nm in order], dtype=np.float64)


def covariance_model_from_state(
    n: int,
    n_traits: int,
    diagonal: bool,
    matrices: Dict[str, object],
    variances: Sequence,
    elements: Sequence,
    group_magnitudes: Optional[Dict[str, float]] = None,
    device="cuda",
) -> CovarianceModel:
    """The port's CovarianceModel from a JAX CovarianceModel's state: its
    matrices by name (numpy arrays, moved to `device` as float64), its
    Variance records and its Element records (any objects with those
    attribute names; enums are matched by member name), and its group
    magnitudes.  Both engines then evaluate the same V(theta).  Every
    trait block must hold all n individuals (uniform trait sizes)."""
    model = CovarianceModel(n, n_traits, diagonal)
    model.group_magnitudes = dict(group_magnitudes or {})
    names = [v.name for v in variances]
    for v in variances:
        idx = model.insert_variance(
            v.name,
            v.group,
            ParameterType[v.type.name],
            EffectType[v.effect.name],
            v.initial_value,
            [names[d] for d in sorted(v.constrained_on_product_of)],
        )
        model.variances[idx].fixed = bool(v.fixed)
        model.variances[idx].unfix_after = v.unfix_after
    for name, m in matrices.items():
        model.insert_matrix(
            name, torch.as_tensor(np.array(m, dtype=np.float64), device=device)
        )
    for e in elements:
        model.insert_element(
            e.subcovariance_id, e.name, e.matrix_name, tuple(e.block), e.factor
        )
        for vn, transform in e.variance_factors:
            model.append_variance_to_element(e.name, vn, VarianceTransform[transform.name])
        if e.parameter_name is not None:
            model.append_parameter_to_element(e.name, e.parameter_name)
    return model
