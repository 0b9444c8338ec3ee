"""The symbolic covariance matrix V(theta) = sum_e c_e * g_e(theta) * M_e.

Parity: covariancematrix.{h,cpp}; port of dissect_tpu/model/covariance.py.
The element table compiles into tensors:

  powers  (E, K)  exponent of variance k in element e's coefficient
                  (1 = nochange, 0.5 = squareRoot, 0 = absent)
  factors (E,)    the constant factor c_e
  blocks  (E, 2)  trait-block placement

The coefficient function g: R^K -> R^E is differentiated with
`torch.func.jacfwd` / `torch.func.hessian` (K and E are tiny), and the
heavy REML quantities assemble from per-element primitives.

This slice ports the diagonal representation — V as (n, T, T)
per-individual blocks over eigen-rotated kernels — which the GWAS null
fit runs.  The dense representation comes with the dense --reml slice
(ROADMAP.md, queue 1 item 2).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch


class ParameterType(enum.Enum):
    """Parity: ParameterAttributes type (covariancematrix.h:107-120)."""

    VARIANCE = "variance"
    COVARIANCE = "covariance"
    CORRELATION = "correlation"
    STANDARD_DEVIATION = "stddev"
    PARAMETER = "parameter"


class EffectType(enum.Enum):
    GENETIC = "genetic"
    ENVIRONMENT = "environment"
    OTHER = "other"


class VarianceTransform(enum.Enum):
    """Parity: nochange / squareRoot (covariancematrix.h:100-105)."""

    NOCHANGE = 1.0
    SQRT = 0.5


@dataclasses.dataclass
class Variance:
    name: str
    group: str
    type: ParameterType
    effect: EffectType
    initial_value: float
    fixed: bool = False
    # PARAMETER-type entries stay fixed for the first N Newton steps
    # (remlStepsToUnfixExpKernelParameter, options.cpp:143)
    unfix_after: Optional[int] = None
    # indices of variances whose product bounds this covariance
    # (constrainedDependingOnProductOfi, covariancematrix.h:117)
    constrained_on_product_of: Set[int] = dataclasses.field(default_factory=set)


@dataclasses.dataclass
class Element:
    """One summand of V (covariancematrix.h:90-105)."""

    name: str
    matrix_name: str
    block: Tuple[int, int]  # trait-block placement (row, col)
    factor: float = 1.0
    variance_factors: List[Tuple[str, VarianceTransform]] = dataclasses.field(
        default_factory=list
    )
    subcovariance_id: str = ""  # named sub-covariance (e.g. "GRM", "E")


class CovarianceModel:
    """Host-side builder (insertVarianceGroup, insertVariance,
    insertElement, appendVarianceToElement; REML::prepare,
    reml.cpp:592-917); `compile` places it on a device."""

    def __init__(self, n: int, n_traits: int = 1, diagonal: bool = False):
        self.n = n
        self.n_traits = n_traits
        self.diagonal = diagonal
        self.matrices: Dict[str, torch.Tensor] = {}
        self.variances: List[Variance] = []
        self._variance_index: Dict[str, int] = {}
        self.elements: List[Element] = []
        self.group_magnitudes: Dict[str, float] = {}

    # --- construction --------------------------------------------------------
    def insert_variance_group(self, name: str, expected_magnitude: float):
        """Parity: insertVarianceGroup (covariancematrix.cpp:131-141)."""
        self.group_magnitudes[name] = float(expected_magnitude)

    def insert_variance(
        self,
        name: str,
        group: str,
        ptype: ParameterType,
        effect: EffectType,
        initial_value: float,
        constrained_on_product_of: Optional[Sequence[str]] = None,
    ) -> int:
        if name in self._variance_index:
            return self._variance_index[name]
        deps: Set[int] = set()
        if constrained_on_product_of:
            deps = {self._variance_index[d] for d in constrained_on_product_of}
        idx = len(self.variances)
        self.variances.append(
            Variance(
                name=name,
                group=group,
                type=ptype,
                effect=effect,
                initial_value=float(initial_value),
                constrained_on_product_of=deps,
            )
        )
        self._variance_index[name] = idx
        return idx

    def insert_matrix(self, name: str, matrix):
        """Register a kernel: (n,) diagonal (eigenvalues) in diagonal mode."""
        m = torch.as_tensor(matrix)
        if not self.diagonal:
            raise NotImplementedError(
                "dense covariance models are not ported yet "
                "(ROADMAP.md queue 1, item 2)"
            )
        if tuple(m.shape) != (self.n,):
            raise ValueError(f"matrix {name}: shape {tuple(m.shape)} != ({self.n},)")
        self.matrices[name] = m

    def insert_element(
        self,
        subcovariance_id: str,
        name: str,
        matrix_name: str,
        block: Tuple[int, int] = (0, 0),
        factor: float = 1.0,
    ) -> Element:
        if matrix_name not in self.matrices:
            raise ValueError(f"unknown matrix {matrix_name}")
        e = Element(
            name=name,
            matrix_name=matrix_name,
            block=block,
            factor=factor,
            subcovariance_id=subcovariance_id,
        )
        self.elements.append(e)
        return e

    def append_variance_to_element(
        self, element_name: str, variance_name: str, transform: VarianceTransform
    ):
        """Parity: appendVarianceToElement."""
        if variance_name not in self._variance_index:
            raise ValueError(f"unknown variance {variance_name}")
        for e in self.elements:
            if e.name == element_name:
                e.variance_factors.append((variance_name, transform))
                return
        raise ValueError(f"unknown element {element_name}")

    # --- accessors -----------------------------------------------------------
    @property
    def n_variances(self) -> int:
        return len(self.variances)

    @property
    def n_total(self) -> int:
        return self.n * self.n_traits

    def initial_theta(self) -> np.ndarray:
        return np.array([v.initial_value for v in self.variances], dtype=np.float64)

    def variance_names(self) -> List[str]:
        return [v.name for v in self.variances]

    def genetic_variance_indices(self) -> List[int]:
        return [
            i
            for i, v in enumerate(self.variances)
            if v.effect == EffectType.GENETIC and v.type == ParameterType.VARIANCE
        ]

    # --- compilation ---------------------------------------------------------
    def compile(self, device=None, dtype=torch.float64) -> "CompiledCovariance":
        """The model on `device`; by default on the one device its
        matrices already live on (never moved to the host unasked)."""
        if device is None:
            devices = {m.device for m in self.matrices.values()}
            if len(devices) != 1:
                raise ValueError(
                    f"matrices on {sorted(map(str, devices)) or 'no device'}: name the device"
                )
            (device,) = devices
        E, K = len(self.elements), self.n_variances
        powers = np.zeros((E, K), dtype=np.float64)
        factors = np.zeros((E,), dtype=np.float64)
        mats = []
        blocks = []
        for ei, e in enumerate(self.elements):
            factors[ei] = e.factor
            blocks.append(tuple(e.block))
            mats.append(self.matrices[e.matrix_name].to(device=device, dtype=dtype))
            for vn, transform in e.variance_factors:
                powers[ei, self._variance_index[vn]] += transform.value
        return CompiledCovariance(
            n=self.n,
            n_traits=self.n_traits,
            element_matrices=tuple(mats),
            blocks=tuple(blocks),
            powers=torch.as_tensor(powers, device=device, dtype=dtype),
            factors=torch.as_tensor(factors, device=device, dtype=dtype),
        )


@dataclasses.dataclass(frozen=True)
class CompiledCovariance:
    """Diagonal-mode covariance structure on a device: one (n,) vector
    per element, placed at a (row, col) trait block."""

    n: int
    n_traits: int
    element_matrices: Tuple[torch.Tensor, ...]
    blocks: Tuple[Tuple[int, int], ...]
    powers: torch.Tensor  # (E, K)
    factors: torch.Tensor  # (E,)

    diagonal = True

    @property
    def n_total(self) -> int:
        return self.n * self.n_traits

    @property
    def n_elements(self) -> int:
        return len(self.element_matrices)

    # --- coefficient function g(theta) --------------------------------------
    def coefficients(self, theta: torch.Tensor) -> torch.Tensor:
        """g_e(theta) = c_e * prod_k theta_k^{p_ek} (E,).

        Exponent 1 keeps sign (covariances/correlations may be
        negative); exponent 0.5 is sqrt(|theta|) — the reference's
        squareRoot transform applies only to positive variances."""
        t = theta[None, :]
        one = torch.ones_like(self.powers)
        lin = torch.where(self.powers == 1.0, t.expand_as(self.powers), one).prod(dim=1)
        sq = torch.where(
            self.powers == 0.5, torch.sqrt(torch.abs(t)).expand_as(self.powers), one
        ).prod(dim=1)
        return self.factors * lin * sq

    def coefficient_jacobian(self, theta: torch.Tensor) -> torch.Tensor:
        """dg/dtheta (E, K) — replaces computeDerivateCovariance(i)."""
        return torch.func.jacfwd(self.coefficients)(theta)

    def coefficient_hessian(self, theta: torch.Tensor) -> torch.Tensor:
        """d2g/dtheta2 (E, K, K) — replaces computeDerivateCovariance(i, j)."""
        return torch.func.hessian(self.coefficients)(theta)

    # --- assembly ------------------------------------------------------------
    def assemble_blockdiag(self, theta: torch.Tensor) -> torch.Tensor:
        """V as (n, T, T) per-individual blocks (computeBlockCovariance,
        covariancematrix.cpp:579-650)."""
        g = self.coefficients(theta)
        T, n = self.n_traits, self.n
        v = torch.zeros((n, T, T), dtype=theta.dtype, device=theta.device)
        for ei in range(self.n_elements):
            m = self.element_matrices[ei]
            ti, tj = self.blocks[ei]
            v[:, ti, tj] += g[ei] * m
            if ti != tj:
                v[:, tj, ti] += g[ei] * m
        return v

    def placed_blockdiag(self, ei: int) -> torch.Tensor:
        """Element ei alone as (n, T, T) per-individual blocks."""
        m = self.element_matrices[ei]
        ti, tj = self.blocks[ei]
        out = torch.zeros((self.n, self.n_traits, self.n_traits), dtype=m.dtype, device=m.device)
        out[:, ti, tj] += m
        if ti != tj:
            out[:, tj, ti] += m
        return out

    # --- per-element primitives for REML ------------------------------------
    def elements_times_vector(self, u: torch.Tensor) -> torch.Tensor:
        """M_e^(placed) @ u for every element -> (E, n_total); u is flat
        (n_total,).  The building block of subVPy (reml.cpp:1947-1960)."""
        n = self.n
        outs = []
        for ei in range(self.n_elements):
            m = self.element_matrices[ei]
            ti, tj = self.blocks[ei]
            ri, ci = ti * n, tj * n
            out = torch.zeros((self.n_total,), dtype=u.dtype, device=u.device)
            out[ri : ri + n] += m * u[ci : ci + n]
            if ti != tj:
                out[ci : ci + n] += m * u[ri : ri + n]
            outs.append(out)
        return torch.stack(outs)

    def element_traces_blockdiag(self, p_blocks: torch.Tensor) -> torch.Tensor:
        """tr(P M_e) from the (n, T, T) block-diagonal part of P; cross
        blocks count twice (trace identity, matrix.cpp:3835)."""
        traces = []
        for ei in range(self.n_elements):
            ti, tj = self.blocks[ei]
            t = torch.sum(p_blocks[:, ti, tj] * self.element_matrices[ei])
            traces.append((2.0 if ti != tj else 1.0) * t)
        return torch.stack(traces)
