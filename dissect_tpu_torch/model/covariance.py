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

Two representations of V:
  dense     (T n, T n) for general kernels, assembled out of place so
            that `torch.func.jacfwd` / `hessian` run over it (the
            squared-exponential kernels' inside-matrix parameter);
  diagonal  (n, T, T) per-individual trait blocks over eigen-rotated
            kernels — the GWAS null fit's O(n) fast path.
Trait blocks may differ in size (`trait_sizes`): the per-trait
individual sets of the asymmetric multi-trait model place each block at
its trait's offset, with rectangular cross-trait blocks.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from dissect_tpu_torch.runtime.mesh import RowShards


@dataclasses.dataclass
class DiagonalMatrix:
    """An (n, n) diagonal element matrix kept as its (n,) diagonal: the
    identity and diag(w) of a model whose kernels are row-sharded, so
    that no rank forms an N x N matrix for them."""

    values: torch.Tensor

    ndim = 2

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.values.shape[0], self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def dtype(self) -> torch.dtype:
        return self.values.dtype


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
    # inside-matrix parameter: the element matrix holds squared distances
    # D and evaluates as exp(-theta_p * D) (applyExponentialOperator,
    # covariancematrix.cpp:805; ParameterAttributes::insideMatrix)
    parameter_name: Optional[str] = None


class CovarianceModel:
    """Host-side builder (insertVarianceGroup, insertVariance,
    insertElement, appendVarianceToElement; REML::prepare,
    reml.cpp:592-917); `compile` places it on a device."""

    def __init__(
        self,
        n: int,
        n_traits: int = 1,
        diagonal: bool = False,
        trait_sizes: Optional[Sequence[int]] = None,
    ):
        self.n = n
        self.n_traits = n_traits
        # per-trait individual counts: uniform [n]*T unless given —
        # differing sizes model the reference's asymmetric kernel blocks
        # (nIndividualsTraits, reml.cpp:812-877)
        self.trait_sizes = [n] * n_traits if trait_sizes is None else list(trait_sizes)
        if len(self.trait_sizes) != n_traits:
            raise ValueError("trait_sizes length != n_traits")
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
        """Register a kernel matrix: (rows, cols) dense (rectangular for
        asymmetric cross-trait blocks), or (n,) diagonal (eigenvalues) in
        diagonal mode.  `compile` checks each dense element's matrix
        against its block's shape."""
        m = matrix if isinstance(matrix, (RowShards, DiagonalMatrix)) else torch.as_tensor(matrix)
        if self.diagonal:
            if tuple(m.shape) != (self.n,):
                raise ValueError(f"matrix {name}: shape {tuple(m.shape)} != ({self.n},)")
        elif m.ndim != 2:
            raise ValueError(f"matrix {name}: expected a 2D matrix")
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

    def append_parameter_to_element(self, element_name: str, param_name: str):
        """Attach an inside-matrix parameter (insideMatrix position,
        covariancematrix.h:100-105): M_e(theta) = exp(-theta_p * D_e)."""
        if param_name not in self._variance_index:
            raise ValueError(f"unknown variance {param_name}")
        for e in self.elements:
            if e.name == element_name:
                e.parameter_name = param_name
                return
        raise ValueError(f"unknown element {element_name}")

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
        return sum(self.trait_sizes)

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

    def delete_subcovariance(self, sub_id: str) -> "CovarianceModel":
        """A copy with the named sub-covariance removed — the reduced
        models of the LRTs (deleteCovariance, reml.cpp:1335-1460).
        Variances that no longer appear in any element are dropped."""
        kept_elements = [e for e in self.elements if e.subcovariance_id != sub_id]
        used = {vn for e in kept_elements for vn, _ in e.variance_factors}
        used |= {e.parameter_name for e in kept_elements if e.parameter_name}
        model = CovarianceModel(
            self.n, self.n_traits, self.diagonal, trait_sizes=self.trait_sizes
        )
        model.group_magnitudes = dict(self.group_magnitudes)
        for v in self.variances:
            if v.name in used:
                deps = [
                    self.variances[d].name
                    for d in v.constrained_on_product_of
                    if self.variances[d].name in used
                ]
                idx = model.insert_variance(
                    v.name, v.group, v.type, v.effect, v.initial_value, deps
                )
                model.variances[idx].unfix_after = v.unfix_after
        for name, m in self.matrices.items():
            if any(e.matrix_name == name for e in kept_elements):
                model.insert_matrix(name, m)
        for e in kept_elements:
            ne = model.insert_element(
                e.subcovariance_id, e.name, e.matrix_name, e.block, e.factor
            )
            ne.variance_factors = [
                (vn, t) for vn, t in e.variance_factors if vn in used
            ]
            ne.parameter_name = e.parameter_name
        return model

    # --- compilation ---------------------------------------------------------
    def compile(self, device=None, dtype=torch.float64, matrices: bool = True) -> "CompiledCovariance":
        """The model on `device`; by default on the one device its
        matrices already live on (never moved to the host unasked).
        With matrices=False only the structure (coefficients, blocks) is
        compiled and each element matrix is an empty placeholder: the
        row-sharded REML engine places its own local rows."""
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
        mats = {}  # one upcast copy per matrix, shared by its elements
        blocks = []
        pids = []
        for ei, e in enumerate(self.elements):
            factors[ei] = e.factor
            blocks.append(tuple(e.block))
            m = self.matrices[e.matrix_name]
            ti, tj = e.block
            expected = (self.trait_sizes[ti], self.trait_sizes[tj])
            if not self.diagonal and tuple(m.shape) != expected:
                raise ValueError(
                    f"element {e.name}: matrix {e.matrix_name} shape "
                    f"{tuple(m.shape)} != block shape {expected}"
                )
            if e.matrix_name not in mats:
                mats[e.matrix_name] = (
                    m.to(device=device, dtype=dtype) if matrices
                    else torch.empty(0, device=device, dtype=dtype)
                )
            pids.append(
                -1 if e.parameter_name is None else self._variance_index[e.parameter_name]
            )
            for vn, transform in e.variance_factors:
                powers[ei, self._variance_index[vn]] += transform.value
        return CompiledCovariance(
            trait_sizes=tuple(self.trait_sizes),
            element_matrices=tuple(mats[e.matrix_name] for e in self.elements),
            blocks=tuple(blocks),
            powers=torch.as_tensor(powers, device=device, dtype=dtype),
            factors=torch.as_tensor(factors, device=device, dtype=dtype),
            diagonal=self.diagonal,
            param_ids=tuple(pids),
        )


@dataclasses.dataclass(frozen=True)
class CompiledCovariance:
    """Covariance structure on a device: one matrix per element — dense
    (rows, cols) of its trait block, or (n,) in diagonal mode — placed at
    a (row, col) trait block, each block at its trait's offset."""

    trait_sizes: Tuple[int, ...]
    element_matrices: Tuple[torch.Tensor, ...]
    blocks: Tuple[Tuple[int, int], ...]
    powers: torch.Tensor  # (E, K)
    factors: torch.Tensor  # (E,)
    diagonal: bool = True
    param_ids: Tuple[int, ...] = ()  # inside-matrix parameter per element, -1 = none

    # --- shape helpers -------------------------------------------------------
    @property
    def n_traits(self) -> int:
        return len(self.trait_sizes)

    @property
    def n(self) -> int:
        """Per-trait size for uniform models (the common case)."""
        return self.trait_sizes[0]

    @property
    def uniform(self) -> bool:
        return all(s == self.trait_sizes[0] for s in self.trait_sizes)

    @property
    def n_total(self) -> int:
        return sum(self.trait_sizes)

    @property
    def offsets(self) -> Tuple[int, ...]:
        out, acc = [], 0
        for s in self.trait_sizes:
            out.append(acc)
            acc += s
        return tuple(out)

    @property
    def has_matrix_params(self) -> bool:
        return any(p >= 0 for p in self.param_ids)

    @property
    def n_elements(self) -> int:
        return len(self.element_matrices)

    def element_matrix(self, ei: int, theta: torch.Tensor) -> torch.Tensor:
        """The (possibly theta-dependent) element matrix: raw M, or
        exp(-theta_p * D) for squared-exponential elements
        (applyExponentialOperator, covariancematrix.cpp:805)."""
        m = self.element_matrices[ei]
        p = self.param_ids[ei] if self.param_ids else -1
        if p >= 0:
            m = torch.exp(-theta[p] * m)
        return m

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
    def assemble_dense(self, theta: torch.Tensor) -> torch.Tensor:
        """V as (n_total, n_total) (computeCovariance,
        covariancematrix.cpp:545-577).  Out of place — trait blocks are
        summed, then concatenated — so `torch.func` transforms run over
        it."""
        g = self.coefficients(theta)
        T = self.n_traits
        grid = [[None] * T for _ in range(T)]

        def add(ti, tj, term):
            grid[ti][tj] = term if grid[ti][tj] is None else grid[ti][tj] + term

        for ei in range(self.n_elements):
            m = self.element_matrix(ei, theta)
            if self.diagonal:
                m = torch.diag(m)
            ti, tj = self.blocks[ei]
            add(ti, tj, g[ei] * m)
            if ti != tj:
                add(tj, ti, g[ei] * m.T)
        if T == 1:
            return grid[0][0]
        dtype, device = self.element_matrices[0].dtype, self.element_matrices[0].device
        sizes = self.trait_sizes
        zero = lambda ti, tj: torch.zeros((sizes[ti], sizes[tj]), dtype=dtype, device=device)
        return torch.cat(
            [
                torch.cat([b if b is not None else zero(ti, tj) for tj, b in enumerate(row)], dim=1)
                for ti, row in enumerate(grid)
            ],
            dim=0,
        )

    def assemble_blockdiag(self, theta: torch.Tensor) -> torch.Tensor:
        """V as (n, T, T) per-individual blocks (computeBlockCovariance,
        covariancematrix.cpp:579-650); uniform diagonal models only."""
        if not self.diagonal or not self.uniform:
            raise ValueError("blockdiag assembly requires uniform diagonal matrices")
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

    def placed_dense(self, ei: int) -> torch.Tensor:
        """Element ei alone as a dense (n_total, n_total) matrix."""
        m = self.element_matrices[ei]
        if self.diagonal:
            m = torch.diag(m)
        ti, tj = self.blocks[ei]
        ri, ci = self.offsets[ti], self.offsets[tj]
        nr, nc = m.shape
        out = torch.zeros((self.n_total, self.n_total), dtype=m.dtype, device=m.device)
        out[ri : ri + nr, ci : ci + nc] += m
        if ti != tj:
            out[ci : ci + nc, ri : ri + nr] += m.T
        return out

    # --- per-element primitives for REML ------------------------------------
    # These evaluate theta-independent element matrices; parameterized
    # (inside-matrix) models go through the autodiff core instead.
    def elements_times_matrix(self, u: torch.Tensor) -> torch.Tensor:
        """M_e^(placed) @ U for every element, U (n_total, c) ->
        (E, n_total, c): forms tr(P M_e) without ever materializing the
        dense P (P is V^-1 minus a rank-c correction)."""
        off = self.offsets
        outs = []
        for ei in range(self.n_elements):
            m = self.element_matrices[ei]
            ti, tj = self.blocks[ei]
            ri, ci = off[ti], off[tj]
            out = torch.zeros((self.n_total,) + tuple(u.shape[1:]), dtype=u.dtype, device=u.device)
            if self.diagonal:
                n = m.shape[0]
                mm = m.reshape((n,) + (1,) * (u.ndim - 1))
                out[ri : ri + n] += mm * u[ci : ci + n]
                if ti != tj:
                    out[ci : ci + n] += mm * u[ri : ri + n]
            else:
                nr, nc = m.shape
                out[ri : ri + nr] += m @ u[ci : ci + nc]
                if ti != tj:
                    out[ci : ci + nc] += m.T @ u[ri : ri + nr]
            outs.append(out)
        return torch.stack(outs)

    def elements_times_vector(self, u: torch.Tensor) -> torch.Tensor:
        """M_e^(placed) @ u for every element -> (E, n_total); u is flat
        (n_total,).  The building block of subVPy (reml.cpp:1947-1960)."""
        return self.elements_times_matrix(u)

    def element_traces_dense(self, p: torch.Tensor) -> torch.Tensor:
        """tr(P M_e^(placed)) for every element -> (E,), P (n_total,
        n_total) symmetric; cross blocks count twice (trace identity,
        matrix.cpp:3835)."""
        off = self.offsets
        traces = []
        for ei in range(self.n_elements):
            m = self.element_matrices[ei]
            ti, tj = self.blocks[ei]
            nr, nc = (m.shape[0],) * 2 if self.diagonal else m.shape
            block = p[off[ti] : off[ti] + nr, off[tj] : off[tj] + nc]
            t = torch.sum((torch.diagonal(block) if self.diagonal else block) * m)
            traces.append((2.0 if ti != tj else 1.0) * t)
        return torch.stack(traces)

    def element_traces_blockdiag(self, p_blocks: torch.Tensor) -> torch.Tensor:
        """tr(P M_e) from the (n, T, T) block-diagonal part of P; cross
        blocks count twice (trace identity, matrix.cpp:3835)."""
        traces = []
        for ei in range(self.n_elements):
            ti, tj = self.blocks[ei]
            t = torch.sum(p_blocks[:, ti, tj] * self.element_matrices[ei])
            traces.append((2.0 if ti != tj else 1.0) * t)
        return torch.stack(traces)
