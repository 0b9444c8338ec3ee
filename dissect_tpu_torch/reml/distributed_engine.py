"""Dense AI-REML with a row-sharded covariance — biobank N across cards.

Port of dissect_tpu/reml/distributed_engine.py.  At biobank N the
(N, N) float64 V, its factor and its inverse outgrow one card, so this
engine keeps every N x N quantity ROW-SHARDED over the ranks of a
MeshContext for the whole fit:

  * each rank holds its rows of every element matrix, placed in the
    (T n_pad, T n_pad) layout (`ShardedCovariance`); elements whose
    matrix is diagonal (identities, diag(w) weights) are kept as
    vectors, never densified;
  * the factorization + inverse is the interleaved blocked Cholesky ->
    in-place trtri -> in-place lauum pipeline (linalg/distributed.py);
  * P = Vi - ViX (X'ViX)^-1 (ViX)' is applied as an operator, never
    formed; tr(P M_e) = tr(Vi M_e) - tr((X'ViX)^-1 (ViX)' M_e (ViX));
  * N-vectors (y, Py, M_e Py) and the thin (N, c) products are
    replicated: each rank computes its rows and all-gathers them.

Arbitrary N is identity-padded: every trait block grows to the next
multiple of (world * block) with ones on V's pad diagonal and zero pad
rows in y, X and every element, so log|V|, y'Py, the gradient, the
traces and the AI matrix are exact for the unpadded problem
(ScaLAPACK's partial trailing blocks, matrix.cpp:1748-1786); BLUPs,
BLUP errors, residuals and `final_py` are sliced back.

What is not ported: the JAX engine fits in float32 and finishes with a
float64 endgame built for the TPU (hi/lo pair storage, `_newton_cc`, the
`_stage_*` emulation and the memory probes, :537-880 and :1075-1302).
Here the fit is float64 on the device from its first iteration, through
the base engine's host loop, whose convergence test keeps the logL
window -1e-2 < dlogL < 1e-4 as a conjunct: the reference endgame's
Newton-decrement disjunct (:1290), which declares convergence even
after logL fell by more than 1e-2, is not copied.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dissect_tpu_torch.linalg.distributed import (
    pick_interleave,
    sharded_matmul,
    spd_inverse_logdet_cyclic,
)
from dissect_tpu_torch.model.covariance import CovarianceModel, DiagonalMatrix
from dissect_tpu_torch.reml.engine import (
    _HOST_KEYS,
    REMLEngine,
    REMLOptions,
    _finite,
    _host,
    _inverse_logdet,
)
from dissect_tpu_torch.runtime.mesh import MeshContext, RowShards
from dissect_tpu_torch.runtime.timers import timers


def pick_block(n_total: int, n_devices: int, requested: Optional[int] = None) -> int:
    """Cholesky panel width: the largest power of two <= n_total/devices,
    capped at 256 and floored at 8."""
    if requested is not None:
        return requested
    per_dev = max(n_total // max(n_devices, 1), 8)
    block = 8
    while block * 2 <= min(per_dev, 256):
        block *= 2
    return block


class ShardedCovariance:
    """This rank's rows of each element matrix of V, placed in the padded
    (N_pad, N_pad) layout.

    A dense element is a list of pieces (first local row, first column,
    slab): its block m at (row offset, col offset) and, off the trait
    diagonal, m^T at the mirrored offsets, each cut to the local rows.
    Slabs are cut once per matrix and shared between elements that use
    the same matrix at the same rows (the uniform multi-trait model
    places ONE GRM on every (t, u) block); each rank fetches its slabs
    of a row-sharded matrix (RowShards) in one collective.  A diagonal
    element (a DiagonalMatrix, or a dense matrix found diagonal) is the
    (local row, column, value) triples of its entries."""

    def __init__(self, cc, matrices, padded_sizes, ctx: MeshContext, dtype=torch.float64):
        self.blocks = cc.blocks
        self.n_total = sum(padded_sizes)
        self.r0, self.r1 = ctx.local_rows(self.n_total)
        off = np.cumsum([0] + list(padded_sizes))[:-1]
        device = ctx.device
        self.dense: list = []  # per element: list of (a0, c0, slab) or None
        self.diag: list = []  # per element: (local rows, cols, values) or None
        slabs: Dict[tuple, Optional[torch.Tensor]] = {}
        kinds: Dict[int, Tuple[bool, bool]] = {}
        sharded: list = []  # the RowShards matrices, in first use (the same on every rank)
        for m, (ti, tj) in zip(matrices, cc.blocks):
            if id(m) not in kinds:
                if isinstance(m, DiagonalMatrix):
                    kinds[id(m)] = (True, True)
                elif isinstance(m, RowShards):  # a kernel: square and symmetric
                    kinds[id(m)] = (False, True)
                    sharded.append(m)
                else:
                    nz = torch.count_nonzero(m)
                    is_diag = m.shape[0] == m.shape[1] and int(nz) == int(
                        torch.count_nonzero(torch.diagonal(m))
                    )
                    symmetric = m.shape[0] == m.shape[1] and bool(torch.equal(m, m.T))
                    kinds[id(m)] = (is_diag, symmetric)
            is_diag, symmetric = kinds[id(m)]
            ri, ci = int(off[ti]), int(off[tj])
            placements = [(ri, ci, False)] + ([(ci, ri, True)] if ti != tj else [])
            if is_diag:
                vals = m.values if isinstance(m, DiagonalMatrix) else torch.diagonal(m)
                vals = vals.to(device=device, dtype=dtype)
                a = torch.arange(m.shape[0], device=device)
                rows, cols, values = [], [], []
                for r_off, c_off, _ in placements:
                    keep = (a + r_off >= self.r0) & (a + r_off < self.r1)
                    rows.append(a[keep] + r_off - self.r0)
                    cols.append(a[keep] + c_off)
                    values.append(vals[keep])
                self.diag.append((torch.cat(rows), torch.cat(cols), torch.cat(values)))
                self.dense.append(None)
                continue
            pieces = []
            for r_off, c_off, transposed in placements:
                nrows = m.shape[1] if transposed else m.shape[0]
                a0, a1 = max(r_off, self.r0), min(r_off + nrows, self.r1)
                if a0 >= a1:
                    continue
                lo, hi = a0 - r_off, a1 - r_off
                flip = transposed and not symmetric
                key = (id(m), lo, hi, flip)
                if key not in slabs:
                    if isinstance(m, RowShards):
                        slabs[key] = None  # fetched below
                    else:
                        src = m[:, lo:hi].T if flip else m[lo:hi]
                        slabs[key] = src.to(device=device, dtype=dtype).contiguous()
                pieces.append((a0 - self.r0, c_off, key))
            self.dense.append(pieces)
            self.diag.append(None)
        self.n_row_sharded = len(sharded)
        for m in sharded:  # one collective per row-sharded matrix, on every rank
            keys = [key for key in slabs if key[0] == id(m)]
            got = m.take([(torch.arange(lo, hi), None) for _, lo, hi, _ in keys])
            for key, rows in zip(keys, got):
                slabs[key] = rows.to(device=device, dtype=dtype)
        self.dense = [
            None if pieces is None else [(a0, c0, slabs[key]) for a0, c0, key in pieces]
            for pieces in self.dense
        ]

    @property
    def n_local(self) -> int:
        return self.r1 - self.r0

    def assemble_local(self, g: torch.Tensor, pad_diag: torch.Tensor) -> torch.Tensor:
        """This rank's rows of V = sum_e g_e M_e + diag(pad)."""
        v = self.dense_local(g, range(len(self.dense)))
        local = torch.arange(self.n_local, device=g.device)
        v[local, local + self.r0] += pad_diag[self.r0 : self.r1]
        return v

    def times_local(self, u: torch.Tensor, elements=None) -> torch.Tensor:
        """This rank's rows of M_e @ U for each element (all, or those in
        `elements`), U replicated (N_pad, ...) -> (E', n_local, ...)."""
        ids = range(len(self.dense)) if elements is None else elements
        outs = []
        for ei in ids:
            out = u.new_zeros((self.n_local,) + tuple(u.shape[1:]))
            if self.dense[ei] is None:
                rows, cols, vals = self.diag[ei]
                out.index_add_(0, rows, vals.reshape((-1,) + (1,) * (u.ndim - 1)) * u[cols])
            else:
                for a0, c0, slab in self.dense[ei]:
                    out[a0 : a0 + slab.shape[0]] += slab @ u[c0 : c0 + slab.shape[1]]
            outs.append(out)
        return torch.stack(outs)

    def traces_local(self, w_loc: torch.Tensor) -> torch.Tensor:
        """This rank's share of tr(W M_e) = sum_ij W_ij M_e,ij for each
        element, W symmetric and row-sharded like V (all-reduce the sum)."""
        out = []
        for ei, pieces in enumerate(self.dense):
            if pieces is None:
                rows, cols, vals = self.diag[ei]
                out.append(torch.sum(w_loc[rows, cols] * vals))
                continue
            t = w_loc.new_zeros(())
            for a0, c0, slab in pieces:
                t = t + torch.sum(w_loc[a0 : a0 + slab.shape[0], c0 : c0 + slab.shape[1]] * slab)
            out.append(t)
        return torch.stack(out)

    def dense_local(self, g: torch.Tensor, elements) -> torch.Tensor:
        """This rank's rows of sum_{e in elements} g_e M_e."""
        c = torch.zeros((self.n_local, self.n_total), dtype=g.dtype, device=g.device)
        for ei in elements:
            if self.dense[ei] is None:
                rows, cols, vals = self.diag[ei]
                c.index_put_((rows, cols), g[ei] * vals, accumulate=True)
            else:
                for a0, c0, slab in self.dense[ei]:
                    c[a0 : a0 + slab.shape[0], c0 : c0 + slab.shape[1]].add_(slab, alpha=float(g[ei]))
        return c


def _gather_rows(ctx: MeshContext, local: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Every rank's rows along `axis` (the local row axis), concatenated."""
    if axis == 0:
        return ctx.all_gather(local)
    moved = torch.movedim(local, axis, 0)
    return torch.movedim(ctx.all_gather(moved), 0, axis)


def distributed_dense_quantities(
    sc: ShardedCovariance, cc, theta, y, x, pad_diag, ctx: MeshContext, block: int,
    use_ml: bool = False,
):
    """Dense REML/ML quantities with row-sharded V and Vi and
    operator-form P (the port's `_dense_quantities` on the mesh).  Every
    returned quantity is replicated except `vi_loc`, this rank's rows of
    V^-1."""
    g = cc.coefficients(theta)
    with timers.phase("DistributedInverse"):
        vi_loc, logdet_v = spd_inverse_logdet_cyclic(sc.assemble_local(g, pad_diag), ctx, block)
    vix = ctx.all_gather(vi_loc @ x)
    xtvix_i, logdet_x = _inverse_logdet(x.T @ vix)

    def apply_p(z):
        return ctx.all_gather(vi_loc @ z) - vix @ (xtvix_i @ (vix.T @ z))

    py = apply_p(y)
    ytpy = y @ py
    mpy = _gather_rows(ctx, sc.times_local(py), axis=1)  # (E, N)
    tr_vi_e = ctx.all_reduce(sc.traces_local(vi_loc))
    mw = _gather_rows(ctx, sc.times_local(vix), axis=1)  # (E, N, c)
    quad_e = torch.einsum("nc,enk->eck", vix, mw)
    tr_p_full = tr_vi_e - torch.einsum("ck,eck->e", xtvix_i, quad_e)
    tr_e = tr_vi_e if use_ml else tr_p_full
    ypmpy_e = mpy @ py
    a = cc.coefficient_jacobian(theta)
    grad = 0.5 * (a.T @ ypmpy_e - a.T @ tr_e)
    subvpy = torch.einsum("ei,ek->ik", mpy, a)
    ai = 0.5 * subvpy.T @ apply_p(subvpy)
    h = cc.coefficient_hessian(theta)
    ai = ai + 0.25 * torch.einsum("ekl,e->kl", h, tr_p_full - ypmpy_e)
    return {
        "logdet_v": logdet_v,
        "logdet_xtvix": logdet_x,
        "ytpy": ytpy,
        "grad": grad,
        "ai": ai,
        "finite": _finite(logdet_v, ytpy, grad, ai),
        "py": py,
        "vix": vix,
        "xtvix_i": xtvix_i,
        "vi_loc": vi_loc,
    }


class DistributedREMLEngine(REMLEngine):
    """REMLEngine whose dense quantities run with row-sharded matrices.

    `block` is the Cholesky panel width (auto-picked when None); any
    (T n) works, every trait block identity-padded to the next multiple
    of world * block.  The model's matrices may live anywhere, or be
    RowShards: each rank copies or fetches its rows to its device in
    float64."""

    compiles_matrices = False

    def __init__(
        self,
        model: CovarianceModel,
        y,
        x,
        ctx: MeshContext,
        options: Optional[REMLOptions] = None,
        block: Optional[int] = None,
    ):
        super().__init__(model, y, x, options, device=ctx.device)
        if self.cc.diagonal:
            raise ValueError(
                "DistributedREMLEngine is the dense-covariance path; "
                "diagonalized models run O(n) on one device"
            )
        if self.cc.has_matrix_params:
            raise NotImplementedError(
                "squared-exponential kernels have no row-sharded path (nor in dissect_tpu)"
            )
        if self.options.use_f_matrix:
            raise NotImplementedError("the F matrix has no row-sharded path")
        self.ctx = ctx
        self.block = pick_block(model.n_total, ctx.world, block)
        quantum = ctx.world * self.block
        real_sizes = self.cc.trait_sizes
        padded = tuple(s + ((-s) % quantum) for s in real_sizes)
        matrices = [model.matrices[e.matrix_name] for e in model.elements]
        with timers.phase("ShardCovariance"):
            self._sc = ShardedCovariance(self.cc, matrices, padded, ctx, self.dtype)
        pad_off = np.cumsum([0] + list(padded))[:-1]
        real_idx = np.concatenate([po + np.arange(s) for po, s in zip(pad_off, real_sizes)])
        self._real_idx = torch.as_tensor(real_idx, device=self.device)
        total = sum(padded)
        pad = torch.ones(total, dtype=self.dtype, device=self.device)
        pad[self._real_idx] = 0.0
        self._pad_diag = pad
        self.y = self.y.new_zeros(total).index_copy_(0, self._real_idx, self.y)
        self.x = self.x.new_zeros((total, self.x.shape[1])).index_copy_(0, self._real_idx, self.x)
        self.inverse_seconds: list = []

    def _quantities(self, theta: np.ndarray) -> dict:
        t = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        start = time.perf_counter()
        out = distributed_dense_quantities(
            self._sc, self.cc, t, self.y, self.x, self._pad_diag, self.ctx, self.block,
            self.options.use_ml,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.inverse_seconds.append(time.perf_counter() - start)
        # rank 0's step decides every rank's next theta: the host loop
        # must take the same branch on all ranks
        for key in _HOST_KEYS:
            val = out[key]
            out[key] = self.ctx.broadcast(val.to(self.dtype).reshape(-1).clone(), 0).reshape(val.shape).to(val.dtype)
        return out

    def fit(self, initial_theta=None, checkpoint_path=None):
        result = super().fit(initial_theta, checkpoint_path)
        if self.inverse_seconds:
            g = pick_interleave(self._sc.n_total, self.ctx.world, self.block)
            self.log.message(
                f"Distributed REML: {self.ctx.world} ranks, N_pad {self._sc.n_total}, "
                f"block {self.block}, interleave {g}, {self._sc.n_row_sharded} "
                f"row-sharded kernel(s); quantities "
                f"{np.mean(self.inverse_seconds):.4f} s per iteration over "
                f"{len(self.inverse_seconds)} calls"
            )
        return result

    # --- post-fit: pad rows sliced back out ----------------------------------
    def final_py(self) -> torch.Tensor:
        return self._final_device_state()["py"][self._real_idx]

    def _sub_elements(self, sub_id: str):
        return [ei for ei, e in enumerate(self.model.elements) if e.subcovariance_id == sub_id]

    def _coefficients(self) -> torch.Tensor:
        theta = torch.as_tensor(self.final_theta, dtype=self.dtype, device=self.device)
        return self.cc.coefficients(theta)

    def compute_blup_individuals(self, sub_id: str) -> np.ndarray:
        """u_hat = V_sub @ Py, each rank's rows gathered
        (computeIndividualsBLUP, reml.cpp:2983-3096)."""
        py = self._final_device_state()["py"]
        ids = self._sub_elements(sub_id)
        g = self._coefficients()
        local = py.new_zeros(self._sc.n_local)
        if ids:
            local = torch.einsum("e,en->n", g[ids], self._sc.times_local(py, ids))
        return _host(self.ctx.all_gather(local)[self._real_idx])

    def compute_blup_errors(self, sub_id: str) -> Optional[np.ndarray]:
        """sqrt(diag(Cov_sub P Cov_sub)) without a dense P: this rank's
        rows of Cov_sub P = Cov_sub Vi - (Cov_sub ViX)(X'ViX)^-1 (ViX)'
        (Vi broadcast a block at a time), then diag_i = sum_j C_ij
        (C P)_ij (diagonalOfABAt, matrix.cpp:3920-3960).  Dense
        single-trait only, like the reference (reml.cpp:3250)."""
        if self.cc.n_traits != 1:
            return None
        ids = self._sub_elements(sub_id)
        if not ids:
            return None
        q = self._final_device_state()
        cov = self._sc.dense_local(self._coefficients(), ids)
        cp = sharded_matmul(cov, q["vi_loc"], self.ctx)
        cp -= (cov @ q["vix"]) @ q["xtvix_i"] @ q["vix"].T
        d = self.ctx.all_gather(torch.sum(cov * cp, dim=1))[self._real_idx]
        return np.sqrt(np.maximum(_host(d), 0.0))
