"""The AI-REML engine.

Parity: reml.{h,cpp}; port of dissect_tpu/reml/engine.py.

  * a "quantities" core evaluates, for a variance vector theta,
    everything one Newton step needs — log|V|, log|X'ViX|, y'Py, the
    0.5-scaled gradient and the AI matrix with the crossed-derivatives
    correction (aiREMLStep's body, reml.cpp:2286-2498, computePMatrix
    reml.cpp:1836-1909, computeAIMatrix reml.cpp:1963-2051);
  * the host drives the iteration in float64 numpy — EM first step, AI
    steps with stale-relative-logL damping, constraint methods M1/M3,
    log-logistic reparameterization, convergence tests, per-iteration
    checkpoints (computeREML, reml.cpp:1543-1834).

Three cores, chosen by the covariance model (and a fourth wrapping
them):
  dense      V (Tn, Tn): one Cholesky inverse per iteration, P never
             materialized (`_dense_quantities`);
  autodiff   dense V with theta-dependent element matrices
             (squared-exponential kernels): dV/dtheta from torch.func
             (`_dense_quantities_autodiff`);
  diagonal   V as (n, T, T) per-individual blocks of eigen-rotated
             kernels, O(n) per step (`_blockdiag_quantities`,
             reml.cpp:480-545, 1896-1908);
  yList      the dense or diagonal core over several phenotype samples
             with their mean gradient, y'Py and AI (`_ylist_quantities`,
             reml.cpp:2296-2350).  No CLI path reaches it, in the JAX
             package either.

Departure from JAX: every fit runs wholly in float64 on its device (the
card, or the CPU).  The TPU had no fast float64, so the JAX package fits
in float32 there and finishes with float64 Newton steps on the host CPU
(`_refine_float64`, dissect_tpu/reml/engine.py:536-607, with its float32
stall rescue); the H100 runs float64 on its tensor cores, and the JAX
tests run with x64 on, so both sides compare float64 with float64.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch.func import hessian, jacfwd

from dissect_tpu_torch.linalg.small import MAX_UNROLL_Q, cholesky_diag_small, inv_spd_small
from dissect_tpu_torch.linalg.spd import fallback_inverse_logdet, spd_inverse_logdet
from dissect_tpu_torch.linalg.traces import diag_of_abat
from dissect_tpu_torch.model.covariance import CovarianceModel, ParameterType
from dissect_tpu_torch.runtime.checkpoint import REMLCheckpoint
from dissect_tpu_torch.runtime.log import get_logger
from dissect_tpu_torch.runtime.timers import timers


@dataclasses.dataclass
class REMLOptions:
    """Defaults parity: options.cpp:102-180 and related flags."""

    max_iterations: int = 40  # --reml-maxit (options.cpp:179)
    variance_convergence_threshold: float = 1e-5  # options.cpp:110
    gradient_convergence_threshold: float = 1e-2  # options.cpp:111
    change_ai_step_threshold: float = 1e-3  # options.cpp:112
    allow_switch_from_ai_to_em: bool = False  # options.cpp:113
    first_step_em: bool = True  # options.cpp:114
    step_weighting_constant: float = 0.3  # options.cpp:120
    allow_convergence_with_constrained: bool = True  # options.cpp:130
    maximum_correlation_covariance_constrain: float = 1.0  # options.cpp:131
    use_log_logistic_scale: bool = False  # options.cpp:133
    variance_constrain_proportion: float = 1e-6  # options.cpp:180
    reml_method_em: bool = False  # --reml-method (REMLMethod=1 => EM only)
    gcta_mode: bool = False  # options.cpp:243
    allow_fixing_variances_to_zero: bool = False  # options.cpp:249
    use_ml: bool = False  # ML instead of REML (GWAS internal fits)
    initial_h2: float = 0.5  # --init-h2 (options.cpp:108)
    # second-derivatives matrix: the AI matrix with the crossed correction
    # (the reference default, options.cpp:141) or the expected-information
    # REML-F/ML-F matrix 0.5 tr(P dV_k P dV_l) (reml.cpp:2053-2157)
    use_f_matrix: bool = False
    # squared-exponential kernel parameters (options.cpp:142-143)
    exp_kernel_initial_factor: float = 1.0  # --param-init-fac
    parameter_unfix_after: int = 8  # --steps-to-unfix


@dataclasses.dataclass
class REMLResult:
    success: bool
    log_likelihood: float
    variances: np.ndarray
    variance_names: List[str]
    ai_inverse: np.ndarray  # sampling covariance of the estimates
    n_iterations: int
    constrained: List[str]
    warnings: List[str]
    logdet_v: float = 0.0
    logdet_xtvix: float = 0.0

    def variance(self, name: str) -> float:
        return float(self.variances[self.variance_names.index(name)])

    def std_error(self, name: str) -> float:
        i = self.variance_names.index(name)
        return float(np.sqrt(self.ai_inverse[i, i]))


def _logistic(x):
    return 2.0 / (1.0 + np.exp(-x)) - 1.0


def _logistic_inv(y):
    return -np.log(2.0 / (y + 1.0) - 1.0)


_HOST_KEYS = ("logdet_v", "logdet_xtvix", "ytpy", "grad", "ai", "finite")


class REMLEngine:
    """One REML/ML fit of V(theta) = sum_e g_e(theta) M_e to (y, X).

    y: (Tn,) trait-major phenotypes; X: (Tn, c) design (rotated into the
    kernel's eigenbasis for a diagonal model).  `y_list` switches on the
    multi-sample mean-likelihood mode (yList, reml.cpp:2304-2350).
    Everything runs in float64 on `device`.
    """

    # the row-sharded subclass places its own rows of each matrix
    compiles_matrices = True

    def __init__(
        self,
        model: CovarianceModel,
        y,
        x,
        options: Optional[REMLOptions] = None,
        device="cuda",
        y_list: Optional[Sequence] = None,
    ):
        self.model = model
        self.device = torch.device(device)
        self.dtype = torch.float64
        self.cc = model.compile(self.device, self.dtype, matrices=self.compiles_matrices)
        self.options = options or REMLOptions()
        self.dimension = model.n_total
        self.y = torch.as_tensor(y, device=self.device).to(self.dtype)
        self.x = torch.as_tensor(x, device=self.device).to(self.dtype)
        if tuple(self.y.shape) != (self.dimension,):
            raise ValueError(f"y shape {tuple(self.y.shape)} != ({self.dimension},)")
        self.y_list = None
        if y_list is not None:
            self.y_list = torch.stack(
                [torch.as_tensor(v, device=self.device).to(self.dtype) for v in y_list]
            )
        if self.cc.has_matrix_params:
            if self.cc.diagonal:
                raise NotImplementedError("parameterized kernels are dense-mode only")
            self._core = _dense_quantities_autodiff
        else:
            self._core = _blockdiag_quantities if self.cc.diagonal else _dense_quantities
        self._final_state = None
        self.log = get_logger()

    def _quantities(self, theta: np.ndarray) -> dict:
        t = torch.as_tensor(theta, dtype=self.dtype, device=self.device)
        args = (self.x, self.options.use_ml, self.options.use_f_matrix)
        if self.y_list is not None:
            return _ylist_quantities(self._core, self.cc, t, self.y_list, *args)
        return self._core(self.cc, t, self.y, *args)

    # ------------------------------------------------------------- host loop
    def _expected_magnitude(self, i: int) -> float:
        v = self.model.variances[i]
        return self.model.group_magnitudes.get(v.group, 1.0)

    def _constrain_m1(self, theta: np.ndarray):
        """Clamp negative variances / over-bound covariances+correlations
        (constrainVariancesM1, covariancematrix.cpp:1183-1330)."""
        opts = self.options
        constrained: List[str] = []
        n_constrained = 0
        for i, v in enumerate(self.model.variances):
            if v.type == ParameterType.VARIANCE and theta[i] < 0:
                theta[i] = self._expected_magnitude(i) * opts.variance_constrain_proportion
                constrained.append(v.name)
                n_constrained += 1
        for i, v in enumerate(self.model.variances):
            if v.type == ParameterType.COVARIANCE and v.constrained_on_product_of:
                bound = opts.maximum_correlation_covariance_constrain
                for d in v.constrained_on_product_of:
                    bound *= theta[d]
                bound = math.sqrt(abs(bound))
                if abs(theta[i]) > bound:
                    theta[i] = math.copysign(bound, theta[i])
                    constrained.append(v.name)
                    n_constrained += 1
            elif v.type == ParameterType.CORRELATION:
                bound = opts.maximum_correlation_covariance_constrain
                if abs(theta[i]) > bound:
                    theta[i] = math.copysign(bound, theta[i])
                    constrained.append(v.name)
                    n_constrained += 1
        return n_constrained, constrained

    def _constrain_m3(self, old_theta: np.ndarray, delta: np.ndarray):
        """Rescale the step until no variance is negative
        (constrainVariancesM3, covariancematrix.cpp:1430-1499)."""
        scaling = 1.0
        theta = old_theta + delta
        is_var = np.array(
            [v.type == ParameterType.VARIANCE for v in self.model.variances]
        )
        while np.any((theta < 0) & is_var):
            scaling *= self.options.step_weighting_constant
            theta = old_theta + delta * scaling
            if scaling == 0.0:
                raise RuntimeError("M3 constraint scaling underflow")
        return theta, scaling

    def _em_update(self, theta: np.ndarray, grad_half: np.ndarray) -> np.ndarray:
        """EM: v <- (n v + v^2 * grad_full)/n (emREMLStep, reml.cpp:2500-2541)."""
        grad_full = 2.0 * grad_half
        n = float(self.dimension)
        return (n * theta + theta * theta * grad_full) / n

    def fit(
        self,
        initial_theta: Optional[np.ndarray] = None,
        checkpoint_path: Optional[str] = None,
    ) -> REMLResult:
        opts = self.options
        theta = np.array(
            self.model.initial_theta() if initial_theta is None else initial_theta,
            dtype=np.float64,
        )
        base_fixed = np.array([v.fixed for v in self.model.variances])
        unfix_after = np.array(
            [
                v.unfix_after if v.unfix_after is not None else -1
                for v in self.model.variances
            ]
        )
        fixed = base_fixed | (unfix_after >= 0)
        names = self.model.variance_names()
        k = len(theta)

        log_likelihood = -1e50
        rel_diff = np.inf
        start_iteration = 0
        if checkpoint_path is not None:
            ckpt = REMLCheckpoint.load(checkpoint_path)
            if ckpt is not None and ckpt.variance_names == names:
                theta = ckpt.theta.copy()
                log_likelihood = ckpt.log_likelihood
                rel_diff = ckpt.rel_diff
                start_iteration = ckpt.iteration
                self.log.message(
                    f"Resuming REML from checkpoint at iteration {start_iteration}"
                )
        self._final_state = None
        success = True
        warnings: List[str] = []
        constrained: List[str] = []
        old_theta = theta.copy()
        delta_store = np.zeros(k)
        ai_inv_full = np.zeros((k, k))
        n_iter = 0
        q = None
        sreml = "ML" if opts.use_ml else "REML"
        self.log.message(f"Starting {sreml} iterations...")

        for it in range(start_iteration, opts.max_iterations):
            n_iter = it + 1
            # unfix inside-matrix parameters after their step count
            # (unfixVariancesAndParameters, reml.cpp:1684)
            fixed = base_fixed | ((unfix_after >= 0) & (it < unfix_after))
            em_step = (it == 0 and opts.first_step_em and not opts.use_ml) or (
                opts.reml_method_em and not opts.use_ml
            )
            with timers.span("reml.quantities"):
                out = self._quantities(theta)
                q = {
                    key: np.asarray(out[key].detach().cpu().numpy(), dtype=np.float64)
                    for key in _HOST_KEYS
                }
            if not bool(q["finite"]):
                success = False
                break
            grad_half = q["grad"]
            old_theta = theta.copy()
            step_mods = ""

            if em_step:
                new_theta = self._em_update(theta, grad_half)
                new_theta[fixed] = theta[fixed]
                theta = new_theta
                delta_store = theta - old_theta
                step_mods += "EM"
            else:
                # invert AI with fixed-variance zeroing (reml.cpp:1997-2049)
                free = ~fixed
                ai = q["ai"][np.ix_(free, free)]
                try:
                    ai_inv = np.linalg.inv(ai)
                except np.linalg.LinAlgError:
                    success = False
                    break
                ai_inv_exp = np.zeros((k, k))
                ai_inv_exp[np.ix_(free, free)] = ai_inv
                ai_inv_full = ai_inv_exp
                delta = ai_inv_exp @ grad_half

                damp = rel_diff > opts.change_ai_step_threshold
                if opts.use_log_logistic_scale:
                    # log/logistic reparameterization (reml.cpp:2382-2456)
                    vv = theta.copy()
                    jac_inv = np.ones(k)
                    for i, v in enumerate(self.model.variances):
                        if v.type == ParameterType.CORRELATION:
                            vv[i] = _logistic_inv(theta[i])
                            e = np.exp(-vv[i])
                            jac_inv[i] = (1.0 + e) ** 2 / (2.0 * e)
                        else:
                            jac_inv[i] = 1.0 / theta[i]
                            vv[i] = np.log(theta[i])
                    delta_t = jac_inv * delta
                    if damp and opts.allow_switch_from_ai_to_em:
                        theta = self._em_update(theta, grad_half)
                        step_mods += "e"
                    else:
                        w = opts.step_weighting_constant if damp else 1.0
                        if damp:
                            step_mods += "q"
                        vv = vv + w * delta_t
                        for i, v in enumerate(self.model.variances):
                            if v.type == ParameterType.CORRELATION:
                                theta[i] = _logistic(vv[i])
                            else:
                                theta[i] = np.exp(vv[i])
                        step_mods += "l"
                else:
                    if damp and opts.allow_switch_from_ai_to_em and not opts.use_ml:
                        theta = self._em_update(theta, grad_half)
                        step_mods += "e"
                    else:
                        w = opts.step_weighting_constant if damp else 1.0
                        if damp:
                            step_mods += "q"
                        theta = theta + w * delta
                delta_store = delta
                theta[fixed] = old_theta[fixed]

            # log-likelihood of the step just taken (computeLogLikelihood,
            # reml.cpp:2267-2284) — evaluated at the *pre-update* theta
            prev_ll = log_likelihood
            if opts.use_ml:
                log_likelihood = -0.5 * (q["logdet_v"] + q["ytpy"])
            else:
                log_likelihood = -0.5 * (
                    q["logdet_v"] + q["logdet_xtvix"] + q["ytpy"]
                )
            ll_diff = log_likelihood - prev_ll
            rel_diff = abs(ll_diff / prev_ll) if prev_ll != 0 else np.inf

            # constraints (reml.cpp:1629-1669)
            n_constrained, constrained = self._constrain_m1(theta)
            constrained_method = 1 if n_constrained else 0
            frac = n_constrained / k
            if frac > 0.5 and it == 0:
                self.log.message(
                    f"Error: more than half of the parameters constrained in the "
                    f"first step. {sreml} stopped."
                )
                success = False
                break
            elif frac > 0.5:
                if opts.gcta_mode:
                    raise RuntimeError("more than half of parameters constrained")
                theta, _scaling = self._constrain_m3(old_theta, delta_store)
                constrained_method = 2
                n_constrained = 0

            self.log.message(
                f"  {n_iter:3d} {step_mods:>4s}  logL {log_likelihood:.6f}  "
                + " ".join(f"{t:.6g}" for t in theta)
                + (f"  ({n_constrained} constrained)" if n_constrained else "")
            )

            if checkpoint_path is not None:
                REMLCheckpoint(
                    iteration=n_iter,
                    theta=theta,
                    log_likelihood=log_likelihood,
                    variance_names=names,
                    rel_diff=rel_diff,
                ).save(checkpoint_path)

            # convergence (reml.cpp:1687-1737)
            ll_converged = (ll_diff < 1e-4) and (ll_diff > -1e-2)
            with np.errstate(divide="ignore", invalid="ignore"):
                rel_changes = np.abs((theta - old_theta) / old_theta)
            var_converged = bool(np.all(rel_changes <= opts.variance_convergence_threshold))
            grad_converged = bool(
                np.all(
                    (np.abs(grad_half) <= opts.gradient_convergence_threshold)
                    | np.array([names[i] in constrained for i in range(k)])
                )
            )
            if (
                ll_converged
                and var_converged
                and constrained_method != 2
                and (
                    constrained_method != 1
                    or opts.allow_convergence_with_constrained
                )
                and not fixed.any()
            ):
                if constrained_method == 1:
                    warnings.append(
                        f"{n_constrained} parameters constrained: "
                        + ", ".join(constrained)
                    )
                if not grad_converged:
                    warnings.append(
                        "gradient did not converge below "
                        f"{opts.gradient_convergence_threshold}"
                    )
                break
        else:
            success = False

        if success:
            self.log.message(
                f"{sreml} finished with success (logL: {log_likelihood:.10g})"
            )
        else:
            self.log.message(f"Sorry, {sreml} failed to converge...")

        self.final_theta = theta
        self.final_quantities = q
        return REMLResult(
            success=success,
            log_likelihood=float(log_likelihood),
            variances=theta,
            variance_names=names,
            ai_inverse=ai_inv_full,
            n_iterations=n_iter,
            constrained=constrained,
            warnings=warnings,
            logdet_v=float(q["logdet_v"]) if q else 0.0,
            logdet_xtvix=float(q["logdet_xtvix"]) if q else 0.0,
        )

    # ----------------------------------------------------------- post-fit ---
    def _final_device_state(self) -> dict:
        """The quantities at the fitted variances, computed once and kept
        for every post-fit output (the JAX package recomputes them for
        each, dissect_tpu/reml/engine.py:610-612: same values)."""
        if self._final_state is None:
            self._final_state = self._quantities(self.final_theta)
        return self._final_state

    def final_py(self) -> torch.Tensor:
        """Py at the fitted variances, a float64 tensor on the engine's
        device — the vector every BLUP flows from (computeSNPsBLUP
        consumes it, reml.cpp:3098-3356)."""
        return self._final_device_state()["py"]

    def compute_blue(self):
        """beta = (X'ViX)^-1 X'Vi y with SEs (computeBLUE, reml.cpp:2924-2981)."""
        q = self._final_device_state()
        vix, xtvix_i = q["vix"], q["xtvix_i"]
        T, n = self.cc.n_traits, self.cc.n
        if self.cc.diagonal:
            b = torch.einsum("tic,ti->c", vix, self.y.reshape(T, n))
        else:
            b = vix.T @ self.y
        beta = xtvix_i @ b
        se = torch.sqrt(torch.diagonal(xtvix_i))
        return _host(beta), _host(se)

    def _subcovariance(self, sub_id: str):
        """(element index, coefficient, matrix) of each element of the
        named sub-covariance, at the fitted variances."""
        theta = torch.as_tensor(self.final_theta, dtype=self.dtype, device=self.device)
        g = self.cc.coefficients(theta)
        return [
            (ei, g[ei], self.cc.element_matrix(ei, theta))
            for ei, e in enumerate(self.model.elements)
            if e.subcovariance_id == sub_id
        ]

    def compute_blup_individuals(self, sub_id: str) -> np.ndarray:
        """u_hat = V_sub @ Py for the named sub-covariance
        (computeIndividualsBLUP, reml.cpp:2983-3096)."""
        py = self._final_device_state()["py"]
        off = self.cc.offsets
        blup = torch.zeros((self.cc.n_total,), dtype=py.dtype, device=py.device)
        for ei, g, m in self._subcovariance(sub_id):
            ti, tj = self.cc.blocks[ei]
            ri, ci = off[ti], off[tj]
            if self.cc.diagonal:
                n = m.shape[0]
                blup[ri : ri + n] += g * m * py[ci : ci + n]
                if ti != tj:
                    blup[ci : ci + n] += g * m * py[ri : ri + n]
            else:
                nr, nc = m.shape
                blup[ri : ri + nr] += g * (m @ py[ci : ci + nc])
                if ti != tj:
                    blup[ci : ci + nc] += g * (m.T @ py[ri : ri + nr])
        return _host(blup)

    def compute_blup_errors(self, sub_id: str) -> Optional[np.ndarray]:
        """sqrt(diag(Cov_sub P Cov_sub)) — BLUP standard errors
        (computeBLUPErrors, reml.cpp:3058-3110 via diagonalOfABAt).  Like
        the reference (reml.cpp:3250), restricted to the dense
        single-trait path; returns None otherwise.  P and Cov_sub are
        formed on the engine's device."""
        if self.cc.diagonal or self.cc.n_traits != 1:
            return None
        parts = self._subcovariance(sub_id)
        if not parts:
            return None
        q = self._final_device_state()
        p = q["vi"] - q["vix"] @ q["xtvix_i"] @ q["vix"].T
        cov = sum(g * m for _, g, m in parts)
        d = diag_of_abat(cov, p)
        return np.sqrt(np.maximum(_host(d), 0.0))

    def residuals(self) -> np.ndarray:
        """e = sigma2_E * Py — the 'E' sub-covariance applied to Py
        (mpresiduals.cpp:141: V->multiply("E", Py))."""
        return self.compute_blup_individuals("E")


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


def _finite(logdet_v, ytpy, grad, ai):
    return (
        torch.isfinite(logdet_v)
        & torch.isfinite(ytpy)
        & torch.all(torch.isfinite(grad))
        & torch.all(torch.isfinite(ai))
    )


def _inverse_logdet(v):
    """(V^-1, log|V|): Cholesky when V is PD, else the LU fallback.  The
    PD test is one host read of the factorization's status per call —
    the loop reads its step back to the host in any case."""
    vi, logdet, ok = spd_inverse_logdet(v)
    if not ok:
        vi, logdet, _ = fallback_inverse_logdet(v)
    return vi, logdet


def _dense_quantities(cc, theta, y, x, use_ml=False, use_f_matrix=False):
    """Dense-V REML/ML quantities (aiREMLStep body, reml.cpp:2286-2498)."""
    v = cc.assemble_dense(theta)
    vi, logdet_v = _inverse_logdet(v)
    del v
    vix = vi @ x
    xtvix_i, logdet_x = _inverse_logdet(x.T @ vix)

    # P = Vi - ViX (X'ViX)^-1 (ViX)' is Vi minus a rank-c correction:
    # never materialized, which saves n x n buffers at biobank n
    def apply_p(z):
        return vi @ z - vix @ (xtvix_i @ (vix.T @ z))

    py = apply_p(y)
    ytpy = y @ py
    mpy = cc.elements_times_vector(py)  # (E, n_total)
    # tr(P M_e) = tr(Vi M_e) - tr((X'ViX)^-1 (ViX)' M_e (ViX))
    tr_vi_e = cc.element_traces_dense(vi)
    mw = cc.elements_times_matrix(vix)  # (E, Tn, c)
    quad_e = torch.einsum("nc,enk->eck", vix, mw)  # (E, c, c)
    tr_p_full = tr_vi_e - torch.einsum("ck,eck->e", xtvix_i, quad_e)
    tr_e = tr_vi_e if use_ml else tr_p_full
    ypmpy_e = mpy @ py
    a = cc.coefficient_jacobian(theta)  # (E, K)
    grad = 0.5 * (a.T @ ypmpy_e - a.T @ tr_e)
    subvpy = torch.einsum("ei,ek->ik", mpy, a)  # (Tn, K)
    if use_f_matrix:
        # expected information: F_kl = 0.5 tr(W dV_k W dV_l) with W = P
        # (REML-F) or Vi (ML-F) — computeREMLFMatrix/computeMLFMatrix.
        # This opt-in path does need the dense W.
        w = vi if use_ml else vi - vix @ xtvix_i @ vix.T
        wm = torch.stack([w @ cc.placed_dense(ei) for ei in range(cc.n_elements)])
        t_ef = torch.einsum("eij,fji->ef", wm, wm)
        ai = 0.5 * a.T @ t_ef @ a
    else:
        psubvpy = apply_p(subvpy)
        ai = 0.5 * subvpy.T @ psubvpy
        # crossed second-derivative correction (reml.cpp:2159-2218)
        h = cc.coefficient_hessian(theta)  # (E, K, K)
        tr_p_e = tr_p_full if use_ml else tr_e
        ai = ai + 0.25 * torch.einsum("ekl,e->kl", h, tr_p_e - ypmpy_e)
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
        "vi": vi,
    }


def _ylist_quantities(core, cc, theta, y_list, x, use_ml=False, use_f_matrix=False):
    """Multi-sample mean likelihood (yList, reml.cpp:2296-2350): one
    `core` evaluation per phenotype sample; the gradient, y'Py and AI are
    averaged over the samples, everything else comes from the first."""
    outs = [core(cc, theta, y, x, use_ml, use_f_matrix) for y in y_list]
    out = dict(outs[0])
    for key in ("grad", "ytpy", "ai"):
        out[key] = torch.mean(torch.stack([o[key] for o in outs]), dim=0)
    out["finite"] = torch.all(torch.stack([o["finite"] for o in outs]))
    return out


def _dense_quantities_autodiff(cc, theta, y, x, use_ml=False, use_f_matrix=False):
    """General dense core for theta-dependent element matrices
    (squared-exponential kernels, applyExponentialOperator,
    covariancematrix.cpp:780-960): dV/dtheta comes from
    `torch.func.jacfwd` of the whole assembly instead of the
    coefficient-Jacobian shortcut, and the crossed correction from
    `torch.func.hessian`.  `use_f_matrix` does not apply (as in JAX)."""
    vi, logdet_v = _inverse_logdet(cc.assemble_dense(theta))
    vix = vi @ x
    xtvix_i, logdet_x = _inverse_logdet(x.T @ vix)
    p = vi - vix @ xtvix_i @ vix.T
    py = p @ y
    ytpy = y @ py

    subvpy = jacfwd(lambda th: cc.assemble_dense(th) @ py)(theta)  # (Tn, K)
    w = vi if use_ml else p
    tr_k = jacfwd(lambda th: torch.sum(w * cc.assemble_dense(th)))(theta)
    grad = 0.5 * (subvpy.T @ py - tr_k)
    ai = 0.5 * subvpy.T @ (p @ subvpy)
    # crossed second-derivative correction with the full d2V
    h_quad = hessian(lambda th: py @ (cc.assemble_dense(th) @ py))(theta)
    h_tr = hessian(lambda th: torch.sum(p * cc.assemble_dense(th)))(theta)
    ai = ai + 0.25 * (h_tr - h_quad)
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
        "vi": vi,
    }


def _blockdiag_quantities(cc, theta, y, x, use_ml=False, use_f_matrix=False):
    """Diagonal-V REML/ML quantities: V as (n, T, T) per-individual
    blocks — the BlockMatrix replacement (reml.cpp:1896-1908,
    blockmatrix.h:32-124)."""
    T, n = cc.n_traits, cc.n
    vb = cc.assemble_blockdiag(theta)  # (n, T, T)
    if T <= MAX_UNROLL_Q:
        diag = cholesky_diag_small(vb)
        vi = inv_spd_small(vb)
    else:
        diag = torch.diagonal(torch.linalg.cholesky_ex(vb)[0], dim1=-2, dim2=-1)
        vi = torch.linalg.inv(vb)
    logdet_v = 2.0 * torch.sum(torch.log(torch.where(diag > 0, diag, torch.ones_like(diag))))
    y4 = y.reshape(T, n)
    x4 = x.reshape(T, n, -1)
    vix = torch.einsum("ist,tic->sic", vi, x4)
    xtvix_i, logdet_x = _inverse_logdet(torch.einsum("sic,sid->cd", x4, vix))
    viy = torch.einsum("ist,ti->si", vi, y4)
    b = torch.einsum("tic,ti->c", vix, y4)
    coef = xtvix_i @ b
    py4 = viy - torch.einsum("sic,c->si", vix, coef)
    ytpy = torch.einsum("si,si->", y4, py4)
    # block-diagonal part of P (PDiagonal via diagonalOfABAt, reml.cpp:1906)
    p_blocks = vi - torch.einsum("sic,cd,tid->ist", vix, xtvix_i, vix)
    tr_e = cc.element_traces_blockdiag(vi if use_ml else p_blocks)
    mpy = cc.elements_times_vector(py4.reshape(-1)).reshape(cc.n_elements, T, n)
    ypmpy_e = torch.einsum("eti,ti->e", mpy, py4)
    a = cc.coefficient_jacobian(theta)
    grad = 0.5 * (a.T @ ypmpy_e - a.T @ tr_e)
    subvpy = torch.einsum("eti,ek->kti", mpy, a)  # (K, T, n)

    if use_f_matrix:
        # diagonal-path F uses the block-diagonal part of P, matching the
        # reference's PDiagonal-based traces (computeREMLFMatrix with
        # this->P == NULL)
        w = vi if use_ml else p_blocks
        em = torch.stack([cc.placed_blockdiag(ei) for ei in range(cc.n_elements)])
        wm = torch.einsum("nst,entu->ensu", w, em)
        t_ef = torch.einsum("ensu,fnus->ef", wm, wm)
        ai = 0.5 * a.T @ t_ef @ a
    else:
        # P u for every u = subvpy[k] (T, n), without densifying P
        viu = torch.einsum("ist,kti->ksi", vi, subvpy)
        bu = torch.einsum("tic,kti->kc", vix, subvpy)
        psubvpy = viu - torch.einsum("sic,kc->ksi", vix, bu @ xtvix_i.T)
        ai = 0.5 * torch.einsum("kti,lti->kl", subvpy, psubvpy)
        h = cc.coefficient_hessian(theta)
        tr_p_e = cc.element_traces_blockdiag(p_blocks) if use_ml else tr_e
        ai = ai + 0.25 * torch.einsum("ekl,e->kl", h, tr_p_e - ypmpy_e)
    finite = _finite(logdet_v, ytpy, grad, ai)
    return {
        "logdet_v": logdet_v,
        "logdet_xtvix": logdet_x,
        "ytpy": ytpy,
        "grad": grad,
        "ai": ai,
        "finite": finite,
        "py": py4.reshape(-1),
        "vix": vix,
        "xtvix_i": xtvix_i,
        "vi": vi,
    }
