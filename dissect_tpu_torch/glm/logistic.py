"""Newton logistic regression.

Parity: glm.{h,cpp} — logit link (glm.h:36-40), probabilities
p = 1/(1+exp(-(X b + u))) (computeProbabilities, glm.cpp:145),
gradient X'(y - p) (computeLogLikelihoodGradient, glm.cpp:206), Hessian
-X' diag(p(1-p)) X, Newton iterations until all parameter relative
differences drop below threshold (allParametersRelativeDifferencesLowerThan,
glm.h:71).  Port of dissect_tpu/glm/logistic.py: the jitted while-loop
becomes a host loop over float64 tensors on an explicit device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class LogisticGLM:
    betas: np.ndarray
    se: np.ndarray
    probabilities: np.ndarray
    log_likelihood: float
    n_iterations: int
    success: bool


def _solve(a, b):
    """a^-1 b, NaN where a is singular (jnp.linalg.solve gives non-finite
    values there and never raises)."""
    x, info = torch.linalg.solve_ex(a, b)
    return torch.where(info != 0, torch.full_like(x, float("nan")), x)


def _fit_core(y, x, offset, beta0, threshold, max_iterations):
    beta, rel, n_iter, finite = beta0, float("inf"), 0, True
    while rel > threshold and n_iter < max_iterations and finite:
        eta = x @ beta + offset
        p = torch.sigmoid(eta)
        w = p * (1.0 - p)
        grad = x.T @ (y - p)
        hess = (x.T * w) @ x
        delta = _solve(hess, grad)
        new_beta = beta + delta
        rel = float(torch.max(torch.abs(delta) / torch.clamp_min(torch.abs(beta), 1e-12)))
        beta, n_iter = new_beta, n_iter + 1
        finite = bool(torch.all(torch.isfinite(new_beta)))
    eta = x @ beta + offset
    p = torch.sigmoid(eta)
    w = p * (1.0 - p)
    hess = (x.T * w) @ x
    cov = torch.linalg.inv_ex(hess)[0]
    logl = torch.sum(y * eta - torch.log1p(torch.exp(eta)))
    return beta, torch.sqrt(torch.diagonal(cov)), p, logl, n_iter, finite and rel <= threshold


def fit_logistic(
    y,
    x,
    offset=None,
    beta0: Optional[np.ndarray] = None,
    threshold: float = 1e-6,
    max_iterations: int = 50,
    device="cuda",
) -> LogisticGLM:
    """Fit logit(P(y=1)) = X b (+ offset for fixed random effects), in
    float64 on `device`.

    y coded 0/1 (callers translate the reference's 1/2 case-control
    coding).  y, x, offset and beta0 may be arrays or tensors."""
    put = lambda a: torch.as_tensor(a).to(device=device, dtype=torch.float64)
    yv, xm = put(y), put(x)
    off = torch.zeros_like(yv) if offset is None else put(offset)
    b0 = torch.zeros(xm.shape[1], dtype=torch.float64, device=yv.device) if beta0 is None \
        else put(beta0)
    beta, se, p, logl, n_iter, ok = _fit_core(yv, xm, off, b0, threshold, max_iterations)
    host = lambda t: t.cpu().numpy()
    return LogisticGLM(
        betas=host(beta),
        se=host(se),
        probabilities=host(p),
        log_likelihood=float(logl),
        n_iterations=int(n_iter),
        success=bool(ok),
    )
