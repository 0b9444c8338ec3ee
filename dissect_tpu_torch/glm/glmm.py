"""Experimental logistic mixed model via MCMC.

Parity: glmm.{h,cpp} (marked "Unfinished" in the reference,
main.cpp:200): given a prepared covariance V = sum s2_i K_i from a REML
setup, random effects u are sampled by Metropolis-Hastings using the
conditional Gaussian proposal built from the precision matrix's
diagonal (MHSampling, glmm.cpp:104-200: proposal mean
-D^-1 (V^-1 - D) u, variance D^-1 with D = diag(V^-1)), accepted on the
logistic likelihood ratio; fixed effects beta are refit by Newton
logistic regression with the posterior-mean random effects as offset
(GLMM::fit / iteration, glmm.cpp:210+).

Port of dissect_tpu/glm/glmm.py.  V^-1 and the chain's products run in
float64 on V's device; the draws stay on the host, from
np.random.default_rng(seed + it) in the reference's call order
(normal(size=n), then random()).  The JAX package seeds the same
generator: it passes jax.random.PRNGKey(seed + it), whose last word is
seed + it, to np.random.default_rng.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dissect_tpu_torch.glm.logistic import fit_logistic


@dataclasses.dataclass
class GLMMResult:
    betas: np.ndarray
    betas_se: np.ndarray
    random_effects: np.ndarray  # posterior mean
    acceptance_rate: float
    n_iterations: int
    success: bool


def _log_likelihood(y, eta):
    """The logistic log-likelihood, written as the reference writes it."""
    return torch.sum(y * eta - torch.log1p(torch.exp(eta)))


class GLMM:
    """Logistic mixed model: logit(P(y=1)) = X b + u, u ~ N(0, V).

    y (0/1) and x are arrays; v is the (n, n) covariance, a tensor (its
    device is where the chain runs) or an array (then on `device`)."""

    def __init__(self, y, x, v, seed: int = 1, device=None):
        if device is None:
            device = v.device if isinstance(v, torch.Tensor) else "cuda"
        self.device = torch.device(device)
        put = lambda a: torch.as_tensor(a).to(device=self.device, dtype=torch.float64)
        self.y, self.x = put(y), put(x)
        self.v_inv = torch.linalg.inv(put(v))
        self.seed = seed

    def _mh_chain(self, beta, u0, n_samples, seed):
        """MH over random effects with the conditional-Gaussian proposal.
        Returns the (n_samples, n) chain on the device and the
        acceptance rate."""
        d = torch.diagonal(self.v_inv).clone()
        d_inv = 1.0 / d
        sd = torch.sqrt(d_inv)
        off_diag = self.v_inv - torch.diag(d)
        eta_fixed = self.x @ torch.as_tensor(beta, dtype=torch.float64, device=self.device)
        u = u0
        samples = []
        accepted = 0
        rng = np.random.default_rng(seed)
        n = u.shape[0]
        for _ in range(n_samples):
            mean = -d_inv * (off_diag @ u)
            noise = torch.as_tensor(rng.normal(size=n), device=self.device)
            proposal = mean + noise * sd
            # logistic log-likelihood ratio (prior terms cancel against the
            # proposal for the conditional update, glmm.cpp:200+)
            ratio = float(_log_likelihood(self.y, eta_fixed + proposal)
                          - _log_likelihood(self.y, eta_fixed + u))
            if np.log(rng.random()) < ratio:
                u = proposal
                accepted += 1
            samples.append(u)
        return torch.stack(samples), accepted / max(n_samples, 1)

    def fit(self, n_outer: int = 10, n_samples: int = 50, burn_in: int = 10) -> GLMMResult:
        n = self.y.shape[0]
        beta = np.zeros(self.x.shape[1])
        u = torch.zeros(n, dtype=torch.float64, device=self.device)
        acc = 0.0
        glm = None
        for it in range(n_outer):
            samples, acc = self._mh_chain(beta, u, n_samples + burn_in, self.seed + it)
            u = samples[burn_in:].mean(dim=0)
            glm = fit_logistic(self.y, self.x, offset=u, beta0=beta, device=self.device)
            if not glm.success:
                return GLMMResult(
                    betas=beta,
                    betas_se=np.zeros_like(beta),
                    random_effects=u.cpu().numpy(),
                    acceptance_rate=acc,
                    n_iterations=it + 1,
                    success=False,
                )
            beta = glm.betas
        return GLMMResult(
            betas=beta,
            betas_se=glm.se if glm else np.zeros_like(beta),
            random_effects=u.cpu().numpy(),
            acceptance_rate=acc,
            n_iterations=n_outer,
            success=True,
        )
