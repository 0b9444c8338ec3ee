"""K3 — fused per-SNP weighted moments for the ML refits.

Port of dissect_tpu/gwas/pallas_moments.py.  One Fisher-scoring step of
the per-SNP ML refit (gwas/mlm.py `_ml_refit_core`; gwas.cpp:787-914)
needs, for every SNP row m with weights w1 = 1/(t1*lam + t2), w2 = w1^2,
w3 = w2*lam:

    m1 = w1 @ feats          m2 = w2 @ feats          (shared-column moments)
    gs_k = (wk * g) @ s      gg_k = sum_n wk * g^2    (genotype moments)

packed per `moment_columns` into one (M, 2K + 3q + 3) row block.  The
layout is the JAX kernel's without its padding to 128 lanes: the CUDA
kernel (csrc/refit_moments.cu) takes any q and K, so on the card K3
always runs.

`fused_refit_moments` launches the kernel for tensors on the card and
runs `plain_refit_moments` only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from dissect_tpu_torch.runtime import cuda_lib


def moment_columns(q: int, k_feats: int):
    """Static column layout of the packed output:
    [m1 | m2 | gs1 | gs2 | gs3 | gg1 gg2 gg3]."""
    c0_m1 = 0
    c0_m2 = k_feats
    c0_gs1 = 2 * k_feats
    c0_gs2 = c0_gs1 + q
    c0_gs3 = c0_gs2 + q
    c0_gg = c0_gs3 + q
    total = c0_gg + 3
    return c0_m1, c0_m2, c0_gs1, c0_gs2, c0_gs3, c0_gg, total


def plain_refit_moments(g, thetas, lam, s, feats):
    """The plain version of K3 (the XLA moment form of
    dissect_tpu/gwas/mlm.py:248-261), packed per `moment_columns`."""
    v = thetas[:, :1] * lam[None, :] + thetas[:, 1:]
    vi = 1.0 / v
    vi2 = vi * vi
    g1 = vi * g
    g2 = vi2 * g
    g3 = g2 * lam[None, :]
    return torch.cat(
        [
            vi @ feats,
            vi2 @ feats,
            g1 @ s,
            g2 @ s,
            g3 @ s,
            torch.einsum("mn,mn->m", g1, g)[:, None],
            torch.einsum("mn,mn->m", g2, g)[:, None],
            torch.einsum("mn,mn->m", g3, g)[:, None],
        ],
        dim=1,
    )


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, g on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_refit_moments(g, thetas, lam, s, feats):
    """All nine ML-refit moments in one pass over g.

    g: (M, n) eigenbasis genotypes; thetas: (M, 2) current per-SNP
    variances; lam: (n,) eigenvalues; s: (n, q) shared columns [X | y];
    feats: (n, K) shared feature columns.  Returns (M, 2K + 3q + 3)
    packed per `moment_columns`.  On the card this launches
    csrc/refit_moments.cu on float32 tensors (or raises); only tensors
    on the CPU take the plain version."""
    if g.device.type == "cpu":
        return plain_refit_moments(g, thetas, lam, s, feats)
    if g.device.type != "cuda":
        raise ValueError(f"no moments kernel for device {g.device}")
    if g.dim() != 2 or s.dim() != 2 or feats.dim() != 2:
        raise ValueError("g, s and feats must be 2-D")
    m, n = g.shape
    q, k_feats = s.shape[1], feats.shape[1]
    device = g.device
    _check("g", g, (m, n), device)
    _check("thetas", thetas, (m, 2), device)
    _check("lam", lam, (n,), device)
    _check("s", s, (n, q), device)
    _check("feats", feats, (n, k_feats), device)
    total = moment_columns(q, k_feats)[-1]
    out = torch.empty((m, total), dtype=torch.float32, device=device)
    if m == 0:
        return out
    lib = _library()
    # the kernel stages the shared columns from column-major copies
    # (coalesced loads); they are n x (q + K), small beside g
    s_t, feats_t = s.T.contiguous(), feats.T.contiguous()
    with torch.cuda.device(device):
        rc = lib.fused_refit_moments(
            g.data_ptr(), thetas.data_ptr(), lam.data_ptr(), s_t.data_ptr(),
            feats_t.data_ptr(), out.data_ptr(), m, n, q, k_feats,
            cuda_lib.stream_handle(device),
        )
    if rc != 0:
        raise RuntimeError(f"fused_refit_moments: CUDA error {rc}")
    fused_refit_moments.launches += 1
    return out


fused_refit_moments.launches = 0


def _library():
    lib = cuda_lib.load("refit_moments")
    fn = lib.fused_refit_moments
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    return lib
