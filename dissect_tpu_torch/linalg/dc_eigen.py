"""Full-spectrum symmetric eigensolver by spectral divide-and-conquer.

Port of dissect_tpu/linalg/dc_eigen.py — the replacement of the
reference's pdsyev_ (Matrix::eigenDecomposition, matrix.cpp:3327-3380)
over a mesh: Nakatsukasa & Higham's QDWH-eig, all matmuls, Cholesky
factorizations and triangular solves:

  1. pick a split point sigma (median of the diagonal, then the
     mid-range and the quartiles if the median fails);
  2. U = sign(A - sigma I) by QDWH dynamically weighted rational
     iterations X <- (b/c) X + (a - b/c) X (I + c X^2)^-1 (one product
     and one SPD solve each), then Newton-Schulz polishing
     X <- X (3 I - X^2) / 2;
  3. the projectors (I -/+ U)/2 split the spectrum, their ranks come
     from tr(U), and Gaussian probes through them give the invariant
     subspace bases, orthonormalized by CholeskyQR2;
  4. recurse on the Rayleigh quotients Q^T A Q, down to a local
     `torch.linalg.eigh` at `base_size`.

Every O(m^3) product is split by rows over the ranks of the
MeshContext (each rank multiplies its rows, an all-gather joins them),
and the SPD solves of step 2 run the row-sharded blocked Cholesky
(`spd_solve_cyclic`, linalg/distributed.py) on more than one rank.
Between steps each operand is held whole on every rank, so the work is
sharded and the memory is not: the row-sharded REML engine, not this
solver, is the path for matrices beyond one card.

All of it runs in float64.  Not ported, being TPU workarounds: the
host-float64 CholeskyQR above 2,560 columns, the AOT memory probes, the
compile-rejection fallbacks, and the vmapped batch of the four shifts
(the shifts run one at a time).  A CholeskyQR2 that fails or leaves the
basis non-orthonormal falls back to a Householder QR.  Departure from
the reference (ADVICE.md): the trace-leak check
|tr A - tr A1 - tr A2| is normalized by ||A||_F, not by 1 + |tr A|,
which is near zero for a sign-balanced spectrum.  A failed split above
`base_size` raises, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from dissect_tpu_torch.linalg.distributed import spd_solve_cyclic
from dissect_tpu_torch.runtime.mesh import MeshContext

# a split whose children's traces miss the parent's by more than this
# share of ||A||_F lost eigenvalue mass
LEAK_TOL = 1e-3
# QDWH's lower bound on the smallest singular value of the scaled A - sigma I
L0 = 1e-6
# Newton-Schulz polishing steps after the QDWH schedule
NS_ITERS = 2
# the seed of the split's Gaussian probes
SEED = 0
# recursion levels before a split counts as failed
MAX_DEPTH = 32


def qdwh_coefficients(l0: float, max_iter: int = 12):
    """Host-side QDWH dynamic-weighting schedule from the lower bound l0.

    Returns the (a, b, c) list; the map x -> x (a + b x^2)/(1 + c x^2)
    drives |x| in [l0, 1] to 1 cubically (~6 steps for l0 = 1e-16)."""
    coeffs = []
    l = float(min(max(l0, 1e-16), 1.0))
    while len(coeffs) < max_iter:
        d = (4.0 * (1.0 - l * l) / (l ** 4)) ** (1.0 / 3.0)
        a = math.sqrt(1.0 + d) + 0.5 * math.sqrt(
            max(8.0 - 4.0 * d + 8.0 * (2.0 - l * l) / (l * l * math.sqrt(1.0 + d)), 0.0)
        )
        b = (a - 1.0) ** 2 / 4.0
        c = a + b - 1.0
        coeffs.append((a, b, c))
        l = l * (a + b * l * l) / (1.0 + c * l * l)
        if abs(1.0 - l) < 1e-14:
            break
    return coeffs


def pick_sign_block(n: int, n_devices: int) -> int:
    """Cholesky panel width of the sign iterations' SPD solves: the
    largest power of two <= n/(4 devices), clamped to [64, 512]."""
    per = max(n // max(4 * n_devices, 1), 64)
    block = 64
    while block * 2 <= min(per, 512):
        block *= 2
    return block


def rows_product(a: torch.Tensor, b: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    """a @ b, each rank computing its rows of a and an all-gather
    joining them."""
    if ctx is None or ctx.world == 1:
        return a @ b
    r0, r1 = ctx.local_rows(a.shape[0])
    return ctx.all_gather_rows(a[r0:r1] @ b, a.shape[0])


def gram(a: torch.Tensor, b: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    """a^T b, each rank contracting its rows and an all-reduce summing."""
    if ctx is None or ctx.world == 1:
        return a.T @ b
    r0, r1 = ctx.local_rows(a.shape[0])
    return ctx.all_reduce(a[r0:r1].T @ b[r0:r1])


def spd_solve(z: torch.Tensor, rhs: torch.Tensor, ctx: Optional[MeshContext], block: int):
    """Z^-1 rhs for SPD Z: one device's Cholesky alone, else the
    row-sharded blocked cyclic solve with Z identity-padded to a
    multiple of world * block."""
    if ctx is None or ctx.world == 1:
        return torch.cholesky_solve(rhs, torch.linalg.cholesky(z))
    m = z.shape[0]
    q = ctx.world * block
    target = -(-m // q) * q
    r0, r1 = ctx.local_rows(target)
    z_loc = torch.zeros((r1 - r0, target), dtype=z.dtype, device=z.device)
    rows = torch.arange(min(r0, m), min(r1, m), device=z.device)
    z_loc[: rows.numel(), :m] = z[rows]
    pad = torch.arange(max(r0, m), max(r1, m), device=z.device)
    z_loc[pad - r0, pad] = 1.0
    b_loc = torch.zeros((r1 - r0, rhs.shape[1]), dtype=rhs.dtype, device=rhs.device)
    b_loc[: rows.numel()] = rhs[rows]
    x_loc, _ = spd_solve_cyclic(z_loc, b_loc, ctx, block)
    return ctx.all_gather(x_loc)[:m]


def matrix_sign(a: torch.Tensor, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """sign(A) of a symmetric matrix with no zero eigenvalue: scale by
    alpha = min(||A||_F, max row 1-norm) >= ||A||_2, run the QDWH
    schedule from L0, polish with NS_ITERS Newton-Schulz steps."""
    n = a.shape[0]
    block = pick_sign_block(n, ctx.world if ctx is not None else 1)
    alpha = torch.minimum(torch.linalg.norm(a), torch.max(torch.sum(torch.abs(a), dim=1))) + 1e-30
    x = a / alpha
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    for ca, cb, cc in qdwh_coefficients(L0):
        y = spd_solve(cc * rows_product(x, x, ctx) + eye, x, ctx, block)
        x = (cb / cc) * x + (ca - cb / cc) * y
        x = 0.5 * (x + x.T)
    for _ in range(NS_ITERS):
        x = 0.5 * rows_product(x, 3.0 * eye - rows_product(x, x, ctx), ctx)
        x = 0.5 * (x + x.T)
    return x


def orthonormalize(y: torch.Tensor, ctx: Optional[MeshContext]) -> torch.Tensor:
    """An orthonormal basis of range(y): two rounds of CholeskyQR (Gram,
    small Cholesky, triangular solve), or a Householder QR when a
    Cholesky fails or the result is not orthonormal to 1e-3."""
    q = y
    for _ in range(2):
        r, info = torch.linalg.cholesky_ex(gram(q, q, ctx))
        if int(info) != 0:
            break
        q = torch.linalg.solve_triangular(r.T, q, upper=True, left=False)
    else:
        k = q.shape[1]
        eye = torch.eye(k, dtype=q.dtype, device=q.device)
        err = float(torch.linalg.norm(gram(q, q, ctx) - eye)) / math.sqrt(k)
        if math.isfinite(err) and err <= 1e-3:
            return q
    return torch.linalg.qr(y)[0]


def split(a: torch.Tensor, u: torch.Tensor, k: int, gen: torch.Generator, ctx):
    """(Q1, Q2, A1, A2, finite, leak) of one spectral split: probes
    through both projectors, their orthonormal bases, both Rayleigh
    quotients, and the trace leak |tr A - tr A1 - tr A2| / ||A||_F."""
    m = a.shape[0]
    probes = torch.randn((m, m), generator=gen, dtype=a.dtype, device="cpu").to(a.device)
    up = rows_product(u, probes, ctx)
    q1 = orthonormalize(0.5 * (probes[:, :k] - up[:, :k]), ctx)
    q2 = orthonormalize(0.5 * (probes[:, k:] + up[:, k:]), ctx)
    aq = rows_product(a, torch.cat([q1, q2], dim=1), ctx)
    a1 = gram(q1, aq[:, :k], ctx)
    a2 = gram(q2, aq[:, k:], ctx)
    a1, a2 = 0.5 * (a1 + a1.T), 0.5 * (a2 + a2.T)
    finite = bool(torch.isfinite(a1).all()) and bool(torch.isfinite(a2).all())
    leak = float(
        torch.abs(torch.trace(a) - torch.trace(a1) - torch.trace(a2)) / (torch.linalg.norm(a) + 1e-300)
    )
    return q1, q2, a1, a2, finite, leak


def distributed_eigh(
    a: torch.Tensor, ctx: Optional[MeshContext] = None, base_size: int = 2048
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(w ascending, V) of a symmetric matrix held whole on every rank,
    by spectral divide-and-conquer in float64.  On more than one rank a
    failed split above `base_size` raises (the reference aborts on a
    pdsyev failure, matrix.cpp:3327-3380); one rank solves it with a
    local eigh.  Every rank returns rank 0's result."""
    a = a.to(torch.float64)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    eps = float(torch.finfo(a.dtype).eps)
    inv_tol = 100.0 * math.sqrt(eps)

    def local_or_raise(a_sub, depth, reason):
        if ctx is None or ctx.world == 1:
            return torch.linalg.eigh(a_sub)
        m = a_sub.shape[0]
        raise RuntimeError(
            f"distributed_eigh: no valid spectral split for a {m} x {m} "
            f"subproblem at depth {depth} ({reason})"
        )

    def rec(a_sub, depth):
        m = a_sub.shape[0]
        if m <= base_size:
            return torch.linalg.eigh(a_sub)
        if depth >= MAX_DEPTH:
            return local_or_raise(a_sub, depth, "max recursion depth")
        d = torch.diagonal(a_sub).cpu().numpy()
        candidates = []
        for s in (np.median(d), 0.5 * (d.min() + d.max()), np.quantile(d, 0.25), np.quantile(d, 0.75)):
            if all(abs(s - c) > 1e-12 * max(1.0, abs(s)) for c in candidates):
                candidates.append(float(s))
        probes = torch.as_tensor(rng.standard_normal((m, 4)) / math.sqrt(m), device=a_sub.device)
        found = None
        for s in candidates:
            shifted = a_sub - s * torch.eye(m, dtype=a_sub.dtype, device=a_sub.device)
            u = matrix_sign(shifted, ctx)
            tr = float(torch.trace(u))
            err = float(torch.linalg.norm(u @ (u @ probes) - probes) / torch.linalg.norm(probes))
            if not math.isfinite(tr) or not math.isfinite(err) or err > inv_tol:
                continue
            k = int(round((m - tr) / 2.0))
            if 0 < k < m:
                found = (u, k)
                break
        if found is None:
            return local_or_raise(a_sub, depth, "all shift candidates failed")
        u, k = found
        ok, leak = False, math.inf
        for _ in range(2):  # fresh probes once on a leak or a non-finite quotient
            q1, q2, a1, a2, ok, leak = split(a_sub, u, k, gen, ctx)
            if ok and leak <= LEAK_TOL:
                break
        if not ok:
            return local_or_raise(a_sub, depth, "non-finite Rayleigh quotient")
        if leak > LEAK_TOL:
            return local_or_raise(a_sub, depth, f"trace leak {leak:.2e} after a basis retry")
        del u, found
        w1, v1 = rec(a1, depth + 1)
        w2, v2 = rec(a2, depth + 1)
        return torch.cat([w1, w2]), torch.cat(
            [rows_product(q1, v1, ctx), rows_product(q2, v2, ctx)], dim=1
        )

    w, v = rec(a, 0)
    order = torch.argsort(w)
    w, v = w[order].contiguous(), v[:, order].contiguous()
    if ctx is not None and ctx.world > 1:
        ctx.broadcast(w, 0)
        ctx.broadcast(v, 0)
    return w, v
