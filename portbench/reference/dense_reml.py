"""The plain REML fit of a cohort whose eigendecomposition one card cannot
hold: V = t1 K + t2 I factored densely, in tiles, with no N x N inverse.

The model, the definitions and the convergence rule are those of
`mixed_model.reml_diagonal` (its docstring; `TOL`), worked out from the
Cholesky factor L of V instead of K's eigenbasis:
  * log|V| = 2 sum log diag L;
  * with a = L^-1 [y X] (thin triangular solves): X'V^-1 X = a_X' a_X,
    the BLUEs b = (X'V^-1 X)^-1 a_X' a_y, r = a_y - a_X b, y'Py = r'r and
    Py = L^-T r;
  * tr(V^-1) = ||L^-1||_F^2, from L^-1 one column block at a time; then
    tr(V^-1 K) = (N - t2 tr V^-1) / t1, since K = (V - t2 I) / t1, and the
    thin terms of tr(P K) and tr(P) follow;
  * the BLUPs are t1 K Py.
K and V are the only N x N planes (57.6 GB in float64 at N = 60,000):
V is formed anew and factored in place each iteration; a tile panel and
a column block of L^-1 are the temporaries.

The GRM is `grm.grm`'s (its `standardized` rows, K = Z'Z / O'O), built
within K's plane and a float32 plane of counts: lower tiles only, then
mirrored.  It imports nothing of the program.
"""

from __future__ import annotations

import torch

from portbench.reference.grm import matmul_precision, standardized
from portbench.reference.mixed_model import TOL

# rows and columns of a tile: a diagonal tile is factored by one
# `torch.linalg.cholesky`, the rest is matrix products
TILE = 4096
# AI steps of one fit at most: from the program's variances it takes two
# or three, from the default start under ten
MAX_STEPS = 20


def tiles(n: int, tile: int):
    return [(s, min(s + tile, n)) for s in range(0, n, tile)]


def grm(row_blocks, n: int, hard_calls: bool, device, tile: int = TILE):
    """K in float64, whole and symmetric, from an iterable of genotype
    row blocks on `device`: each block's Z'Z and O'O added to the lower
    tiles, the quotient taken in place, the upper tiles mirrored."""
    bounds = tiles(n, tile)
    kern = torch.zeros((n, n), dtype=torch.float64, device=device)
    counts = torch.zeros((n, n), dtype=torch.float32, device=device)
    for rows in row_blocks:
        z, o = standardized(rows.to(device), hard_calls, torch.float64)
        o = o.to(torch.float32)
        for i0, i1 in bounds:
            kern[i0:i1, :i1].addmm_(z[:, i0:i1].T, z[:, :i1])
            # 0/1 products summed below 2^24 are exact in TF32 products
            # with float32 sums: the counts lose nothing to the tensor cores
            with matmul_precision(True):
                counts[i0:i1, :i1].addmm_(o[:, i0:i1].T, o[:, :i1])
        del z, o
    kern.div_(counts.clamp_min_(1.0))
    del counts
    for j, (j0, j1) in enumerate(bounds):
        d = kern[j0:j1, j0:j1]
        d.copy_(torch.tril(d) + torch.tril(d, -1).T)
        for i0, i1 in bounds[j + 1:]:
            kern[j0:j1, i0:i1].copy_(kern[i0:i1, j0:j1].T)
    return kern


def factor(v: torch.Tensor, bounds) -> None:
    """V's lower triangle := its Cholesky factor L, in place (the tiles
    above the diagonal tiles are left as they were and never read)."""
    n = v.shape[0]
    for k, (k0, k1) in enumerate(bounds):
        l_kk = torch.linalg.cholesky(v[k0:k1, k0:k1])
        v[k0:k1, k0:k1] = l_kk
        if k1 == n:
            break
        # the panel below: P L_kk^-T
        panel = torch.linalg.solve_triangular(l_kk, v[k1:, k0:k1].T, upper=False).T
        v[k1:, k0:k1] = panel
        for i0, i1 in bounds[k + 1:]:
            v[i0:i1, k1:i1].addmm_(panel[i0 - k1:i1 - k1], panel[:i1 - k1].T, alpha=-1.0)
        del panel


def lower_solve(l, b, bounds):
    """L^-1 b, b (N, r)."""
    x = b.clone()
    for i0, i1 in bounds:
        if i0:
            x[i0:i1] -= l[i0:i1, :i0] @ x[:i0]
        x[i0:i1] = torch.linalg.solve_triangular(l[i0:i1, i0:i1], x[i0:i1], upper=False)
    return x


def upper_solve(l, b, bounds):
    """L^-T b, b (N, r)."""
    n = l.shape[0]
    x = b.clone()
    for i0, i1 in reversed(bounds):
        if i1 < n:
            x[i0:i1] -= l[i1:, i0:i1].T @ x[i1:]
        x[i0:i1] = torch.linalg.solve_triangular(l[i0:i1, i0:i1].T, x[i0:i1], upper=True)
    return x


def inverse_trace(l, bounds):
    """tr(V^-1) = ||L^-1||_F^2: L^-1 a column block at a time (its rows
    above the block are zero), by forward substitution over the tiles."""
    n = l.shape[0]
    diag = [l[i0:i1, i0:i1].clone() for i0, i1 in bounds]
    total = l.new_zeros(())
    for j, (j0, j1) in enumerate(bounds):
        w = l.new_empty((n - j0, j1 - j0))
        for i, (i0, i1) in enumerate(bounds[j:], start=j):
            if i == j:
                rhs = torch.eye(j1 - j0, dtype=l.dtype, device=l.device)
            else:
                rhs = -(l[i0:i1, j0:i0] @ w[:i0 - j0])
            w[i0 - j0:i1 - j0] = torch.linalg.solve_triangular(diag[i], rhs, upper=False)
        total += torch.linalg.vector_norm(w) ** 2
        del w
    return total


def quantities(kern, v, theta, y, x, bounds):
    """Everything an AI-REML step and the fitted outputs need at `theta`;
    V is formed in `v` and left holding its factor."""
    n = y.shape[0]
    torch.mul(kern, theta[0], out=v)
    v.diagonal().add_(theta[1])
    factor(v, bounds)
    logdet_v = 2.0 * torch.log(torch.diagonal(v)).sum()
    a = lower_solve(v, torch.column_stack([y, x]), bounds)
    ay, ax = a[:, 0], a[:, 1:]
    xvx = ax.T @ ax
    xvx_inv = torch.linalg.inv(xvx)
    blue = xvx_inv @ (ax.T @ ay)
    r = ay - ax @ blue
    py = upper_solve(v, r[:, None], bounds)[:, 0]
    vix = upper_solve(v, ax, bounds)
    kpy = kern @ py
    tr_vi = inverse_trace(v, bounds)
    tr_vik = (n - theta[1] * tr_vi) / theta[0]
    tr_p = torch.stack([tr_vik - torch.trace(xvx_inv @ (vix.T @ (kern @ vix))),
                        tr_vi - torch.trace(xvx_inv @ (vix.T @ vix))])
    u = torch.stack([kpy, py], dim=1)
    grad = 0.5 * (u.T @ py - tr_p)
    vi_u = upper_solve(v, lower_solve(v, u, bounds), bounds)
    pu = vi_u - vix @ (xvx_inv @ (vix.T @ u))
    return {
        "logl": -0.5 * (logdet_v + torch.linalg.slogdet(xvx)[1] + r @ r),
        "blue": blue,
        "blue_se": torch.sqrt(torch.diagonal(xvx_inv)),
        "blup": theta[0] * kpy,
        "grad": grad,
        "ai": 0.5 * u.T @ pu,
    }


def reml_dense(kern, v, y, x, start=None, tile: int = TILE):
    """The REML fit of V = t1 K + t2 I to (y, X), in K's dtype, by AI
    steps to `TOL` from `start` (the default: half the variance of y
    each).  `v` is a plane of K's shape and dtype, overwritten.  Returns
    dict: theta, logl, blue, blue_se, blup and steps, at the last theta
    evaluated (its step was within `TOL`, as `reml_diagonal` stops)."""
    dtype, device = kern.dtype, kern.device
    bounds = tiles(kern.shape[0], tile)
    y, x = (torch.as_tensor(a, dtype=dtype, device=device) for a in (y, x))
    theta = None if start is None else torch.as_tensor(start, dtype=dtype, device=device)
    if theta is None or not bool(torch.isfinite(theta).all() and (theta > 0).all()):
        var = float(torch.var(y))
        theta = torch.tensor([var / 2, var / 2], dtype=dtype, device=device)
    with matmul_precision(False):
        for steps in range(1, MAX_STEPS + 1):
            q = quantities(kern, v, theta, y, x, bounds)
            step = torch.linalg.solve(q["ai"], q["grad"])
            if bool((step.abs() <= TOL[dtype] * theta.abs()).all()) or steps == MAX_STEPS:
                break
            new = theta + step
            while bool((new <= 0).any()):
                step = step / 2
                new = theta + step
            theta = new
    return {"theta": theta, "steps": steps,
            **{k: q[k] for k in ("logl", "blue", "blue_se", "blup")}}
