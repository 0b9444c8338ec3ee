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
  4. recurse on the Rayleigh quotients Q^T A Q, down to
     `torch.linalg.eigh` at `base_size`.

Row layout.  On a MeshContext of P ranks every operand of a subproblem
of size m (the shifted matrix and the sign iterate X, the probes and
their products, the bases Q1 and Q2, A Q1 and A Q2, the Rayleigh
quotients A1 and A2, which are the children's inputs, and the
eigenvectors) is held between steps as this rank's `ctx.local_rows(m)`
rows, as JAX holds it P(axis, None), so no rank holds a whole m x m
operand above `base_size`:
  * products A B go through `sharded_matmul` (each rank's row block of
    B broadcast in turn; X X needs only X's row blocks), A B^T through
    `sharded_matmul_t`, and (X + X^T)/2 takes X^T's rows from each
    rank's block in turn (`symmetrized`);
  * the SPD solves of the sign iterations, and CholeskyQR's Gram factor,
    run the row-sharded blocked Cholesky (linalg/distributed.py) on each
    rank's rows as they lie: each rank's block is identity-padded at its
    end to a multiple of the Cholesky block, a symmetric permutation of
    the identity-padded matrix that changes no solution, so no row moves
    between ranks;
  * Gram products Q^T B end row-sharded through one reduce-scatter
    (`gram_rows`), the Rayleigh quotients among them;
  * scalars are gathered or all-reduced: the diagonal for the shift
    candidates, the traces, ||A||_F and the involution check U (U p) on
    four probe columns;
  * a subproblem of at most `base_size` is gathered and solved by
    `torch.linalg.eigh`, rank 0's result broadcast so every rank holds
    the same bits; the combine multiplies Q1 and Q2 by the children's
    eigenvectors, row-sharded or (after a base case) whole.
One rank runs the same code, its collectives the identity and its
Cholesky solves LAPACK's.

Probes.  Each split draws a seed from a host generator seeded with
SEED, in the same order on every rank (a retried split draws another).
Its Gaussian probe matrix is drawn in tiles of PROBE_ROWS rows: tile i
from a generator on the operand's device seeded with seed * 2^20 + i.
So a rank draws only the tiles that hold its rows, no rank's draws
depend on another's, and the probes are the same for every number of
ranks; the eigenpairs agree across world sizes once converged, not
iterate by iterate (the Cholesky's blocking and the sums' order move
the rounding), as the two packages already agree.

All of it runs in float64.  Not ported, being TPU workarounds: the
host-float64 CholeskyQR above 2,560 columns, the AOT memory probes, the
compile-rejection fallbacks, and the vmapped batch of the four shifts
(the shifts run one at a time).  A CholeskyQR2 that fails or leaves the
basis non-orthonormal to 1e-3 is redone with a shifted first round
(Fukaya et al.'s shifted CholeskyQR3), which keeps the rows sharded.
Departure from the reference (ADVICE.md): the trace-leak check
|tr A - tr A1 - tr A2| is normalized by ||A||_F, not by 1 + |tr A|,
which is near zero for a sign-balanced spectrum.  A failed split above
`base_size` raises on more than one rank, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from dissect_tpu_torch.linalg.distributed import (
    distributed_cholesky,
    distributed_trtri,
    gram_rows,
    pick_interleave,
    sharded_matmul,
    sharded_matmul_t,
    spd_solve_cyclic,
    symmetrized,
)
from dissect_tpu_torch.runtime.mesh import MeshContext, RowShards

# a split whose children's traces miss the parent's by more than this
# share of ||A||_F lost eigenvalue mass
LEAK_TOL = 1e-3
# QDWH's lower bound on the smallest singular value of the scaled A - sigma I
L0 = 1e-6
# Newton-Schulz polishing steps after the QDWH schedule
NS_ITERS = 2
# the seed of the host generator that draws each split's probe seed
SEED = 0
# recursion levels before a split counts as failed
MAX_DEPTH = 32
# rows of one tile of a split's Gaussian probes (one generator seed each)
PROBE_ROWS = 16


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
    """Cholesky panel width of the row-sharded SPD solves: the largest
    power of two <= n/(4 devices), clamped to [8, 512].  (JAX's floor is
    64; 8 keeps a small subproblem's identity padding within its rows.)"""
    per = max(n // max(4 * n_devices, 1), 8)
    block = 8
    while block * 2 <= min(per, 512):
        block *= 2
    return block


def _diagonal_index(m: int, ctx: MeshContext, device):
    """(local row, column) of each diagonal entry in this rank's rows of
    an m x m matrix."""
    r0, r1 = ctx.local_rows(m)
    return (torch.arange(r1 - r0, device=device), torch.arange(r0, r1, device=device))


def _local_trace(x_loc: torch.Tensor, ctx: MeshContext) -> torch.Tensor:
    return x_loc[_diagonal_index(x_loc.shape[1], ctx, x_loc.device)].sum()


def _padded(a_loc: torch.Tensor, ctx: MeshContext, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(this rank's rows of the identity-padded (P t, P t) form of a
    row-sharded m x m matrix, the padded column of each of its m
    columns), t = the longest shard rounded up to a multiple of
    `block`: rank r's t rows are its own rows, then identity rows, and
    the columns follow the same order."""
    m = a_loc.shape[1]
    bounds = ctx.row_bounds(m)
    t = -(-max(hi - lo for lo, hi in bounds) // block) * block
    cols = torch.cat([torch.arange(lo, hi) - lo + r * t for r, (lo, hi) in enumerate(bounds)])
    n_loc = a_loc.shape[0]
    out = a_loc.new_zeros((t, ctx.world * t))
    out[:n_loc, cols.to(a_loc.device)] = a_loc
    pad = torch.arange(n_loc, t, device=a_loc.device)
    out[pad, ctx.rank * t + pad] = 1.0
    return out, cols.to(a_loc.device)


def spd_solve(z_loc: torch.Tensor, rhs_loc: torch.Tensor, ctx: MeshContext, block: int) -> torch.Tensor:
    """This rank's rows of Z^-1 B for SPD Z and B held in the same rows:
    one rank's Cholesky alone, else the row-sharded blocked cyclic solve
    on the identity-padded rows (`_padded`)."""
    if ctx.world == 1:
        return torch.cholesky_solve(rhs_loc, torch.linalg.cholesky(z_loc))
    n_loc = z_loc.shape[0]
    z_pad, _ = _padded(z_loc, ctx, block)
    b_pad = rhs_loc.new_zeros((z_pad.shape[0], rhs_loc.shape[1]))
    b_pad[:n_loc] = rhs_loc
    return spd_solve_cyclic(z_pad, b_pad, ctx, block)[0][:n_loc]


def matrix_sign(a_loc: torch.Tensor, ctx: Optional[MeshContext] = None, shift: float = 0.0) -> torch.Tensor:
    """This rank's rows of sign(A - shift I) for a symmetric A held as
    its rows (whole without `ctx`), with no zero eigenvalue: scale by
    alpha = min(||A||_F, max row 1-norm) >= ||A||_2, run the QDWH
    schedule from L0, polish with NS_ITERS Newton-Schulz steps."""
    ctx = ctx or MeshContext()
    m = a_loc.shape[1]
    diag = _diagonal_index(m, ctx, a_loc.device)
    x = a_loc.clone()
    x[diag] -= shift
    fro = torch.sqrt(ctx.all_reduce((torch.linalg.vector_norm(x) ** 2).reshape(1)))[0]
    row1 = torch.max(ctx.all_gather((
        torch.max(torch.linalg.vector_norm(x, ord=1, dim=1)) if x.shape[0] else x.new_zeros(())
    ).reshape(1)))
    x /= torch.minimum(fro, row1) + 1e-30
    block = pick_sign_block(m, ctx.world)
    for ca, cb, cc in qdwh_coefficients(L0):
        z = sharded_matmul(x, x, ctx)
        z *= cc
        z[diag] += 1.0
        y = spd_solve(z, x, ctx, block)
        del z
        x = symmetrized(x.mul_(cb / cc).add_(y, alpha=ca - cb / cc), ctx)
        del y
    for _ in range(NS_ITERS):
        x2 = sharded_matmul(x, x, ctx)
        x2 *= -0.5
        x2[diag] += 1.5
        x = symmetrized(sharded_matmul(x, x2, ctx), ctx)
        del x2
    return x


def _cholesky_qr_round(q: torch.Tensor, ctx: MeshContext, shift: float = 0.0) -> Optional[torch.Tensor]:
    """One round of CholeskyQR of a row-sharded (m, k) Q: G = Q^T Q +
    shift I = L L^T, then Q L^-T; None when the Cholesky fails.  On one
    rank LAPACK's factor and triangular solve; on more, the row-sharded
    factor and its inverse (`_padded` rows of G), Q L^-T as Q W^T."""
    k = q.shape[1]
    g = gram_rows(q, q, ctx)
    if shift:
        g[_diagonal_index(k, ctx, g.device)] += shift
    if ctx.world == 1:
        r, info = torch.linalg.cholesky_ex(g)
        if int(info) != 0:
            return None
        return torch.linalg.solve_triangular(r.T, q, upper=True, left=False)
    block = pick_sign_block(k, ctx.world)
    k_loc = g.shape[0]
    g_pad, cols = _padded(g, ctx, block)
    del g
    interleave = pick_interleave(g_pad.shape[1], ctx.world, block)
    _, logdet = distributed_cholesky(g_pad, ctx, block, interleave)
    if not math.isfinite(float(logdet)):
        return None
    w = distributed_trtri(g_pad, ctx, block, interleave)[:k_loc][:, cols]
    del g_pad
    return sharded_matmul_t(q, w, k, ctx)


def _orthonormality_error(q: torch.Tensor, ctx: MeshContext) -> float:
    """||Q^T Q - I||_F / sqrt(k) of a row-sharded (m, k) Q."""
    k = q.shape[1]
    g = gram_rows(q, q, ctx)
    g[_diagonal_index(k, ctx, g.device)] -= 1.0
    return math.sqrt(float(ctx.all_reduce(torch.sum(g * g).reshape(1))[0]) / k)


def orthonormalize(y: torch.Tensor, m: int, ctx: Optional[MeshContext] = None) -> torch.Tensor:
    """An orthonormal basis of range(Y) for a row-sharded (m, k) Y: two
    rounds of CholeskyQR; where a Cholesky fails or the result is not
    orthonormal to 1e-3, a first round on Y^T Y + s I with s = 11 (m k +
    k (k + 1)) eps ||Y||_F^2 (shifted CholeskyQR3), then two plain ones."""
    ctx = ctx or MeshContext()
    q = y
    for _ in range(2):
        q = _cholesky_qr_round(q, ctx)
        if q is None:
            break
    else:
        err = _orthonormality_error(q, ctx)
        if math.isfinite(err) and err <= 1e-3:
            return q
    k = y.shape[1]
    norm2 = float(ctx.all_reduce((torch.linalg.vector_norm(y) ** 2).reshape(1))[0])
    shift = 11.0 * (m * k + k * (k + 1)) * float(torch.finfo(y.dtype).eps) * norm2
    q = _cholesky_qr_round(y, ctx, shift)
    for _ in range(2):
        if q is None:
            break
        q = _cholesky_qr_round(q, ctx)
    return q if q is not None else torch.full_like(y, float("nan"))


def gaussian_rows(lo: int, hi: int, n_cols: int, seed: int, like: torch.Tensor) -> torch.Tensor:
    """Rows [lo, hi) of the (m, n_cols) standard normal probe matrix of
    the split seeded `seed`, on `like`'s device and dtype: tile i (rows
    [PROBE_ROWS i, PROBE_ROWS (i + 1))) is drawn from a generator seeded
    with seed * 2^20 + i, as far as the rows it must give."""
    gen = torch.Generator(device=like.device)
    out = like.new_empty((hi - lo, n_cols))
    for tile in range(lo // PROBE_ROWS, -(-hi // PROBE_ROWS)):
        t0 = tile * PROBE_ROWS
        a, b = max(lo, t0), min(hi, t0 + PROBE_ROWS)
        gen.manual_seed(seed * (1 << 20) + tile)
        drawn = torch.randn((b - t0, n_cols), generator=gen, dtype=like.dtype, device=like.device)
        out[a - lo : b - lo] = drawn[a - t0 :]
    return out


def split(a: torch.Tensor, u: torch.Tensor, k: int, seed: int, ctx: Optional[MeshContext] = None):
    """(Q1, Q2, A1, A2, finite, leak) of one spectral split, every matrix
    as this rank's rows (whole without `ctx`): the probes of the split
    seeded `seed` through both projectors, their orthonormal bases,
    both Rayleigh quotients, and the trace leak
    |tr A - tr A1 - tr A2| / ||A||_F."""
    ctx = ctx or MeshContext()
    m = a.shape[1]
    lo, hi = ctx.local_rows(m)
    probes = gaussian_rows(lo, hi, m, seed, a)
    up = sharded_matmul(u, probes, ctx)
    y1 = 0.5 * (probes[:, :k] - up[:, :k])
    y2 = 0.5 * (probes[:, k:] + up[:, k:])
    del probes, up
    q1 = orthonormalize(y1, m, ctx)
    del y1
    q2 = orthonormalize(y2, m, ctx)
    del y2
    a1 = symmetrized(gram_rows(q1, sharded_matmul(a, q1, ctx), ctx), ctx)
    a2 = symmetrized(gram_rows(q2, sharded_matmul(a, q2, ctx), ctx), ctx)
    sums = ctx.all_reduce(torch.stack([
        _local_trace(a, ctx), _local_trace(a1, ctx), _local_trace(a2, ctx),
        torch.linalg.vector_norm(a) ** 2,
        (~torch.isfinite(a1)).sum().to(a.dtype) + (~torch.isfinite(a2)).sum().to(a.dtype)]))
    finite = float(sums[4]) == 0.0
    leak = float(torch.abs(sums[0] - sums[1] - sums[2]) / (torch.sqrt(sums[3]) + 1e-300))
    return q1, q2, a1, a2, finite, leak


def _rows_of(a: Union[torch.Tensor, RowShards], ctx: MeshContext) -> torch.Tensor:
    """This rank's rows of `a` in float64."""
    if isinstance(a, RowShards):
        return a.local.to(torch.float64)
    lo, hi = ctx.local_rows(a.shape[0])
    return a[lo:hi].to(torch.float64)


def distributed_eigh(
    a: Union[torch.Tensor, RowShards], ctx: Optional[MeshContext] = None, base_size: int = 2048
) -> Tuple[torch.Tensor, RowShards]:
    """(w ascending, V) of a symmetric matrix by spectral
    divide-and-conquer in float64.  `a` is RowShards over `ctx`'s ranks
    (a GRM as built) or a tensor whole on every rank, of which each rank
    takes its rows.  w comes back whole and equal on every rank, V as
    RowShards.  On more than one rank a failed split above `base_size`
    raises (the reference aborts on a pdsyev failure,
    matrix.cpp:3327-3380); one rank solves it with a local eigh."""
    ctx = ctx or MeshContext()
    n = a.shape[0]
    rng = np.random.default_rng(SEED)
    inv_tol = 100.0 * math.sqrt(float(torch.finfo(torch.float64).eps))

    def base(a_sub: RowShards):
        w, v = torch.linalg.eigh(a_sub.whole())
        if ctx.world > 1:  # every rank holds rank 0's bits
            ctx.broadcast(w, 0)
            ctx.broadcast(v, 0)
        return w, v

    def local_or_raise(a_sub: RowShards, depth, reason):
        if ctx.world == 1:
            return base(a_sub)
        m = a_sub.n
        raise RuntimeError(
            f"distributed_eigh: no valid spectral split for a {m} x {m} "
            f"subproblem at depth {depth} ({reason})"
        )

    def rec(a_sub: RowShards, depth):
        """(w, V) of a subproblem: V whole after a base case, else RowShards."""
        m = a_sub.n
        if m <= base_size:
            return base(a_sub)
        if depth >= MAX_DEPTH:
            return local_or_raise(a_sub, depth, "max recursion depth")
        x = a_sub.local
        d = ctx.all_gather_rows(x[_diagonal_index(m, ctx, x.device)], m).cpu().numpy()
        candidates = []
        for s in (np.median(d), 0.5 * (d.min() + d.max()), np.quantile(d, 0.25), np.quantile(d, 0.75)):
            if all(abs(s - c) > 1e-12 * max(1.0, abs(s)) for c in candidates):
                candidates.append(float(s))
        lo, hi = ctx.local_rows(m)
        probes = torch.as_tensor(rng.standard_normal((m, 4))[lo:hi] / math.sqrt(m), device=x.device)
        found = None
        for s in candidates:
            u = matrix_sign(x, ctx, shift=s)
            uup = sharded_matmul(u, sharded_matmul(u, probes, ctx), ctx)
            sums = ctx.all_reduce(torch.stack(
                [_local_trace(u, ctx), torch.sum((uup - probes) ** 2), torch.sum(probes ** 2)]))
            tr, err = float(sums[0]), math.sqrt(float(sums[1]) / float(sums[2]))
            if math.isfinite(tr) and math.isfinite(err) and err <= inv_tol:
                k = int(round((m - tr) / 2.0))
                if 0 < k < m:
                    found = (u, k)
                    break
            del u
        if found is None:
            return local_or_raise(a_sub, depth, "all shift candidates failed")
        u, k = found
        del found
        ok, leak = False, math.inf
        for _ in range(2):  # fresh probes once on a leak or a non-finite quotient
            q1, q2, a1, a2, ok, leak = split(x, u, k, int(rng.integers(1 << 31)), ctx)
            if ok and leak <= LEAK_TOL:
                break
        if not ok:
            return local_or_raise(a_sub, depth, "non-finite Rayleigh quotient")
        if leak > LEAK_TOL:
            return local_or_raise(a_sub, depth, f"trace leak {leak:.2e} after a basis retry")
        del a_sub, x, u, probes
        children = [RowShards(a1, k, ctx), RowShards(a2, m - k, ctx)]
        del a1, a2
        w1, v1 = rec(children.pop(0), depth + 1)
        w2, v2 = rec(children.pop(0), depth + 1)
        times = lambda q, v: sharded_matmul(q, v.local, ctx) if isinstance(v, RowShards) else q @ v
        return torch.cat([w1, w2]), RowShards(torch.cat([times(q1, v1), times(q2, v2)], dim=1), m, ctx)

    w, v = rec(RowShards(_rows_of(a, ctx), n, ctx), 0)
    if not isinstance(v, RowShards):  # the whole problem was a base case
        lo, hi = ctx.local_rows(n)
        v = RowShards(v[lo:hi], n, ctx)
    order = torch.argsort(w)
    return w[order].contiguous(), RowShards(v.local[:, order].contiguous(), n, ctx)
