"""The port's row-sharded linear algebra on the CPU, in float64 against
float64 (tolerances about 1e-10): the blocked Cholesky, the forward and
transposed solves, the in-place trtri and lauum and the SPD inverse at a
world of one with interleave 1, 2 and 4 (the balanced schedule without
a process group), and on 2 and 4 gloo ranks against JAX's
`spd_inverse_logdet_cyclic` on a 4-device mesh, with an N that is
padded by an identity block; the row-sharded products, transpose and
Gram on uneven rows; then the divide-and-conquer eigensolver against
JAX's and numpy's on 1 to 4 ranks, its row layout (RowShards in and
out, no tensor above one rank's rows of the operand), its shifted
CholeskyQR3 on an ill-conditioned basis and its trace-leak norm (a
stated departure).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dissect_tpu_torch.linalg import dc_eigen
from dissect_tpu_torch.linalg import distributed as dl
from dissect_tpu_torch.runtime.mesh import MeshContext
from tests.test_torch_mesh_runtime import run_ranks

RTOL = 1e-10


def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, n))
    return a @ a.T + n * np.eye(n)


def _padded(a, quantum):
    """a in the top-left of an identity-padded matrix, its size a
    multiple of `quantum` (the engines' padding)."""
    n = a.shape[0]
    t = -(-n // quantum) * quantum
    out = np.eye(t)
    out[:n, :n] = a
    return out


@pytest.mark.parametrize("interleave", [1, 2, 4])
def test_blocked_factor_solves_and_inverse_at_world_one(interleave):
    n, block = 48, 4
    a = _spd(n)
    ctx = MeshContext()
    l, logdet = dl.distributed_cholesky(torch.tensor(a), ctx, block, interleave)
    np.testing.assert_allclose(float(logdet), np.linalg.slogdet(a)[1], rtol=RTOL)
    if interleave == 1:  # a plain lower-triangular factor
        np.testing.assert_allclose(l.numpy(), np.linalg.cholesky(a), rtol=RTOL, atol=1e-12)
    b = np.random.default_rng(1).standard_normal((n, 3))
    y = dl.distributed_triangular_solve(l, torch.as_tensor(b), ctx, block, interleave)
    x = dl.distributed_triangular_solve_t(l, y, ctx, block, interleave)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a, b), rtol=1e-9, atol=1e-13)
    w = dl.distributed_trtri(l.clone(), ctx, block, interleave)
    inv = dl.distributed_lauum_full(w, ctx, block, interleave)
    np.testing.assert_allclose(inv.numpy(), np.linalg.inv(a), rtol=1e-9, atol=1e-14)
    vi, ld = dl.spd_inverse_logdet_cyclic(torch.tensor(a), ctx, block)
    np.testing.assert_allclose(vi.numpy(), np.linalg.inv(a), rtol=1e-9, atol=1e-14)


def test_a_non_pd_matrix_gives_a_nan_logdet():
    a = _spd(16)
    a[3, 3] = -100.0
    _, logdet = dl.distributed_cholesky(torch.tensor(a), MeshContext(), 4)
    assert np.isnan(float(logdet))


def _sharded_inverse_and_solve(ctx, a, b, block):
    n = a.shape[0]
    r0, r1 = ctx.local_rows(n)
    vi, logdet = dl.spd_inverse_logdet_cyclic(torch.as_tensor(a[r0:r1]).clone(), ctx, block)
    x, logdet2 = dl.spd_solve_cyclic(torch.as_tensor(a[r0:r1]).clone(),
                                     torch.as_tensor(b[r0:r1]), ctx, block)
    prod = dl.sharded_matmul(torch.as_tensor(a[r0:r1]), vi, ctx)
    return vi.numpy(), float(logdet), x.numpy(), float(logdet2), prod.numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_inverse_matches_jax_on_a_4_device_mesh(world, tmp_path):
    """N = 37 identity-padded to 48 (4 devices x block 4, and 2 ranks x
    4 x 2): every rank's rows of A^-1, log|A| and A^-1 B against JAX's
    interleaved kernels on the same padded matrix."""
    import jax.numpy as jnp
    from dissect_tpu.linalg.distributed import spd_inverse_logdet_cyclic as jax_inv
    from dissect_tpu.linalg.distributed import spd_solve_cyclic as jax_solve

    block, n = 4, 37
    a = _padded(_spd(n, seed=2), 16)
    b = np.random.default_rng(3).standard_normal((a.shape[0], 2))
    b[n:] = 0.0
    jmesh = Mesh(np.array(jax.devices()[:4]), ("i",))
    jvi, jld = jax_inv(jnp.asarray(a), jmesh, "i", block)
    jx, _ = jax_solve(jnp.asarray(a), jnp.asarray(b), jmesh, "i", block)
    jvi, jx = np.asarray(jvi), np.asarray(jx)
    outs = run_ranks(_sharded_inverse_and_solve, world, tmp_path, a, b, block)
    per = a.shape[0] // world
    for r, (vi, logdet, x, logdet2, prod) in enumerate(outs):
        rows = slice(r * per, (r + 1) * per)
        np.testing.assert_allclose(vi, jvi[rows], rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose(x, jx[rows], rtol=1e-9, atol=1e-14)
        np.testing.assert_allclose([logdet, logdet2], [float(jld)] * 2, rtol=RTOL)
        np.testing.assert_allclose(prod, np.eye(a.shape[0])[rows], atol=1e-12)
    np.testing.assert_allclose(float(jld), np.linalg.slogdet(a[:n, :n])[1], rtol=RTOL)


def _row_products(ctx, a, b, c1, c2):
    n = a.shape[0]
    rows = lambda m: torch.as_tensor(m[slice(*ctx.local_rows(m.shape[0]))])
    return (dl.sharded_matmul(rows(a), rows(b), ctx).numpy(),
            dl.sharded_matmul_t(rows(a), rows(b), n, ctx).numpy(),
            dl.symmetrized(rows(a), ctx).numpy(),
            dl.gram_rows(rows(c1), rows(c2), ctx).numpy())


@pytest.mark.parametrize("world", [2, 3])
def test_row_sharded_products_on_uneven_rows(world, tmp_path):
    """N = 11 rows over 2 and 3 ranks (6/5 and 4/4/3): A B, A B^T,
    (A + A^T)/2 and the 5 x 4 Gram C1^T C2 (rows 3/2 and 2/2/1), each
    rank's rows, stacked, equal the whole products."""
    rng = np.random.default_rng(12)
    a, b = rng.standard_normal((11, 11)), rng.standard_normal((11, 11))
    c1, c2 = rng.standard_normal((11, 5)), rng.standard_normal((11, 4))
    outs = run_ranks(_row_products, world, tmp_path, a, b, c1, c2)
    for i, want in enumerate((a @ b, a @ b.T, 0.5 * (a + a.T), c1.T @ c2)):
        np.testing.assert_allclose(np.concatenate([o[i] for o in outs]), want, rtol=1e-13,
                                   atol=1e-13)


def _grm_like(n, seed=4):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 3 * n))
    return z @ z.T / (3 * n) + 0.05 * np.eye(n)


def _eigh(ctx, a, base_size):
    w, v = dc_eigen.distributed_eigh(torch.as_tensor(a), ctx, base_size=base_size)
    return w.numpy(), v.whole().numpy()


def _check_eigenpairs(w, v, a, w_ref, rtol=1e-9):
    np.testing.assert_allclose(w, w_ref, rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(v.T @ v, np.eye(len(w)), atol=1e-10)
    np.testing.assert_allclose(a @ v, v * w, atol=1e-10)


def test_distributed_eigh_matches_jax_and_numpy():
    """One rank (the local Cholesky solves) against numpy's eigh and
    JAX's distributed_eigh on a 4-device mesh: eigenvalues to 1e-9,
    eigenvectors sign-free (|V_ours^T V_jax| = I)."""
    from dissect_tpu.linalg.dc_eigen import distributed_eigh as jax_eigh

    n = 40
    a = _grm_like(n)
    w, v = _eigh(MeshContext(), a, base_size=12)
    w_ref = np.linalg.eigvalsh(a)
    _check_eigenpairs(w, v, a, w_ref)
    jw, jv = jax_eigh(a, mesh=Mesh(np.array(jax.devices()[:4]), ("i",)), base_size=12)
    np.testing.assert_allclose(w, np.asarray(jw), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(np.abs(v.T @ np.asarray(jv)), np.eye(n), atol=1e-7)


def _clustered(n, seed=9):
    """A symmetric matrix whose spectrum holds a cluster: 10 eigenvalues
    1e-5 apart at 1.0 among others spread over [0.1, 3]."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([1.0 + 1e-5 * np.arange(10), np.linspace(0.1, 3.0, n - 10)])
    a = (q * lam) @ q.T
    return 0.5 * (a + a.T)


def _eigh_both(ctx, a, b, base_size):
    return _eigh(ctx, a, base_size), _eigh(ctx, b, base_size)


@pytest.mark.parametrize("world", [2, 3, 4])
def test_distributed_eigh_on_gloo_ranks(world, tmp_path):
    """The sign iterations' SPD solves on the row-sharded blocked
    Cholesky (N = 50 and 60 padded inside each solve; 3 ranks hold
    uneven rows), every operand row-sharded: every rank holds the same
    eigenvalues and, gathered, the same eigenvectors, numpy's within
    rtol 1e-10 and |V^T V_ref| = I within 1e-8 on a clustered spectrum."""
    a, b = _grm_like(50, seed=6), _clustered(60)
    outs = run_ranks(_eigh_both, world, tmp_path, a, b, 16)
    for mat, i in ((a, 0), (b, 1)):
        w_ref, v_ref = np.linalg.eigh(mat)
        for out in outs:
            w, v = out[i]
            _check_eigenpairs(w, v, mat, w_ref)
            np.testing.assert_allclose(w, w_ref, rtol=1e-10)
            np.testing.assert_allclose(np.abs(v.T @ v_ref), np.eye(len(w)), atol=1e-8)
            np.testing.assert_array_equal(w, outs[0][i][0])
            np.testing.assert_array_equal(v, outs[0][i][1])


def test_eigenpairs_agree_across_world_sizes(tmp_path):
    """The probes do not depend on the ranks, but the Cholesky's blocking
    and the sums' order move the rounding: the converged eigenpairs of
    1, 2 and 3 ranks agree (rtol 1e-12, |V_1^T V_P| = I within 1e-8),
    not their iterates bit for bit."""
    a = _clustered(60, seed=10)
    runs = {world: run_ranks(_eigh, world, tmp_path, a, 16)[0] for world in (1, 2, 3)}
    w1, v1 = runs[1]
    for world in (2, 3):
        w, v = runs[world]
        np.testing.assert_allclose(w, w1, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(np.abs(v1.T @ v), np.eye(len(w)), atol=1e-8)


def _eigh_row_shards(ctx, a, base_size):
    from dissect_tpu_torch.model.kernels import Kernel, KernelType
    from dissect_tpu_torch.pca.pca import compute_pca
    from dissect_tpu_torch.runtime.mesh import RowShards

    n = a.shape[0]
    r0, r1 = ctx.local_rows(n)
    rows = RowShards(torch.as_tensor(a[r0:r1], dtype=torch.float32), n, ctx)
    w, v = dc_eigen.distributed_eigh(rows, ctx, base_size=base_size)
    assert isinstance(v, RowShards) and v.n == n and v.ctx is ctx
    assert v.local.shape == (r1 - r0, n) and v.dtype == torch.float64
    # the Kernel keeps them so; dense() and whole() gather; PCA's
    # diagonalized branch takes its columns to rank 0's host
    diag = Kernel("GRM", KernelType.GRM, [f"i@{j}" for j in range(n)], matrix=rows)
    diag = diag.diagonalize(mesh=ctx)
    assert isinstance(diag.eigenvectors, RowShards)
    whole = diag.whole().eigenvectors
    pca = compute_pca(diag, n_components=3)
    return (w.numpy(), v.local.numpy(), (r0, r1), diag.dense().numpy(), whole.numpy(),
            pca.eigenvectors, pca.eigenvalues)


@pytest.mark.parametrize("world", [2, 3])
def test_row_shards_in_row_shards_out(world, tmp_path):
    """A float32 GRM's RowShards go in as they lie (no rank gathers it);
    each rank gets its own rows of V back as RowShards, which stacked
    are the eigenvectors of the float32 matrix.  Kernel.diagonalize keeps
    them as RowShards, its dense() recovers the matrix, whole() gathers
    V, and the PCA of the diagonalized kernel has its top columns on
    rank 0 only."""
    a = _grm_like(50, seed=7).astype(np.float32).astype(np.float64)
    w_ref = np.linalg.eigvalsh(a)
    outs = run_ranks(_eigh_row_shards, world, tmp_path, a, 16)
    v = np.concatenate([out[1] for out in outs])
    assert [out[2] for out in outs] == [MeshContext(rank=r, world=world).local_rows(50)
                                        for r in range(world)]
    for rank, (w, _, _, dense, whole, pca_v, pca_w) in enumerate(outs):
        _check_eigenpairs(w, v, a, w_ref)
        np.testing.assert_allclose(dense, a, rtol=1e-10, atol=1e-12)
        np.testing.assert_array_equal(whole, outs[0][4])
        _check_eigenpairs(w, whole, a, w_ref)
        np.testing.assert_allclose(pca_w, w_ref[::-1][:3], rtol=1e-10)
        if rank == 0:
            np.testing.assert_array_equal(pca_v, whole[:, ::-1][:, :3])
        else:
            assert pca_v is None


def _largest_tensor(ctx, a, base_size):
    """The most elements of any tensor an op creates on this rank inside
    distributed_eigh, the input rows given as RowShards beforehand."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from dissect_tpu_torch.runtime.mesh import RowShards

    class Largest(TorchDispatchMode):
        most = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    Largest.most = max(Largest.most, t.numel())
            return out

    r0, r1 = ctx.local_rows(a.shape[0])
    rows = RowShards(torch.as_tensor(a[r0:r1]).clone(), a.shape[0], ctx)
    with Largest():
        w, v = dc_eigen.distributed_eigh(rows, ctx, base_size=base_size)
    return Largest.most, w.numpy(), v.whole().numpy()


@pytest.mark.parametrize("world", [2, 3])
def test_no_rank_holds_a_whole_operand(world, tmp_path):
    """The CPU stand-in for the card's per-rank peak: at m = 96 and
    base_size 16 no tensor that an op creates on a rank inside
    distributed_eigh has more than ceil(m / P) m elements (one rank's
    rows of an m x m operand, the size of the one broadcast block too),
    and the eigenpairs are numpy's."""
    m = 96
    a = _clustered(m, seed=11)
    outs = run_ranks(_largest_tensor, world, tmp_path, a, 16)
    for most, w, v in outs:
        assert 0 < most <= -(-m // world) * m, most
        _check_eigenpairs(w, v, a, np.linalg.eigvalsh(a))


def _orthonormalized(ctx, y):
    """orthonormalize on this rank's rows of y and of y with one NaN,
    with the shift of every CholeskyQR round it ran and whether the
    round failed."""
    rounds = []
    plain = dc_eigen._cholesky_qr_round

    def spied(q, ctx, shift=0.0):
        out = plain(q, ctx, shift)
        rounds.append((shift, out is None))
        return out

    dc_eigen._cholesky_qr_round = spied
    lo, hi = ctx.local_rows(y.shape[0])
    q = dc_eigen.orthonormalize(torch.as_tensor(y[lo:hi]), y.shape[0], ctx)
    shown = list(rounds)
    broken = y.copy()
    broken[5, 3] = np.nan
    q_nan = dc_eigen.orthonormalize(torch.as_tensor(broken[lo:hi]), y.shape[0], ctx)
    return shown, q.numpy(), q_nan.numpy()


@pytest.mark.parametrize("world", [1, 2, 3])
def test_shifted_cholesky_qr3_orthonormalizes_an_ill_conditioned_basis(world, tmp_path):
    """A (60, 12) Y of condition number 1e10: the plain CholeskyQR2's
    first Cholesky fails (Y^T Y's condition is 1e20), so the shifted
    round (s = 11 (m k + k (k + 1)) eps ||Y||_F^2) runs, then two plain
    ones, and the row-sharded Q spans Y with ||Q^T Q - I||_F <= 1e-12.
    A Y with a NaN fails every round and comes back all NaN."""
    rng = np.random.default_rng(3)
    m, k = 60, 12
    u, _ = np.linalg.qr(rng.standard_normal((m, k)))
    v, _ = np.linalg.qr(rng.standard_normal((k, k)))
    y = (u * np.logspace(0, -10, k)) @ v.T
    assert np.linalg.cond(y) == pytest.approx(1e10, rel=1e-3)
    shift = 11.0 * (m * k + k * (k + 1)) * np.finfo(np.float64).eps * np.sum(y * y)
    outs = run_ranks(_orthonormalized, world, tmp_path, y)
    for rounds, _, _ in outs:
        assert rounds[0] == (0.0, True)
        assert rounds[1][0] == pytest.approx(shift, rel=1e-12) and not rounds[1][1]
        assert rounds[2:] == [(0.0, False), (0.0, False)]
    q = np.concatenate([out[1] for out in outs])
    assert np.linalg.norm(q.T @ q - np.eye(k)) <= 1e-12
    np.testing.assert_allclose(q @ (q.T @ y), y, rtol=0, atol=1e-12)
    assert all(np.isnan(out[2]).all() for out in outs)


def _eigh_or_error(ctx, a):
    try:
        w, _ = dc_eigen.distributed_eigh(torch.as_tensor(a), ctx, base_size=8)
    except RuntimeError as err:
        return str(err)
    return w.numpy()


@pytest.mark.parametrize("world", [1, 2])
def test_a_failed_split_raises_on_more_than_one_rank(world, tmp_path):
    """3 I above base_size: no shift splits a spectrum of one repeated
    eigenvalue.  On two ranks distributed_eigh raises (the reference
    aborts); one rank solves it with a local eigh."""
    outs = run_ranks(_eigh_or_error, world, tmp_path, 3.0 * np.eye(24))
    for out in outs:
        if world == 1:
            np.testing.assert_allclose(out, np.full(24, 3.0), rtol=1e-12)
        else:
            assert "no valid spectral split for a 24 x 24 subproblem at depth 0" in out


def test_trace_leak_is_normalized_by_the_frobenius_norm():
    """Departure (ADVICE.md, dissect_tpu/linalg/dc_eigen.py:510): on a
    sign-balanced spectrum tr(A) ~ 0, so JAX's 1 + |tr A| makes the leak
    an absolute number.  At |lambda| ~ 1e14 the float64 rounding of a
    correct split's traces reaches their ulp (0.5 here), far above 1e-3
    in absolute terms (it may round to 0 for one probe draw, so five
    splits are drawn), but a rounding-sized share of ||A||_F, which is
    what the port reports."""
    rng = np.random.default_rng(8)
    n = 32
    q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = 1e14 * np.concatenate([np.linspace(1, 2, n // 2), -np.linspace(1, 2, n // 2)])
    a = (q * lam) @ q.T
    a = 0.5 * (a + a.T)
    t = torch.as_tensor(a)
    u = dc_eigen.matrix_sign(t)
    k = int(round((n - float(torch.trace(u))) / 2))
    assert k == n // 2
    jax_leaks = []
    for seed in range(5):
        q1, q2, a1, a2, finite, leak = dc_eigen.split(t, u, k, seed, None)
        absolute = abs(float(torch.trace(t) - torch.trace(a1) - torch.trace(a2)))
        assert finite
        assert leak == pytest.approx(absolute / float(torch.linalg.norm(t)))
        assert leak <= dc_eigen.LEAK_TOL
        jax_leaks.append(absolute / (1.0 + abs(float(torch.trace(t)))))
    assert max(jax_leaks) > dc_eigen.LEAK_TOL
    w, _ = dc_eigen.distributed_eigh(t, base_size=8)
    np.testing.assert_allclose(w.numpy(), np.sort(lam), rtol=1e-9)


def test_qdwh_coefficients_match_jax():
    from dissect_tpu.linalg.dc_eigen import qdwh_coefficients as jax_coeffs

    for l0 in (1e-6, 1e-3, 0.5):
        np.testing.assert_allclose(dc_eigen.qdwh_coefficients(l0), jax_coeffs(l0), rtol=1e-15)
    assert dc_eigen.pick_sign_block(10000, 2) == 512
