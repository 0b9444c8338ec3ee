"""The port's row-sharded linear algebra on the CPU, in float64 against
float64 (tolerances about 1e-10): the blocked Cholesky, the forward and
transposed solves, the in-place trtri and lauum and the SPD inverse at a
world of one with interleave 1, 2 and 4 (the balanced schedule without
a process group), and on 2 and 4 gloo ranks against JAX's
`spd_inverse_logdet_cyclic` on a 4-device mesh, with an N that is
padded by an identity block; then the divide-and-conquer eigensolver
against JAX's and numpy's, and its trace-leak norm (a stated departure).
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


def _grm_like(n, seed=4):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 3 * n))
    return z @ z.T / (3 * n) + 0.05 * np.eye(n)


def _eigh(ctx, a, base_size):
    w, v = dc_eigen.distributed_eigh(torch.as_tensor(a), ctx, base_size=base_size)
    return w.numpy(), v.numpy()


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


@pytest.mark.parametrize("world", [2])
def test_distributed_eigh_on_gloo_ranks(world, tmp_path):
    """The sign iterations' SPD solves on the row-sharded blocked
    Cholesky (N = 50 padded inside each solve), products split by rows:
    every rank returns rank 0's eigenpairs, equal to numpy's."""
    a = _grm_like(50, seed=6)
    w_ref = np.linalg.eigvalsh(a)
    outs = run_ranks(_eigh, world, tmp_path, a, 16)
    for w, v in outs:
        _check_eigenpairs(w, v, a, w_ref)
        np.testing.assert_array_equal(v, outs[0][1])


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
    correct split's traces is far above 1e-3 in absolute terms but a
    rounding-sized share of ||A||_F, which is what the port reports."""
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
    gen = torch.Generator().manual_seed(0)
    q1, q2, a1, a2, finite, leak = dc_eigen.split(t, u, k, gen, None)
    absolute = abs(float(torch.trace(t) - torch.trace(a1) - torch.trace(a2)))
    assert finite
    assert leak == pytest.approx(absolute / float(torch.linalg.norm(t)))
    assert leak <= dc_eigen.LEAK_TOL
    assert absolute / (1.0 + abs(float(torch.trace(t)))) > dc_eigen.LEAK_TOL
    w, _ = dc_eigen.distributed_eigh(t, base_size=8)
    np.testing.assert_allclose(w.numpy(), np.sort(lam), rtol=1e-9)


def test_qdwh_coefficients_match_jax():
    from dissect_tpu.linalg.dc_eigen import qdwh_coefficients as jax_coeffs

    for l0 in (1e-6, 1e-3, 0.5):
        np.testing.assert_allclose(dc_eigen.qdwh_coefficients(l0), jax_coeffs(l0), rtol=1e-15)
    assert dc_eigen.pick_sign_block(10000, 2) == 512
