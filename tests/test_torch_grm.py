"""The port's GRM pieces (dissect_tpu_torch.linalg, model.kernels) held
against the JAX package on the CPU.

The JAX side of kernel K1 runs its Pallas kernel in interpret mode; the
port's side runs the plain version, which its wrapper takes for CPU
tensors.  Both build the GRM in float32, so products agree to float32
rounding of differently ordered sums (rtol 2e-5 on the tiles, the
tolerance tests/test_native_sharding.py uses for the same kernel), and
the O'O counts are sums of 0/1 products, exact in float32: compared
exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.io.bed import read_plink as jax_read_plink
from dissect_tpu.linalg import pallas_syrk as jax_pallas
from dissect_tpu.linalg.syrk import grm_accumulator as jax_grm_accumulator
from dissect_tpu.model.kernels import grm_from_plink as jax_grm_from_plink
from dissect_tpu_torch.convert import grm_accumulator_from_packed
from dissect_tpu_torch.io.bed import read_plink
from dissect_tpu_torch.linalg import grm_kernels
from dissect_tpu_torch.linalg.syrk import grm_accumulator, standardize_chunk
from dissect_tpu_torch.model.kernels import grm_from_plink
from tests.conftest import make_dosage, make_plink

N, M, CHUNK = 72, 96, 32  # tests/test_native_sharding.py:129-155


def _stats(d):
    p2 = np.clip(np.where(d >= 0, d, 0).sum(1) / (2.0 * (d >= 0).sum(1)), 0.05, 0.95)
    return 2.0 * p2, 1.0 / np.sqrt(2.0 * p2 * (1.0 - p2))


@pytest.fixture
def chunked(rng):
    d = make_dosage(rng, M, N, missing_rate=0.05)
    mean, inv_std = _stats(d)
    return d, mean.astype(np.float32), inv_std.astype(np.float32)


def test_pair_maps_and_packed_shape_match_jax():
    for nt in (1, 2, 5):
        pairs, imap, jmap = grm_kernels._pair_maps(nt)
        jpairs, jimap, jjmap = jax_pallas._pair_maps(nt)
        assert pairs == jpairs
        np.testing.assert_array_equal(imap, jimap)
        np.testing.assert_array_equal(jmap, jjmap)
    for n, bn in ((72, 16), (10000, 512), (512, 512), (5, 512)):
        assert grm_kernels.packed_shape(n, bn) == jax_pallas.packed_shape(n, bn)


@pytest.mark.parametrize("block_n", [16, 32])
def test_plain_k1_matches_jax_interpret(chunked, block_n):
    """K1's plain version, through its wrapper on CPU tensors, against
    the Pallas kernel in interpret mode, chunk by chunk, at the same
    block_n: packed tiles at rtol 2e-5, counts exactly."""
    d, mean, inv_std = chunked
    shape = grm_kernels.packed_shape(N, block_n)
    jk = jnp.zeros(shape, jnp.float32)
    jc = jnp.zeros(shape, jnp.float32)
    tk = torch.zeros(shape, dtype=torch.float32)
    tc = torch.zeros(shape, dtype=torch.float32)
    for s in range(0, M, CHUNK):
        sl = slice(s, s + CHUNK)
        jk, jc = jax_pallas.grm_fused_triangle_update(
            jnp.asarray(d[sl]), jnp.asarray(mean[sl]), jnp.asarray(inv_std[sl]),
            jk, jc, block_n=block_n, block_m=16, interpret=True,
            compute_dtype=jnp.float32,
        )
        out_k, out_c = grm_kernels.grm_fused_triangle_update(
            torch.as_tensor(d[sl]), torch.as_tensor(mean[sl]),
            torch.as_tensor(inv_std[sl]), tk, tc, block_n=block_n,
        )
        assert out_k is tk and out_c is tc  # updated in place
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_unpack_triangle_matches_jax(rng):
    n, bn = 45, 16
    tiles = rng.normal(size=grm_kernels.packed_shape(n, bn)).astype(np.float32)
    ours = grm_kernels.unpack_triangle(torch.as_tensor(tiles), n, bn)
    theirs = jax_pallas.unpack_triangle(jnp.asarray(tiles), n, bn)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_pack_triangle_inverts_unpack(rng):
    n, bn = 40, 16
    a = rng.normal(size=(n, n))
    sym = torch.as_tensor(a + a.T)
    packed = grm_kernels.pack_triangle(sym, bn)
    assert tuple(packed.shape) == grm_kernels.packed_shape(n, bn)
    np.testing.assert_array_equal(grm_kernels.unpack_triangle(packed, n, bn).numpy(), sym.numpy())


@pytest.mark.parametrize("block_n", [16, 512])
def test_accumulator_matches_jax_xla(chunked, block_n):
    """The port's packed accumulator + unpack against the JAX dense XLA
    accumulator (the path the JAX CLI runs)."""
    d, mean, inv_std = chunked
    ours = grm_accumulator(N, device="cpu", block_n=block_n)
    ref = jax_grm_accumulator(N, dtype=jnp.float32)
    for s in range(0, M, CHUNK):
        sl = slice(s, s + CHUNK)
        ours.update(d[sl], mean[sl], inv_std[sl])
        ref.update(d[sl], mean[sl], inv_std[sl])
    k, c = ours.finalize()
    k_ref, c_ref = ref.finalize()
    np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_accumulator_resumes_from_jax_packed_state(chunked):
    """convert.grm_accumulator_from_packed: JAX's packed tiles after two
    chunks, then the port streams the rest; equals one port run."""
    d, mean, inv_std = chunked
    bn = 16
    shape = grm_kernels.packed_shape(N, bn)
    jk = jnp.zeros(shape, jnp.float32)
    jc = jnp.zeros(shape, jnp.float32)
    for s in (0, CHUNK):
        sl = slice(s, s + CHUNK)
        jk, jc = jax_pallas.grm_fused_triangle_update(
            jnp.asarray(d[sl]), jnp.asarray(mean[sl]), jnp.asarray(inv_std[sl]),
            jk, jc, block_n=bn, block_m=16, interpret=True, compute_dtype=jnp.float32,
        )
    resumed = grm_accumulator_from_packed(np.asarray(jk), np.asarray(jc), N, bn, device="cpu")
    whole = grm_accumulator(N, device="cpu", block_n=bn)
    for s in range(0, M, CHUNK):
        sl = slice(s, s + CHUNK)
        whole.update(d[sl], mean[sl], inv_std[sl])
        if s >= 2 * CHUNK:
            resumed.update(d[sl], mean[sl], inv_std[sl])
    (k1, c1), (k2, c2) = resumed.finalize(), whole.finalize()
    np.testing.assert_allclose(k1.numpy(), k2.numpy(), rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    with pytest.raises(ValueError):
        grm_accumulator_from_packed(np.zeros((3, 3)), np.zeros((3, 3)), N, bn, device="cpu")


def test_standardize_chunk_matches_jax(chunked):
    from dissect_tpu.linalg.syrk import standardize_chunk as jax_standardize

    d, mean, inv_std = chunked
    z, o = standardize_chunk(torch.as_tensor(d), torch.as_tensor(mean),
                             torch.as_tensor(inv_std), torch.float32)
    jz, jo = jax_standardize(jnp.asarray(d), jnp.asarray(mean), jnp.asarray(inv_std), jnp.float32)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))


@pytest.mark.parametrize("chunk_size", [2048, 40, 33])
def test_grm_from_plink_matches_jax(tmp_path, rng, chunk_size):
    """The whole --make-grm build, ragged last chunk included: kernel at
    rtol 1e-6 (the golden .grm.dat tolerance), counts exactly."""
    d = make_dosage(rng, 100, 60, missing_rate=0.03)
    prefix, _ = make_plink(tmp_path, d)
    ours = grm_from_plink(read_plink(prefix), chunk_size=chunk_size, device="cpu")
    ref = jax_grm_from_plink(jax_read_plink(prefix), chunk_size=chunk_size)
    assert ours.individual_keys == ref.individual_keys
    assert ours.snp_names == ref.snp_names
    assert ours.matrix.dtype == torch.float32
    np.testing.assert_allclose(ours.matrix.numpy(), np.asarray(ref.matrix), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))


def test_grm_from_plink_rejects_monomorphic(tmp_path, rng):
    d = make_dosage(rng, 20, 30)
    d[3] = 0
    prefix, _ = make_plink(tmp_path, d)
    with pytest.raises(ValueError, match="monomorphic"):
        grm_from_plink(read_plink(prefix), device="cpu")
    kept = grm_from_plink(read_plink(prefix), drop_monomorphic=True, device="cpu")
    assert "snp3" not in kept.snp_names and len(kept.snp_names) == 19


def test_k1_wrapper_refuses_other_devices(chunked):
    """Only a CPU tensor takes the plain version: any other device gets
    the kernel or an error, never a silent fallback — for K1 and for K2,
    the float (imputed) GRM kernel."""
    d, mean, inv_std = chunked
    shape = grm_kernels.packed_shape(N, 16)
    meta = lambda a: torch.as_tensor(a).to("meta")
    with pytest.raises(ValueError, match="no GRM kernel"):
        grm_kernels.grm_fused_triangle_update(
            meta(d), meta(mean), meta(inv_std),
            torch.zeros(shape, device="meta"), torch.zeros(shape, device="meta"), block_n=16,
        )
    with pytest.raises(ValueError, match="no syrk_triangle_packed kernel"):
        grm_kernels.syrk_triangle_packed(meta(d.astype(np.float32)), block_n=16)
    launches = (grm_kernels.grm_fused_triangle_update.launches,
                grm_kernels.syrk_triangle_packed.launches)
    assert launches == (0, 0), "a refused call must not count as a launch"


def _k1_coverage(n, bn):
    """How often K1's work list adds to each entry of each packed tile,
    per product, mirrored items counted at their transposed entries."""
    items = grm_kernels.grm_work_items(n, bn)
    n_tiles = grm_kernels.packed_shape(n, bn)[0] // bn
    ts = grm_kernels.K1_SUB_TILE
    cover = np.zeros((2, n_tiles, bn, bn), dtype=np.int8)
    for t, _, _, a0, b0, role, mirror, _ in items:
        cover[role, t, a0:a0 + ts, b0:b0 + ts] += 1
        if mirror:
            cover[role, t, b0:b0 + ts, a0:a0 + ts] += 1
    return items, cover


@pytest.mark.parametrize("n, bn", [(10_000, 512), (1000, 512), (1000, 200), (1008, 256),
                                   (72, 16), (5, 512), (300, 256)])
def test_k1_work_items_cover_every_entry_once(n, bn):
    """Every entry of every packed tile that lies inside the n x n matrix is
    added exactly once by each product (Z^T Z and the counts); entries past
    n at most once (they add zeros); no item lies wholly past n; mirrors
    only on diagonal tiles, strictly below the diagonal sub-tile; the
    Z^T Z items first."""
    items, cover = _k1_coverage(n, bn)
    _, imap, jmap = grm_kernels._pair_maps(-(-n // bn))
    rows = imap[:, None] * bn + np.arange(bn)[None, :]  # (T, bn) individual index
    cols = jmap[:, None] * bn + np.arange(bn)[None, :]
    inside = (rows[:, :, None] < n) & (cols[:, None, :] < n)
    for role in (grm_kernels.K1_ROLE_Z, grm_kernels.K1_ROLE_COUNTS):
        assert (cover[role][inside] == 1).all()
        assert (cover[role][~inside] <= 1).all()
    t, ti, tj, a0, b0, role, mirror = items[:, :7].T
    assert ((ti * bn + a0 < n) & (tj * bn + b0 < n)).all()
    np.testing.assert_array_equal(imap[t], ti)
    np.testing.assert_array_equal(jmap[t], tj)
    assert (mirror == ((ti == tj) & (a0 > b0))).all()
    assert not ((ti == tj) & (a0 < b0)).any()
    half = len(items) // 2  # the long Z^T Z items first, then the counts
    assert (role[:half] == grm_kernels.K1_ROLE_Z).all()
    assert (role[half:] == grm_kernels.K1_ROLE_COUNTS).all()


@pytest.mark.parametrize("m", [1, 31, 32, 33, 777, 848, 2048])
def test_k1_stages_cover_every_row_once(m):
    """The kernel walks `grm_stages(m)` stages of 32 rows: every row of the
    chunk once, no stage wholly past it (the last one ragged, masked)."""
    rows = np.arange(grm_kernels.grm_stages(m) * grm_kernels.K1_ROWS_PER_STAGE)
    assert (rows < m).sum() == m
    assert rows[-grm_kernels.K1_ROWS_PER_STAGE] < m


@pytest.mark.parametrize("n, bn", [(300, 256), (1000, 200), (72, 16)])
def test_k1_work_items_emulated_equal_plain(rng, n, bn):
    """The work list run in numpy as the kernel runs it (each item's
    128 x 128 block of Z^T Z or O^T O added, mirrors transposed) gives the
    plain version's packed buffers: counts exactly, products to float32
    rounding."""
    d = make_dosage(rng, 40, n, missing_rate=0.05)
    mean, inv_std = (a.astype(np.float32) for a in _stats(d))
    shape = grm_kernels.packed_shape(n, bn)
    k0 = rng.normal(size=shape).astype(np.float32)
    c0 = np.floor(rng.uniform(0, 50, size=shape)).astype(np.float32)
    k_plain, c_plain = grm_kernels.plain_grm_fused_triangle_update(
        torch.as_tensor(d), torch.as_tensor(mean), torch.as_tensor(inv_std),
        torch.as_tensor(k0.copy()), torch.as_tensor(c0.copy()), block_n=bn)
    z, o = standardize_chunk(torch.as_tensor(d), torch.as_tensor(mean),
                             torch.as_tensor(inv_std), torch.float32)
    ts = grm_kernels.K1_SUB_TILE
    width = (-(-n // bn)) * bn + ts  # zero columns past n, and past the last sub-tile
    ops = [np.zeros((40, width)), np.zeros((40, width))]
    ops[0][:, :n], ops[1][:, :n] = z.numpy(), o.numpy()
    out = [k0.astype(np.float64).reshape(-1, bn, bn), c0.astype(np.float64).reshape(-1, bn, bn)]
    for t, ti, tj, a0, b0, role, mirror, _ in grm_kernels.grm_work_items(n, bn):
        ci0, cj0 = ti * bn + a0, tj * bn + b0
        ra, rb = min(ts, bn - a0), min(ts, bn - b0)  # the tile's edge
        block = (ops[role][:, ci0:ci0 + ts].T @ ops[role][:, cj0:cj0 + ts])[:ra, :rb]
        out[role][t, a0:a0 + ra, b0:b0 + rb] += block
        if mirror:
            out[role][t, b0:b0 + rb, a0:a0 + ra] += block.T
    np.testing.assert_allclose(out[0].reshape(shape), k_plain.numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(out[1].reshape(shape), c_plain.numpy())
