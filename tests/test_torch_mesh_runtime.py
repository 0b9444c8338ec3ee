"""The port's multi-rank runtime on the CPU: the --mesh grammar and the
`use_distributed` decisions against the JAX package's (on the 8 virtual
CPU devices of tests/conftest.py), the SNP-row shards against JAX's,
the collectives on gloo ranks, and the failure rules: a rank that
raises, or a backend that cannot start, ends every rank with an error
instead of a hang.

Ranks are gloo processes started with `torch.multiprocessing` (spawn)
by `run_ranks`, which the other tests/test_torch_mesh_*.py files share;
each launch has its own file store under tmp_path and its own timeout.
"""

import datetime
import os
import queue
import socket
import traceback

import numpy as np
import pytest
import torch

from dissect_tpu_torch.runtime import distributed, distributed_io, mesh
from dissect_tpu_torch.runtime.mesh import MeshContext

RANK_TIMEOUT_S = 120


def _rank_entry(fn, rank, world, store, args, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group(
            "gloo", init_method="file://" + store, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S),
        )
        ctx = MeshContext(rank=rank, world=world, device=torch.device("cpu"),
                          shape=mesh.near_square_factors(world), backend="gloo")
        q.put((rank, "ok", fn(ctx, *args)))
    except BaseException:  # reported to the parent, which fails the test
        q.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, timeout=RANK_TIMEOUT_S):
    """fn(ctx, *args) on `world` gloo ranks; returns rank-ordered results.
    A rank that raises, hangs or dies fails the calling test."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    q = spawn.Queue()
    store = str(tmp_path / f"store_{fn.__name__}_{world}_{os.getpid()}")
    procs = [spawn.Process(target=_rank_entry, args=(fn, r, world, store, args, q))
             for r in range(world)]
    for p in procs:
        p.start()
    out = {}
    try:
        for _ in range(world):
            rank, status, payload = q.get(timeout=timeout)
            if status != "ok":
                raise AssertionError(f"rank {rank} failed:\n{payload}")
            out[rank] = payload
    except queue.Empty:
        raise AssertionError(f"ranks timed out after {timeout} s") from None
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    return [out[r] for r in range(world)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# --- the --mesh grammar and use_distributed --------------------------------------

@pytest.mark.parametrize("spec", ["auto", "none", "2x4", "4", "8", "4x4", "3x2"])
def test_mesh_spec_parsing(spec):
    """Against dissect_tpu's parse_mesh_spec on 8 devices: the port,
    launched with as many ranks as JAX takes devices, builds the same
    grid; where JAX raises (more devices than visible), the port raises
    at 8 ranks; 'none' is None on both."""
    from dissect_tpu.runtime.distributed import parse_mesh_spec as jax_parse
    from dissect_tpu.runtime.mesh import set_mesh_context as jax_set

    try:
        theirs = jax_parse(spec)
    except ValueError:
        theirs = "error"
    finally:
        jax_set(None)
    if theirs == "error":
        with pytest.raises(ValueError):
            distributed.parse_mesh_spec(spec, 8)
    elif theirs is None:
        assert distributed.parse_mesh_spec(spec, 8) is None
    else:
        world = theirs.n_devices
        assert distributed.parse_mesh_spec(spec, world) == tuple(theirs.mesh.devices.shape)
        if spec != "auto":  # a launch is exactly its ranks
            with pytest.raises(ValueError):
                distributed.parse_mesh_spec(spec, world + 1)


def test_mesh_beyond_one_rank_outside_torchrun_names_torchrun(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torch.distributed.run --nproc-per-node 4"):
        distributed.startup_runtime("2x2", torch.device("cpu"))
    for spec in ("auto", "1", "1x1"):
        ctx = distributed.startup_runtime(spec, torch.device("cpu"))
        assert ctx.world == 1 and ctx.backend is None
    assert distributed.startup_runtime("none", torch.device("cpu")) is None
    distributed.shutdown_runtime()


class _Args:
    def __init__(self, **kw):
        self.force_distributed = False
        self.distributed_threshold = 16384
        self.__dict__.update(kw)


@pytest.mark.parametrize("n, force, force_flag, threshold", [
    (100, False, False, 16384),
    (100, True, False, 16384),
    (100, False, True, 16384),
    (20000, False, False, 16384),
    (100, False, False, 50),
])
def test_use_distributed_decisions_match_jax(n, force, force_flag, threshold):
    from dissect_tpu.runtime.distributed import use_distributed as jax_use
    from dissect_tpu.runtime.mesh import MeshContext as JaxMesh
    from dissect_tpu.runtime.mesh import set_mesh_context as jax_set

    args = _Args(force_distributed=force_flag, distributed_threshold=threshold)
    jax_set(JaxMesh.create())
    try:
        theirs = jax_use(args, n, force=force) is not None
    finally:
        jax_set(None)
    mesh.set_mesh_context(MeshContext(world=8, backend="gloo"))
    try:
        ours = distributed.use_distributed(args, n, force=force) is not None
    finally:
        mesh.set_mesh_context(None)
    assert ours == theirs


def test_one_device_keeps_the_float64_engine():
    """Departure: JAX's allow_single_device routes a big REML on ONE
    accelerator through its sharded engine for that engine's float64
    endgame; every port fit is float64 from its first iteration, so a
    one-rank run above the threshold keeps the single-device engine."""
    from dissect_tpu_torch.io.phenotype import Phenotype
    from dissect_tpu_torch.model.kernels import Kernel, KernelType
    from dissect_tpu_torch.reml.engine import REMLEngine
    from dissect_tpu_torch.reml.single import SingleREML

    args = _Args(distributed_threshold=10)
    mesh.set_mesh_context(MeshContext(world=1))
    try:
        assert distributed.use_distributed(args, 10 ** 6) is None
    finally:
        mesh.set_mesh_context(None)
    rng = np.random.default_rng(3)
    n = 24
    z = rng.normal(size=(n, 40))
    keys = [f"F{i}@I{i}" for i in range(n)]
    kern = Kernel(name="GRM", type=KernelType.GRM, individual_keys=keys,
                  matrix=torch.as_tensor(z @ z.T / 40))
    sreml = SingleREML([kern], Phenotype(keys=keys, values=rng.normal(size=n), column=1),
                       device="cpu", mesh=MeshContext(world=1))
    sreml.compute(compute_blue=False)
    assert type(sreml.engine) is REMLEngine


# --- SNP-row shards ----------------------------------------------------------------

@pytest.mark.parametrize("m, count", [(10, 3), (7, 8), (64, 8), (1, 4)])
def test_snp_shard_bounds_match_jax(m, count):
    from dissect_tpu.runtime.distributed_io import snp_shard_bounds as jax_bounds

    for r in range(count):
        assert distributed_io.snp_shard_bounds(m, r, count) == jax_bounds(m, r, count)


@pytest.mark.parametrize("m, world", [(10, 4), (8, 4), (3, 4), (13, 8)])
def test_shard_snp_rows_match_jax(m, world):
    """Each rank's rows equal its block of JAX's padded, mesh-sharded
    array (the last row repeated up to a multiple of the devices)."""
    import jax

    from dissect_tpu.runtime.distributed_io import shard_snp_rows as jax_shard
    from dissect_tpu.runtime.mesh import MeshContext as JaxMesh

    z = np.arange(m * 3, dtype=np.float64).reshape(m, 3)
    theirs, m_jax = jax_shard(z, JaxMesh.create(jax.devices()[:world]))
    full = np.asarray(theirs)
    per = full.shape[0] // world
    for r in range(world):
        ours, m_ours = distributed_io.shard_snp_rows(z, MeshContext(rank=r, world=world))
        assert m_ours == m_jax == m
        np.testing.assert_array_equal(ours, full[r * per:(r + 1) * per])
        t, _ = distributed_io.shard_snp_rows(torch.as_tensor(z), MeshContext(rank=r, world=world))
        np.testing.assert_array_equal(t.numpy(), ours)


# --- collectives on gloo ranks -------------------------------------------------------

def _collectives(ctx):
    t = torch.full((3,), float(ctx.rank + 1), dtype=torch.float64)
    b = ctx.broadcast(t.clone(), ctx.world - 1)
    s = ctx.all_reduce(t.clone())
    g = ctx.all_gather(t[None].clone())
    rows = ctx.all_gather_rows(torch.arange(*ctx.local_rows(7), dtype=torch.float64), 7)
    obj = ctx.all_gather_object({"rank": ctx.rank, "names": ["a"] * ctx.rank})
    local = np.arange(ctx.rank * 2, ctx.rank * 2 + 2, dtype=np.float64)
    host = distributed_io.to_host(local, 2 * ctx.world - 1, ctx)
    return b.numpy(), s.numpy(), g.numpy(), rows.numpy(), obj, host


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_on_gloo_ranks(world, tmp_path):
    for b, s, g, rows, obj, host in run_ranks(_collectives, world, tmp_path):
        np.testing.assert_array_equal(b, np.full(3, float(world)))
        np.testing.assert_array_equal(s, np.full(3, world * (world + 1) / 2))
        np.testing.assert_array_equal(g[:, 0], np.arange(1, world + 1))
        np.testing.assert_array_equal(rows, np.arange(7))
        assert obj == [{"rank": r, "names": ["a"] * r} for r in range(world)]
        np.testing.assert_array_equal(host, np.arange(2 * world - 1))


def _scattered_rows(ctx):
    """reduce_scatter_rows of 7 uneven rows (rank r's term of every row i
    is (r + 1) (i + 1)); then RowShards.to_root_host."""
    n = 7
    blocks = [float(ctx.rank + 1) * torch.arange(lo + 1, hi + 1, dtype=torch.float64)[:, None]
              .expand(hi - lo, 3).contiguous() for lo, hi in ctx.row_bounds(n)]
    mine = ctx.reduce_scatter_rows(blocks)
    whole = torch.arange(4.0 * n, dtype=torch.float64).reshape(n, 4)
    host = mesh.RowShards(whole[slice(*ctx.local_rows(n))], n, ctx).to_root_host()
    return mine.numpy(), host


@pytest.mark.parametrize("world", [2, 3])
def test_reduce_scatter_rows_and_to_root_host(world, tmp_path):
    """Each rank gets its rows (4/3 and 3/3/1 of 7) of the sum over the
    ranks, by gloo's reduce-scatter; to_root_host gives rank 0 the whole
    matrix and the other ranks None."""
    for rank, (mine, host) in enumerate(run_ranks(_scattered_rows, world, tmp_path)):
        lo, hi = MeshContext(rank=rank, world=world).local_rows(7)
        want = world * (world + 1) / 2 * np.arange(lo + 1, hi + 1, dtype=np.float64)
        np.testing.assert_array_equal(mine, np.repeat(want[:, None], 3, axis=1))
        if rank == 0:
            np.testing.assert_array_equal(host, np.arange(28.0).reshape(7, 4))
        else:
            assert host is None


# --- failures stop every rank ---------------------------------------------------

def _cli_rank(rank, world, port, argv, q):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      DISSECT_TPU_TORCH_DEVICE="cpu")
    torch.set_num_threads(1)
    from dissect_tpu_torch.analysis.dispatcher import main

    try:
        main(argv[rank])
        q.put((rank, "ok", None))
    except BaseException as exc:  # the rank's own failure, or its peer's
        q.put((rank, "error", repr(exc)))


def _sharded_kernel_ops(ctx, a, counts, keep, rows, cols):
    """Every row-shard-aware Kernel transform on a kernel whose matrix and
    counts are RowShards of (a, counts), gathered for comparison."""
    from dissect_tpu_torch.model.kernels import Kernel, KernelType

    n = a.shape[0]
    r0, r1 = ctx.local_rows(n)
    keys = [f"i@{j}" for j in range(n)]
    shards = lambda m: mesh.RowShards(torch.as_tensor(m[r0:r1]), n, ctx)
    k = Kernel("GRM", KernelType.GRM, keys, matrix=shards(a), counts=shards(counts))
    low = counts.copy()
    low[3, 5] = low[5, 3] = 1.0  # one pair with too few shared SNPs
    k_low = Kernel("GRM", KernelType.GRM, keys, matrix=shards(a), counts=shards(low))
    f = k.filter_individuals([keys[i] for i in keep])
    e = k.epistatic()
    pruned = k.prune(0.3)
    return {
        "filtered": (f.sharded, f.dense().numpy(), f.counts.whole().numpy(), f.individual_keys),
        "epistatic": (e.sharded, e.dense().numpy()),
        "kept_by_sanitize": k.sanitize(0.1) is k,
        "sanitized": k_low.sanitize(0.1).individual_keys,
        "kept_by_prune": k.prune(10.0) is k,
        "pruned": (pruned.sharded, pruned.individual_keys),
        "take": [t.numpy() for t in k.matrix.take([(rows, cols), (rows[::-1].copy(), None)])],
    }


@pytest.mark.parametrize("world", [2, 3])
def test_a_row_sharded_kernel_transforms_as_the_whole_one(world, tmp_path):
    """A GRM held as RowShards over 2 and 3 gloo ranks (n = 10, shards of
    5/5 and 4/4/2 rows): filtering to a reordered subset stays sharded
    and equals the whole kernel's filter; K .* K stays sharded; sanitize
    and prune return the kernel itself when nothing is dropped and the
    whole kernel's result otherwise; `take` fetches any rows and columns.
    Exact: only copies."""
    from dissect_tpu_torch.model.kernels import Kernel, KernelType

    rng = np.random.default_rng(11)
    n = 10
    z = rng.standard_normal((n, 40))
    a = (z @ z.T / 40).astype(np.float32)
    counts = np.full((n, n), 40.0, dtype=np.float32)
    keep = [7, 1, 2, 9, 4, 0]
    rows, cols = np.array([9, 0, 4, 4]), np.array([2, 8, 1])
    keys = [f"i@{j}" for j in range(n)]
    whole = Kernel("GRM", KernelType.GRM, keys, matrix=torch.as_tensor(a),
                   counts=torch.as_tensor(counts))
    want_f = whole.filter_individuals([keys[i] for i in keep])
    low = counts.copy()
    low[3, 5] = low[5, 3] = 1.0
    want_sanitized = Kernel("GRM", KernelType.GRM, keys, matrix=torch.as_tensor(a),
                            counts=torch.as_tensor(low)).sanitize(0.1).individual_keys
    assert len(want_sanitized) == n - 1
    want_pruned = whole.prune(0.3).individual_keys
    assert len(want_pruned) < n
    for out in run_ranks(_sharded_kernel_ops, world, tmp_path, a, counts, keep, rows, cols):
        sharded, fm, fc, fkeys = out["filtered"]
        assert sharded and fkeys == want_f.individual_keys
        np.testing.assert_array_equal(fm, want_f.matrix.numpy())
        np.testing.assert_array_equal(fc, want_f.counts.numpy())
        assert out["epistatic"][0]
        np.testing.assert_array_equal(out["epistatic"][1], a * a)
        assert out["kept_by_sanitize"] and out["sanitized"] == want_sanitized
        assert out["kept_by_prune"] and out["pruned"] == (False, want_pruned)
        np.testing.assert_array_equal(out["take"][0], a[rows][:, cols])
        np.testing.assert_array_equal(out["take"][1], a[rows[::-1]])


def test_a_failed_rank_stops_the_launch(tmp_path):
    """Rank 1 cannot read its phenotype file and raises; rank 0 is then in
    the GRM's collectives, which fail once rank 1 leaves the group, so
    both ranks end with an error, well inside the timeout."""
    import torch.multiprocessing as mp

    from tests.conftest import make_dosage, make_plink

    rng = np.random.default_rng(5)
    bfile, _ = make_plink(tmp_path, make_dosage(rng, 30, 24), prefix="c")
    pheno = tmp_path / "p.txt"
    pheno.write_text("".join(f"F{i} I{i} {rng.normal():.4f}\n" for i in range(24)))
    base = ["--reml", "--bfile", bfile, "--mesh", "2", "--force-distributed"]
    argv = [base + ["--pheno", str(pheno), "--out", str(tmp_path / "r0")],
            base + ["--pheno", str(tmp_path / "missing.txt"), "--out", str(tmp_path / "r1")]]
    spawn = mp.get_context("spawn")
    q = spawn.Queue()
    port = free_port()
    procs = [spawn.Process(target=_cli_rank, args=(r, 2, port, argv, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        status = dict((r, s) for r, s, _ in (q.get(timeout=RANK_TIMEOUT_S) for _ in range(2)))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert status == {0: "error", 1: "error"}


def _nccl_on_cpu(rank, world, port, q):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    distributed.choose_backend = lambda device: "nccl"
    try:
        distributed.startup_runtime("2", torch.device("cpu"))
        q.put((rank, "ok"))
    except BaseException:  # the expected backend failure
        q.put((rank, "error"))
    finally:
        distributed.shutdown_runtime(failed=True)


def test_a_backend_that_cannot_start_raises(tmp_path):
    """NCCL asked for where it cannot run (CPU ranks): the init raises on
    every rank, nothing carries on without the group."""
    import torch.multiprocessing as mp

    spawn = mp.get_context("spawn")
    q = spawn.Queue()
    port = free_port()
    procs = [spawn.Process(target=_nccl_on_cpu, args=(r, 2, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        status = dict(q.get(timeout=RANK_TIMEOUT_S) for _ in range(2))
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
    assert status == {0: "error", 1: "error"}
