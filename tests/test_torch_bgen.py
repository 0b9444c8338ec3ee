"""The port's BGEN path (dissect_tpu_torch.io.bgen, kernel K2's plain
version, the float GRM accumulator, the `--bgen` CLI) held against the
JAX package on the CPU.

Tolerances: the reader and writer are exact (dosages `array_equal`,
files byte for byte); K2's packed tiles at rtol 2e-5 (float32 sums in
another order, the tolerance tests/test_native_sharding.py uses for the
same kernel) and the 0/1 mask product exactly; the GRM at rtol 1e-6 and
its counts exactly (the golden .grm.dat tolerance); CLI text outputs at
rtol 2e-5 (tests/test_golden.py).
"""

import os
import pathlib
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.io import bgen as jax_bgen
from dissect_tpu.io.bed import IndividualInfo as JaxIndividual, SnpInfo as JaxSnp
from dissect_tpu.linalg import pallas_syrk as jax_pallas
from dissect_tpu.linalg.syrk import grm_accumulator as jax_grm_accumulator
from dissect_tpu.model.kernels import grm_from_plink as jax_grm_from_plink
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.convert import bgen_data_from_state
from dissect_tpu_torch.io import bgen
from dissect_tpu_torch.io.grm_io import read_grm
from dissect_tpu_torch.linalg import grm_kernels
from dissect_tpu_torch.linalg.syrk import grm_accumulator, grm_update_packed
from dissect_tpu_torch.model.kernels import grm_from_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
N, M, CHUNK = 72, 96, 40  # M % CHUNK != 0: a ragged last chunk


def imputed(rng, m, n, missing=0.02):
    """Imputed-style float32 dosages: hard calls blurred off the integers
    by up to 0.3, NaN = missing, every row polymorphic."""
    p = rng.uniform(0.05, 0.5, size=(m, 1))
    d = (rng.random((m, n)) < p).astype(np.float32) + (rng.random((m, n)) < p)
    d = np.clip(d + rng.uniform(-0.3, 0.3, size=(m, n)), 0.0, 2.0).astype(np.float32)
    d[rng.random((m, n)) < missing] = np.nan
    return d


def jax_bgen_data(dosages, fid_prefix="S"):
    m, n = dosages.shape
    return jax_bgen.BgenData(
        snps=[JaxSnp(str(1 + i % 22), f"rs{i}", 0.0, 1000 + i, "A", "G") for i in range(m)],
        individuals=[JaxIndividual(f"{fid_prefix}{i}", f"{fid_prefix}{i}") for i in range(n)],
        dosages=dosages,
    )


def port_bgen_data(jd):
    return bgen_data_from_state(jd.snps, jd.individuals, jd.dosages)


def assert_same_data(ours, theirs):
    assert [vars(s) for s in ours.snps] == [vars(s) for s in theirs.snps]
    assert [vars(i) for i in ours.individuals] == [vars(i) for i in theirs.individuals]
    got = ours.dosages.cpu().numpy()
    assert got.dtype == theirs.dosages.dtype == np.float32
    np.testing.assert_array_equal(got, theirs.dosages)


# --------------------------------------------------------------- reader ---
def test_read_golden_bgen_matches_jax():
    ours = bgen.read_bgen(str(GOLDEN / "cohort.bgen"), device="cpu")
    theirs = jax_bgen.read_bgen(str(GOLDEN / "cohort.bgen"), native=False)
    assert_same_data(ours, theirs)
    assert np.isnan(ours.dosages.numpy()).any()


FORMATS = [(1, 16, "none"), (1, 16, "zlib")] + [
    (2, bits, comp) for bits in (8, 16) for comp in ("none", "zlib")
] + [(2, 8, "zstd"), (2, 16, "zstd")]


@pytest.mark.parametrize("layout,bits,compression", FORMATS)
def test_write_and_read_match_jax(tmp_path, rng, layout, bits, compression):
    """JAX's write_bgen and the port's give the same bytes; the port reads
    JAX's file to the same dosages as JAX's pure-Python reader."""
    if compression == "zstd":
        pytest.importorskip("zstandard")
    jd = jax_bgen_data(imputed(rng, 50, 37))
    theirs_path, ours_path = tmp_path / "j.bgen", tmp_path / "t.bgen"
    jax_bgen.write_bgen(str(theirs_path), jd, bits=bits, layout=layout, compression=compression)
    bgen.write_bgen(str(ours_path), port_bgen_data(jd), bits=bits, layout=layout,
                    compression=compression)
    assert ours_path.read_bytes() == theirs_path.read_bytes()
    assert_same_data(bgen.read_bgen(str(theirs_path), device="cpu"),
                     jax_bgen.read_bgen(str(theirs_path), native=False))


def test_batched_reader_spans_batches(tmp_path, rng, monkeypatch):
    """More variants than one decode batch, so the batch decoder (K6's
    plain version here) runs over several batches."""
    monkeypatch.setattr(bgen, "_BATCH", 16)
    jd = jax_bgen_data(imputed(rng, 50, 21))
    path = tmp_path / "b.bgen"
    jax_bgen.write_bgen(str(path), jd, bits=8)
    assert_same_data(bgen.read_bgen(str(path), device="cpu"),
                     jax_bgen.read_bgen(str(path), native=False))
    assert_same_data(bgen.read_bgen(str(path), max_variants=20, device="cpu"),
                     jax_bgen.read_bgen(str(path), max_variants=20, native=False))


def test_batch_decoder_matches_per_variant_parser(rng):
    """A batch mixing blocks the batch decoder takes (8- and 16-bit) with
    one the per-variant parser must take (a haploid sample, which both
    readers drop)."""
    n = 30
    d = imputed(rng, 4, n)
    blocks = bgen._probability_payloads(d, 8, 2)
    haploid = bytearray(blocks[1])
    haploid[8 + 3] = 1  # sample 3 ploidy 1
    blocks[1] = bytes(haploid)
    blocks.append(bgen._probability_payloads(d[:1], 16, 2)[0])
    rows, ok, _ = bgen._decode_blocks(blocks, n, 2, torch.device("cpu"))
    for data, row, took in zip(blocks, rows.numpy(), ok):
        want = jax_bgen._parse_layout2_dosage(data, n)
        if want is None:
            assert not took
        else:
            np.testing.assert_array_equal(row, want)
    assert not ok[1] and ok[0] and ok[-1]


@pytest.mark.parametrize("half", [0, 1])
def test_dosage_table_holds_every_byte_pair(half):
    """The batch decoder (K6's plain version) against JAX's per-variant
    parser on one block whose 32,768 samples carry half of all 65,536
    (P(11), P(12)) byte pairs."""
    n = 32768
    pairs = np.arange(half * n, (half + 1) * n, dtype="<u2")
    block = struct.pack("<IHBB", n, 2, 2, 2) + bytes([2]) * n + bytes([0, 8]) + pairs.tobytes()
    rows, ok, _ = bgen._decode_blocks([block], n, 2, torch.device("cpu"))
    assert ok[0]
    np.testing.assert_array_equal(rows[0].numpy(), jax_bgen._parse_layout2_dosage(block, n))


def test_stats_filter_and_chunks_match_jax(rng, monkeypatch):
    """stats() in row blocks (here 7 rows each) equals JAX's whole-array
    statistics exactly; filter and chunking keep JAX's order."""
    monkeypatch.setattr(bgen, "_STATS_ROWS", 7)
    jd = jax_bgen_data(imputed(rng, 30, 25))
    td = port_bgen_data(jd)
    for name in ("n_nonmissing", "p1", "p2", "std"):
        np.testing.assert_array_equal(getattr(td.stats(), name), getattr(jd.stats(), name))
    keep_s = ["rs4", "rs1", "rs17"]
    keep_i = [jd.individual_keys[i] for i in (5, 0, 9, 24)]
    assert_same_data(td.filter(keep_snps=keep_s, keep_individuals=keep_i),
                     jd.filter(keep_snps=keep_s, keep_individuals=keep_i))
    for (s1, e1, c1), (s2, e2, c2) in zip(td.iter_chunks(8), jd.iter_chunks(8)):
        assert (s1, e1) == (s2, e2)
        np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(td.decode_chunk(3, 11), jd.decode_chunk(3, 11))


def test_bgen_data_from_state_checks_shape(rng):
    jd = jax_bgen_data(imputed(rng, 5, 4))
    with pytest.raises(ValueError, match="shape"):
        bgen_data_from_state(jd.snps, jd.individuals[:3], jd.dosages)


# ------------------------------------------------------------------- K2 ---
@pytest.fixture
def float_chunk(rng):
    d = imputed(rng, M, N, missing=0.05)
    finite = np.isfinite(d)
    mean = (np.where(finite, d, 0).sum(1) / finite.sum(1)).astype(np.float32)
    inv_std = (1.0 / np.nanstd(d, axis=1)).astype(np.float32)
    return d, mean, inv_std


@pytest.mark.parametrize("block_n", [32, 16])
def test_plain_k2_matches_jax_interpret(float_chunk, block_n):
    """K2's plain version, through its wrapper on CPU tensors, against the
    Pallas kernel in interpret mode at the same block_n: tiles of Z'Z at
    rtol 2e-5, the 0/1 mask product exactly (the shape of
    tests/test_native_sharding.py:116-127)."""
    from dissect_tpu.linalg.syrk import standardize_chunk as jax_standardize

    d, mean, inv_std = float_chunk
    jz, jo = jax_standardize(jnp.asarray(d), jnp.asarray(mean), jnp.asarray(inv_std), jnp.float32)
    for operand, exact in ((jz, False), (jo, True)):
        theirs = np.asarray(jax_pallas.syrk_triangle_packed(
            operand, block_n=block_n, block_m=32, interpret=True))
        ours = grm_kernels.syrk_triangle_packed(torch.as_tensor(np.array(operand)), block_n)
        assert tuple(ours.shape) == grm_kernels.packed_shape(N, block_n) == theirs.shape
        if exact:
            np.testing.assert_array_equal(ours.numpy(), theirs)
        else:
            np.testing.assert_allclose(ours.numpy(), theirs, rtol=2e-5, atol=1e-4)
    full = grm_kernels.syrk_triangle(torch.as_tensor(np.array(jz)), block_n)
    np.testing.assert_allclose(
        full.numpy(),
        np.asarray(jax_pallas.syrk_triangle(jz, block_n=block_n, block_m=32, interpret=True)),
        rtol=2e-5, atol=1e-4)


def test_float_accumulator_never_falls_back(float_chunk):
    """The float GRM step on a device that is neither the CPU nor a card
    reaches K2's wrapper, which raises: only CPU tensors take the plain
    version."""
    d, mean, inv_std = float_chunk
    acc = grm_accumulator(N, device="meta", block_n=16)
    with pytest.raises(ValueError, match="no syrk_triangle_packed kernel"):
        acc.update(d, mean, inv_std)
    assert grm_kernels.syrk_triangle_packed.launches == 0


@pytest.mark.parametrize("block_n", [16, 512])
def test_float_accumulator_matches_jax(float_chunk, block_n):
    """grm_update_packed chunk by chunk (ragged last chunk) + finalize
    against JAX's triangle accumulator in interpret mode and JAX's dense
    accumulator, on NaN dosages: kernel at rtol 2e-5, counts exactly."""
    d, mean, inv_std = float_chunk
    ours = grm_accumulator(N, device="cpu", block_n=block_n)
    tri = jax_grm_accumulator(N, dtype=jnp.float32, triangle=True, block_n=block_n,
                              block_m=16, interpret=True)
    dense = jax_grm_accumulator(N, dtype=jnp.float32)
    for s in range(0, M, CHUNK):
        sl = slice(s, s + CHUNK)
        assert ours.update(d[sl], mean[sl], inv_std[sl]) is ours
        tri.update(d[sl], mean[sl], inv_std[sl])
        dense.update(d[sl], mean[sl], inv_std[sl])
    np.testing.assert_allclose(ours.kernel.numpy(), np.asarray(tri.kernel), rtol=2e-5, atol=1e-4)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(tri.counts))
    k, c = ours.finalize()
    for ref in (tri, dense):
        k_ref, c_ref = ref.finalize()
        np.testing.assert_allclose(k.numpy(), np.asarray(k_ref), rtol=2e-5, atol=1e-4)
        np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))


def test_grm_update_packed_adds_in_place(float_chunk):
    d, mean, inv_std = float_chunk
    shape = grm_kernels.packed_shape(N, 16)
    k0 = torch.ones(shape)
    c0 = torch.full(shape, 2.0)
    k, c = grm_update_packed(k0, c0, torch.as_tensor(d), torch.as_tensor(mean),
                             torch.as_tensor(inv_std), block_n=16)
    assert k is k0 and c is c0
    fresh = grm_update_packed(torch.zeros(shape), torch.zeros(shape), torch.as_tensor(d),
                              torch.as_tensor(mean), torch.as_tensor(inv_std), block_n=16)
    np.testing.assert_array_equal(k.numpy(), fresh[0].numpy() + 1.0)
    np.testing.assert_array_equal(c.numpy(), fresh[1].numpy() + 2.0)


@pytest.mark.parametrize("chunk_size", [2048, 7])
def test_grm_from_bgen_matches_jax(chunk_size):
    """grm_from_plink(read_bgen(golden)) against JAX's: kernel at rtol
    1e-6, counts exactly, same ids and SNPs."""
    ours = grm_from_plink(bgen.read_bgen(str(GOLDEN / "cohort.bgen"), device="cpu"),
                          chunk_size=chunk_size, device="cpu")
    ref = jax_grm_from_plink(jax_bgen.read_bgen(str(GOLDEN / "cohort.bgen"), native=False),
                             chunk_size=chunk_size)
    assert ours.individual_keys == ref.individual_keys
    assert ours.snp_names == ref.snp_names
    assert ours.matrix.dtype == torch.float32
    np.testing.assert_allclose(ours.matrix.numpy(), np.asarray(ref.matrix), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))


# ------------------------------------------------------------------ CLI ---
@pytest.fixture(scope="module")
def bgen_runs(tmp_path_factory):
    """Both CLIs on the golden BGEN cohort: --make-grm, --gwas (OLS) and
    --gwas --grm (the mixed model on the BGEN GRM).  BGEN sample ids give
    FID = IID, so the phenotype file carries the IID twice."""
    out = tmp_path_factory.mktemp("torch_bgen_cli")
    pheno = out / "pheno.txt"
    with open(GOLDEN / "pheno.txt") as fh, open(pheno, "w") as dst:
        for line in fh:
            f = line.split()
            dst.write(f"{f[1]} {f[1]} {f[2]}\n")
    geno = ["--bgen", str(GOLDEN / "cohort.bgen"), "--mesh", "none"]
    runs = lambda d: [
        ["--make-grm"] + geno + ["--out", f"{d}/b"],
        ["--gwas"] + geno + ["--pheno", str(pheno), "--out", f"{d}/b.ols"],
        ["--gwas", "--grm", f"{d}/b"] + geno + ["--pheno", str(pheno), "--out", f"{d}/b.mlm"],
    ]
    saved = os.environ.get("DISSECT_TPU_TORCH_DEVICE")
    os.environ["DISSECT_TPU_TORCH_DEVICE"] = "cpu"
    try:
        for side, fn in (("jax", jax_main), ("torch", main)):
            (out / side).mkdir()
            for argv in runs(out / side):
                try:
                    fn(argv)
                finally:
                    set_mesh_context(None)
    finally:
        if saved is None:
            os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)
        else:
            os.environ["DISSECT_TPU_TORCH_DEVICE"] = saved
    return out


def test_make_grm_bgen_matches_golden(bgen_runs):
    """--make-grm --bgen against golden.bgen.grm.*: ids and SNPs equal,
    kernel at rtol 1e-6, counts exactly."""
    for ext in ("grm.ids", "grm.snps"):
        assert (bgen_runs / "torch" / f"b.{ext}").read_bytes() == \
            (GOLDEN / f"golden.bgen.{ext}").read_bytes()
    new, old = read_grm(f"{bgen_runs}/torch/b"), read_grm(str(GOLDEN / "golden.bgen"))
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(new["counts"], old["counts"])


@pytest.mark.parametrize("name", [
    "b.ols.gwas.snps", "b.ols.gwas.mean", "b.ols.gwas.quantitative", "b.ols.gwas.discrete",
    "b.mlm.gwas.snps", "b.mlm.gwas.mean", "b.mlm.gwas.quantitative", "b.mlm.gwas.discrete",
    "b.grm.ids", "b.grm.snps",
])
def test_bgen_cli_matches_jax_cli(bgen_runs, name):
    _diff_files(bgen_runs / "torch" / name, bgen_runs / "jax" / name, rtol=2e-5)


def test_bgen_mlm_unfitted_matches_jax_cli(bgen_runs):
    ours, theirs = bgen_runs / "torch" / "b.mlm.gwas.unfitted", bgen_runs / "jax" / "b.mlm.gwas.unfitted"
    assert ours.exists() == theirs.exists()
    if theirs.exists():
        assert ours.read_text() == theirs.read_text()
