"""The bounds chip_smoke.py reports beside each kernel's time, checked on
the CPU at the main paths' shapes (chip_smoke is imported, not run).

A bound is the least time an H100 SXM could take for the work: the
largest of the bytes at 3.35 TB/s, the float32 flops at 67 TFLOP/s and
the int8 tensor-core operations at 1,979 TOP/s.
"""

import pytest

import chip_smoke as cs

M_CHUNK, N, BLOCK_N = 2048, 10_000, 512  # one GRM chunk of the main paths
M_SNPS, Q, K = 50_000, 4, 23               # one Fisher step of the refit


def test_k1_bound_counts_ztz_on_fp32_and_counts_on_int8():
    """K1: Z^T Z on the float32 pipes (3.06 ms); the exact 0/1 counts cost
    0.10 ms on the int8 tensor cores, so they no longer double the bound
    (6.11 ms when both products were counted as float32)."""
    ms, by = cs.k1_bound(M_CHUNK, N, BLOCK_N)
    assert by == "operations"
    assert ms == pytest.approx(2 * M_CHUNK * N * (N + 1) / 2 / 67e12 * 1e3)
    assert ms == pytest.approx(3.06, abs=0.005)


def test_k2_bound_unchanged():
    ms, by = cs.k2_bound(M_CHUNK, N, BLOCK_N)
    assert by == "operations"
    assert ms == pytest.approx(3.06, abs=0.005)


def test_k3_bound():
    """K3: 2K + 3q + 3 = 61 FMAs per element of g, above g's single read
    (0.60 ms)."""
    ms, by = cs.k3_bound(M_SNPS, N, Q, K)
    assert by == "operations"
    assert ms == pytest.approx(0.91, abs=0.005)


def test_k3_bound_at_the_igwas_shape():
    """K3 on the igwas refit (s = 3 covariates, K = 15): 42 FMAs per
    element of g, 0.63 ms, still above g's single read (0.60 ms)."""
    ms, by = cs.k3_bound(M_SNPS, N, 3, 15)
    assert by == "operations"
    assert ms == pytest.approx(2 * 42 * M_SNPS * N / 67e12 * 1e3)
    assert ms == pytest.approx(0.63, abs=0.005)


def test_k4_bound_is_the_chunk_bytes():
    """K4 on one 2,048-SNP chunk at N = 10,000: 5.1 MB of packed rows in,
    20.5 MB of int8 dosages out, 7.6 us at 3.35 TB/s."""
    ms, by = cs.k4_bound(M_CHUNK, N)
    assert by == "bytes"
    assert ms == pytest.approx((M_CHUNK * N // 4 + M_CHUNK * N) / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0076, abs=0.0001)
    with_index, _ = cs.k4_bound(M_CHUNK, N, n_out=9_000)
    assert with_index == pytest.approx((M_CHUNK * N // 4 + M_CHUNK * 9_000 + 4 * 9_000)
                                       / 3.35e12 * 1e3)


def test_k5_bound_over_the_file_is_its_packed_bytes():
    """K5 reads the 125 MB payload of 50,000 SNPs once (and writes 1.6 MB
    of counts): 37.8 us; one 8,192-row block 6.2 us."""
    ms, by = cs.k5_bound(M_SNPS, N)
    assert by == "bytes"
    assert ms == pytest.approx(0.0378, abs=0.0001)
    assert cs.k5_bound(8192, N)[0] == pytest.approx(0.0062, abs=0.0001)


def test_k4_bound_at_the_timed_shapes():
    """K4 as chip_smoke times it: a 2,048-row GRM chunk through a 9,000-entry
    index (5.1 MB in, 18.4 MB out, 36 KB of index: 7.0 us) and an 8,192-row
    block of a whole-file decode (20.5 MB in, 81.9 MB out: 30.6 us)."""
    with_index, by = cs.k4_bound(M_CHUNK, N, n_out=9_000)
    assert by == "bytes"
    assert with_index == pytest.approx(0.0070, abs=0.0001)
    block, by = cs.k4_bound(8192, N)
    assert by == "bytes"
    assert block == pytest.approx((8192 * N // 4 + 8192 * N) / 3.35e12 * 1e3)
    assert block == pytest.approx(0.0306, abs=0.0001)


def test_k5_bound_with_an_index():
    """K5 on an 8,192-row block through a 9,000-entry index: the packed rows
    are read whole either way, so the bound stays 6.2 us (the index adds
    36 KB)."""
    ms, by = cs.k5_bound(8192, N, n_out=9_000)
    assert by == "bytes"
    assert ms == pytest.approx((8192 * N // 4 + 32 * 8192 + 4 * 9_000) / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.0062, abs=0.0001)


def test_k6_bound_is_the_batch_bytes():
    """K6 on the BGEN path's batch: 1,024 blocks of 10 + 3N bytes in and
    1,024 x N float32 out, about 72 MB, 21 us."""
    v = 1024
    ms, by = cs.bgen_bound(v * (10 + 3 * N), v, N)
    assert by == "bytes"
    assert ms == pytest.approx(0.0214, abs=0.0001)


@pytest.mark.parametrize("layout, v, n, want", [
    (1, 1024, N, 0.0306),           # K7 on a batch of the BGEN path's size
    (2, 64, 487_409, 0.0652),       # K6 at UK Biobank's sample count
    (1, 64, 487_409, 0.0931),       # K7 there
])
def test_bgen_bounds_at_the_timed_shapes(layout, v, n, want):
    """K6 and K7 at the other shapes chip_smoke.py times: the blocks' bytes
    (10 + 3N a layout-2 block, 6N a layout-1 block) in, the float32 rows
    out; at N = 487,409, 94 MB or 187 MB in and 125 MB out."""
    block = 10 + 3 * n if layout == 2 else 6 * n
    ms, by = cs.bgen_bound(v * block, v, n)
    assert by == "bytes"
    assert ms == pytest.approx((v * block + 16 * v + 4 * v * n + 4 * v) / 3.35e12 * 1e3)
    assert ms == pytest.approx(want, abs=0.0001)


@pytest.mark.parametrize(
    "n_bytes, fp32, int8, want",
    [
        (3.35e9, 0, 0, (1.0, "bytes")),
        (0, 67e9, 0, (1.0, "operations")),
        (0, 0, 1979e9, (1.0, "operations")),
        (3.35e9, 67e9, 2 * 1979e9, (2.0, "operations")),
    ],
)
def test_bound_takes_the_slowest_pipe(n_bytes, fp32, int8, want):
    ms, by = cs.bound_ms(n_bytes, fp32, int8)
    assert (ms, by) == (pytest.approx(want[0]), want[1])


def test_needed_entries_is_the_lower_triangle():
    for n, bn in ((10_000, 512), (1000, 200), (5, 512), (512, 512)):
        assert cs._needed_entries(n, bn) == n * (n + 1) // 2
