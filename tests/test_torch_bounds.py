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
