"""The work counts the roofline and mfu metrics divide by, pinned at the
four cells' shapes (N = 20,000; M = 100,000 SNPs or 10,000 variants;
c = 3 fixed effects), and the kernel bounds copied from chip_smoke.py
at the smoke's shapes."""

import pytest

from portbench import rooflines as rl

N, M_ARRAY, M_BGEN, C = 20_000, 100_000, 10_000, 3


def test_peaks():
    assert rl.PEAK_FP32_FLOPS == 67e12 and rl.PEAK_FP64_TENSOR_FLOPS == 67e12
    assert rl.PEAK_FP64_FLOPS == 34e12 and rl.PEAK_BYTES_PER_S == 3.35e12


def test_kernel_bounds_equal_the_smokes_at_its_shapes():
    """chip_smoke's figures (tests/test_torch_bounds.py): K1 and K2 3.06 ms
    a 2,048-SNP chunk at N = 10,000, K3 0.91 ms at M = 50,000, K4 7.6 us."""
    assert rl.k1_bound(2048, 10_000)[0] == pytest.approx(3.06, abs=0.005)
    assert rl.k2_bound(2048, 10_000)[0] == pytest.approx(3.06, abs=0.005)
    assert rl.k3_bound(50_000, 10_000, 4, 23) == (pytest.approx(0.91, abs=0.005), "operations")
    assert rl.k4_bound(2048, 10_000) == (pytest.approx(0.0076, abs=0.0001), "bytes")
    assert rl.k5_bound(50_000, 10_000)[0] == pytest.approx(0.0378, abs=0.0001)


def test_refit_shape():
    assert rl.refit_shape(C) == (4, 23)


def test_scan_flops_at_the_scan_cells():
    """The rotation is 2 M N^2 (8e13 a pass of the array cell), K3 61
    FMAs per element of g at each launch: 16 launches a SNP, 31 more a
    retried one."""
    rotation = 2 * M_ARRAY * N * N
    assert rotation == 8e13
    launches = [65_536] * 16 + [34_464] * 16 + [1_000] * 31
    k3 = 2 * 61 * N * (16 * M_ARRAY + 31 * 1_000)
    assert rl.scan_flops(M_ARRAY, N, C, launches) == rotation + k3
    assert rl.scan_flops(M_BGEN, N, C, [M_BGEN] * 16) == 2 * M_BGEN * N * N + 2 * 61 * N * 16 * M_BGEN


def test_k3_bound_at_the_scan_chunk():
    """K3 on a 65,536-SNP chunk at N = 20,000: 1.6e11 flops, 2.39 ms."""
    ms, by = rl.k3_bound(65_536, N, 4, 23)
    assert by == "operations"
    assert ms == pytest.approx(2 * 61 * 65_536 * N / 67e12 * 1e3)
    assert ms == pytest.approx(2.387, abs=0.001)


def test_reml_flops_at_the_reml_cell():
    """N^3 = 8e12 for the inverse an iteration, plus 4 n^2 c + 10 n^2."""
    it = rl.reml_iteration_flops(N, C)
    assert it == 8e12 + 4 * N * N * 3 + 10 * N * N
    assert rl.reml_fit_flops(N, C, 6) == 7 * it
    # one iteration at the FP64 tensor-core peak: 0.1196 s
    assert it / rl.PEAK_FP64_TENSOR_FLOPS == pytest.approx(0.1196, abs=1e-4)


def test_grm_flops_and_k1_at_the_grm_cell():
    """Z^T Z over the lower triangle: 2 M N(N+1)/2 = 4.0e13 a build; K1's
    bound over its 49 chunks (48 of 2,048 and one of 1,696) is 0.597 s."""
    assert rl.grm_flops(M_ARRAY, N) == M_ARRAY * N * (N + 1)
    chunks = [min(2048, M_ARRAY - s) for s in range(0, M_ARRAY, 2048)]
    assert len(chunks) == 49 and chunks[-1] == 1_696
    total = sum(rl.k1_bound(m, N)[0] for m in chunks)
    assert all(rl.k1_bound(m, N)[1] == "operations" for m in chunks)
    assert total == pytest.approx(2 * M_ARRAY * N * (N + 1) / 2 / 67e12 * 1e3, rel=1e-12)
    assert total == pytest.approx(597.0, abs=0.5)


def test_k4_and_k6_bounds_at_the_scan_cells():
    """K4 on an 8,192-row block at N = 20,000 (41 MB in, 164 MB out) is
    bytes-bound at 61.1 us; K6 over a pass of the imputed cell (10,000
    blocks of 60,010 bytes in, 800 MB of float32 out) at 0.418 ms."""
    ms, by = rl.k4_bound(8192, N)
    assert by == "bytes" and ms == pytest.approx((8192 * N // 4 + 8192 * N) / 3.35e12 * 1e3)
    assert rl.layout2_block_bytes(N) == 60_010
    ms, by = rl.bgen_bound(M_BGEN * 60_010, M_BGEN, N)
    assert by == "bytes"
    assert ms == pytest.approx((M_BGEN * (60_010 + 16 + 4 * N + 4)) / 3.35e12 * 1e3)
    assert ms == pytest.approx(0.418, abs=0.001)
