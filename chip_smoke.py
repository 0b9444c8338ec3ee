"""Drive the PyTorch/CUDA port (dissect_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which stops the script on failure:

  1. build     compile every hand-written kernel under dissect_tpu_torch/csrc/
               (one nvcc per source, all started together);
  2. kernels   hold each kernel (K1, K2, K3) against its plain PyTorch version
               on the card, at a ragged shape and at the shape the main paths
               give it, and time kernel, plain version and (where one exists)
               the single PyTorch call that computes the same function;
  3. golden    the CLI on the repository's golden cohort (tests/golden), PLINK
               and BGEN input, on the card, against the stored golden files;
  4. main      the PLINK path: a synthetic PLINK cohort at the size users run
               (10,000 individuals x 50,000 SNPs, 1% missing, 2 quantitative
               covariates, a phenotype with h2 = 0.5 from 500 causal SNPs),
               then `--make-grm` and `--gwas --grm` through the CLI's main();
               every kernel launch counter is zeroed just before and read
               just after;
  5. checks    finite outputs of the right shape, causal SNPs enriched among
               the smallest p-values, and on a 512-SNP subset the refit through
               K3 against the refit through K3's plain version;
  6. bgen      the BGEN path: a synthetic imputed cohort of the same size in
               UK Biobank's format (BGEN layout 2, 8-bit, zlib), dosages blurred
               off the hard calls, 1% missing, the same covariate and phenotype
               recipe, then `--make-grm --bgen` and `--gwas --grm --bgen`
               through main(), launch counters zeroed just before and read just
               after, and the same science checks.

The last lines of standard output are the `kernels` JSON line, the card's
name and power limit as nvidia-smi reports them, and the result line
{"ok": true, "device": {...}}.  Without a CUDA card the script exits 1
and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
N_INDIVIDUALS = 10_000
N_SNPS = 50_000
N_CAUSAL = 500
SEED = 20261016
BGEN_SNPS = 50_000
GRM_CHUNK = 2048  # grm_from_plink's chunk: K1's and K2's row count on the main paths
BLOCK_N = 512     # grm_accumulator's packed tile edge

# One NVIDIA H100 SXM (NVIDIA data sheet, dense rates): float32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of the kernel-vs-plain comparisons, relative to the largest
# magnitude of the plain result: both sides sum the same float32 terms in
# different orders, whose rounding grows like sqrt(terms) * eps32 ~ 1e-5
# at these contraction lengths (2,048 SNP rows for K1 and K2, 10,000
# eigenbasis entries for K3).  K1's counts and K2 on the 0/1 mask are sums
# of 0/1 products: exact.
K1_REL_TOL = 1e-5
K2_REL_TOL = 1e-5
K3_REL_TOL = 1e-4
# The 512-SNP refit through K3 vs through its plain version: 15 float32
# Fisher steps on moments that differ by rounding; the bound JAX's tests
# use between their two moment paths (tests/test_gwas_covariance.py).
REFIT_RTOL = 2e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*parts):
    print(*parts, flush=True)


# ------------------------------------------------------------------ timing --
def time_ms(fn, iters=10, warmup=2):
    """Mean milliseconds of fn() on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phase 1 --
def phase_build():
    from dissect_tpu_torch.runtime import cuda_lib

    report = cuda_lib.build_all()
    for name, info in report.items():
        log(f"build {name}: {info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    return report


# ----------------------------------------------------------------- phase 2 --
def _dosage_on_card(gen, m, n, missing, device):
    """(m, n) int8 dosages, MAF uniform on [0.05, 0.5], -1 = missing."""
    p = 0.05 + 0.45 * torch.rand((m, 1), generator=gen, device=device)
    d = (torch.rand((m, n), generator=gen, device=device) < p).to(torch.int8)
    d += (torch.rand((m, n), generator=gen, device=device) < p).to(torch.int8)
    miss = torch.rand((m, n), generator=gen, device=device) < missing
    return torch.where(miss, torch.full_like(d, -1), d)


def _snp_scaling(d):
    obs = (d >= 0).to(torch.float64)
    p2 = (torch.where(d >= 0, d, torch.zeros_like(d)).to(torch.float64).sum(1)
          / (2.0 * obs.sum(1)).clamp_min(1.0)).clamp(0.01, 0.99)
    mean = (2.0 * p2).to(torch.float32)
    inv_std = (1.0 / torch.sqrt(2.0 * p2 * (1.0 - p2))).to(torch.float32)
    return mean, inv_std


def _needed_entries(n, block_n):
    """GRM entries one K1 call must compute: the whole of each off-diagonal
    tile, and the lower triangle of each diagonal tile (its strict upper
    half is the transpose).  Sums to n(n+1)/2."""
    from dissect_tpu_torch.linalg.grm_kernels import _pair_maps

    nt = -(-n // block_n)
    _, imap, jmap = _pair_maps(nt)
    rows = np.minimum(block_n, n - imap * block_n)
    cols = np.minimum(block_n, n - jmap * block_n)
    entries = np.where(imap == jmap, rows * (rows + 1) // 2, rows * cols)
    return int(entries.sum())


def compare_k1(gen, m, n, block_n, device, timed):
    from dissect_tpu_torch.linalg import grm_kernels as gk
    from dissect_tpu_torch.linalg.syrk import standardize_chunk

    d = _dosage_on_card(gen, m, n, 0.05, device)
    mean, inv_std = _snp_scaling(d)
    shape = gk.packed_shape(n, block_n)
    # start from non-zero tiles: the kernel must ADD in place
    k0 = torch.randn(shape, generator=gen, device=device)
    c0 = torch.floor(torch.rand(shape, generator=gen, device=device) * 100.0)
    k_kern, c_kern = k0.clone(), c0.clone()
    out = gk.grm_fused_triangle_update(d, mean, inv_std, k_kern, c_kern, block_n=block_n)
    check(out[0] is k_kern and out[1] is c_kern, "K1 must update its buffers in place")
    k_plain, c_plain = gk.plain_grm_fused_triangle_update(
        d, mean, inv_std, k0.clone(), c0.clone(), block_n=block_n
    )
    torch.cuda.synchronize()
    err = float((k_kern - k_plain).abs().max())
    scale = float(k_plain.abs().max())
    counts_equal = bool(torch.equal(c_kern, c_plain))
    log(f"K1 m={m} n={n} block_n={block_n}: max_abs_err {err:.3e} (scale {scale:.3e}, "
        f"tol {K1_REL_TOL:g} x scale), counts exact: {counts_equal}")
    check(math.isfinite(err) and err <= K1_REL_TOL * scale, "K1 disagrees with its plain version")
    check(counts_equal, "K1 counts differ from its plain version")
    if not timed:
        return None
    kb, cb = k0.clone(), c0.clone()
    ms = time_ms(lambda: gk.grm_fused_triangle_update(d, mean, inv_std, kb, cb, block_n=block_n))
    plain_ms = time_ms(lambda: gk.plain_grm_fused_triangle_update(
        d, mean, inv_std, kb, cb, block_n=block_n), iters=5)
    z, _ = standardize_chunk(d, mean, inv_std, torch.float32)
    library_ms = time_ms(lambda: torch.mm(z.T, z), iters=5)
    entries = _needed_entries(n, block_n)
    tiles_bytes = shape[0] * shape[1] * 4
    n_bytes = m * n + 2 * m * 4 + 2 * 2 * tiles_bytes  # dosage, mean/istd, 2 buffers read+written
    n_flops = 2 * 2 * m * entries  # two products, one FMA each
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {
        "name": "grm_fused_triangle_update",
        "route": "cuda",
        "source": "dissect_tpu_torch/csrc/grm_syrk.cu",
        "replaces": "dissect_tpu/linalg/pallas_syrk.py:192",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"m": m, "n": n, "block_n": block_n},
    }


def _imputed_on_card(gen, m, n, missing, device):
    """(m, n) float32 imputed-style dosages: hard calls (MAF uniform on
    [0.05, 0.5]) that posterior uncertainty has moved up to 0.25 toward a
    neighbouring genotype, so most values are not integers; NaN =
    missing."""
    d = _dosage_on_card(gen, m, n, 0.0, device).to(torch.float32)
    blur = 0.25 * torch.rand((m, n), generator=gen, device=device)
    up = torch.rand((m, n), generator=gen, device=device) < 0.5
    step = torch.where((d == 0) | ((d == 1) & up), blur, -blur)
    d = d + step
    miss = torch.rand((m, n), generator=gen, device=device) < missing
    return torch.where(miss, torch.full_like(d, float("nan")), d)


def _float_scaling(d):
    """Per-row empirical mean and 1/std of a NaN-missing float chunk."""
    obs = torch.isfinite(d)
    x = torch.where(obs, d, torch.zeros_like(d)).to(torch.float64)
    cnt = obs.sum(1).clamp_min(1)
    mean = x.sum(1) / cnt
    var = (torch.where(obs, x - mean[:, None], torch.zeros_like(x)) ** 2).sum(1) / (cnt - 1).clamp_min(1)
    return mean.to(torch.float32), (1.0 / torch.sqrt(var)).to(torch.float32)


def compare_k2(gen, m, n, block_n, device, timed):
    """K2 on a standardized float chunk (NaN entries zeroed) and on its 0/1
    observed mask, the two calls the streaming GRM makes per chunk."""
    from dissect_tpu_torch.linalg import grm_kernels as gk
    from dissect_tpu_torch.linalg.syrk import standardize_chunk

    d = _imputed_on_card(gen, m, n, 0.01, device)
    mean, inv_std = _float_scaling(d)
    z, o = standardize_chunk(d, mean, inv_std, torch.float32)
    z, o = z.contiguous(), o.contiguous()
    k_kern = gk.syrk_triangle_packed(z, block_n)
    k_plain = gk.plain_syrk_triangle_packed(z, block_n)
    c_kern = gk.syrk_triangle_packed(o, block_n)
    c_plain = gk.plain_syrk_triangle_packed(o, block_n)
    torch.cuda.synchronize()
    check(tuple(k_kern.shape) == gk.packed_shape(n, block_n), f"K2 output shape {tuple(k_kern.shape)}")
    err = float((k_kern - k_plain).abs().max())
    scale = float(k_plain.abs().max())
    mask_equal = bool(torch.equal(c_kern, c_plain))
    log(f"K2 m={m} n={n} block_n={block_n}: max_abs_err {err:.3e} (scale {scale:.3e}, "
        f"tol {K2_REL_TOL:g} x scale), mask product exact: {mask_equal}")
    check(math.isfinite(err) and err <= K2_REL_TOL * scale, "K2 disagrees with its plain version")
    check(mask_equal, "K2 on the 0/1 mask differs from its plain version")
    if not timed:
        return None
    ms = time_ms(lambda: gk.syrk_triangle_packed(z, block_n))
    plain_ms = time_ms(lambda: gk.plain_syrk_triangle_packed(z, block_n), iters=5)
    library_ms = time_ms(lambda: torch.mm(z.T, z), iters=5)
    shape = gk.packed_shape(n, block_n)
    n_bytes = 4 * m * n + 4 * shape[0] * shape[1]  # z read, packed tiles written
    n_flops = 2 * m * _needed_entries(n, block_n)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {
        "name": "syrk_triangle_packed",
        "route": "cuda",
        "source": "dissect_tpu_torch/csrc/syrk_packed.cu",
        "replaces": "dissect_tpu/linalg/pallas_syrk.py:61",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": library_ms,
        "shape": {"m": m, "n": n, "block_n": block_n},
    }


def _k3_inputs(gen, m, n, q, device):
    from dissect_tpu_torch.gwas.mlm import refit_features

    g = torch.randn((m, n), generator=gen, device=device)
    lam = 3.0 * torch.rand((n,), generator=gen, device=device)
    s = torch.randn((n, q), generator=gen, device=device)
    thetas = 0.1 + torch.rand((m, 2), generator=gen, device=device)
    feats = refit_features(s, lam).contiguous()
    return g, thetas, lam, s, feats


def compare_k3(gen, m, n, q, device, timed):
    from dissect_tpu_torch.gwas import moments_kernels as mk

    g, thetas, lam, s, feats = _k3_inputs(gen, m, n, q, device)
    out = mk.fused_refit_moments(g, thetas, lam, s, feats)
    ref = mk.plain_refit_moments(g, thetas, lam, s, feats)
    torch.cuda.synchronize()
    k_feats = feats.shape[1]
    total = mk.moment_columns(q, k_feats)[-1]
    check(tuple(out.shape) == (m, total), f"K3 output shape {tuple(out.shape)}")
    err = float((out - ref).abs().max())
    col_scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    rel = float(((out - ref).abs().amax(dim=0) / col_scale).max())
    log(f"K3 m={m} n={n} q={q} K={k_feats}: max_abs_err {err:.3e}, worst column error "
        f"{rel:.3e} of its scale (tol {K3_REL_TOL:g})")
    check(math.isfinite(rel) and rel <= K3_REL_TOL, "K3 disagrees with its plain version")
    if not timed:
        return None
    ms = time_ms(lambda: mk.fused_refit_moments(g, thetas, lam, s, feats))
    plain_ms = time_ms(lambda: mk.plain_refit_moments(g, thetas, lam, s, feats), iters=5)
    n_bytes = 4 * (m * n + 2 * m + n + n * q + n * k_feats + m * total)
    n_flops = 2 * total * m * n  # one FMA per output column per element of g
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    return {
        "name": "fused_refit_moments",
        "route": "cuda",
        "source": "dissect_tpu_torch/csrc/refit_moments.cu",
        "replaces": "dissect_tpu/gwas/pallas_moments.py:81",
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "shape": {"m": m, "n": n, "q": q, "k_feats": k_feats},
    }


def phase_kernels(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    compare_k1(gen, GRM_CHUNK, 1000, BLOCK_N, device, timed=False)
    compare_k1(gen, 333, 1000, 200, device, timed=False)
    k1 = compare_k1(gen, GRM_CHUNK, N_INDIVIDUALS, BLOCK_N, device, timed=True)
    compare_k2(gen, 333, 1000, 200, device, timed=False)
    k2 = compare_k2(gen, GRM_CHUNK, N_INDIVIDUALS, BLOCK_N, device, timed=True)
    compare_k3(gen, 777, 1000, 4, device, timed=False)
    compare_k3(gen, 300, 1000, 9, device, timed=False)
    k3 = compare_k3(gen, N_SNPS, N_INDIVIDUALS, 4, device, timed=True)
    return [k1, k2, k3]


# ----------------------------------------------------------------- phase 3 --
def phase_golden(workdir):
    """The CLI on tests/golden on the card.  The GRMs (PLINK and BGEN
    input) are float32 on both sides: kernel at rtol 1e-5 (sums in
    another order), counts exact, ids and SNP lists equal.
    The GWAS runs in float32 on the card against float64 golden files:
    estimates and SEs at rtol 1e-3 (atol 1e-3 x SE for estimates near 0),
    and the same unfitted SNPs."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.io.grm_io import read_grm

    golden = REPO / "tests" / "golden"
    out = workdir / "golden"
    base = ["--bfile", str(golden / "cohort"), "--pheno", str(golden / "pheno.txt")]
    main(["--make-grm"] + base + ["--out", f"{out}"])
    main(["--gwas"] + base + ["--out", f"{out}.ols"])
    main(["--gwas", "--grm", f"{out}"] + base + ["--out", f"{out}.mlm"])
    new, old = read_grm(str(out)), read_grm(str(golden / "golden"))
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(new["counts"], old["counts"])
    for kind in ("ols", "mlm"):
        ours = _read_gwas(Path(f"{out}.{kind}.gwas.snps"))
        ref = _read_gwas(golden / f"golden.{kind}.gwas.snps")
        check(list(ours) == list(ref), f"golden {kind}: fitted SNP set differs")
        got, want = np.array(list(ours.values())), np.array(list(ref.values()))
        np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-3, err_msg=f"{kind} SE")
        np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3,
                                   atol=1e-3 * float(want[:, 1].min()), err_msg=f"{kind} BETA")
    unfit_ours = Path(f"{out}.mlm.gwas.unfitted").read_text().split()
    unfit_ref = (golden / "golden.mlm.gwas.unfitted").read_text().split()
    check(unfit_ours == unfit_ref, f"golden mlm: unfitted {unfit_ours} != {unfit_ref}")
    # the BGEN-ingested GRM: K2 on the card against golden.bgen.grm.*
    main(["--make-grm", "--bgen", str(golden / "cohort.bgen"), "--out", f"{out}.bgen"])
    new, old = read_grm(f"{out}.bgen"), read_grm(str(golden / "golden.bgen"))
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(new["counts"], old["counts"])
    for ext in ("grm.ids", "grm.snps"):
        check(Path(f"{out}.bgen.{ext}").read_bytes() == (golden / f"golden.bgen.{ext}").read_bytes(),
              f"golden BGEN .{ext} differs")
    log("golden cohort on the card: GRM, OLS and mixed-model GWAS, and the BGEN GRM, "
        "agree with tests/golden")


def _read_gwas(path):
    """SNP -> (BETA, SE, PV) from a .gwas.snps file."""
    rows = {}
    with open(path) as fh:
        next(fh)
        for line in fh:
            f = line.split()
            rows[f[1]] = (float(f[5]), float(f[7]), float(f[8]))
    return rows


# ----------------------------------------------------------------- phase 4 --
def _write_traits(workdir, gen, causal_rows, ids, device):
    """The phenotype (h2 = 0.5 from the causal rows, 2 quantitative
    covariates with effects 0.3 and -0.2) and the covariate file, each row
    keyed by its (FID, IID) pair.  Missing genotypes (-1 or NaN) count 0."""
    d = causal_rows
    obs = torch.isfinite(d) if d.is_floating_point() else d >= 0
    df = torch.where(obs, d, torch.zeros_like(d)).to(torch.float64)
    mu = df.sum(1, keepdim=True) / obs.sum(1, keepdim=True)
    zc = torch.where(obs, (df - mu) / df.std(1, keepdim=True), torch.zeros_like(df))
    n = d.shape[1]
    beta = torch.randn((d.shape[0],), generator=gen, device=device, dtype=torch.float64)
    genetic = beta @ zc
    genetic = genetic / genetic.std() * math.sqrt(0.5)
    noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
    qcov = torch.randn((n, 2), generator=gen, device=device, dtype=torch.float64)
    y = 1.0 + qcov @ torch.tensor([0.3, -0.2], device=device, dtype=torch.float64) + genetic \
        + noise * math.sqrt(0.5)
    y_h, q_h = y.cpu().numpy(), qcov.cpu().numpy()
    with open(workdir / "pheno.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            fh.write(f"{fid} {iid} {y_h[i]:.10f}\n")
    with open(workdir / "qcovar.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            fh.write(f"{fid} {iid} {q_h[i, 0]:.10f} {q_h[i, 1]:.10f}\n")


def _snp_infos(m):
    from dissect_tpu_torch.io.bed import SnpInfo

    return [SnpInfo(str(1 + i * 22 // m), f"rs{i:06d}", 0.0, 1000 + 100 * i, "A", "G")
            for i in range(m)]


def write_cohort(workdir, device):
    """The synthetic PLINK cohort, made on the card from SEED: PLINK files,
    a 2-column quantitative covariate file and the phenotype."""
    from dissect_tpu_torch.io.bed import IndividualInfo, PlinkData, write_plink

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    n, m = N_INDIVIDUALS, N_SNPS
    dosage = np.empty((m, n), dtype=np.int8)
    step = 5000
    for s in range(0, m, step):
        dosage[s:s + step] = _dosage_on_card(gen, min(step, m - s), n, 0.01, device).cpu().numpy()
    causal = torch.randperm(m, generator=gen, device=device)[:N_CAUSAL].sort().values
    d = torch.as_tensor(dosage[causal.cpu().numpy()], device=device)
    ids = [(f"F{i}", f"I{i}") for i in range(n)]
    _write_traits(workdir, gen, d, ids, device)
    data = PlinkData(
        snps=_snp_infos(m),
        individuals=[IndividualInfo(fid, iid) for fid, iid in ids],
        _dosage=dosage,
    )
    prefix = workdir / "cohort"
    write_plink(str(prefix), data)
    return ["--bfile", str(prefix)], {f"rs{i:06d}" for i in causal.cpu().numpy()}


def drive_path(tag, workdir, genotype_args, counters, expect):
    """`--make-grm` then `--gwas --grm` through the CLI's main(), with
    every launch counter zeroed just before and read just after; fails if
    a kernel in `expect` was not launched.  Returns (launches, seconds),
    the seconds of each step and of its dispatcher phases."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.runtime.timers import timers

    args = genotype_args + ["--pheno", str(workdir / "pheno.txt"),
                            "--qcovar", str(workdir / "qcovar.txt")]
    for fn in counters.values():
        fn.launches = 0
    seconds = {}
    t0 = time.monotonic()
    main(["--make-grm"] + args + ["--out", str(workdir / "grm")])
    seconds[f"{tag}make_grm"] = time.monotonic() - t0
    seconds.update({f"{tag}make_grm.{k}": v for k, v in timers.elapsed.items()})
    t0 = time.monotonic()
    main(["--gwas", "--grm", str(workdir / "grm")] + args + ["--out", str(workdir / "mlm")])
    seconds[f"{tag}gwas_grm"] = time.monotonic() - t0
    seconds.update({f"{tag}gwas_grm.{k}": v for k, v in timers.elapsed.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"{tag or 'plink_'}path launches: " + json.dumps(launches))
    for name in expect:
        check(launches[name] > 0, f"kernel {name} was not launched on the {tag or 'plink_'}path")
    return launches, seconds


# ----------------------------------------------------------------- phase 5 --
def science_checks(workdir, causal, n_snps):
    """The GRM (finite, symmetric, counts in range, mean diagonal near 1)
    and the GWAS (every SNP fitted or listed unfitted, under 1% unfitted,
    finite, causal SNPs at least 10x enriched among the smallest
    p-values) of one path."""
    from dissect_tpu_torch.io.grm_io import read_grm

    grm = read_grm(str(workdir / "grm"))
    k, c = grm["kernel"], grm["counts"]
    check(k.shape == (N_INDIVIDUALS, N_INDIVIDUALS) and np.isfinite(k).all(), "GRM not finite")
    check(np.array_equal(k, k.T) and np.array_equal(c, c.T), "GRM not symmetric")
    check(c.max() <= n_snps and c.min() > 0.9 * n_snps, "GRM counts out of range")
    mean_diag = float(np.mean(np.diag(k)))
    check(abs(mean_diag - 1.0) < 0.05, f"GRM mean diagonal {mean_diag}")

    rows = _read_gwas(workdir / "mlm.gwas.snps")
    unfitted_path = workdir / "mlm.gwas.unfitted"
    unfitted = unfitted_path.read_text().split() if unfitted_path.exists() else []
    check(len(rows) + len(unfitted) == n_snps, "GWAS rows + unfitted != SNPs")
    check(len(unfitted) < 0.01 * n_snps, f"{len(unfitted)} unfitted SNPs")
    vals = np.array(list(rows.values()))
    check(np.isfinite(vals).all(), "non-finite GWAS output")
    names = list(rows)
    top = [names[i] for i in np.argsort(vals[:, 2])[:N_CAUSAL]]
    hits = sum(1 for nm in top if nm in causal)
    enrichment = hits / N_CAUSAL / (N_CAUSAL / n_snps)
    log(f"causal SNPs among the {N_CAUSAL} smallest p-values: {hits} "
        f"({enrichment:.1f}x the base rate); {len(unfitted)} unfitted")
    check(enrichment >= 10.0, "causal SNPs not enriched among the smallest p-values")
    return k, {"causal_in_top": hits, "enrichment": enrichment, "unfitted": len(unfitted),
               "grm_mean_diag": mean_diag}


def phase_checks(workdir, causal, device):
    """The PLINK path's science checks, and on a 512-SNP subset the refit
    through K3 against the refit through its plain version."""
    from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
    from dissect_tpu_torch.gwas.moments_kernels import plain_refit_moments
    from dissect_tpu_torch.io.bed import read_plink

    k, summary = science_checks(workdir, causal, N_SNPS)

    # 512-SNP subset: refit through K3 vs through its plain version, on the card
    data = read_plink(str(workdir / "cohort"))
    pheno = {}
    with open(workdir / "pheno.txt") as fh:
        for line in fh:
            f = line.split()
            pheno[f[0] + "@" + f[1]] = float(f[2])
    qcov = np.loadtxt(workdir / "qcovar.txt", usecols=(2, 3))
    x = np.column_stack([np.ones(N_INDIVIDUALS), qcov])
    y = np.array([pheno[kk] for kk in data.individual_keys])
    from dissect_tpu_torch.analysis.dispatcher import _centered_genotypes
    from dissect_tpu_torch.model.kernels import Kernel, KernelType
    from dissect_tpu_torch.io.phenotype import Phenotype
    from dissect_tpu_torch.io.covariate import Covariate
    from dissect_tpu_torch.reml.single import SingleREML

    kern = Kernel(name="GRM", type=KernelType.GRM, individual_keys=data.individual_keys,
                  matrix=torch.as_tensor(k, device=device, dtype=torch.float32)).diagonalize()
    null = SingleREML(
        [kern], Phenotype(keys=data.individual_keys, values=y, column=1),
        Covariate(keys=data.individual_keys, matrix=x,
                  column_names=["mean", "quantitative_1", "quantitative_2"],
                  missing_keys=[], categories=[]),
        device=device,
    ).compute()
    theta = tuple(null.result.variances)
    idx = np.arange(0, N_SNPS, N_SNPS // 512)[:512]
    stats = data.stats()
    dosage = torch.as_tensor(data.decode_chunk(0, N_SNPS)[idx], device=device)
    z = _centered_genotypes(dosage, torch.as_tensor(stats.mean[idx], device=device))
    z = z.to(torch.float32)
    args = (y, x, kern.eigenvalues, kern.eigenvectors, theta)
    fused = mlm_gwas_ml_refit(z, *args)
    plain = mlm_gwas_ml_refit(z, *args, moments=plain_refit_moments)
    both = fused.converged & plain.converged
    check(both.sum() > 0.95 * len(idx), "subset refits did not converge")
    np.testing.assert_allclose(fused.snp_se[both], plain.snp_se[both], rtol=REFIT_RTOL)
    np.testing.assert_allclose(fused.snp_beta[both], plain.snp_beta[both], rtol=REFIT_RTOL,
                               atol=REFIT_RTOL * float(plain.snp_se[both].min()))
    log(f"512-SNP subset: K3 vs plain refit agree at rtol {REFIT_RTOL:g} on {int(both.sum())} SNPs "
        f"(max beta diff {np.max(np.abs(fused.snp_beta[both] - plain.snp_beta[both])):.3e})")
    return {**summary, "null_variances": list(theta)}


# ----------------------------------------------------------------- phase 6 --
def write_bgen_cohort(workdir, device):
    """The synthetic imputed cohort, made on the card from SEED + 2, in UK
    Biobank's imputed format (BGEN layout 2, 8-bit probabilities, zlib),
    written with the port's write_bgen.  BGEN sample ids give FID = IID,
    so the phenotype and covariate files carry the id in both columns."""
    from dissect_tpu_torch.io.bed import IndividualInfo
    from dissect_tpu_torch.io.bgen import BgenData, write_bgen

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    n, m = N_INDIVIDUALS, BGEN_SNPS
    dosage = np.empty((m, n), dtype=np.float32)
    step = 5000
    for s in range(0, m, step):
        dosage[s:s + step] = _imputed_on_card(gen, min(step, m - s), n, 0.01, device).cpu().numpy()
    integral = float(np.mean(dosage[:step] == np.round(dosage[:step])))
    log(f"BGEN cohort: {integral:.2%} of the first {step} variants' dosages are whole numbers")
    check(integral < 0.5, "imputed dosages are mostly whole numbers")
    causal = torch.randperm(m, generator=gen, device=device)[:N_CAUSAL].sort().values
    d = torch.as_tensor(dosage[causal.cpu().numpy()], device=device)
    ids = [(f"S{i}", f"S{i}") for i in range(n)]
    _write_traits(workdir, gen, d, ids, device)
    data = BgenData(snps=_snp_infos(m),
                    individuals=[IndividualInfo(fid, iid) for fid, iid in ids],
                    dosages=dosage)
    path = workdir / "cohort.bgen"
    write_bgen(str(path), data, bits=8, layout=2, compression="zlib")
    log(f"BGEN cohort: {path.stat().st_size / 1e6:.1f} MB for {m} variants x {n} samples")
    return ["--bgen", str(path)], {f"rs{i:06d}" for i in causal.cpu().numpy()}


def time_bgen_host(path):
    """Seconds of the two host steps inside the BGEN path's ComputeGRM and
    LoadGenotypes, read_bgen (zlib + decode) and the dosage statistics,
    timed apart once more."""
    from dissect_tpu_torch.io.bgen import read_bgen

    t0 = time.monotonic()
    data = read_bgen(path)
    t1 = time.monotonic()
    data.stats()
    t2 = time.monotonic()
    return {"bgen_host.read_bgen": t1 - t0, "bgen_host.stats": t2 - t1}


# -------------------------------------------------------------------- main --
def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs on the card only",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments
    from dissect_tpu_torch.linalg.grm_kernels import grm_fused_triangle_update, syrk_triangle_packed
    from dissect_tpu_torch.runtime.dtypes import configure_precision

    os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)  # the CLI runs on the card
    configure_precision()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    counters = {"grm_fused_triangle_update": grm_fused_triangle_update,
                "syrk_triangle_packed": syrk_triangle_packed,
                "fused_refit_moments": fused_refit_moments}
    workdir = REPO / ".chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    plink_dir, bgen_dir = workdir / "plink", workdir / "bgen"
    plink_dir.mkdir(parents=True)
    bgen_dir.mkdir()
    seconds = {}
    peak_gb = {}
    try:
        t0 = time.monotonic()
        phase_build()
        seconds["build"] = time.monotonic() - t0

        t0 = time.monotonic()
        kernels = phase_kernels(device)
        seconds["kernels"] = time.monotonic() - t0

        t0 = time.monotonic()
        phase_golden(workdir)
        seconds["golden"] = time.monotonic() - t0

        t0 = time.monotonic()
        plink_args, causal = write_cohort(plink_dir, device)
        seconds["write_cohort"] = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats(device)
        plink_launches, path_seconds = drive_path(
            "", plink_dir, plink_args, counters,
            expect=("grm_fused_triangle_update", "fused_refit_moments"))
        seconds.update(path_seconds)
        peak_gb["plink"] = torch.cuda.max_memory_allocated(device) / 1e9
        t0 = time.monotonic()
        summary = {"plink": phase_checks(plink_dir, causal, device)}
        seconds["checks"] = time.monotonic() - t0
        shutil.rmtree(plink_dir, ignore_errors=True)

        t0 = time.monotonic()
        bgen_args, causal = write_bgen_cohort(bgen_dir, device)
        seconds["write_bgen_cohort"] = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats(device)
        bgen_launches, path_seconds = drive_path(
            "bgen_", bgen_dir, bgen_args, counters,
            expect=("syrk_triangle_packed", "fused_refit_moments"))
        seconds.update(path_seconds)
        peak_gb["bgen"] = torch.cuda.max_memory_allocated(device) / 1e9
        t0 = time.monotonic()
        _, summary["bgen"] = science_checks(bgen_dir, causal, BGEN_SNPS)
        seconds["bgen_checks"] = time.monotonic() - t0
        seconds.update(time_bgen_host(bgen_args[1]))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for entry in kernels:
        by_path = {"plink": plink_launches[entry["name"]], "bgen": bgen_launches[entry["name"]]}
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
    smi = nvidia_smi_line()
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    log("main paths: " + json.dumps({**summary, "peak_device_gb": peak_gb,
                                     "individuals": N_INDIVIDUALS,
                                     "snps": {"plink": N_SNPS, "bgen": BGEN_SNPS}}))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
