"""Drive the PyTorch/CUDA port (dissect_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which stops the script on failure:

  1. build     compile every hand-written kernel under dissect_tpu_torch/csrc/
               (one nvcc per source, all started together);
  2. kernels   hold each kernel (K1, K2, K3; the genotype decoders K4
               bed_decode, K5 bed_counts, K6 bgen_decode_l2, K7
               bgen_decode_l1) against its plain PyTorch version on the card,
               at ragged shapes and at the shapes the main paths give it
               (K4-K7 bit-exact, NaN positions equal: N % 4 in {1, 2, 3},
               odd, 4- and 8-byte row strides, an individual index that
               drops and reorders or repeats, `packed`, the index and out=
               views that start inside their buffers, 0 and 1 rows, rows
               past K4's staging limit, all-missing rows; BGEN blocks of
               1 to 32 bits, phased, all missing, with probability
               streams that stop short, at every offset mod 16, blocks of
               several tiles with a haploid sample in the last, a batch
               of few variants (split over several blocks each), and
               blocks K6 and K7 must refuse: phase_bgen_kernels), and
               time kernel, plain version and (where one exists) the
               single PyTorch call that computes the same function (for K4
               the lookup gather lut[rows.long()]), with each kernel's
               bound (bytes at the memory rate, float32 flops and int8
               tensor-core operations each at its pipe's rate); K4 at a
               2,048-SNP chunk with and without a 9,000-entry index and at
               an 8,192-row block, K5 at an 8,192-row block with and
               without it, K6 and K7 at the BGEN path's 1,024-block batch
               and at UK Biobank's N = 487,409 (64 blocks), warm and with
               the L2 cache emptied before each call;
  3. golden    the CLI on the repository's golden cohort (tests/golden), PLINK
               and BGEN input, dense `--reml --blue --snp-blup`, `--pca`,
               `--bivar-reml`, regional `--reml`, grouped `--gwas`,
               `--mpresiduals`/`--mpgwas`, `--igwas`, `--simulate` and
               `--predict`, on the card, against the stored golden files;
  4. main      the PLINK path: a synthetic PLINK cohort at the size users run
               (10,000 individuals x 50,000 SNPs, 1% missing, 2 quantitative
               covariates, a phenotype with h2 = 0.5 from 500 causal SNPs),
               then `--make-grm` and `--gwas --grm` through the CLI's main();
               every kernel launch counter is zeroed just before and read
               just after;
  5. checks    finite outputs of the right shape, causal SNPs enriched among
               the smallest p-values, and on a 512-SNP subset the refit through
               K3 against the refit through K3's plain version, after the
               diagonal null REML fit of the same cohort;
  5b. reml     dense `--reml --bfile --blue --snp-blup --indiv-blup
               --indiv-blup-error` on the PLINK cohort through main(), the GRM
               built in line by K1, launch counters zeroed just before and read
               just after; its variances against the diagonal null fit's, h2,
               the covariate BLUEs, SNP BLUPs recomputed in float64 and the
               BLUP errors; one REML iteration's Cholesky inverse and the whole
               iteration timed apart;
  5k. mesh     (run right after 5b) the multi-GPU path as two torchrun ranks
               sharing the card over gloo, after a one-rank NCCL group's
               broadcast, all_reduce and all_gather: `--make-grm`, `--reml
               --bfile --blue --indiv-blup` and `--make-grm --diagonalize
               --store-both` on all 10,000 individuals with `--mesh 2
               --force-distributed` (the D&C eigensolver's operands
               row-sharded, each rank's peak device memory inside it
               recorded and bounded), and `--gwas --grm`, `--rgwas` and
               `--gwas --groups --group-effects` with `--parallel-gwas`,
               held against K1's GRM, a single-device fit of the same GRM
               (BLUEs and BLUPs too) and the 5b fit, the PLINK path's GWAS,
               the grouped phase's single-device runs (after 5f) and
               torch.linalg.eigh; K3 must launch on both ranks, every rank
               must shard its groups, and rank 0's first pass is read by
               four routes (K3, K3 on the single-device run's product
               shape, plain float32, plain float64: `first_pass_reading`);
  5c. pca      `--pca --bfile --num-eval 20` on the PLINK cohort (K1 builds
               the GRM in line; the randomized branch), each eigenvalue
               between 90% of and 1e-6 above a float64 eigh's, orthonormal
               eigenvectors, the top-k solve and the full eigh timed;
  5d. bivar    `--bivar-reml` on two traits of the PLINK cohort, the second
               missing for 1,000 individuals (Tn = 19,000 in float64): the
               genetic correlation within 4 SE of the simulated 0.5, the joint
               log-likelihood at least the two single-trait fits' sum, one
               iteration and its Cholesky inverse timed apart;
  5e. regional `--reml --groups` on four 2,000-SNP regions, one holding all
               causal SNPs: its Regional-GRM LRT p < 1e-10, the others' > 1e-6;
  5f. grouped  `--gwas --groups` on 5-SNP groups, OLS and under `--grm`, causal
               groups enriched among the smallest GROUPPVs, `--rgwas` on
               100-SNP groups, its SNPs enriched for causal ones, and the
               OLS step with `--group-effects`;
  5g. mp       `--mpresiduals` on four phenotype columns (h2 0.5, 0.3, 0.1, 0;
               K1 builds the GRM in line), the first column's residuals against
               s2_E V^-1 (y - X b) recomputed in float64, then `--mpgwas`: causal
               SNPs enriched for the h2 0.5 column, lambda_GC near 1 for the h2 0
               column;
  5h. igwas    `--igwas --grm` with the PLINK path's GRM: the per-SNP ML refits
               with the SNP as the outcome, their moments through K3 (q = 3,
               K = 15), under 1% unfitted, and on a 2,048-SNP subset the K3 route
               against the plain float64 route;
  5i. glmm     `--glmm` on a case/control coding of the trait (K1 builds the
               GRM in line), then the same argv on a 2,000 x 5,000 fileset cut
               from the cohort on the card and on the CPU, equal at rtol 1e-6,
               and a 60-individual chain whose proposals are accepted now and
               then, card against CPU;
  5j. simulate `--simulate` from the 500 causal SNPs, then `--predict` with the
               simulated effects (host numpy in both packages): the genetic
               share near --simu-h2 and the predictions equal to the simulated
               genetic values less the effects of the observed genotypes.
               Every step of 5c-5j runs through main() with the launch counters
               zeroed just before and read just after;
  6. bgen      the BGEN path: a synthetic imputed cohort of the same
               individuals and 25,000 variants in UK Biobank's format
               (BGEN layout 2, 8-bit, zlib), dosages blurred
               off the hard calls, 1% missing, the same covariate and phenotype
               recipe, then `--make-grm --bgen` and `--gwas --grm --bgen`
               through main(), launch counters zeroed just before and read just
               after, and the same science checks; then `--make-grm --bgen`
               on a layout-1 (v1.1) copy of 2,048 variants x 2,000 samples,
               which K7 decodes, against the source dosages' GRM;
  7. k3_retry  K3 held against its plain version and timed at each path's
               retry shape (the other M than all SNPs at which the path
               launched K3, as K3's launch counter by M recorded it), each
               mesh rank's included.

Every CLI step that reads --bfile must launch K4 and (unless it needs no
SNP statistics: --simulate, --predict) K5, every mesh rank's steps
included; every step that reads --bgen must launch K6 or K7 and parse no
block on the host; no step may run a decoder's plain version on a CUDA
tensor.

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

# Each kernel's bound beside its time: the least time one H100 SXM could
# take for its work, from the card's peaks.  One copy, which the
# benchmark's roofline metrics read too; tests/test_torch_bounds.py checks
# it through this module, bound_ms and _needed_entries included.
from portbench.rooflines import (bgen_bound, bound_ms, k1_bound, k2_bound, k3_bound, k4_bound,
                                 k5_bound, needed_entries as _needed_entries)

REPO = Path(__file__).resolve().parent
N_INDIVIDUALS = 10_000
N_SNPS = 50_000
N_CAUSAL = 500
SEED = 20261016
# The BGEN path's variants, half the PLINK path's 50,000, to keep the
# whole run under 600 s with the mesh phase in it
BGEN_SNPS = 25_000
N_MISSING_TRAIT2 = 1_000  # the bivariate phase's second trait misses these
N_PCS = 20
GROUP_SNPS = 5       # the grouped GWAS phase: groups of consecutive SNPs
REGION_SNPS = 2_000  # the regional phase: four groups of this many SNPs
MP_H2 = (0.5, 0.3, 0.1, 0.0)  # the mp phase's phenotype columns (the first is the trait)
PREVALENCE = 0.3     # the glmm phase's case share, cut from the trait's liability
IGWAS_SUBSET = 2_048  # SNPs of the igwas phase's K3-vs-float64 comparison
GLMM_SMALL = (2_000, 5_000)  # individuals x SNPs of the glmm card-vs-CPU fileset
GRM_CHUNK = 2048  # grm_from_plink's chunk: K1's, K2's and K4's row count on the main paths
BLOCK_ROWS = 8192  # PlinkData's row block: K5's row count in stats() (io/bed.py BLOCK_ROWS)
BGEN_BATCH = 1024  # read_bgen's batch: K6's blocks per launch (io/bgen.py _BATCH)
# K6 and K7 are also timed at UK Biobank's width: the imputed release's
# 487,409 samples, 64 variants (94 MB of layout-2 blocks, 187 MB of layout 1)
UKB_SAMPLES = 487_409
UKB_VARIANTS = 64
# The layout-1 BGEN step's variants and individuals (a corner of the BGEN
# cohort), and its GRM's distance from the source dosages' GRM: layout 1
# rounds each probability to 1/32768, a dosage error under 2e-4, which
# moves a GRM entry (a mean of products of standardized dosages) by about
# that much relative to its scale of 1.
BGEN_L1_SNPS = 2_048
BGEN_L1_N = 2_000
BGEN_L1_GRM_ATOL = 1e-3
BLOCK_N = 512     # grm_accumulator's packed tile edge

# A held timing first spins the stream this many clock cycles, about
# 0.1 s at the H100's 1.98 GHz boost clock.
HOLD_CYCLES = 200_000_000

# Tolerances of the kernel-vs-plain comparisons, relative to the largest
# magnitude of the plain result: both sides sum the same float32 terms in
# different orders, whose rounding grows like sqrt(terms) * eps32 ~ 1e-5
# at these contraction lengths (2,048 SNP rows for K1 and K2, 10,000
# eigenbasis entries for K3).  K1's counts and K2 on the 0/1 mask are sums
# of 0/1 products: exact.
K1_REL_TOL = 1e-5
K2_REL_TOL = 1e-5
K3_REL_TOL = 1e-4
# K3's lam-weighted trace column (sum_k w1 lam, a positive sum over all n
# entries) against float64: the refit's gradient subtracts two such sums
# of about 1e4 and is held to 1e-2, so they need about 1e-6 relative.
K3_TRACE_RTOL = 1e-6
# The 512-SNP refit through K3 vs through its plain version: 15 float32
# Fisher steps on moments that differ by rounding; the bound JAX's tests
# use between their two moment paths (tests/test_gwas_covariance.py).
REFIT_RTOL = 2e-3
# Golden REML files: the dense fit runs in float64 on the card, as the JAX
# package ran it on the CPU; the golden tests' tolerance.
GOLDEN_REML_RTOL = 2e-5
# The dense REML's variances against the diagonal null fit of the same
# model: both are float64 Newton fits stopped at relative variance
# changes of 1e-5, so they meet well inside 1e-4.
NULL_VS_DENSE_RTOL = 1e-4
# SNP BLUPs against their float64 recomputation from the fitted
# variances: the same float64 sums in another order.
SNP_BLUP_RTOL = 1e-6
# --mpresiduals' residuals against s2_E P y recomputed in float64 from the
# diagonal null fit: two float64 REML fits stopped at relative variance
# changes of 1e-5 (as NULL_VS_DENSE_RTOL), relative to the largest residual.
MP_RESIDUAL_RTOL = 1e-4
# The golden multi-phenotype and inverse GWAS on the card run their products
# in float32 against float64 golden files: each number within 1e-3 relative
# plus 1e-3 of its column's largest magnitude (an effect near 0 against its
# column's spread), the float32 rule of the golden GWAS.
GOLDEN_F32_RTOL = 1e-3
# The card's .glmm against the CPU run of the same argv: float64 on both
# sides, the GRM K1's (float32 sums in another order than the plain version).
GLMM_CARD_VS_CPU_RTOL = 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(*parts):
    print(*parts, flush=True)


# ------------------------------------------------------------------ timing --
def time_ms(fn, iters=10, warmup=2, held=False):
    """Mean milliseconds of fn() on the card, by CUDA events.

    held: the stream first spins HOLD_CYCLES, so the host has queued every
    call before the first one runs, and the reading is the card's time
    alone, without the host's gaps between calls that a launch of a tenth
    of a millisecond would otherwise show.  Fails if the host was not done
    queueing when the spin ended."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if held:
        torch.cuda._sleep(HOLD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    if held:
        check(not start.query(), "the timed calls started before the host had queued them all")
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# ----------------------------------------------------------------- phase 1 --
def phase_build():
    from dissect_tpu_torch.runtime import cuda_lib

    report = cuda_lib.build_all()
    for name, info in report.items():
        log(f"build {name}: {info['seconds']:.1f}s -> {info['path']}")
        for line in info["ptxas"].splitlines():
            # each kernel's (mangled) name, then its registers and spills
            if "Compiling entry" in line or "registers" in line or "spill" in line:
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
    b_ms, b_by = k1_bound(m, n, block_n)
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
    b_ms, b_by = k2_bound(m, n, block_n)
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


def compare_k3(gen, m, n, q, device, timed, iters=10):
    """K3 against its plain version.  Timed: `ms` is the kernel's launch
    on inputs the wrapper has already checked and packed, held (see
    time_ms) over `iters` calls; `wrapper_ms` is the whole wrapper call,
    host work and gaps included, as a caller pays it."""
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
    col = 2 * (q * (q + 1) // 2)  # m1's lam column (refit_features layout)
    exact = mk.plain_refit_moments(*(a.double() for a in (g, thetas, lam, s, feats)))[:, col]
    trace_err = float(((out[:, col].double() - exact).abs() / exact.abs()).max())
    plain_err = float(((ref[:, col].double() - exact).abs() / exact.abs()).max())
    log(f"K3 m={m}: trace column vs float64, worst relative error {trace_err:.2e} "
        f"(plain float32 {plain_err:.2e}, tol {K3_TRACE_RTOL:g})")
    check(trace_err <= K3_TRACE_RTOL, "K3's trace sums are not accurate enough for the refit")
    ms = time_ms(mk.prepare_refit_moments(g, thetas, lam, s, feats), iters=iters, held=True)
    wrapper_ms = time_ms(lambda: mk.fused_refit_moments(g, thetas, lam, s, feats), iters=iters)
    plain_ms = time_ms(lambda: mk.plain_refit_moments(g, thetas, lam, s, feats), iters=5)
    b_ms, b_by = k3_bound(m, n, q, k_feats)
    return {
        "name": "fused_refit_moments",
        "route": "cuda",
        "source": "dissect_tpu_torch/csrc/refit_moments.cu",
        "replaces": "dissect_tpu/gwas/pallas_moments.py:81",
        "max_abs_err": err,
        "trace_rel_err": trace_err,
        "ms": ms,
        "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "shape": {"m": m, "n": n, "q": q, "k_feats": k_feats},
    }


# K4-K7, the genotype decoders (io/genotype_kernels.py): bit-exact against
# their plain versions, so the check is equality, with NaN positions equal.
# They move bytes and do next to no arithmetic: each bound is the bytes
# read once and written once at the memory rate (k4_bound, k5_bound,
# bgen_bound).
def _packed_on_card(gen, m, n, device, row_offset=0):
    """(m, ceil(n/4)) random .bed rows, the last byte's unused codes
    random too, and row 1 all missing; with row_offset, a view that starts
    that many rows into its buffer."""
    rows = torch.randint(0, 256, (m + row_offset, (n + 3) // 4), generator=gen, device=device,
                         dtype=torch.uint8)
    if m > 1:
        rows[row_offset + 1] = 0b01010101
    return rows[row_offset:]


def _cols_on_card(gen, n, device, repeat=False, offset=0):
    """An individual index that drops a tenth of n and reorders the rest;
    with repeat, its last entry names its first individual again; with
    offset, a view that starts that many entries into its buffer."""
    perm = torch.randperm(n, generator=gen, device=device)
    keep = n - n // 10
    cols = torch.empty((offset + keep,), dtype=torch.int32, device=device)[offset:]
    cols.copy_(perm[:keep])
    if repeat:
        cols[-1] = cols[0]
    return cols


def _same_bits(a, b):
    """Equal values, NaN positions equal (torch.equal sees NaN != NaN)."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(nan_a, nan_b)) and bool(
        torch.equal(torch.where(nan_a, 0.0, a), torch.where(nan_b, 0.0, b)))


def _max_abs_diff(a, b):
    """max |a - b| in float64 over the positions where neither is NaN (0
    where there are none)."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    both = ~(torch.isnan(a) | torch.isnan(b))
    return float((a - b).abs()[both].max()) if bool(both.any()) else 0.0


def _decode_case(m, n, with_cols, row_offset, repeat, out_shift=None):
    tags = [f"m={m}", f"n={n}", "cols=" + ("repeating" if repeat else
                                           "dropped and reordered" if with_cols else "all")]
    if row_offset:
        tags.append(f"packed {row_offset} row into its buffer")
        if with_cols:
            tags.append("cols 1 entry into its buffer")
    if out_shift:
        tags.append(f"out 1 {out_shift} into its buffer")
    return " ".join(tags)


def _timed_entry(entry, keys=("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                              "max_abs_err", "shape")):
    return {key: entry[key] for key in keys}


def compare_k4(gen, m, n, device, with_cols, timed=False, row_offset=0, out_shift=None,
               repeat=False):
    """K4 against its plain version (the lookup table as a torch gather),
    with an individual index that drops and reorders (or repeats) or
    without one; `packed` may start `row_offset` rows into its buffer (and
    the index as many entries into its own), and out= one row or one byte
    (`out_shift`) into its own, whose bytes before it must stay untouched.
    Timed: the kernel into a given out= (as io/bed.py calls it), the plain
    version, and the one-call lookup gather lut[rows.long()] (which decodes
    all individuals: no one call gathers through the index) as its
    library call."""
    from dissect_tpu_torch.io import genotype_kernels as gk

    packed = _packed_on_card(gen, m, n, device, row_offset)
    cols = (_cols_on_card(gen, n, device, repeat, offset=row_offset)
            if with_cols or repeat else None)
    n_out = n if cols is None else cols.shape[0]
    skip = {None: 0, "row": n_out, "byte": 1}[out_shift]
    buf = torch.full((skip + m * n_out,), 77, dtype=torch.int8, device=device)
    dst = buf[skip:].view(m, n_out)
    out = gk.bed_decode(packed, n, cols, out=dst)
    ref = gk.plain_bed_decode(packed, n, cols)
    torch.cuda.synchronize()
    equal = out is dst and bool(torch.equal(out, ref)) and bool((buf[:skip] == 77).all())
    err = _max_abs_diff(out, ref)
    log(f"K4 {_decode_case(m, n, with_cols, row_offset, repeat, out_shift)}: "
        f"bit-exact {equal}, max abs err {err}")
    check(equal, "K4 disagrees with its plain version")
    if not timed:
        return None
    lut = gk._byte_lut(device)
    b_ms, b_by = k4_bound(m, n, None if cols is None else n_out)
    return {
        "name": "bed_decode", "route": "cuda", "source": "dissect_tpu_torch/csrc/bed_decode.cu",
        "replaces": "dissect_tpu/native/bed_decode.cpp:36", "max_abs_err": err,
        "ms": time_ms(lambda: gk.bed_decode(packed, n, cols, out=dst), iters=50, held=True),
        "plain_ms": time_ms(lambda: gk.plain_bed_decode(packed, n, cols), iters=5),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: lut[packed.long()], iters=5),
        "shape": {"m": m, "n": n, "n_bytes": packed.shape[1], "n_out": n_out},
    }


def compare_k5(gen, m, n, device, with_cols, timed=False, row_offset=0, repeat=False):
    """K5's counts against its plain version (a reduction over the plain
    decode), over all individuals, a dropped and reordered index or one
    that repeats an individual (the gather route); `packed` may start
    `row_offset` rows into its buffer, and the index as many entries."""
    from dissect_tpu_torch.io import genotype_kernels as gk

    packed = _packed_on_card(gen, m, n, device, row_offset)
    cols = (_cols_on_card(gen, n, device, repeat, offset=row_offset)
            if with_cols or repeat else None)
    out = gk.bed_counts(packed, n, cols)
    ref = gk.plain_bed_counts(packed, n, cols)
    torch.cuda.synchronize()
    n_out = n if cols is None else cols.shape[0]
    equal = bool(torch.equal(out, ref)) and bool((out.sum(1) == n_out).all())
    err = _max_abs_diff(out, ref)
    log(f"K5 {_decode_case(m, n, with_cols, row_offset, repeat)}: "
        f"bit-exact {equal}, max abs err {err}")
    check(equal, "K5 disagrees with its plain version")
    if not timed:
        return None
    b_ms, b_by = k5_bound(m, n, None if cols is None else n_out)
    return {
        "name": "bed_counts", "route": "cuda", "source": "dissect_tpu_torch/csrc/bed_decode.cu",
        "replaces": "dissect_tpu/native/bed_decode.cpp:59", "max_abs_err": err,
        "ms": time_ms(lambda: gk.bed_counts(packed, n, cols), iters=50, held=True),
        "plain_ms": time_ms(lambda: gk.plain_bed_counts(packed, n, cols), iters=5),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"m": m, "n": n, "n_bytes": packed.shape[1], "n_out": n_out},
    }


def _layout2_block(rng, n, bits, phased, ploidy, cut=0):
    """One uncompressed layout-2 block of random `bits`-bit values; with
    `cut`, its probability stream that many bytes short (the values past
    its end read as 0)."""
    vals = rng.integers(0, 2 ** bits, size=2 * n, dtype=np.uint64)
    planes = (vals[:, None] >> np.arange(bits, dtype=np.uint64)) & np.uint64(1)
    probs = np.packbits(planes.astype(np.uint8).ravel(), bitorder="little").tobytes()
    block = (np.array([n], "<u4").tobytes() + np.array([2], "<u2").tobytes() + bytes([2, 2])
             + bytes(ploidy) + bytes([phased, bits]) + probs)
    return block[:len(block) - cut]


def _some_missing(rng, n):
    ploidy = np.full(n, 2, dtype=np.uint8)
    ploidy[rng.choice(n, size=max(1, n // 50), replace=False)] = 0x82
    return ploidy


def _ragged_l2_blocks(rng, n):
    """Layout-2 blocks at 1, 3, 8, 11, 12, 16, 24, 31 and 32 bits (K6's
    table up to 11, the division in line beyond), unphased and phased, a few
    missing samples each; one all missing; two whose probability stream
    stops short, followed by other bytes (8 bits at half its samples, 12
    bits 7 bytes short: the rest reads as 0); and one K6 must refuse (a
    haploid sample: status 1)."""
    ploidy = _some_missing(rng, n)
    blocks = [_layout2_block(rng, n, bits, phased, ploidy)
              for bits in (1, 3, 8, 11, 12, 16, 24, 31, 32) for phased in (0, 1)]
    blocks.append(_layout2_block(rng, n, 8, 0, np.full(n, 0x82, dtype=np.uint8)))
    blocks.append(_layout2_block(rng, n, 8, 0, ploidy, cut=n))
    blocks.append(_layout2_block(rng, n, 12, 1, ploidy, cut=7))
    haploid = ploidy.copy()
    haploid[n // 2] = 1
    blocks.append(_layout2_block(rng, n, 8, 0, haploid))
    return blocks, [0] * (len(blocks) - 1) + [1]


def _tiled_l2_blocks(rng, n):
    """Blocks of several of K6's 2,048-sample tiles: 8-bit unphased,
    16-bit phased, 8-bit with its stream stopping at half its samples, and
    one whose last sample is haploid, found in its last tile after the
    earlier tiles decoded (status 1, the whole row NaN)."""
    ploidy = _some_missing(rng, n)
    haploid = ploidy.copy()
    haploid[-1] = 1
    blocks = [_layout2_block(rng, n, 8, 0, ploidy), _layout2_block(rng, n, 16, 1, ploidy),
              _layout2_block(rng, n, 8, 0, ploidy, cut=n), _layout2_block(rng, n, 8, 0, haploid)]
    return blocks, [0, 0, 0, 1]


def _main_l2_batch(rng, k, n):
    """The BGEN path's batch: k unphased 8-bit blocks of 10 + 3N bytes,
    1% of samples missing, random probability bytes."""
    width = 10 + 3 * n
    raw = np.empty((k, width), dtype=np.uint8)
    raw[:, :8] = np.frombuffer(np.array([n], "<u4").tobytes() + bytes([2, 0, 2, 2]), np.uint8)
    raw[:, 8:8 + n] = np.where(rng.random((k, n)) < 0.01, 0x82, 2)
    raw[:, 8 + n] = 0
    raw[:, 9 + n] = 8
    raw[:, 10 + n:] = rng.integers(0, 256, size=(k, 2 * n), dtype=np.uint8)
    return [row.tobytes() for row in raw], [0] * k


def _blocks_on_card(blocks, device, align=False):
    """The blocks in one buffer on the card, end to end as read_bgen lays
    them or, with `align`, block i at an offset = i mod 16, after 0-15
    filler bytes 0xA5."""
    parts, offsets, at = [], [], 0
    for i, block in enumerate(blocks):
        pad = (i - at) % 16 if align else 0
        parts += [b"\xa5" * pad, block]
        offsets.append(at + pad)
        at += pad + len(block)
    lengths = np.array([len(b) for b in blocks], dtype=np.int64)
    buf = torch.frombuffer(bytearray(b"".join(parts)), dtype=torch.uint8).to(device)
    return (buf, torch.as_tensor(np.array(offsets, dtype=np.int64), device=device),
            torch.as_tensor(lengths, device=device))


def time_cold_ms(fn, iters=10):
    """Mean milliseconds of fn() on the card with the 50 MB L2 emptied
    before each call (a 256 MB write), by CUDA events around each call;
    the stream first spins, so the host has queued the call."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    total = 0.0
    fn()
    for _ in range(iters):
        flush.fill_(1)
        torch.cuda._sleep(HOLD_CYCLES // 100)
        start.record()
        fn()
        stop.record()
        check(not start.query(), "the cold call started before the host had queued it")
        torch.cuda.synchronize()
        total += start.elapsed_time(stop)
    return total / iters


def compare_bgen(kernel, blocks, statuses, n, device, timed=False, align=False, out_shift=0):
    """K6 (`bgen_decode_l2`) or K7 (`bgen_decode_l1`) against its plain
    version on the same uploaded blocks (with `align`, at every offset mod
    16): dosages bit-exact with NaN positions equal, statuses equal and as
    expected; the kernel writes into out=, a view `out_shift` floats into
    its buffer, whose floats around it stay untouched.  Timed: the kernel
    into out= (as io/bgen.py calls it), held, and again with the L2 cache
    emptied before each call (cold_ms), and the plain version."""
    from dissect_tpu_torch.io import genotype_kernels as gk

    fn, plain = getattr(gk, kernel), getattr(gk, "plain_" + kernel)
    buf, offsets, lengths = _blocks_on_card(blocks, device, align)
    size = len(blocks) * n
    store = torch.full((out_shift + size + 4,), 77.0, device=device)
    dst = store[out_shift:out_shift + size].view(len(blocks), n)
    out, status = fn(buf, offsets, lengths, n, out=dst)
    ref, ref_status = plain(buf, offsets, lengths, n)
    torch.cuda.synchronize()
    untouched = bool((store[:out_shift] == 77).all()) and bool((store[out_shift + size:] == 77).all())
    equal = out is dst and untouched and _same_bits(out, ref) and bool(torch.equal(status, ref_status))
    err = _max_abs_diff(out, ref)
    expected = status.cpu().tolist() == list(statuses)
    log(f"{kernel} {len(blocks)} blocks n={n}{' at every offset mod 16' if align else ''}"
        f"{f' out {out_shift} floats in' if out_shift else ''}: bit-exact {equal}, "
        f"max abs err {err}, statuses as expected {expected}")
    check(equal, f"{kernel} disagrees with its plain version")
    check(expected, f"{kernel} statuses {status.cpu().tolist()} != {list(statuses)}")
    if not timed:
        return None
    b_ms, b_by = bgen_bound(buf.numel(), len(blocks), n)
    start = "86" if kernel == "bgen_decode_l2" else "154"
    return {
        "name": kernel, "route": "cuda", "source": "dissect_tpu_torch/csrc/bgen_decode.cu",
        "replaces": f"dissect_tpu/native/bgen_decode.cpp:{start}", "max_abs_err": err,
        "ms": time_ms(lambda: fn(buf, offsets, lengths, n, out=dst), iters=20, held=True),
        "cold_ms": time_cold_ms(lambda: fn(buf, offsets, lengths, n, out=dst)),
        "plain_ms": time_ms(lambda: plain(buf, offsets, lengths, n), iters=3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"blocks": len(blocks), "n": n, "bytes": buf.numel(),
                  "out_bytes": 4 * size},
    }


def _main_l1_batch(rng, k, n):
    """k layout-1 blocks of 6 N bytes: uint16 probability triples, 1% of
    samples all zero (missing)."""
    triples = rng.integers(0, 32769, size=(k, n, 3), dtype=np.uint16).astype("<u2")
    triples[rng.random((k, n)) < 0.01] = 0
    return [t.tobytes() for t in triples], [0] * k


def phase_bgen_kernels(device):
    """K6 and K7 against their plain versions (bit-exact), then timed:
    every bit width, phased, missing samples, streams that stop short, a
    refused block, blocks at every offset mod 16 and N % 4 in {0, 1, 2,
    3}, out= views into their buffers, blocks of several tiles with a
    haploid sample in the last (few variants, split over several blocks
    each, and a batch of one block each); then the BGEN path's batch
    (1,024 8-bit unphased blocks at N = 10,000), a layout-1 batch of the
    same size, and both at UK Biobank's N = 487,409 (64 variants)."""
    rng = np.random.default_rng(SEED + 4)
    blocks, statuses = _ragged_l2_blocks(rng, 1001)
    compare_bgen("bgen_decode_l2", blocks, statuses, 1001, device)
    for n in (1001, 1002, 1003, 1004):
        blocks, statuses = _ragged_l2_blocks(rng, n)
        compare_bgen("bgen_decode_l2", blocks, statuses, n, device, align=True, out_shift=n % 3)
    tiled, tiled_status = _tiled_l2_blocks(rng, 5003)
    compare_bgen("bgen_decode_l2", tiled, tiled_status, 5003, device, out_shift=1)
    blocks, statuses = _main_l2_batch(rng, BGEN_BATCH - len(tiled), 5003)
    compare_bgen("bgen_decode_l2", blocks + tiled, statuses + tiled_status, 5003, device)
    k6 = compare_bgen("bgen_decode_l2", *_main_l2_batch(rng, BGEN_BATCH, N_INDIVIDUALS),
                      N_INDIVIDUALS, device, timed=True)
    for n in (1001, 1002, 1003):
        blocks, statuses = _main_l1_batch(rng, 17, n)
        compare_bgen("bgen_decode_l1", blocks + [b"\x00" * (6 * n - 1)], statuses + [1], n,
                     device, align=True, out_shift=n % 3)
    blocks, statuses = _main_l1_batch(rng, 3, 5003)
    compare_bgen("bgen_decode_l1", blocks + [b"\x01" * (6 * 5003 + 6)], statuses + [1], 5003,
                 device)
    k7 = compare_bgen("bgen_decode_l1", *_main_l1_batch(rng, BGEN_BATCH, N_INDIVIDUALS),
                      N_INDIVIDUALS, device, timed=True)
    keys = ("ms", "cold_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "shape")
    for entry, kernel, batch in ((k6, "bgen_decode_l2", _main_l2_batch),
                                 (k7, "bgen_decode_l1", _main_l1_batch)):
        entry["ukb_shape"] = _timed_entry(compare_bgen(
            kernel, *batch(rng, UKB_VARIANTS, UKB_SAMPLES), UKB_SAMPLES, device, timed=True), keys)
    return k6, k7


def phase_kernels(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    # K1: rows and columns not 16-byte aligned (byte staging), aligned
    # with ragged tiles and stage (cp.async staging), the last chunk of the
    # main paths (848 rows), and the main shape
    compare_k1(gen, GRM_CHUNK, 1000, BLOCK_N, device, timed=False)
    compare_k1(gen, 333, 1000, 200, device, timed=False)
    compare_k1(gen, 100, 1008, 256, device, timed=False)
    compare_k1(gen, N_SNPS % GRM_CHUNK, N_INDIVIDUALS, BLOCK_N, device, timed=False)
    k1 = compare_k1(gen, GRM_CHUNK, N_INDIVIDUALS, BLOCK_N, device, timed=True)
    compare_k2(gen, 333, 1000, 200, device, timed=False)
    k2 = compare_k2(gen, GRM_CHUNK, N_INDIVIDUALS, BLOCK_N, device, timed=True)
    # K3: one row, ragged shapes (split n, several column chunks), the main shape
    compare_k3(gen, 1, 1000, 4, device, timed=False)
    compare_k3(gen, 777, 1000, 4, device, timed=False)
    compare_k3(gen, 777, 1000, 9, device, timed=False)
    compare_k3(gen, 300, 1000, 9, device, timed=False)
    k3 = compare_k3(gen, N_SNPS, N_INDIVIDUALS, 4, device, timed=True)
    # the BGEN path's M and each mesh rank's share of the PLINK path's SNPs
    for m in sorted({BGEN_SNPS, -(-N_SNPS // MESH_RANKS)}):
        compare_k3(gen, m, N_INDIVIDUALS, 4, device, timed=False)
    # the igwas refit's layout: s = the 3 rotated covariates, K = 15
    compare_k3(gen, 777, 1000, 3, device, timed=False)
    k3_igwas = compare_k3(gen, N_SNPS, N_INDIVIDUALS, 3, device, timed=True)
    k3["igwas_shape"] = {key: k3_igwas[key] for key in (
        "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
        "trace_rel_err", "shape")}
    # K4, K5 bit-exact: N % 4 in {1, 2, 3}; row strides of 251, 252, 253
    # and 280 bytes (N = 1,004, 1,008, 1,012, 1,120: odd, 4-byte and
    # 8-byte aligned rows; 1,120's index of 1,008 gives 16-byte output
    # rows); each with and without an index that drops and reorders, and
    # with one that repeats an individual (K5's gather route), an
    # all-missing row (row 1 of each); `packed` one row into its buffer
    # (the index one entry into its own: 4-byte, not 16-byte aligned), out=
    # one row and one byte into its own; one row and none; rows over
    # the staging limit (N = 400,004: K4's gather from global memory)
    for n in (1001, 1002, 1003, 1004, 1008, 1012, 1120):
        for with_cols in (False, True):
            compare_k4(gen, 333, n, device, with_cols)
            compare_k5(gen, 333, n, device, with_cols)
        compare_k4(gen, 333, n, device, True, repeat=True)
        compare_k5(gen, 333, n, device, True, repeat=True)
    for n in (1004, 1008, 1012):
        for with_cols in (False, True):
            compare_k4(gen, 333, n, device, with_cols, row_offset=1)
            compare_k5(gen, 333, n, device, with_cols, row_offset=1)
            for out_shift in ("row", "byte"):
                compare_k4(gen, 333, n, device, with_cols, row_offset=1, out_shift=out_shift)
    for m in (1, 0):
        for with_cols in (False, True):
            compare_k4(gen, m, N_INDIVIDUALS, device, with_cols)
            compare_k5(gen, m, N_INDIVIDUALS, device, with_cols)
    for with_cols in (False, True):
        compare_k4(gen, 3, 400_004, device, with_cols, row_offset=1)
        compare_k5(gen, 3, 400_004, device, with_cols, row_offset=1)
    # timed at the main paths' shapes: K4 on a 2,048-SNP GRM chunk, all
    # individuals (the GRM path) and through a 9,000-entry index (a
    # filtered PlinkData), and on an 8,192-row block (a whole-file decode);
    # K5 on an 8,192-row block, without and with the index, and with an
    # index that repeats one individual (the gather route)
    k4 = compare_k4(gen, GRM_CHUNK, N_INDIVIDUALS, device, False, timed=True)
    k4["index_shape"] = _timed_entry(
        compare_k4(gen, GRM_CHUNK, N_INDIVIDUALS, device, True, timed=True))
    k4["block_shape"] = _timed_entry(
        compare_k4(gen, BLOCK_ROWS, N_INDIVIDUALS, device, False, timed=True))
    k5 = compare_k5(gen, BLOCK_ROWS, N_INDIVIDUALS, device, False, timed=True)
    k5["index_shape"] = _timed_entry(
        compare_k5(gen, BLOCK_ROWS, N_INDIVIDUALS, device, True, timed=True))
    k5["repeated_index"] = _timed_entry(
        compare_k5(gen, BLOCK_ROWS, N_INDIVIDUALS, device, True, timed=True, repeat=True))
    k6, k7 = phase_bgen_kernels(device)
    return [k1, k2, k3, k4, k5, k6, k7]


def k3_at_retry(device, retry_rows):
    """K3 checked and timed at each path's retry shape (its rows, n =
    10,000, q = 4; each mesh rank's apart), after the paths: these
    launches do not count.  A
    launch takes about a tenth of a millisecond here, so the held timing
    runs 200 of them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 3)
    timed = {}
    for tag, rows in retry_rows.items():
        if rows:
            entry = compare_k3(gen, rows, N_INDIVIDUALS, 4, device, timed=True, iters=200)
            timed[tag] = {key: entry[key] for key in ("ms", "wrapper_ms", "shape", "max_abs_err")}
    return timed


# ----------------------------------------------------------------- phase 3 --
def phase_golden(workdir):
    """The CLI on tests/golden on the card.  The GRMs (PLINK and BGEN
    input) are float32 on both sides: kernel at rtol 1e-5 (sums in
    another order), counts exact, ids and SNP lists equal.
    The GWAS runs in float32 on the card against float64 golden files:
    estimates and SEs at rtol 1e-3 (atol 1e-3 x SE for estimates near 0),
    and the same unfitted SNPs.  Dense REML on the stored golden GRM runs
    in float64, as the golden files were written: text at rtol 2e-5."""
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
    # dense REML, BLUE and SNP BLUPs on the stored golden GRM
    main(["--reml", "--grm", str(golden / "golden"), "--blue", "--snp-blup"] + base
         + ["--out", f"{out}"])
    for name in ("golden.reml", "golden.blue.mean", "golden.GRM.blup.snps"):
        diff_text_files(workdir / name, golden / name, GOLDEN_REML_RTOL)
    golden_pca(workdir, golden, base)
    # bivariate REML, regional REML and grouped GWAS, in float64 on the card
    main(["--bivar-reml", "--grm", str(golden / "golden"), "--bfile", str(golden / "cohort"),
          "--pheno", str(golden / "pheno2.txt"), "--pheno-cols", "1,2", "--out", f"{out}.bi"])
    main(["--reml", "--groups", str(golden / "groups.txt")] + base + ["--out", f"{out}.reg"])
    main(["--gwas", "--groups", str(golden / "groups.txt")] + base + ["--out", f"{out}.grp"])
    for name in ("golden.bi.reml", "golden.bi.correlations", "golden.reg.regional",
                 "golden.reg.lrt", "golden.grp.multi.gwas.snps"):
        diff_text_files(workdir / name, golden / name, GOLDEN_REML_RTOL)
    # multi-phenotype and inverse GWAS (their products in float32 on the
    # card), simulation and prediction (host numpy in both packages)
    main(["--mpresiduals"] + base + ["--out", f"{out}.mp"])
    main(["--mpgwas"] + base + ["--out", f"{out}.mp"])
    main(["--igwas", "--bfile", str(golden / "cohort"), "--igwas-qcovar",
          str(golden / "testcovar.txt"), "--out", f"{out}.ig"])
    main(["--simulate", "--bfile", str(golden / "cohort"), "--effect-sizes",
          str(golden / "causal.txt"), "--simu-h2", "0.6", "--random-seed", "7",
          "--out", f"{out}.sim"])
    main(["--predict", "--bfile", str(golden / "cohort"), "--snp-effects",
          str(golden / "eff.txt"), "--out", f"{out}.pred"])
    worst = {}
    for name in ("golden.mp.mpgwas", "golden.mp.multipheno.gwas.snps", "golden.ig.gwas.snps",
                 "golden.ig.gwas.mean", "golden.ig.igwas"):
        worst[name] = diff_text_files(workdir / name, golden / name, GOLDEN_F32_RTOL,
                                      col_atol=GOLDEN_F32_RTOL)
    for name in ("golden.sim.simulated.phenos", "golden.sim.simulated.effects",
                 "golden.pred.predicted.phenos"):
        worst[name] = diff_text_files(workdir / name, golden / name, GOLDEN_REML_RTOL)
    log("golden files, worst relative difference: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in worst.items()}))
    log("golden cohort on the card: GRM, OLS and mixed-model GWAS, the BGEN GRM, dense "
        "REML with BLUE and SNP BLUPs, PCA, bivariate and regional REML, grouped, "
        "multi-phenotype and inverse GWAS, simulation and prediction agree with tests/golden")


def golden_pca(workdir, golden, base):
    """`--pca --grm golden --num-eval 5` (the full-eigh branch, 5 * 8 >=
    24): eigenvalues equal numpy's eigvalsh of the golden GRM at rtol
    1e-6, and the golden file, written by a float32 eigh, within twice the
    float32 solver bound; eigenvectors the same, up to sign."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.io.grm_io import read_grm

    main(["--pca", "--grm", str(golden / "golden"), "--num-eval", "5"] + base
         + ["--out", str(workdir / "golden")])
    w, v = np.linalg.eigh(read_grm(str(golden / "golden"))["kernel"].astype(np.float64))
    ours = np.loadtxt(workdir / "golden.pca.eigenvalues")
    np.testing.assert_allclose(ours, w[::-1], rtol=1e-6, atol=1e-9)
    old = np.loadtxt(golden / "golden.pca.eigenvalues")
    scale = float(np.max(np.abs(old)))
    eps32 = float(np.finfo(np.float32).eps)
    np.testing.assert_allclose(ours, old, rtol=0, atol=2 * eps32 * scale)
    vectors = lambda path: np.array(
        [[float(x) for x in ln.split()[2:]] for ln in Path(path).read_text().splitlines()])
    new_v = vectors(workdir / "golden.pca.eigenvectors")
    old_v = vectors(golden / "golden.pca.eigenvectors")
    signs = np.sign(np.sum(new_v * old_v, axis=0))
    gap = float(np.min(np.abs(np.diff(old[:6]))))
    np.testing.assert_allclose(new_v * signs, old_v, rtol=0, atol=2 * eps32 * scale / gap)
    signs = np.sign(np.sum(new_v * v[:, ::-1][:, :5], axis=0))
    np.testing.assert_allclose(new_v * signs, v[:, ::-1][:, :5], rtol=0, atol=1e-7)


def diff_text_files(ours, ref, rtol, col_atol=0.0):
    """Line by line, field by field: words equal, numbers at rtol (the
    rule of tests/test_golden.py's _diff_files), plus `col_atol` times
    the largest finite magnitude of the number's column in `ref`.
    Returns the worst |ours - ref| / |ref| over the numbers."""
    a, b = Path(ours).read_text().split("\n"), Path(ref).read_text().split("\n")
    check(len(a) == len(b), f"{Path(ref).name}: {len(a)} lines, expected {len(b)}")
    col_max = {}
    for lb in b:
        for j, fb in enumerate(lb.split()):
            try:
                vb = abs(float(fb))
            except ValueError:
                continue
            if math.isfinite(vb):
                col_max[j] = max(col_max.get(j, 0.0), vb)
    worst = 0.0
    for ln, (la, lb) in enumerate(zip(a, b), start=1):
        pa, pb = la.split(), lb.split()
        check(len(pa) == len(pb), f"{Path(ref).name}:{ln}: field count")
        for j, (fa, fb) in enumerate(zip(pa, pb)):
            try:
                va, vb = float(fa), float(fb)
            except ValueError:
                check(fa == fb, f"{Path(ref).name}:{ln}: {fa!r} != {fb!r}")
                continue
            if math.isnan(vb):
                check(math.isnan(va), f"{Path(ref).name}:{ln}: {va!r} != nan")
                continue
            tol = rtol * abs(vb) + col_atol * col_max.get(j, 0.0) + 1e-12
            check(abs(va - vb) <= tol, f"{Path(ref).name}:{ln}: {va!r} != {vb!r} at rtol {rtol:g}")
            if vb != 0.0:
                worst = max(worst, abs(va - vb) / abs(vb))
    return worst


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
    return zc, genetic, qcov, y_h


def _write_second_trait(workdir, gen, zc, genetic, qcov, y1, ids, device):
    """pheno2.txt: trait 1 as written, and trait 2 with h2 = 0.5 and
    genetic correlation 0.5 with trait 1 on the same causal rows
    (covariate effects 0.2 and 0.1), NA for the last N_MISSING_TRAIT2
    individuals.  Its draws come after every earlier draw of `gen`."""
    n = zc.shape[1]
    beta = torch.randn((zc.shape[0],), generator=gen, device=device, dtype=torch.float64)
    noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
    other = beta @ zc
    other = other - (other @ genetic) / (genetic @ genetic) * genetic
    other = other / other.std() * math.sqrt(0.5)
    genetic2 = 0.5 * genetic + math.sqrt(0.75) * other
    y2 = 0.5 + qcov @ torch.tensor([0.2, 0.1], device=device, dtype=torch.float64) + genetic2 \
        + noise * math.sqrt(0.5)
    y2_h = y2.cpu().numpy()
    with open(workdir / "pheno2.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            second = "NA" if i >= n - N_MISSING_TRAIT2 else f"{y2_h[i]:.10f}"
            fh.write(f"{fid} {iid} {y1[i]:.10f} {second}\n")


def _write_mp_traits(workdir, gen, zc, qcov, y1, ids, device):
    """pheno4.txt: trait 1 as written (h2 0.5), then one trait for each
    further h2 of MP_H2 on the same causal rows with their own effects
    (covariate effects 0.3 and -0.2), all drawn after every earlier draw
    of `gen`.  cc.txt: trait 1 as a liability cut at PREVALENCE into
    case (2) and control (1) codes."""
    n = zc.shape[1]
    columns = [np.asarray(y1)]
    for h2 in MP_H2[1:]:
        beta = torch.randn((zc.shape[0],), generator=gen, device=device, dtype=torch.float64)
        noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
        genetic = beta @ zc
        genetic = genetic / genetic.std() * math.sqrt(h2)
        y = 1.0 + qcov @ torch.tensor([0.3, -0.2], device=device, dtype=torch.float64) \
            + genetic + noise * math.sqrt(1.0 - h2)
        columns.append(y.cpu().numpy())
    with open(workdir / "pheno4.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            fh.write(f"{fid} {iid} " + " ".join(f"{c[i]:.10f}" for c in columns) + "\n")
    cut = np.quantile(columns[0], 1.0 - PREVALENCE)
    with open(workdir / "cc.txt", "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            fh.write(f"{fid} {iid} {2 if columns[0][i] > cut else 1}\n")


def _snp_infos(m):
    from dissect_tpu_torch.io.bed import SnpInfo

    return [SnpInfo(str(1 + i * 22 // m), f"rs{i:06d}", 0.0, 1000 + 100 * i, "A", "G")
            for i in range(m)]


def write_cohort(workdir, device):
    """The synthetic PLINK cohort, made on the card from SEED: PLINK files,
    a 2-column quantitative covariate file, the phenotype, the two traits
    of the bivariate phase (pheno2.txt), the four of the mp phase
    (pheno4.txt) and the glmm phase's case/control coding (cc.txt)."""
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
    zc, genetic, qcov, y1 = _write_traits(workdir, gen, d, ids, device)
    _write_second_trait(workdir, gen, zc, genetic, qcov, y1, ids, device)
    _write_mp_traits(workdir, gen, zc, qcov, y1, ids, device)
    data = PlinkData(
        snps=_snp_infos(m),
        individuals=[IndividualInfo(fid, iid) for fid, iid in ids],
        _dosage=dosage,
    )
    prefix = workdir / "cohort"
    write_plink(str(prefix), data)
    return ["--bfile", str(prefix)], {f"rs{i:06d}" for i in causal.cpu().numpy()}


# Each CLI step's launches by kernel, and its decode record (`decode_record`),
# by step tag, as `check_decode` records them.
STEP_LAUNCHES = {}
STEP_DECODE = {}
PLAIN_DECODERS = ("plain_bed_decode", "plain_bed_counts", "plain_bgen_decode_l2",
                  "plain_bgen_decode_l1")
ROW_COUNTED_DECODERS = ("bed_decode", "bed_counts")  # K4, K5: launches by row count


def kernel_counters():
    """Every kernel wrapper's launch counter, by kernel name."""
    from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments
    from dissect_tpu_torch.io import genotype_kernels as gk
    from dissect_tpu_torch.linalg.grm_kernels import grm_fused_triangle_update, syrk_triangle_packed

    return {"grm_fused_triangle_update": grm_fused_triangle_update,
            "syrk_triangle_packed": syrk_triangle_packed,
            "fused_refit_moments": fused_refit_moments,
            "bed_decode": gk.bed_decode, "bed_counts": gk.bed_counts,
            "bgen_decode_l2": gk.bgen_decode_l2, "bgen_decode_l1": gk.bgen_decode_l1}


def zero_counters(counters):
    """Every launch counter, K3's, K4's and K5's by row count, the
    decoders' plain calls on the card and the BGEN reader's host-parsed
    blocks to 0."""
    from dissect_tpu_torch.io import genotype_kernels as gk
    from dissect_tpu_torch.io.bgen import read_bgen

    for fn in counters.values():
        fn.launches = 0
    for name in ("fused_refit_moments",) + ROW_COUNTED_DECODERS:
        counters[name].launches_by_rows.clear()
    for name in PLAIN_DECODERS:
        getattr(gk, name).card_calls = 0
    read_bgen.unsupported = 0


def decode_record():
    """The decoders' plain calls on the card, the BGEN blocks parsed on
    the host, and K4's and K5's launches by row count since
    `zero_counters`."""
    from dissect_tpu_torch.io import genotype_kernels as gk
    from dissect_tpu_torch.io.bgen import read_bgen

    return {"plain_card_calls": {name: getattr(gk, name).card_calls for name in PLAIN_DECODERS},
            "bgen_unsupported": read_bgen.unsupported,
            "launches_by_rows": {name: {str(rows): count for rows, count in
                                        getattr(gk, name).launches_by_rows.items()}
                                 for name in ROW_COUNTED_DECODERS}}


def check_decode(tag, argv, launches, record):
    """A step that reads --bfile decoded its genotypes with K4 and, when it
    needs SNP statistics (all but --simulate and --predict, which read
    dosages only), counted them with K5; one that reads --bgen decoded
    with K6 or K7 and parsed no block on the host; no step ran a decoder's
    plain version on a CUDA tensor."""
    STEP_LAUNCHES[tag] = dict(launches)
    STEP_DECODE[tag] = record
    check(not any(record["plain_card_calls"].values()),
          f"{tag}: a decoder's plain version ran on the card: {record['plain_card_calls']}")
    if "--bfile" in argv:
        check(launches["bed_decode"] > 0, f"{tag}: K4 (bed_decode) was not launched")
        if not {"--simulate", "--predict"} & set(argv):
            check(launches["bed_counts"] > 0, f"{tag}: K5 (bed_counts) was not launched")
    if "--bgen" in argv:
        check(launches["bgen_decode_l2"] + launches["bgen_decode_l1"] > 0,
              f"{tag}: K6/K7 (bgen_decode) was not launched")
        check(record["bgen_unsupported"] == 0,
              f"{tag}: {record['bgen_unsupported']} BGEN blocks were parsed on the host")


def drive_path(tag, workdir, genotype_args, counters, expect, n_snps=N_SNPS):
    """`--make-grm` then `--gwas --grm` through the CLI's main(), with
    every launch counter zeroed just before and read just after; fails if
    a kernel in `expect` was not launched.  Returns (launches, seconds,
    k3_by_rows): the seconds of each step and of its dispatcher phases,
    and K3's launches by row count M, counted where K3 launches.  Those
    must be the refit's: a first pass over all SNPs and at most one retry
    on fewer rows with twice the Fisher steps, so 2 s + 1 launches at the
    retry's M against s + 1 at M = all SNPs."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.runtime.timers import timers

    args = genotype_args + ["--pheno", str(workdir / "pheno.txt"),
                            "--qcovar", str(workdir / "qcovar.txt")]
    k3 = counters["fused_refit_moments"]
    zero_counters(counters)
    seconds = {}
    launches = dict.fromkeys(counters, 0)
    for step, argv in (("make_grm", ["--make-grm"] + args + ["--out", str(workdir / "grm")]),
                       ("gwas_grm", ["--gwas", "--grm", str(workdir / "grm")] + args
                        + ["--out", str(workdir / "mlm")])):
        before = {name: fn.launches for name, fn in counters.items()}
        for name in ROW_COUNTED_DECODERS:  # each step's record holds its own launches
            counters[name].launches_by_rows.clear()
        t0 = time.monotonic()
        main(argv)
        seconds[f"{tag}{step}"] = time.monotonic() - t0
        seconds.update({f"{tag}{step}.{k}": v for k, v in timers.elapsed.items()})
        step_launches = {name: fn.launches - before[name] for name, fn in counters.items()}
        check_decode(f"{tag or 'plink_'}{step}", argv, step_launches, decode_record())
        launches = {name: launches[name] + step_launches[name] for name in counters}
    k3_by_rows = dict(sorted(k3.launches_by_rows.items(), reverse=True))
    log(f"{tag or 'plink_'}path launches: " + json.dumps(launches))
    log(f"{tag or 'plink_'}path K3 launches by M: " + json.dumps(k3_by_rows))
    for name in expect:
        check(launches[name] > 0, f"kernel {name} was not launched on the {tag or 'plink_'}path")
    check(sum(k3_by_rows.values()) == launches["fused_refit_moments"],
          "K3's launches by M do not add up to its launches")
    retry = {rows: count for rows, count in k3_by_rows.items() if rows != n_snps}
    check(len(retry) <= 1 and all(rows < n_snps for rows in retry),
          f"K3 ran at M = {list(k3_by_rows)}: not one pass over all SNPs and one retry")
    for count in retry.values():
        check(count == 2 * k3_by_rows.get(n_snps, 0) - 1,
              f"K3 launches by M {k3_by_rows}: the retry did not run twice the Fisher steps")
    return launches, seconds, k3_by_rows


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
    through K3 against the refit through its plain version.  Returns the
    summary and the written GRM, diagonalized on the card."""
    from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
    from dissect_tpu_torch.gwas.moments_kernels import plain_refit_moments
    from dissect_tpu_torch.io.bed import read_plink

    k, summary = science_checks(workdir, causal, N_SNPS)

    # 512-SNP subset: refit through K3 vs through its plain version, on the card
    data = read_plink(str(workdir / "cohort"), device=device)
    y, x = _traits(workdir, data.individual_keys)
    from dissect_tpu_torch.gwas.grouped import centered_genotypes
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
    dosage = data.filter(keep_snps=[data.snps[i].name for i in idx]).decode_rows(0, len(idx))
    z = centered_genotypes(dosage, torch.as_tensor(stats.mean[idx], device=device))
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
    return {**summary, "null_variances": list(theta)}, kern


def _traits(workdir, keys):
    """(y, X) of the written cohort in the order of `keys`: the phenotype
    and the design [1 | the two quantitative covariates]."""
    pheno = {}
    with open(workdir / "pheno.txt") as fh:
        for line in fh:
            f = line.split()
            pheno[f[0] + "@" + f[1]] = float(f[2])
    qcov = np.loadtxt(workdir / "qcovar.txt", usecols=(2, 3))
    return np.array([pheno[k] for k in keys]), np.column_stack([np.ones(len(keys)), qcov])


# ---------------------------------------------------------------- phase 5b --
def phase_reml(workdir, counters, null_variances, device):
    """Dense `--reml --bfile --blue --snp-blup --indiv-blup
    --indiv-blup-error` on the PLINK cohort through main(), every launch
    counter zeroed just before and read just after: the GRM is built in
    line by K1 (25 launches), then the dense float64 fit.  Checks: the fit
    converged; its variances equal the diagonal null fit's of phase 5 (the
    same REML model, fitted in the GRM's eigenbasis); h2 near the
    simulated 0.5; the covariate BLUEs within 4 SE of the simulated 0.3
    and -0.2; the SNP BLUPs of 1,000 SNPs equal
    s2_g (z . Py) n / (n_s M) with Py recomputed here in float64 from the
    fitted variances; BLUP errors finite and positive.  Then one
    iteration's parts at the fitted variances, timed apart: the Cholesky
    inverse of V, and the whole quantities call."""
    from dissect_tpu_torch.io.bed import read_plink
    from dissect_tpu_torch.io.grm_io import read_grm
    from dissect_tpu_torch.linalg.spd import spd_inverse_logdet
    from dissect_tpu_torch.reml.builders import build_variance_model
    from dissect_tpu_torch.reml.engine import REMLEngine

    out, launches, seconds, peak_gb = _drive(
        "reml", ["--reml"] + _cohort_args(workdir) + [
            "--blue", "--snp-blup", "--indiv-blup", "--indiv-blup-error",
            "--out", str(workdir / "reml")], counters, device)
    check(launches["grm_fused_triangle_update"] == -(-N_SNPS // GRM_CHUNK),
          f"K1 launched {launches['grm_fused_triangle_update']} times on the reml path")
    res = out.result
    check(res.success, "dense REML did not converge")
    var = dict(zip(res.variance_names, res.variances))
    dense = np.array([var["Var(GRM)"], var["Var(E)"]])
    null_variances = [float(v) for v in null_variances]
    log(f"dense REML: variances {dense.tolist()} in {res.n_iterations} iterations; "
        f"diagonal null fit {null_variances}")
    check(np.allclose(dense, null_variances, rtol=NULL_VS_DENSE_RTOL, atol=0),
          f"dense REML variances {dense} differ from the null fit's {null_variances}")
    h2 = out.heritabilities[-1].value
    check(abs(h2 - 0.5) <= 0.1, f"h2 {h2} not within 0.5 +- 0.1")
    blue, blue_se = out.blue, out.blue_se
    for j, truth in ((1, 0.3), (2, -0.2)):
        check(abs(blue[j] - truth) <= 4 * blue_se[j],
              f"BLUE {j} = {blue[j]} +- {blue_se[j]}, simulated {truth}")
    errors = out.blup_errors["GRM"]
    check(np.isfinite(errors).all() and (errors > 0).all(), "BLUP errors not finite and positive")
    check(np.isfinite(out.blup["GRM"]).all(), "individual BLUPs not finite")

    # Py recomputed in float64 from the fitted variances and the written GRM
    data = read_plink(str(workdir / "cohort"), device=device)
    check(data.individual_keys == out.individual_keys, "REML individuals are not the cohort's")
    y_h, x_h = _traits(workdir, data.individual_keys)
    k64 = torch.as_tensor(read_grm(str(workdir / "grm"))["kernel"], device=device).double()
    y, x = (torch.as_tensor(a, device=device) for a in (y_h, x_h))
    v = dense[0] * k64 + dense[1] * torch.eye(N_INDIVIDUALS, device=device, dtype=torch.float64)
    py = _py_float64(v, y, x).cpu().numpy()
    idx = np.arange(0, N_SNPS, N_SNPS // 1000)[:1000]
    stats = data.stats()
    d = data.filter(keep_snps=[data.snps[i].name for i in idx]).dosages().astype(np.float64)
    obs = d >= 0
    z = np.where(obs, (d - stats.mean[idx, None]) / stats.std[idx, None], 0.0)
    expect = dense[0] * (z @ py) * N_INDIVIDUALS / (obs.sum(1) * N_SNPS)
    written = {}
    with open(workdir / "reml.GRM.blup.snps") as fh:
        next(fh)
        for line in fh:
            f = line.split()
            written[f[0]] = float(f[2])
    got = np.array([written[data.snps[i].name] for i in idx])
    snp_err = float(np.max(np.abs(got - expect) / np.abs(expect)))
    log(f"SNP BLUPs of {len(idx)} SNPs against float64: worst relative error {snp_err:.2e} "
        f"(tol {SNP_BLUP_RTOL:g})")
    check(snp_err <= SNP_BLUP_RTOL, "SNP BLUPs disagree with their float64 recomputation")

    # one iteration's parts at the fitted variances
    model = build_variance_model([k64], ["GRM"], [float(np.var(y_h, ddof=1))], [0.5])
    engine = REMLEngine(model, y, x, device=device)
    inverse_ms = time_ms(lambda: spd_inverse_logdet(v), iters=3, warmup=1)
    iteration_ms = time_ms(lambda: engine._quantities(res.variances), iters=3, warmup=1)
    del v, engine, model, k64
    phase_s = seconds.get("reml_REML", float("nan"))
    summary = {
        "variances": dense.tolist(), "null_variances": null_variances,
        "h2": h2, "blue": blue.tolist(), "blue_se": blue_se.tolist(),
        "iterations": res.n_iterations, "log_likelihood": res.log_likelihood,
        "seconds_per_iteration": phase_s / res.n_iterations,
        "cholesky_inverse_ms": inverse_ms, "iteration_ms": iteration_ms,
        "snp_blup_rel_err": snp_err, "peak_device_gb": peak_gb,
    }
    log("reml path: " + json.dumps(summary))
    return launches, seconds, summary


def _py_float64(v, y, x):
    """P y = V^-1 (y - X b), b = (X'V^-1 X)^-1 X'V^-1 y, in float64 on V's
    device by a Cholesky factor of V."""
    chol = torch.linalg.cholesky(v)
    vi_y, vi_x = torch.cholesky_solve(y[:, None], chol)[:, 0], torch.cholesky_solve(x, chol)
    beta = torch.linalg.solve(x.T @ vi_x, vi_x.T @ y)
    return vi_y - vi_x @ beta


# ---------------------------------------------------------------- phase 5c --
def _drive(tag, argv, counters, device):
    """One CLI run through main(), every launch counter zeroed just before
    and read just after, the peak device memory reset before it.  Returns
    (its output, launches, seconds with the dispatcher's phases, peak GB)."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.runtime.timers import timers

    zero_counters(counters)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.monotonic()
    out = main(argv)
    seconds = {tag: time.monotonic() - t0}
    seconds.update({f"{tag}_{k}": v for k, v in timers.elapsed.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    log(f"{tag} path launches: " + json.dumps(launches))
    check_decode(tag, argv, launches, decode_record())
    return out, launches, seconds, torch.cuda.max_memory_allocated(device) / 1e9


def _cohort_args(workdir):
    return ["--bfile", str(workdir / "cohort"), "--pheno", str(workdir / "pheno.txt"),
            "--qcovar", str(workdir / "qcovar.txt")]


def phase_pca(workdir, counters, device):
    """`--pca --bfile --num-eval 20` on the PLINK cohort: K1 builds the GRM
    in line (25 launches), then the randomized branch (20 * 8 < 10,000):
    13 subspace iterations and Rayleigh-Ritz in float64.  The cohort has
    no population structure, so its top eigenvalues crowd at the
    Marchenko-Pastur edge and the iteration does not converge: each value
    lies between 90% of its exact eigenvalue (a float64 eigh of the same
    GRM, built again in process) and that eigenvalue plus 1e-6 relative.
    The eigenvectors are orthonormal to 1e-8.  Returns the GRM kernel for
    the next phase."""
    from dissect_tpu_torch.io.bed import read_plink
    from dissect_tpu_torch.model.kernels import grm_from_plink

    pca, launches, seconds, peak = _drive(
        "pca", ["--pca", "--bfile", str(workdir / "cohort"), "--num-eval", str(N_PCS),
                "--out", str(workdir / "pca")], counters, device)
    check(launches["grm_fused_triangle_update"] == -(-N_SNPS // GRM_CHUNK),
          f"K1 launched {launches['grm_fused_triangle_update']} times on the pca path")
    check(pca.all_eigenvalues is None and pca.eigenvalues.shape == (N_PCS,),
          "--pca did not take the randomized branch")
    kern = grm_from_plink(read_plink(str(workdir / "cohort"), device=device), device=device)
    k64 = kern.matrix.double()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    exact = torch.linalg.eigvalsh(k64)
    torch.cuda.synchronize()
    seconds["pca_full_eigh"] = time.monotonic() - t0
    del k64
    exact = torch.flip(exact, dims=(0,))[:N_PCS].cpu().numpy()
    ratio = pca.eigenvalues / exact
    log(f"pca: top-{N_PCS} eigenvalues {pca.eigenvalues[:3].tolist()}... against exact "
        f"{exact[:3].tolist()}...; smallest ratio {ratio.min():.4f}, largest {ratio.max():.9f}; "
        f"top-k solve {seconds['pca_PCA']:.3f} s, full float64 eigh {seconds['pca_full_eigh']:.3f} s")
    check(np.all(pca.eigenvalues <= exact * (1.0 + 1e-6)), "a top-k eigenvalue exceeds the exact one")
    check(np.all(ratio >= 0.9), f"top-k eigenvalues reach only {ratio.min():.3f} of the exact ones")
    v = pca.eigenvectors
    ortho = float(np.max(np.abs(v.T @ v - np.eye(N_PCS))))
    check(np.isfinite(v).all() and ortho <= 1e-8, f"eigenvectors not orthonormal ({ortho:.2e})")
    summary = {"min_ratio": float(ratio.min()), "max_ratio": float(ratio.max()),
               "orthonormality_err": ortho, "eigenvalues": pca.eigenvalues.tolist(),
               "exact": exact.tolist(), "peak_device_gb": peak}
    return launches, seconds, summary, kern


def phase_bivar(workdir, counters, kern, device):
    """`--bivar-reml --bfile --pheno pheno2.txt --pheno-cols 1,2 --qcovars
    qcovar.txt,qcovar.txt`: K1 builds the GRM in line (25 launches); trait
    2 misses its last 1,000 individuals, so the per-trait sets differ and
    the joint V has Tn = 19,000 rows in float64.  Checks: the fit
    converged; Cor(GRM_p1-2) within 4 SE of the simulated 0.5; the joint
    log-likelihood at least the sum of the two single-trait dense fits'
    (each on its own individuals and covariates) less 1e-6 |logL|, since
    the joint model contains the independent one.  Then one iteration at
    the fitted variances and its Cholesky inverse, timed apart."""
    from dissect_tpu_torch.io.covariate import read_covariates
    from dissect_tpu_torch.io.phenotype import read_phenotype
    from dissect_tpu_torch.linalg.spd import spd_inverse_logdet
    from dissect_tpu_torch.reml.engine import REMLEngine
    from dissect_tpu_torch.reml.multi import MultiREML
    from dissect_tpu_torch.reml.single import SingleREML

    pheno2, qcovar = str(workdir / "pheno2.txt"), str(workdir / "qcovar.txt")
    out, launches, seconds, peak = _drive(
        "bivar", ["--bivar-reml", "--bfile", str(workdir / "cohort"), "--pheno", pheno2,
                  "--pheno-cols", "1,2", "--qcovars", f"{qcovar},{qcovar}",
                  "--out", str(workdir / "bivar")], counters, device)
    check(launches["grm_fused_triangle_update"] == -(-N_SNPS // GRM_CHUNK),
          f"K1 launched {launches['grm_fused_triangle_update']} times on the bivar path")
    res = out.result
    check(res.success, "bivariate REML did not converge")
    n_total = len(out.individual_keys)
    check(n_total == 2 * N_INDIVIDUALS - N_MISSING_TRAIT2, f"Tn = {n_total}")
    cor = next(r for r in out.correlations if r.name == "Cor(GRM_p1-2)")
    log(f"bivar: Cor(GRM_p1-2) = {cor.value:.4f} +- {cor.std_error:.4f} (simulated 0.5); "
        f"{res.n_iterations} iterations, logL {res.log_likelihood:.6f}")
    check(abs(cor.value - 0.5) <= 4 * cor.std_error, "genetic correlation not within 4 SE of 0.5")
    phenos = [read_phenotype(pheno2, c) for c in (1, 2)]
    covs = [read_covariates(None, qcovar, default_keys=p.keys) for p in phenos]
    singles = []
    for pheno, cov in zip(phenos, covs):
        fit = SingleREML([kern], pheno, cov, device=device).compute(compute_blue=False)
        check(fit.result.success, "a single-trait REML did not converge")
        singles.append(fit.result.log_likelihood)
    bound = sum(singles) - 1e-6 * abs(res.log_likelihood)
    log(f"bivar: joint logL {res.log_likelihood:.6f} >= single-trait sum {sum(singles):.6f} "
        f"less 1e-6 |logL|")
    check(res.log_likelihood >= bound, "the joint fit is worse than the two single-trait fits")

    joint = MultiREML([kern], phenos, covs, device=device)
    engine = REMLEngine(joint.build_model(), joint.y, joint.x, device=device)
    check(engine.dimension == n_total, "the timing model is not the fitted one")
    iteration_ms = time_ms(lambda: engine._quantities(res.variances), iters=2, warmup=1)
    v = engine.cc.assemble_dense(torch.as_tensor(res.variances, device=device))
    inverse_ms = time_ms(lambda: spd_inverse_logdet(v), iters=2, warmup=1)
    del v, engine, joint
    summary = {
        "variances": dict(zip(res.variance_names, res.variances.tolist())),
        "genetic_correlation": [cor.value, cor.std_error],
        "iterations": res.n_iterations, "log_likelihood": res.log_likelihood,
        "single_trait_log_likelihoods": singles, "n_total": n_total,
        "seconds_per_iteration": seconds.get("bivar_REML", float("nan")) / res.n_iterations,
        "iteration_ms": iteration_ms, "cholesky_inverse_ms": inverse_ms, "peak_device_gb": peak,
    }
    log("bivar path: " + json.dumps(summary))
    return launches, seconds, summary


def phase_regional(workdir, causal, counters, device):
    """`--reml --bfile --groups` on four groups of 2,000 SNPs: the first
    holds all 500 causal SNPs and the first 1,500 others, the other three
    the next 6,000 SNPs without a causal one.  K1 launches 25 times for the
    whole GRM and once for each region's.  The causal region's
    Regional-GRM LRT gives p < 1e-10, each null region's p > 1e-6."""
    names = [f"rs{i:06d}" for i in range(N_SNPS)]
    others = [nm for nm in names if nm not in causal]
    first = sorted(causal) + others[: REGION_SNPS - len(causal)]
    rest = others[REGION_SNPS - len(causal):]
    regions = {"causal": first}
    for r in range(3):
        regions[f"null{r + 1}"] = rest[r * REGION_SNPS:(r + 1) * REGION_SNPS]
    with open(workdir / "regions.txt", "w") as fh:
        for group, snps in regions.items():
            for nm in snps:
                fh.write(f"{nm} {group}\n")
    results, launches, seconds, peak = _drive(
        "regional", ["--reml", "--groups", str(workdir / "regions.txt")]
        + _cohort_args(workdir) + ["--out", str(workdir / "regional")], counters, device)
    expect_k1 = -(-N_SNPS // GRM_CHUNK) + len(regions) * -(-REGION_SNPS // GRM_CHUNK)
    check(launches["grm_fused_triangle_update"] == expect_k1,
          f"K1 launched {launches['grm_fused_triangle_update']} times on the regional path, "
          f"expected {expect_k1}")
    check(list(results) == list(regions), f"regions {list(results)}")
    pvalues = {}
    for group, res in results.items():
        check(res["full"].result.success, f"region {group}: the full fit did not converge")
        row = next(r for r in res["lrts"] if r["removed"] == "Regional-GRM")
        check(row["converged"], f"region {group}: the reduced fit did not converge")
        pvalues[group] = row["p_value"]
    log("regional: Regional-GRM LRT p-values " + json.dumps(pvalues))
    check(pvalues["causal"] < 1e-10, "the causal region's Regional-GRM is not significant")
    check(all(p > 1e-6 for g, p in pvalues.items() if g != "causal"),
          "a null region's Regional-GRM is significant")
    return launches, seconds, {"p_values": pvalues, "peak_device_gb": peak}


def write_groups5(workdir):
    """groups5.txt: the cohort's SNPs in groups of GROUP_SNPS consecutive
    SNPs (written once; the mesh and grouped phases read it)."""
    path = workdir / "groups5.txt"
    if not path.exists():
        with open(path, "w") as fh:
            for i in range(N_SNPS):
                fh.write(f"rs{i:06d} G{i // GROUP_SNPS}\n")
    return path


def phase_grouped(workdir, causal, counters, device):
    """`--gwas --groups` on groups of 5 consecutive SNPs, OLS and under
    `--grm` of the main path: in each, groups holding a causal SNP at least
    5x enriched among the 100 smallest GROUPPVs.  Then `--rgwas
    --rgwas-group-size 100 --significance-threshold 1e-5`: at least 5 SNPs
    reported, at least 10x enriched for causal ones.  Last, the OLS step
    again with `--group-effects` (`grouped_effects`, the single-device
    run of the mesh phase's step)."""
    write_groups5(workdir)
    causal_groups = {f"G{int(nm[2:]) // GROUP_SNPS}" for nm in causal}
    base_rate = len(causal_groups) / (N_SNPS // GROUP_SNPS)
    seconds, summary, peaks = {}, {}, {}
    for tag, extra in (("grouped_ols", []), ("grouped_grm", ["--grm", str(workdir / "grm")])):
        results, _, secs, peaks[tag] = _drive(
            tag, ["--gwas", "--groups", str(workdir / "groups5.txt")] + extra
            + _cohort_args(workdir) + ["--out", str(workdir / tag)], counters, device)
        seconds.update(secs)
        check(len(results) == N_SNPS // GROUP_SNPS, f"{tag}: {len(results)} groups")
        pv = {g: r.f_p_value for g, r in results.items()}
        check(all(np.isfinite(p) and p >= 0 for p in pv.values()), f"{tag}: GROUPPV not finite")
        top = sorted(pv, key=pv.get)[:100]
        hits = sum(1 for g in top if g in causal_groups)
        enrichment = hits / 100 / base_rate
        log(f"{tag}: {hits} of the 100 smallest GROUPPVs hold a causal SNP "
            f"({enrichment:.1f}x the base rate {base_rate:.4f})")
        check(enrichment >= 5.0, f"{tag}: causal groups not enriched")
        summary[tag] = {"causal_in_top100": hits, "enrichment": enrichment}
    significant, _, secs, peaks["rgwas"] = _drive(
        "rgwas", ["--rgwas", "--rgwas-group-size", "100", "--significance-threshold", "1e-5"]
        + _cohort_args(workdir) + ["--out", str(workdir / "rgwas")], counters, device)
    seconds.update(secs)
    hits = sum(1 for nm in significant if nm in causal)
    enrichment = hits / max(len(significant), 1) / (N_CAUSAL / N_SNPS)
    log(f"rgwas: {len(significant)} SNPs reported, {hits} causal ({enrichment:.1f}x)")
    check(len(significant) >= 5, "--rgwas reported fewer than 5 SNPs")
    check(enrichment >= 10.0, "--rgwas SNPs not enriched for causal ones")
    summary["rgwas"] = {"reported": len(significant), "causal": hits, "enrichment": enrichment}
    _, _, secs, peaks["grouped_effects"] = _drive(
        "grouped_effects", ["--gwas", "--groups", str(workdir / "groups5.txt"), "--group-effects"]
        + _cohort_args(workdir) + ["--out", str(workdir / "grouped_effects")], counters, device)
    seconds.update(secs)
    summary["peak_device_gb"] = peaks
    return seconds, summary


def check_mesh_grouped(workdir):
    """The mesh phase's `--rgwas` and `--gwas --groups --group-effects`
    under `--parallel-gwas` against the same argv on one device
    (phase_grouped's `rgwas` and `grouped_effects`): the reported SNPs
    equal as a set; .multi.gwas.snps (groups, SNPs and alleles equal) and
    the .effects matrix by the float32 rule of GOLDEN_F32_RTOL."""
    from dissect_tpu_torch.io.labeled_matrix import LabeledMatrix

    reported = [set(open(workdir / f"{tag}.rgwas").read().split()[1:])
                for tag in ("mesh_rgwas", "rgwas")]
    log(f"mesh rgwas: {len(reported[0])} SNPs reported, single device {len(reported[1])}")
    check(reported[0] == reported[1], "mesh --rgwas reports other SNPs than one device")

    def bad(ours, ref):
        col_max = np.abs(ref).max(axis=0)
        return int((np.abs(ours - ref) > GOLDEN_F32_RTOL * np.abs(ref)
                    + GOLDEN_F32_RTOL * col_max).sum())

    def rel(ours, ref):
        return float(np.max(np.abs(ours - ref) / (np.abs(ref) + 1e-300)))

    paths = [workdir / f"{tag}.multi.gwas.snps" for tag in ("mesh_grouped_effects", "grouped_effects")]
    labels = [np.loadtxt(p, skiprows=1, usecols=(0, 1, 2), dtype=str) for p in paths]
    values = [np.loadtxt(p, skiprows=1, usecols=range(3, 10)) for p in paths]
    effects = [LabeledMatrix.load(str(workdir / f"{tag}.effects"))
               for tag in ("mesh_grouped_effects", "grouped_effects")]
    out = {"rgwas_reported": len(reported[0]), "snps_rows": len(values[0]),
           "snps_outside_f32_rule": bad(*values), "snps_max_rel_diff": rel(*values),
           "effects_shape": list(effects[0].values.shape),
           "effects_outside_f32_rule": bad(effects[0].values, effects[1].values),
           "effects_max_abs_diff": float(np.max(np.abs(effects[0].values - effects[1].values)))}
    log("mesh grouped against one device: " + json.dumps(out))
    check(np.array_equal(*labels), "mesh --group-effects: groups, SNPs or alleles differ")
    check(out["snps_outside_f32_rule"] == 0, "mesh --group-effects .multi.gwas.snps differs")
    check(effects[0].row_labels == effects[1].row_labels
          and effects[0].col_labels == effects[1].col_labels, "mesh .effects labels differ")
    check(out["effects_outside_f32_rule"] == 0, "mesh .effects differ from one device's")
    return out


# ---------------------------------------------------------------- phase 5g --
def phase_mp(workdir, causal, counters, null_variances, device):
    """`--mpresiduals --bfile --pheno pheno4.txt --pheno-cols 1,2,3,4` (K1
    builds the GRM in line, 25 launches; one diagonal float64 REML fit
    per column), then `--mpgwas`.  Checks: the first column's residuals
    equal s2_E P y recomputed here in float64 from the diagonal null fit
    of phase 5 (the same model), within MP_RESIDUAL_RTOL of the largest
    residual; every mpgwas number finite; causal SNPs at least 10x
    enriched among the 500 smallest p-values of the h2 0.5 column;
    lambda_GC of the h2 0 column within [0.9, 1.1]."""
    from dissect_tpu_torch.io.grm_io import read_grm

    args = ["--bfile", str(workdir / "cohort"), "--pheno", str(workdir / "pheno4.txt"),
            "--qcovar", str(workdir / "qcovar.txt"), "--out", str(workdir / "mp")]
    lm, launches, seconds, peak = _drive(
        "mpresiduals", ["--mpresiduals", "--pheno-cols", "1,2,3,4"] + args, counters, device)
    check(launches["grm_fused_triangle_update"] == -(-N_SNPS // GRM_CHUNK),
          f"K1 launched {launches['grm_fused_triangle_update']} times on the mpresiduals path")
    check(lm.values.shape == (N_INDIVIDUALS, len(MP_H2)) and np.isfinite(lm.values).all(),
          f"residuals of shape {lm.values.shape}, not all finite")
    y_h, x_h = _traits(workdir, lm.row_labels)
    k64 = torch.as_tensor(read_grm(str(workdir / "grm"))["kernel"], device=device).double()
    s2_g, s2_e = (float(v) for v in null_variances)
    v = s2_g * k64 + s2_e * torch.eye(N_INDIVIDUALS, device=device, dtype=torch.float64)
    del k64
    y, x = (torch.as_tensor(a, device=device) for a in (y_h, x_h))
    expect = s2_e * _py_float64(v, y, x).cpu().numpy()
    del v
    res_err = float(np.max(np.abs(lm.values[:, 0] - expect)) / np.max(np.abs(expect)))
    log(f"mpresiduals: column 1 against s2_E P y in float64, worst error {res_err:.2e} of the "
        f"largest residual (tol {MP_RESIDUAL_RTOL:g})")
    check(res_err <= MP_RESIDUAL_RTOL, "mp residuals disagree with their float64 recomputation")

    res, gwas_launches, gwas_seconds, gwas_peak = _drive(
        "mpgwas", ["--mpgwas", "--bfile", str(workdir / "cohort"), "--out", str(workdir / "mp")],
        counters, device)
    seconds.update(gwas_seconds)
    check(res.beta.shape == (N_SNPS, len(MP_H2)), f"mpgwas effects of shape {res.beta.shape}")
    check(all(np.isfinite(getattr(res, f)).all() for f in ("beta", "se", "t", "p")),
          "non-finite mpgwas output")
    top = np.argsort(res.p[:, 0])[:N_CAUSAL]
    hits = sum(1 for i in top if res.snp_names[i] in causal)
    enrichment = hits / N_CAUSAL / (N_CAUSAL / N_SNPS)
    lambda_gc = float(np.median(res.t[:, -1] ** 2) / 0.4549364231195724)  # chi2_1 median
    log(f"mpgwas: {hits} causal SNPs among the {N_CAUSAL} smallest p-values of the h2 "
        f"{MP_H2[0]} column ({enrichment:.1f}x); lambda_GC of the h2 {MP_H2[-1]} column "
        f"{lambda_gc:.4f}")
    check(enrichment >= 10.0, "causal SNPs not enriched in the mpgwas of the h2 0.5 column")
    check(0.9 <= lambda_gc <= 1.1, f"lambda_GC {lambda_gc} of the null column")
    summary = {"residual_rel_err": res_err, "causal_in_top": hits, "enrichment": enrichment,
               "lambda_gc_null": lambda_gc, "peak_device_gb": max(peak, gwas_peak)}
    log("mp path: " + json.dumps(summary))
    return launches, seconds, summary


# ---------------------------------------------------------------- phase 5h --
def phase_igwas(workdir, counters, kern, device):
    """`--igwas --bfile --grm <the PLINK path's GRM> --qcovar`: per-SNP ML
    refits with the SNP as the outcome, whose moments K3 computes (s = the
    3 rotated covariates): 16 launches at M = 50,000 (15 Fisher steps and
    the final quantities; igwas has no retry).  Checks: finite output on
    the fitted SNPs; on a 2,048-SNP subset the refit through K3 (float32)
    against the plain float64 route: beta and SE at REFIT_RTOL on the SNPs
    both fit, at most 1% of the subset fitted by float64 and not by K3, and
    the whole run's unfitted share within 0.05 of the float64 subset's.
    The share itself is the model's: each SNP is one of the M that built
    the GRM, whose self term (n/M = 0.2 of its off-diagonal spread) makes
    the SNP look fully heritable, so most fits stop with the residual
    variance at its floor and a gradient the test rejects (JAX's igwas
    alike).  `kern`: the GRM's eigenbasis."""
    from dissect_tpu_torch.gwas.grouped import centered_genotypes
    from dissect_tpu_torch.gwas.igwas import igwas
    from dissect_tpu_torch.gwas.moments_kernels import plain_refit_moments
    from dissect_tpu_torch.io.bed import read_plink

    res, launches, seconds, peak = _drive(
        "igwas", ["--igwas", "--bfile", str(workdir / "cohort"), "--grm", str(workdir / "grm"),
                  "--qcovar", str(workdir / "qcovar.txt"), "--out", str(workdir / "igwas")],
        counters, device)
    k3_by_rows = dict(counters["fused_refit_moments"].launches_by_rows)
    log(f"igwas path K3 launches by M: {json.dumps(k3_by_rows)}")
    check(k3_by_rows == {N_SNPS: 16}, f"K3 launches by M on the igwas path: {k3_by_rows}")
    unfitted = int((~res.converged).sum())
    written = (workdir / "igwas.gwas.unfitted").read_text().split() if unfitted else []
    check(len(written) == unfitted, "the .gwas.unfitted file does not list the unfitted SNPs")
    log(f"igwas: {unfitted} of {N_SNPS} SNPs unfitted")
    fitted = res.converged
    check(all(np.isfinite(a[fitted]).all() for a in (res.beta, res.se, res.p, res.group_p)),
          "non-finite igwas output on fitted SNPs")

    data = read_plink(str(workdir / "cohort"), device=device)
    _, x = _traits(workdir, data.individual_keys)
    idx = np.arange(0, N_SNPS, N_SNPS // IGWAS_SUBSET)[:IGWAS_SUBSET]
    dosage = data.filter(keep_snps=[data.snps[i].name for i in idx]).decode_rows(0, len(idx))
    z = centered_genotypes(dosage, torch.as_tensor(data.stats().mean[idx], device=device))
    names = [data.snps[i].name for i in idx]
    cov_names = ["mean", "quantitative_1", "quantitative_2"]
    covariance = (kern.eigenvalues, kern.eigenvectors)
    fused = igwas(z, names, x, cov_names, covariance=covariance, dtype=torch.float32)
    plain = igwas(z, names, x, cov_names, covariance=covariance, dtype=torch.float64,
                  moments=plain_refit_moments)
    both = fused.converged & plain.converged
    check(both.any(), "no SNP of the igwas subset was fitted by both routes")
    lost = int((plain.converged & ~fused.converged).sum())
    log(f"igwas {IGWAS_SUBSET}-SNP subset: fitted {int(fused.converged.sum())} through K3, "
        f"{int(plain.converged.sum())} in float64; {lost} fitted in float64 only")
    check(lost <= 0.01 * IGWAS_SUBSET, f"{lost} SNPs fitted in float64 but not through K3")
    share, share64 = unfitted / N_SNPS, 1.0 - float(plain.converged.mean())
    check(abs(share - share64) <= 0.05,
          f"unfitted share {share:.4f} against {share64:.4f} of the float64 subset")
    np.testing.assert_allclose(fused.se[both], plain.se[both], rtol=REFIT_RTOL)
    np.testing.assert_allclose(fused.beta[both], plain.beta[both], rtol=REFIT_RTOL,
                               atol=REFIT_RTOL * float(plain.se[both].min()))
    summary = {"unfitted": unfitted, "unfitted_share": share,
               "subset_unfitted_share_float64": share64,
               "subset_fitted_k3": int(fused.converged.sum()),
               "subset_fitted_float64": int(plain.converged.sum()), "subset_lost": lost,
               "subset_max_beta_diff": float(np.max(np.abs(fused.beta[both] - plain.beta[both]))),
               "launches_by_rows": k3_by_rows, "peak_device_gb": peak}
    log("igwas path: " + json.dumps(summary))
    return launches, seconds, summary


# ---------------------------------------------------------------- phase 5i --
def _glmm_chain_problem(seed, n=60):
    """A 60-individual logistic mixed model, V = 0.2 K + 0.1 I, small enough
    that the chain's joint proposals are accepted now and then."""
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(250, n))
    k = z.T @ z / 250
    u = np.linalg.cholesky(k + 1e-8 * np.eye(n)) @ rng.normal(size=n) * math.sqrt(0.2)
    x = np.column_stack([np.ones(n), rng.normal(size=n)])
    y = (rng.random(n) < 1 / (1 + np.exp(-(x @ [-0.2, 0.8] + u)))).astype(float)
    return y, x, 0.2 * k + 0.1 * np.eye(n)


def phase_glmm(workdir, counters, device):
    """`--glmm --bfile --pheno cc.txt --qcovar`: K1 builds the GRM in line
    (25 launches), V = s2_G K + s2_E I at the REML start values, its
    float64 inverse and the Metropolis-Hastings chain on the card.
    Checks: success, an acceptance rate in [0, 1).  Then the same argv on
    a fileset of the first 2,000 individuals and 5,000 SNPs, on the card
    and on the CPU: the .glmm files equal at GLMM_CARD_VS_CPU_RTOL.  Last,
    a 60-individual chain whose proposals are accepted now and then, card
    against CPU: the same acceptance rate, betas at the same tolerance."""
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.glm.glmm import GLMM
    from dissect_tpu_torch.io.bed import read_plink, write_plink

    argv = lambda cohort, out: ["--glmm", "--bfile", str(cohort), "--pheno",
                                str(workdir / "cc.txt"), "--qcovar", str(workdir / "qcovar.txt"),
                                "--out", str(out)]
    result, launches, seconds, peak = _drive(
        "glmm", argv(workdir / "cohort", workdir / "glmm"), counters, device)
    check(launches["grm_fused_triangle_update"] == -(-N_SNPS // GRM_CHUNK),
          f"K1 launched {launches['grm_fused_triangle_update']} times on the glmm path")
    log(f"glmm: success {result.success}, acceptance rate {result.acceptance_rate}, "
        f"betas {result.betas.tolist()} +- {result.betas_se.tolist()}")
    check(result.success and np.isfinite(result.betas).all(), "GLMM did not succeed")
    check(0.0 <= result.acceptance_rate < 1.0, f"acceptance rate {result.acceptance_rate}")

    n_small, m_small = GLMM_SMALL
    data = read_plink(str(workdir / "cohort"), device=device)
    small = data.filter(keep_snps=data.snp_names[:m_small],
                        keep_individuals=data.individual_keys[:n_small])
    write_plink(str(workdir / "small"), small)
    t0 = time.monotonic()
    main(argv(workdir / "small", workdir / "glmm_card"))
    seconds["glmm_small_card"] = time.monotonic() - t0
    os.environ["DISSECT_TPU_TORCH_DEVICE"] = "cpu"
    try:
        t0 = time.monotonic()
        main(argv(workdir / "small", workdir / "glmm_cpu"))
        seconds["glmm_small_cpu"] = time.monotonic() - t0
    finally:
        os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)
    small_err = diff_text_files(workdir / "glmm_card.glmm", workdir / "glmm_cpu.glmm",
                                GLMM_CARD_VS_CPU_RTOL)
    log(f"glmm on {n_small} x {m_small}: card against CPU, worst relative difference "
        f"{small_err:.2e} (tol {GLMM_CARD_VS_CPU_RTOL:g})")

    y, x, v = _glmm_chain_problem(SEED)
    fit = dict(n_outer=4, n_samples=30, burn_in=5)
    card = GLMM(y, x, torch.as_tensor(v, device=device), seed=7).fit(**fit)
    cpu = GLMM(y, x, torch.as_tensor(v), seed=7).fit(**fit)
    log(f"glmm 60-individual chain: acceptance {card.acceptance_rate} on the card, "
        f"{cpu.acceptance_rate} on the CPU")
    check(0.0 < card.acceptance_rate < 1.0, "the small chain accepted no proposal")
    check(card.acceptance_rate == cpu.acceptance_rate, "the chain decided otherwise on the card")
    np.testing.assert_allclose(card.betas, cpu.betas, rtol=GLMM_CARD_VS_CPU_RTOL)
    summary = {"success": result.success, "acceptance_rate": result.acceptance_rate,
               "betas": result.betas.tolist(), "betas_se": result.betas_se.tolist(),
               "small_card_vs_cpu_rel_err": small_err,
               "chain_acceptance_rate": card.acceptance_rate, "peak_device_gb": peak}
    log("glmm path: " + json.dumps(summary))
    return launches, seconds, summary


# ---------------------------------------------------------------- phase 5j --
def phase_simulate_predict(workdir, causal, counters, device):
    """`--simulate --effect-sizes` on the 500 causal SNPs (their effects
    drawn N(0, 1) by the simulation) at --simu-h2 0.5, then `--predict`
    with the simulated effects on allele 2.  Both are host numpy in both
    packages.  Checks: the simulated genetic share var(g) / var(y) within
    0.05 of 0.5; the predictions equal the simulated genetic values less
    the summed effects of each individual's observed causal genotypes
    (the simulation codes an observed dosage d as d + 1, the prediction
    as d, and a missing one as 0 in both), to 1e-9 of their scale."""
    from dissect_tpu_torch.io.bed import read_plink

    (workdir / "causal.txt").write_text("".join(f"{nm}\n" for nm in sorted(causal)))
    sim, _, seconds, _ = _drive(
        "simulate", ["--simulate", "--bfile", str(workdir / "cohort"), "--effect-sizes",
                     str(workdir / "causal.txt"), "--simu-h2", "0.5", "--random-seed", str(SEED),
                     "--out", str(workdir / "sim")], counters, device)
    share = float(np.var(sim.genetic_effects) / np.var(sim.phenotypes))
    log(f"simulate: genetic share {share:.4f} at --simu-h2 0.5")
    check(abs(share - 0.5) <= 0.05, f"simulated genetic share {share}")
    (workdir / "effects.txt").write_text("SNP ALLELE EFFECT\n" + "".join(
        f"{nm} G {eff!r}\n" for nm, eff in sim.causal_effects.items()))
    pred, _, pred_seconds, _ = _drive(
        "predict", ["--predict", "--bfile", str(workdir / "cohort"), "--snp-effects",
                    str(workdir / "effects.txt"), "--out", str(workdir / "pred")],
        counters, device)
    seconds.update(pred_seconds)
    check(pred.n_snps_used == N_CAUSAL and pred.n_flipped == 0,
          f"predict used {pred.n_snps_used} SNPs, {pred.n_flipped} flipped")
    data = read_plink(str(workdir / "cohort"), device=device)
    index = {s.name: i for i, s in enumerate(data.snps)}
    rows = [index[nm] for nm in sim.causal_effects]
    observed = data.filter(keep_snps=[data.snps[i].name for i in rows]).dosages() >= 0
    effects = np.array(list(sim.causal_effects.values()))
    expect = sim.genetic_effects - effects @ observed
    err = float(np.max(np.abs(pred.scores - expect)) / np.max(np.abs(expect)))
    r = float(np.corrcoef(pred.scores, sim.genetic_effects)[0, 1])
    log(f"predict: scores against the simulated genetic values less the observed effects, "
        f"worst error {err:.2e} of their scale; correlation with the genetic values {r:.6f}")
    check(err <= 1e-9, "predictions disagree with the simulated genetic values")
    summary = {"genetic_share": share, "prediction_rel_err": err, "correlation": r}
    log("simulate/predict: " + json.dumps(summary))
    return seconds, summary


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
    # the layout-1 (v1.1) copy of a corner of it, for phase_bgen_l1
    source = np.ascontiguousarray(dosage[:BGEN_L1_SNPS, :BGEN_L1_N])
    np.save(workdir / "l1_source.npy", source)
    write_bgen(str(workdir / "l1.bgen"), BgenData(
        snps=data.snps[:BGEN_L1_SNPS], individuals=data.individuals[:BGEN_L1_N],
        dosages=source), layout=1, compression="zlib")
    return ["--bgen", str(path)], {f"rs{i:06d}" for i in causal.cpu().numpy()}


def time_bgen_host(path, device):
    """Seconds of the two steps inside the BGEN path's ComputeGRM and
    LoadGenotypes, read_bgen (zlib on the host's threads, K6 on the card)
    and the dosage statistics (on the card), timed apart once more."""
    from dissect_tpu_torch.io.bgen import read_bgen

    t0 = time.monotonic()
    data = read_bgen(path, device=device)
    torch.cuda.synchronize()
    t1 = time.monotonic()
    stats = data.stats()
    t2 = time.monotonic()
    check_bgen_stats(data.dosages[:BGEN_BATCH].cpu().numpy(), stats, BGEN_BATCH)
    return {"bgen_host.read_bgen": t1 - t0, "bgen_host.stats": t2 - t1}


def check_bgen_stats(dosages, stats, rows):
    """BgenData.stats() on the card against the JAX package's numpy
    expressions (dissect_tpu/io/bgen.py BgenData.stats) on the host, on
    the first `rows` variants: bit for bit, since the card takes each sum
    in numpy's order."""
    observed = ~np.isnan(dosages)
    n = observed.sum(axis=1)
    mean = np.nansum(dosages, axis=1) / np.maximum(n, 1)
    var = np.nansum(np.where(observed, (dosages - mean[:, None]) ** 2, 0.0),
                    axis=1) / np.maximum(n - 1, 1)
    p2 = mean / 2.0
    want = {"n_nonmissing": n, "p1": 1.0 - p2, "p2": p2, "std": np.sqrt(var)}
    same = {k: bool(np.array_equal(getattr(stats, k)[:rows], v)) for k, v in want.items()}
    log(f"BGEN stats of {rows} variants on the card against numpy on the host, bit-exact: "
        + json.dumps(same))
    check(all(same.values()), "BGEN stats on the card differ from numpy's")


def phase_bgen_l1(workdir, counters, device):
    """`--make-grm --bgen` on the layout-1 (v1.1, zlib) copy of the BGEN
    cohort's first BGEN_L1_SNPS variants and BGEN_L1_N individuals: K7
    decodes it, K2 builds the GRM.  Checks: K7 launched once per batch and
    K6 not at all; the GRM within BGEN_L1_GRM_ATOL of the GRM that K2
    builds from the source dosages (layout 1 stores each probability
    rounded to 1/32768)."""
    from dissect_tpu_torch.io.bed import IndividualInfo
    from dissect_tpu_torch.io.bgen import BgenData
    from dissect_tpu_torch.io.grm_io import read_grm
    from dissect_tpu_torch.model.kernels import grm_from_plink

    _, launches, seconds, _ = _drive(
        "bgen_l1", ["--make-grm", "--bgen", str(workdir / "l1.bgen"),
                    "--out", str(workdir / "l1")], counters, device)
    check(launches["bgen_decode_l1"] == -(-BGEN_L1_SNPS // BGEN_BATCH)
          and launches["bgen_decode_l2"] == 0,
          f"layout-1 step: K7 launched {launches['bgen_decode_l1']}, K6 "
          f"{launches['bgen_decode_l2']} times")
    source = np.load(workdir / "l1_source.npy")
    ref = grm_from_plink(BgenData(
        snps=_snp_infos(BGEN_SNPS)[:BGEN_L1_SNPS],
        individuals=[IndividualInfo(f"S{i}", f"S{i}") for i in range(BGEN_L1_N)],
        dosages=torch.as_tensor(source, device=device)), device=device)
    err = float(np.max(np.abs(read_grm(str(workdir / "l1"))["kernel"]
                              - ref.matrix.cpu().numpy())))
    log(f"layout-1 BGEN ({BGEN_L1_SNPS} x {BGEN_L1_N}): GRM within {err:.2e} of the source "
        f"dosages' (tol {BGEN_L1_GRM_ATOL:g})")
    check(err <= BGEN_L1_GRM_ATOL, "the layout-1 GRM differs from the source dosages'")
    return launches, seconds, {"grm_max_abs_diff": err}


# -------------------------------------------------------------------- main --
# ---------------------------------------------------------------- phase 5k --
MESH_RANKS = 2
MESH_TIMEOUT_S = 420
# The row-sharded REML (GRM built in line by the row-sharded float32
# product) against a single-device fit of the same GRM (the mesh grm
# step's, read back): two float64 fits of one V whose sums run in other
# orders.  Variances, logL, BLUEs and their SEs, and the BLUPs (each
# within the rtol plus the rtol times the largest BLUP).
MESH_REML_RTOL = 1e-8
# The same fit against the reml phase's float64 fit on K1's GRM: the two
# GRMs differ by float32 summation order (within K1_REL_TOL of the scale,
# about 1e-7 entry by entry).
MESH_VS_K1_REML_RTOL = 1e-6
# The D&C eigensolver step's individuals (the first of the cohort): the
# whole cohort, its operands row-sharded over the ranks.
MESH_EIGH_N = N_INDIVIDUALS
# The whole-operand solver's per-rank peak in planes of N^2 * 8 bytes,
# measured at N = 10,000 on two ranks sharing an NVIDIA H100 80GB HBM3
# (700 W): the solver before its operands were row-sharded, the whole
# float32 matrix on each rank at entry (CHANGES.md, the entry that
# row-sharded the D&C eigensolver; PERF.md).  The row-sharded solver's
# peak must stay within 1/MESH_RANKS of it plus two planes.
WHOLE_OPERAND_EIGH_PLANES = 10.4153856
# SNP rows per block of the first-pass reading's plain routes (float64
# temporaries of 0.4 GB each at n = 10,000)
READING_ROWS = 5_000


def mesh_worker(plan_path):
    """One torchrun rank of the mesh phase (`chip_smoke.py --mesh-worker
    plan.json`): bring up the run's process group (gloo: the ranks share
    cuda:0), hold broadcast, all_reduce and all_gather on CUDA tensors,
    and reduce_scatter_rows, then run each step's argv
    through the CLI's main() with every launch
    counter zeroed just before and read just after, and write this rank's
    record (collectives, per-step seconds, dispatcher phases, launches,
    K3 launches by M, the REML result, the lines this rank would log that
    say what it sharded, the eigensolver's own peak device memory) to
    <plan>.rank<r>.json.  Ends with
    one row-sharded SPD inverse at the REML step's padded N, each of its
    three stages timed, then rank 0's `first_pass_reading`."""
    sys.path.insert(0, str(REPO))
    from dissect_tpu_torch.analysis.dispatcher import main as cli_main
    from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments
    from dissect_tpu_torch.linalg.distributed import (
        distributed_cholesky,
        distributed_lauum_full,
        distributed_trtri,
        pick_interleave,
    )
    from dissect_tpu_torch.runtime.device import cli_device
    from dissect_tpu_torch.runtime.distributed import startup_runtime
    from dissect_tpu_torch.runtime.dtypes import configure_precision
    from dissect_tpu_torch.runtime.timers import timers

    plan = json.loads(Path(plan_path).read_text())
    configure_precision()
    device = cli_device()
    torch.cuda.set_device(device)
    ctx = startup_runtime(str(MESH_RANKS), device)
    record = {"rank": ctx.rank, "backend": ctx.backend, "collectives": {}, "steps": {}}
    t = torch.full((4,), float(ctx.rank + 1), dtype=torch.float64, device=device)
    got = {"broadcast": ctx.broadcast(t.clone(), 1), "all_reduce": ctx.all_reduce(t.clone()),
           "all_gather": ctx.all_gather(t.clone())}
    want = {"broadcast": [2.0] * 4, "all_reduce": [3.0] * 4, "all_gather": [1.0] * 4 + [2.0] * 4}
    for op, val in got.items():
        record["collectives"][op] = {"device": str(val.device),
                                     "ok": val.cpu().tolist() == want[op]}
    # the D&C eigensolver's Gram products: gloo's reduce-scatter of CUDA tensors
    rows = ctx.row_bounds(3)
    scattered = ctx.reduce_scatter_rows(
        [torch.full((hi - lo, 2), float(ctx.rank + 1), dtype=torch.float64, device=device)
         for lo, hi in rows])
    lo, hi = rows[ctx.rank]
    record["collectives"]["reduce_scatter_rows"] = {
        "device": str(scattered.device),
        "ok": scattered.cpu().tolist() == [[3.0, 3.0]] * (hi - lo)}
    counters = kernel_counters()
    # the gwas step's refit inputs on this rank, for first_pass_reading
    import dissect_tpu_torch.analysis.dispatcher as dispatcher_module

    refit, refit_call = dispatcher_module.mlm_gwas_ml_refit, {}

    def recording_refit(genotypes, y, x, lam, u, null_variances, **kw):
        if not refit_call:
            refit_call.update(g=genotypes, y=y, x=x, lam=lam, u=u, theta0=null_variances)
        return refit(genotypes, y, x, lam, u, null_variances, **kw)

    dispatcher_module.mlm_gwas_ml_refit = recording_refit
    # what every rank would log (only rank 0 writes the log), and the
    # device memory inside the D&C eigensolver, its peak read apart
    from dissect_tpu_torch.linalg import dc_eigen
    from dissect_tpu_torch.runtime.log import Logger

    lines, interior = [], {}
    logger_message, solver = Logger.message, dc_eigen.distributed_eigh

    def message(self, *parts):
        lines.append(" ".join(str(p) for p in parts))
        logger_message(self, *parts)

    def measured_solver(*args, **kw):
        torch.cuda.synchronize(device)
        interior.update(step_peak=torch.cuda.max_memory_allocated(device),
                        at_entry=torch.cuda.memory_allocated(device))
        torch.cuda.reset_peak_memory_stats(device)
        out = solver(*args, **kw)
        torch.cuda.synchronize(device)
        interior["peak"] = torch.cuda.max_memory_allocated(device)
        return out

    Logger.message, dc_eigen.distributed_eigh = message, measured_solver
    for step in plan["steps"]:
        zero_counters(counters)
        lines.clear()
        interior.clear()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic()
        out = cli_main(step["argv"])
        rec = {"seconds": time.monotonic() - t0,
               "phases": dict(timers.elapsed),
               "launches": {name: fn.launches for name, fn in counters.items()},
               "decode": decode_record(),
               "k3_by_rows": {str(k): v for k, v in fused_refit_moments.launches_by_rows.items()},
               "peak_device_gb": max(torch.cuda.max_memory_allocated(device),
                                     interior.get("step_peak", 0)) / 1e9,
               "sharded_lines": [line for line in lines if "sharded over" in line]}
        if interior:
            rec["solver_memory_gb"] = {"peak": interior["peak"] / 1e9,
                                       "at_entry": interior["at_entry"] / 1e9}
        if step["name"] == "reml":
            rec["reml"] = _reml_record(out)
        record["steps"][step["name"]] = rec
        del out
    dispatcher_module.mlm_gwas_ml_refit = refit
    Logger.message, dc_eigen.distributed_eigh = logger_message, solver
    # one row-sharded inverse of an SPD matrix (2 I + U U^T / n) at the
    # REML step's padded N
    n = plan["inverse_n"]
    r0, r1 = ctx.local_rows(n)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    u = torch.randn((n, 64), generator=gen, dtype=torch.float64).to(device)
    a = u[r0:r1] @ u.T / n
    a[torch.arange(r1 - r0, device=device), torch.arange(r0, r1, device=device)] += 2.0
    # spd_inverse_logdet_cyclic's three stages, each timed
    block = plan["block"]
    g = pick_interleave(n, ctx.world, block)
    stages = (("cholesky", lambda v: distributed_cholesky(v, ctx, block, g)[0]),
              ("trtri", lambda v: distributed_trtri(v, ctx, block, g)),
              ("lauum", lambda v: distributed_lauum_full(v, ctx, block, g)))
    times, stage_times = [], {name: [] for name, _ in stages}
    for _ in range(2):
        v = a.clone()
        ctx.barrier()
        torch.cuda.synchronize(device)
        t0 = time.monotonic()
        for name, stage in stages:
            t1 = time.monotonic()
            v = stage(v)
            torch.cuda.synchronize(device)
            stage_times[name].append(time.monotonic() - t1)
        times.append(time.monotonic() - t0)
    record["inverse_seconds"] = times
    record["inverse_stage_seconds"] = stage_times
    del a, v, u
    torch.cuda.empty_cache()
    if ctx.rank == 0:
        record["first_pass_reading"] = first_pass_reading(refit_call)
    Path(f"{plan_path}.rank{ctx.rank}.json").write_text(json.dumps(record))
    return 0


def _reml_record(out):
    """The fit, BLUEs and BLUPs of a SingleREMLOutput, as JSON lists."""
    res = out.result
    return {"variances": [float(v) for v in res.variances],
            "log_likelihood": float(res.log_likelihood),
            "iterations": int(res.n_iterations), "success": bool(res.success),
            "blue": np.asarray(out.blue).tolist(), "blue_se": np.asarray(out.blue_se).tolist(),
            "blup": np.asarray(out.blup["GRM"]).tolist(),
            "individuals": list(out.individual_keys)}


def first_pass_reading(call):
    """Which SNPs of one mesh rank's share the refit's first pass sends to
    the retry (gradient >= GRADIENT_THRESHOLD after the Fisher steps), by
    four routes on the rank's own inputs: the refit as the rank ran it
    (K3, M = its share); the same refit at the single-device run's shapes
    (the share stacked twice, M = N_SNPS: the g U product, every K3
    launch and every batched solve), its first M rows; the plain moments
    in float32; the plain moments in float64 from a float64 g U.  Returns
    each route's count and its disagreement with the float64 route, the
    two shapes' disagreement, the largest |difference| of their g U
    products and of their K3 moments at the null variances (relative to
    the largest entry), and how many SNPs have a float64 gradient within
    a factor of 2 of the threshold."""
    import inspect

    from dissect_tpu_torch.gwas import mlm
    from dissect_tpu_torch.gwas.moments_kernels import fused_refit_moments, plain_refit_moments

    g = call["g"]
    m, device = g.shape[0], g.device
    n_iterations = inspect.signature(mlm.mlm_gwas_ml_refit).parameters["n_iterations"].default

    def inputs(dtype, stacked=False):
        put = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
        u, gd = put(call["u"]), g.to(dtype)
        g_rot = (torch.cat([gd, gd]) if stacked else gd) @ u
        return (g_rot.contiguous(), u.T @ put(call["y"]), u.T @ put(call["x"]),
                put(call["lam"]).contiguous(), put(np.asarray(call["theta0"], dtype=np.float64)))

    def rel_diff(a, b):
        return float((a - b).abs().max() / b.abs().max())

    grads, diffs = {}, {}
    for route, dtype, stacked, moments, rows in (
            ("k3", torch.float32, False, fused_refit_moments, m),
            ("k3_single_device_shape", torch.float32, True, fused_refit_moments, 2 * m),
            ("plain_float32", torch.float32, False, plain_refit_moments, READING_ROWS),
            ("plain_float64", torch.float64, False, plain_refit_moments, READING_ROWS)):
        g_rot, *rest = inputs(dtype, stacked)
        if route.startswith("k3"):
            y_rot, x_rot, lam, theta0 = rest
            s = torch.cat([x_rot, y_rot[:, None]], dim=1).contiguous()
            thetas = theta0[None, :].expand(g_rot.shape[0], 2).contiguous()
            diffs[route] = (g_rot[:m].clone(),
                            fused_refit_moments(g_rot, thetas, lam, s, mlm.refit_features(s, lam))[:m])
        # each SNP's fit is its own: the plain routes run in blocks of
        # rows, which bounds their (rows, n) temporaries
        grads[route] = torch.cat([
            mlm._ml_refit_core(g_rot[i:i + rows], *rest, n_iterations, moments=moments)[-1]
            for i in range(0, g_rot.shape[0], rows)])[:m].double().cpu().numpy()
        del g_rot, rest
    flags = {route: grad >= mlm.GRADIENT_THRESHOLD for route, grad in grads.items()}
    exact = flags["plain_float64"]
    near = np.abs(np.log2(grads["plain_float64"] / mlm.GRADIENT_THRESHOLD)) <= 1.0
    (p1, k1), (p2, k2) = diffs["k3"], diffs["k3_single_device_shape"]
    return {"snps": m, "flagged": {route: int(f.sum()) for route, f in flags.items()},
            "differ_from_float64": {route: int((f != exact).sum()) for route, f in flags.items()},
            "shapes_differ": int((flags["k3"] != flags["k3_single_device_shape"]).sum()),
            "product_rel_diff": rel_diff(p2, p1), "k3_moments_rel_diff": rel_diff(k2, k1),
            "float64_gradient_within_2x_of_threshold": int(near.sum())}


def nccl_check(device):
    """A one-rank NCCL group on the card: broadcast, all_reduce and
    all_gather through the port's collectives module."""
    import socket

    import torch.distributed as dist
    from dissect_tpu_torch.runtime.mesh import MeshContext

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=device)
    try:
        ctx = MeshContext(rank=0, world=1, device=device, backend="nccl")
        t = torch.arange(4, dtype=torch.float64, device=device)
        got = {"broadcast": ctx.broadcast(t.clone(), 0).cpu().tolist(),
               "all_reduce": ctx.all_reduce(t.clone()).cpu().tolist(),
               "all_gather": ctx.all_gather(t.clone()).cpu().tolist()}
    finally:
        dist.destroy_process_group()
    for op, val in got.items():
        check(val == [0.0, 1.0, 2.0, 3.0], f"NCCL {op} on one rank gave {val}")
    return got


def _grm_dat_diff(prefix_a, prefix_b, device):
    """(max |kernel difference|, kernel scale, counts equal) of two
    written GRMs, compared on their packed .grm.dat payloads on the card:
    each column j holds counts[0..j, j], then kernel[j.., j]."""
    raw = [np.fromfile(f"{p}.grm.dat", dtype=np.float64, offset=14) for p in (prefix_a, prefix_b)]
    n = int((math.isqrt(4 * raw[0].size + 1) - 1) // 2)
    a, b = (torch.as_tensor(r.reshape(n, n + 1), device=device) for r in raw)
    is_count = (torch.arange(n + 1, device=device)[None, :]
                <= torch.arange(n, device=device)[:, None])
    diff = (a - b).abs()
    kernel_err = float(torch.where(is_count, torch.zeros_like(diff), diff).max())
    scale = float(torch.where(is_count, torch.zeros_like(b), b.abs()).max())
    counts_equal = bool(torch.equal(a[is_count], b[is_count]))
    return kernel_err, scale, counts_equal


def _eigen_check(kernel, w, v, device):
    """The D&C eigenpairs of `kernel` against float64 torch.linalg.eigh on
    the card: eigenvalues within 1e-9 of the spectrum's scale, V
    orthonormal and A V = V diag(w) within 1e-8 of the scale, and each
    eigenvector whose eigenvalue is 1e-3 of the scale from its neighbours
    equal to the reference's up to sign within 1e-6."""
    a = torch.as_tensor(kernel, device=device, dtype=torch.float64)
    w = torch.as_tensor(w, device=device, dtype=torch.float64)
    v = torch.as_tensor(v, device=device, dtype=torch.float64)
    w_ref, v_ref = torch.linalg.eigh(a)
    scale = float(w_ref.abs().max())
    n = a.shape[0]
    eig_err = float((w - w_ref).abs().max()) / scale
    ortho = float((v.T @ v - torch.eye(n, device=device, dtype=torch.float64)).abs().max())
    resid = float((a @ v - v * w).abs().max()) / scale
    gaps = torch.minimum(torch.diff(w_ref, prepend=w_ref[:1] - scale),
                         torch.diff(w_ref, append=w_ref[-1:] + scale))
    isolated = gaps > 1e-3 * scale
    dots = torch.abs(torch.sum(v * v_ref, dim=0))[isolated]
    vec_err = float((1.0 - dots).abs().max()) if dots.numel() else 0.0
    log(f"D&C eigh at N = {n}: eigenvalues {eig_err:.2e} of the scale, V^T V - I {ortho:.2e}, "
        f"AV - VW {resid:.2e}, {int(isolated.sum())} isolated eigenvectors within {vec_err:.2e}")
    check(eig_err <= 1e-9, "D&C eigenvalues differ from torch.linalg.eigh's")
    check(ortho <= 1e-8 and resid <= 1e-8, "D&C eigenvectors not orthonormal eigenvectors")
    check(vec_err <= 1e-6, "D&C eigenvectors differ from torch.linalg.eigh's up to sign")
    return {"n": n, "eig_err": eig_err, "ortho_err": ortho, "residual": resid,
            "isolated": int(isolated.sum()), "vec_err": vec_err}


def inverse_collective_bytes(n, world, block):
    """Bytes of the collectives' results on one rank in one
    spd_inverse_logdet_cyclic at (n, world, block), in float64: each
    step of the factor and of trtri broadcasts the b x b diagonal block
    and all-gathers the panel's trailing rows (world x the longest
    rank's count x b); each lauum step all-reduces a (b, n) panel."""
    from dissect_tpu_torch.linalg.distributed import elimination_steps, pick_interleave

    n_blocks = n // block
    es = elimination_steps(n_blocks, pick_interleave(n, world, block)).reshape(world, -1)
    entries = 0
    for k in range(n_blocks):
        width = int((es > k).sum(axis=1).max()) * block
        entries += 2 * (block * block + world * width * block) + block * n
    return 8 * entries


def phase_mesh(workdir, reml_summary, counters, device):
    """The multi-GPU path, as two torchrun ranks sharing the card (gloo,
    DISSECT_TPU_TORCH_DEVICE=cuda:0): a one-rank NCCL group first, then
    in one launch `--make-grm --mesh 2 --force-distributed` (the GRM
    row-sharded), `--reml --bfile --blue --indiv-blup` (the row-sharded
    float64 engine), `--make-grm --diagonalize --store-both` on the
    first MESH_EIGH_N individuals (the D&C eigensolver, its operands
    row-sharded from the GRM's row blocks to the eigenvectors), `--gwas
    --grm --parallel-gwas` (K3 on each rank's SNPs), and `--rgwas` and
    `--gwas --groups --group-effects` under `--parallel-gwas` (each rank
    fits its share of every size bucket; `check_mesh_grouped` holds them
    against the single-device runs of phase_grouped).  Checks:
    the GRM against the single-device K1 GRM within K1_REL_TOL of its
    scale and the counts exactly; the REML variances, logL, BLUEs and
    BLUPs against a single-device float64 fit of the mesh grm step's GRM
    (run here, after the launch) at MESH_REML_RTOL in as many iterations,
    and the variances and logL against the reml phase's fit on K1's GRM
    at MESH_VS_K1_REML_RTOL; .gwas.snps against the single-device run's
    by the float32 rule on the SNPs both fitted, the unfitted counts
    within 20% or 10 SNPs of each other, K3 launched on both ranks, and
    rank 0's first-pass reading (`first_pass_reading`) flagging by K3 as
    many SNPs as the rank retried; every rank's log lines of the grouped
    steps saying the groups were sharded; the eigenpairs as
    `_eigen_check` says, and each rank's peak device memory inside the
    eigensolver at most WHOLE_OPERAND_EIGH_PLANES / MESH_RANKS + 2 planes
    of N^2 * 8 bytes."""
    from dissect_tpu_torch.io.grm_io import read_grm
    from dissect_tpu_torch.reml.distributed_engine import pick_block

    torch.cuda.empty_cache()  # the ranks share the card with this process
    t0 = time.monotonic()
    nccl = nccl_check(device)
    seconds = {"mesh_nccl": time.monotonic() - t0}
    cohort = _cohort_args(workdir)
    # the eigh step before the GWAS steps: the worker holds the gwas step's
    # refit inputs for first_pass_reading, which would count in its memory
    steps = [
        ("grm", ["--make-grm"] + cohort[:2] + ["--mesh", "2", "--force-distributed"]),
        ("reml", ["--reml"] + cohort + ["--blue", "--indiv-blup", "--mesh", "2",
                                        "--force-distributed"]),
        ("eigh", ["--make-grm", "--diagonalize", "--store-both", "--keep",
                  str(workdir / "mesh_keep.txt")] + cohort[:2]
         + ["--mesh", "2", "--force-distributed"]),
        ("gwas", ["--gwas", "--grm", str(workdir / "grm")] + cohort
         + ["--mesh", "2", "--parallel-gwas"]),
        ("rgwas", ["--rgwas", "--rgwas-group-size", "100", "--significance-threshold", "1e-5"]
         + cohort + ["--mesh", "2", "--parallel-gwas"]),
        ("grouped_effects", ["--gwas", "--groups", str(write_groups5(workdir)), "--group-effects"]
         + cohort + ["--mesh", "2", "--parallel-gwas"]),
    ]
    with open(workdir / "cohort.fam") as src, open(workdir / "mesh_keep.txt", "w") as dst:
        for _, line in zip(range(MESH_EIGH_N), src):
            dst.write(" ".join(line.split()[:2]) + "\n")
    block = pick_block(N_INDIVIDUALS, MESH_RANKS)
    quantum = MESH_RANKS * block
    plan = {"steps": [{"name": name, "argv": argv + ["--out", str(workdir / f"mesh_{name}")]}
                      for name, argv in steps],
            "inverse_n": -(-N_INDIVIDUALS // quantum) * quantum, "block": block}
    plan_path = workdir / "mesh_plan.json"
    plan_path.write_text(json.dumps(plan))
    env = dict(os.environ, DISSECT_TPU_TORCH_DEVICE="cuda:0", OMP_NUM_THREADS="4")
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(MESH_RANKS), str(REPO / "chip_smoke.py"), "--mesh-worker",
         str(plan_path)],
        cwd=str(REPO), env=env, capture_output=True, text=True, timeout=MESH_TIMEOUT_S,
        stdin=subprocess.DEVNULL,
    )
    seconds["mesh_launch"] = time.monotonic() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-8000:])
    check(proc.returncode == 0, f"the mesh launch exited {proc.returncode}")
    ranks = [json.loads(Path(f"{plan_path}.rank{r}.json").read_text()) for r in range(MESH_RANKS)]
    for rec in ranks:
        check(rec["backend"] == "gloo", f"rank {rec['rank']} ran on {rec['backend']}")
        for op, res in rec["collectives"].items():
            check(res["ok"] and res["device"].startswith("cuda"),
                  f"gloo {op} on CUDA tensors: {res}")
    steps_by_rank = [rec["steps"] for rec in ranks]
    for rec in ranks:  # every mesh step reads --bfile: K4 and K5 on every rank
        for name, st in rec["steps"].items():
            check_decode(f"mesh_{name}_rank{rec['rank']}", ["--bfile"], st["launches"],
                         st["decode"])
    for name, _ in steps:
        seconds[f"mesh_{name}"] = max(st[name]["seconds"] for st in steps_by_rank)
        for key, val in steps_by_rank[0][name]["phases"].items():
            seconds[f"mesh_{name}_{key}"] = val

    # 1. the row-sharded GRM against K1's
    grm_err, scale, counts_equal = _grm_dat_diff(workdir / "mesh_grm", workdir / "grm", device)
    log(f"mesh GRM against K1's: max |diff| {grm_err:.3e} (tol {K1_REL_TOL:g} x {scale:.3f}), "
        f"counts exact: {counts_equal}")
    check(grm_err <= K1_REL_TOL * scale, "the row-sharded GRM differs from K1's")
    check(counts_equal, "the row-sharded GRM's counts differ from K1's")

    # 2. the row-sharded REML against single-device float64 fits: of the
    # same GRM (the mesh grm step's, read back), and of K1's (the reml phase)
    fit = steps_by_rank[0]["reml"]["reml"]
    check(fit["success"], "the distributed REML did not converge")
    single_out, _, single_seconds, _ = _drive(
        "mesh_reml_single", ["--reml", "--grm", str(workdir / "mesh_grm")] + cohort[2:] + [
            "--blue", "--indiv-blup", "--out", str(workdir / "mesh_reml_single")],
        counters, device)
    seconds.update(single_seconds)
    single = _reml_record(single_out)
    check(single["success"], "the single-device fit of the mesh GRM did not converge")
    check(fit["individuals"] == single["individuals"], "the distributed REML's individuals")

    def rel_err(ours, ref, scale_share=0.0):
        ours, ref = np.asarray(ours), np.asarray(ref)
        return float(np.max(np.abs(ours - ref) / (np.abs(ref) + scale_share * np.abs(ref).max())))

    errs = {"variances": rel_err(fit["variances"], single["variances"]),
            "log_likelihood": rel_err(fit["log_likelihood"], single["log_likelihood"]),
            "blue": rel_err(fit["blue"], single["blue"]),
            "blue_se": rel_err(fit["blue_se"], single["blue_se"]),
            "blup": rel_err(fit["blup"], single["blup"], scale_share=1.0)}
    log(f"mesh REML: variances {fit['variances']} in {fit['iterations']} iterations, "
        f"single-device fit of the same GRM {single['variances']} in {single['iterations']}; "
        "relative differences " + json.dumps({k: f"{v:.2e}" for k, v in errs.items()})
        + f" (tol {MESH_REML_RTOL:g})")
    check(all(v <= MESH_REML_RTOL for v in errs.values()),
          "the distributed REML differs from the single-device float64 fit of its GRM")
    check(fit["iterations"] == single["iterations"], "the distributed REML's iterations")
    rel = rel_err(fit["variances"], reml_summary["variances"])
    ll_rel = rel_err(fit["log_likelihood"], reml_summary["log_likelihood"])
    log(f"mesh REML against the fit on K1's GRM {reml_summary['variances']} in "
        f"{reml_summary['iterations']}: relative differences {rel:.2e}, logL {ll_rel:.2e} "
        f"(tol {MESH_VS_K1_REML_RTOL:g})")
    check(rel <= MESH_VS_K1_REML_RTOL and ll_rel <= MESH_VS_K1_REML_RTOL,
          "the distributed REML differs from the fit on K1's GRM")
    check(fit["iterations"] == reml_summary["iterations"], "the distributed REML's iterations")
    reml_phase = steps_by_rank[0]["reml"]["phases"].get("REML", float("nan"))
    inverse_s = min(min(rec["inverse_seconds"]) for rec in ranks)
    inverse_stage_s = {name: min(min(rec["inverse_stage_seconds"][name]) for rec in ranks)
                       for name in ranks[0]["inverse_stage_seconds"]}

    # 3. --parallel-gwas against the single-device GWAS
    mesh_rows = _read_gwas(workdir / "mesh_gwas.gwas.snps")
    single_rows = _read_gwas(workdir / "mlm.gwas.snps")
    common = [s for s in single_rows if s in mesh_rows]
    a = np.array([mesh_rows[s] for s in common])
    b = np.array([single_rows[s] for s in common])
    col_max = np.abs(b).max(axis=0)
    bad = np.abs(a - b) > GOLDEN_F32_RTOL * np.abs(b) + GOLDEN_F32_RTOL * col_max
    unfit_mesh, unfit_single = N_SNPS - len(mesh_rows), N_SNPS - len(single_rows)
    log(f"mesh GWAS: {len(common)} SNPs fitted by both, {int(bad.sum())} outside the float32 "
        f"rule; unfitted {unfit_mesh} (single device {unfit_single})")
    check(not bad.any(), "--parallel-gwas differs from the single-device GWAS")
    check(abs(unfit_mesh - unfit_single) <= max(10, 0.2 * unfit_single),
          "--parallel-gwas unfitted count off the single-device count")
    k3_ranks = [st["gwas"]["launches"]["fused_refit_moments"] for st in steps_by_rank]
    check(all(k > 0 for k in k3_ranks), f"K3 launches by rank on the mesh GWAS: {k3_ranks}")
    share = -(-N_SNPS // MESH_RANKS)
    retry_rows = [max((int(rows) for rows in st["gwas"]["k3_by_rows"] if int(rows) != share),
                      default=0) for st in steps_by_rank]
    reading = ranks[0]["first_pass_reading"]
    log(f"mesh GWAS first pass on rank 0's {reading['snps']} SNPs (retried {retry_rows[0]}): "
        + json.dumps(reading))
    check(reading["flagged"]["k3"] == retry_rows[0],
          "the first-pass reading's K3 route does not flag the SNPs rank 0 retried")

    # 4. every rank fitted its share of the groups in the grouped steps
    for name in ("rgwas", "grouped_effects"):
        for r, st in enumerate(steps_by_rank):
            check(any(f"groups sharded over {MESH_RANKS} ranks" in line
                      for line in st[name]["sharded_lines"]),
                  f"mesh {name}: rank {r} did not shard its groups: {st[name]['sharded_lines']}")

    # 5. the D&C eigensolver against torch.linalg.eigh of the same GRM, and
    # each rank's peak device memory inside it and over the step
    diag = read_grm(str(workdir / "mesh_eigh"))
    kernel = read_grm(str(workdir / "mesh_eigh.nondiagonal"))["kernel"]
    eig = _eigen_check(kernel, diag["eigenvalues"], diag["eigenvectors"], device)
    del diag, kernel
    plane_gb = MESH_EIGH_N ** 2 * 8 / 1e9
    eig_memory = {
        "plane_gb": plane_gb,
        "solver_peak_gb": [st["eigh"]["solver_memory_gb"]["peak"] for st in steps_by_rank],
        "solver_at_entry_gb": [st["eigh"]["solver_memory_gb"]["at_entry"] for st in steps_by_rank],
        "step_peak_gb": [st["eigh"]["peak_device_gb"] for st in steps_by_rank]}
    for key in ("solver_peak", "solver_at_entry", "step_peak"):
        eig_memory[f"{key}_planes"] = [gb / plane_gb for gb in eig_memory[f"{key}_gb"]]
    limit = WHOLE_OPERAND_EIGH_PLANES / MESH_RANKS + 2
    log(f"mesh eigh at N = {MESH_EIGH_N}: solver peak {eig_memory['solver_peak_planes']} planes "
        f"of {plane_gb:.3f} GB per rank (limit {limit:.2f}), step peak "
        f"{eig_memory['step_peak_planes']}")
    check(max(eig_memory["solver_peak_planes"]) <= limit,
          "the D&C eigensolver's per-rank peak is not about 1/P of the whole-operand solver's")
    summary = {
        "nccl_one_rank": nccl,
        "collectives_gloo_cuda": ranks[0]["collectives"],
        "grm_max_abs_err": grm_err, "grm_scale": scale,
        "reml": {**{k: fit[k] for k in ("variances", "log_likelihood", "iterations", "success")},
                 "vs_same_grm": errs, "variance_rel_err_vs_k1_grm": rel,
                 "logl_rel_err_vs_k1_grm": ll_rel,
                 "seconds_per_iteration": reml_phase / fit["iterations"],
                 "inverse_seconds_per_iteration_in_fit": steps_by_rank[0]["reml"]["phases"].get(
                     "DistributedInverse", float("nan")) / fit["iterations"],
                 "inverse_seconds": inverse_s, "inverse_stage_seconds": inverse_stage_s,
                 "inverse_n": plan["inverse_n"], "block": block},
        "gwas": {"unfitted": unfit_mesh, "unfitted_single": unfit_single,
                 "k3_launches_by_rank": k3_ranks, "retry_rows_by_rank": retry_rows,
                 "k3_by_rows_by_rank": [st["gwas"]["k3_by_rows"] for st in steps_by_rank],
                 "first_pass_reading": reading},
        "eigh": {**eig, **eig_memory,
                 "seconds": steps_by_rank[0]["eigh"]["phases"].get("DiagonalizeGRM")},
        "grouped_seconds": {name: [st[name]["phases"].get("GWAS") for st in steps_by_rank]
                            for name in ("rgwas", "grouped_effects")},
        "peak_device_gb_by_step": {n: [st[n]["peak_device_gb"] for st in steps_by_rank]
                                   for n in steps_by_rank[0]},
        "gloo_bytes_per_cholesky_inverse": inverse_collective_bytes(
            plan["inverse_n"], MESH_RANKS, block),
    }
    log("mesh path (gloo correctness run, two ranks on one card): " + json.dumps(summary))
    launches = {name: sum(st[step]["launches"][name] for st in steps_by_rank for step in st)
                for name in steps_by_rank[0]["grm"]["launches"]}
    return launches, seconds, summary


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
    from dissect_tpu_torch.runtime.dtypes import configure_precision

    os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)  # the CLI runs on the card
    configure_precision()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    counters = kernel_counters()
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
        plink_launches, path_seconds, plink_k3 = drive_path(
            "", plink_dir, plink_args, counters,
            expect=("grm_fused_triangle_update", "fused_refit_moments"))
        seconds.update(path_seconds)
        peak_gb["plink"] = torch.cuda.max_memory_allocated(device) / 1e9
        t0 = time.monotonic()
        plink_summary, diag_kern = phase_checks(plink_dir, causal, device)
        summary = {"plink": plink_summary}
        seconds["checks"] = time.monotonic() - t0
        reml_launches, reml_seconds, summary["reml"] = phase_reml(
            plink_dir, counters, summary["plink"]["null_variances"], device)
        seconds.update(reml_seconds)
        peak_gb["reml"] = summary["reml"]["peak_device_gb"]
        mesh_launches, mesh_seconds, summary["mesh"] = phase_mesh(
            plink_dir, summary["reml"], counters, device)
        seconds.update(mesh_seconds)
        pca_launches, path_seconds, summary["pca"], kern = phase_pca(plink_dir, counters, device)
        seconds.update(path_seconds)
        bivar_launches, path_seconds, summary["bivar"] = phase_bivar(
            plink_dir, counters, kern, device)
        seconds.update(path_seconds)
        del kern
        regional_launches, path_seconds, summary["regional"] = phase_regional(
            plink_dir, causal, counters, device)
        seconds.update(path_seconds)
        path_seconds, summary["grouped"] = phase_grouped(plink_dir, causal, counters, device)
        seconds.update(path_seconds)
        summary["mesh"]["grouped"] = check_mesh_grouped(plink_dir)
        mp_launches, path_seconds, summary["mp"] = phase_mp(
            plink_dir, causal, counters, summary["plink"]["null_variances"], device)
        seconds.update(path_seconds)
        igwas_launches, path_seconds, summary["igwas"] = phase_igwas(
            plink_dir, counters, diag_kern, device)
        seconds.update(path_seconds)
        del diag_kern
        glmm_launches, path_seconds, summary["glmm"] = phase_glmm(plink_dir, counters, device)
        seconds.update(path_seconds)
        path_seconds, summary["simulate_predict"] = phase_simulate_predict(
            plink_dir, causal, counters, device)
        seconds.update(path_seconds)
        for tag in ("pca", "bivar", "regional", "mp", "igwas", "glmm"):
            peak_gb[tag] = summary[tag]["peak_device_gb"]
        shutil.rmtree(plink_dir, ignore_errors=True)

        t0 = time.monotonic()
        bgen_args, causal = write_bgen_cohort(bgen_dir, device)
        seconds["write_bgen_cohort"] = time.monotonic() - t0
        torch.cuda.reset_peak_memory_stats(device)
        bgen_launches, path_seconds, bgen_k3 = drive_path(
            "bgen_", bgen_dir, bgen_args, counters,
            expect=("syrk_triangle_packed", "fused_refit_moments"), n_snps=BGEN_SNPS)
        seconds.update(path_seconds)
        peak_gb["bgen"] = torch.cuda.max_memory_allocated(device) / 1e9
        t0 = time.monotonic()
        _, summary["bgen"] = science_checks(bgen_dir, causal, BGEN_SNPS)
        summary["bgen"]["blocks_parsed_on_host"] = {
            tag: STEP_DECODE[tag]["bgen_unsupported"] for tag in ("bgen_make_grm", "bgen_gwas_grm")}
        seconds["bgen_checks"] = time.monotonic() - t0
        seconds.update(time_bgen_host(bgen_args[1], device))
        l1_launches, path_seconds, summary["bgen_l1"] = phase_bgen_l1(bgen_dir, counters, device)
        seconds.update(path_seconds)

        t0 = time.monotonic()
        k3_by_rows = {"plink": plink_k3, "bgen": bgen_k3}
        retry_rows = {
            tag: max((rows for rows in by_rows if rows != {"plink": N_SNPS, "bgen": BGEN_SNPS}[tag]),
                     default=0)
            for tag, by_rows in k3_by_rows.items()}
        for r, rows in enumerate(summary["mesh"]["gwas"]["retry_rows_by_rank"]):
            retry_rows[f"mesh_rank{r}"] = rows
        retry_timed = k3_at_retry(device, retry_rows)
        seconds["k3_retry"] = time.monotonic() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for entry in kernels:
        by_path = {"plink": plink_launches[entry["name"]], "bgen": bgen_launches[entry["name"]],
                   "reml": reml_launches[entry["name"]], "pca": pca_launches[entry["name"]],
                   "bivar": bivar_launches[entry["name"]],
                   "regional": regional_launches[entry["name"]],
                   "mpresiduals": mp_launches[entry["name"]],
                   "igwas": igwas_launches[entry["name"]],
                   "glmm": glmm_launches[entry["name"]],
                   "mesh": mesh_launches[entry["name"]],
                   "bgen_l1": l1_launches[entry["name"]]}
        # the steps whose phases return no launches: from their records
        for tag in ("grouped_ols", "grouped_grm", "rgwas", "grouped_effects", "mpgwas",
                    "simulate", "predict"):
            by_path[tag] = STEP_LAUNCHES[tag][entry["name"]]
        entry["launches"] = sum(by_path.values())
        entry["launches_by_path"] = by_path
        if entry["name"] in ROW_COUNTED_DECODERS:  # over every step's record
            by_rows = {}
            for record in STEP_DECODE.values():
                for rows, count in record["launches_by_rows"][entry["name"]].items():
                    by_rows[int(rows)] = by_rows.get(int(rows), 0) + count
            entry["launches_by_rows"] = {f"R={rows}": count
                                         for rows, count in sorted(by_rows.items(), reverse=True)}
            check(sum(by_rows.values()) == entry["launches"],
                  f"{entry['name']} launches by row count {by_rows} do not add up to "
                  f"{entry['launches']}")
        if entry["name"] == "fused_refit_moments":
            entry["launches_by_shape"] = {
                tag: {f"M={rows}": count for rows, count in by_rows.items()}
                for tag, by_rows in k3_by_rows.items()}
            entry["launches_by_shape"]["igwas"] = {
                f"M={rows}": count for rows, count in summary["igwas"]["launches_by_rows"].items()}
            entry["launches_by_shape"]["mesh"] = [
                {f"M={rows}": count for rows, count in by_rows.items()}
                for by_rows in summary["mesh"]["gwas"]["k3_by_rows_by_rank"]]
            first = retry_timed.get("plink") or retry_timed.get("bgen")
            entry["retry_ms"] = first["ms"] if first else None
            entry["retry_shape"] = first["shape"] if first else None
            entry["retry_by_path"] = retry_timed
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
    if len(sys.argv) == 3 and sys.argv[1] == "--mesh-worker":
        sys.exit(mesh_worker(sys.argv[2]))
    sys.exit(main())
