"""Drive the PyTorch/CUDA port (dissect_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py            # from the repository root; needs one CUDA card

Phases, each of which stops the script on failure:

  1. build     compile every hand-written kernel under dissect_tpu_torch/csrc/
               (one nvcc per source, all started together);
  2. kernels   hold each kernel against its plain PyTorch version on the card,
               at a ragged shape and at the shape the main path gives it, and
               time kernel, plain version and (where one exists) the single
               PyTorch call that computes the same function;
  3. golden    the CLI on the repository's golden cohort (tests/golden), on
               the card, against the stored golden files;
  4. main      a synthetic PLINK cohort at the size users run (10,000
               individuals x 50,000 SNPs, 1% missing, 2 quantitative
               covariates, a phenotype with h2 = 0.5 from 500 causal SNPs),
               then `--make-grm` and `--gwas --grm` through the CLI's main();
               every kernel launch counter is zeroed just before and read
               just after;
  5. checks    finite outputs of the right shape, causal SNPs enriched among
               the smallest p-values, and on a 512-SNP subset the refit through
               K3 against the refit through K3's plain version.

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
GRM_CHUNK = 2048  # grm_from_plink's chunk: K1's row count on the main path
BLOCK_N = 512     # grm_accumulator's packed tile edge

# One NVIDIA H100 SXM (NVIDIA data sheet, dense rates): float32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# Tolerances of the kernel-vs-plain comparisons, relative to the largest
# magnitude of the plain result: both sides sum the same float32 terms in
# different orders, whose rounding grows like sqrt(terms) * eps32 ~ 1e-5
# at these contraction lengths (2,048 SNP rows for K1, 10,000 eigenbasis
# entries for K3).  K1's counts are sums of 0/1 products: exact.
K1_REL_TOL = 1e-5
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
    compare_k3(gen, 777, 1000, 4, device, timed=False)
    compare_k3(gen, 300, 1000, 9, device, timed=False)
    k3 = compare_k3(gen, N_SNPS, N_INDIVIDUALS, 4, device, timed=True)
    return [k1, k3]


# ----------------------------------------------------------------- phase 3 --
def phase_golden(workdir):
    """The CLI on tests/golden on the card.  The GRM is float32 on both
    sides: kernel at rtol 1e-5 (sums in another order), counts exact.
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
    log("golden cohort on the card: GRM, OLS and mixed-model GWAS agree with tests/golden")


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
def write_cohort(workdir, device):
    """The synthetic cohort, made on the card from SEED: PLINK files, a
    2-column quantitative covariate file and the phenotype."""
    from dissect_tpu_torch.io.bed import IndividualInfo, PlinkData, SnpInfo, write_plink

    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    n, m = N_INDIVIDUALS, N_SNPS
    dosage = np.empty((m, n), dtype=np.int8)
    step = 5000
    for s in range(0, m, step):
        dosage[s:s + step] = _dosage_on_card(gen, min(step, m - s), n, 0.01, device).cpu().numpy()
    causal = torch.randperm(m, generator=gen, device=device)[:N_CAUSAL].sort().values
    d = torch.as_tensor(dosage[causal.cpu().numpy()], device=device)
    obs = d >= 0
    df = torch.where(obs, d, torch.zeros_like(d)).to(torch.float64)
    mu = df.sum(1, keepdim=True) / obs.sum(1, keepdim=True)
    zc = torch.where(obs, (df - mu) / df.std(1, keepdim=True), torch.zeros_like(df))
    beta = torch.randn((N_CAUSAL,), generator=gen, device=device, dtype=torch.float64)
    genetic = beta @ zc
    genetic = genetic / genetic.std() * math.sqrt(0.5)
    noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
    qcov = torch.randn((n, 2), generator=gen, device=device, dtype=torch.float64)
    y = 1.0 + qcov @ torch.tensor([0.3, -0.2], device=device, dtype=torch.float64) + genetic \
        + noise * math.sqrt(0.5)

    data = PlinkData(
        snps=[SnpInfo(str(1 + i * 22 // m), f"rs{i:06d}", 0.0, 1000 + 100 * i, "A", "G")
              for i in range(m)],
        individuals=[IndividualInfo(f"F{i}", f"I{i}") for i in range(n)],
        _dosage=dosage,
    )
    prefix = workdir / "cohort"
    write_plink(str(prefix), data)
    y_h, q_h = y.cpu().numpy(), qcov.cpu().numpy()
    with open(workdir / "pheno.txt", "w") as fh:
        for i in range(n):
            fh.write(f"F{i} I{i} {y_h[i]:.10f}\n")
    with open(workdir / "qcovar.txt", "w") as fh:
        for i in range(n):
            fh.write(f"F{i} I{i} {q_h[i, 0]:.10f} {q_h[i, 1]:.10f}\n")
    return prefix, {f"rs{i:06d}" for i in causal.cpu().numpy()}


def phase_main(workdir, prefix, counters):
    from dissect_tpu_torch.analysis.dispatcher import main
    from dissect_tpu_torch.runtime.timers import timers

    args = ["--bfile", str(prefix), "--pheno", str(workdir / "pheno.txt"),
            "--qcovar", str(workdir / "qcovar.txt")]
    for fn in counters.values():
        fn.launches = 0
    seconds = {}
    t0 = time.monotonic()
    main(["--make-grm"] + args + ["--out", str(workdir / "grm")])
    seconds["make_grm"] = time.monotonic() - t0
    seconds.update({f"make_grm.{k}": v for k, v in timers.elapsed.items()})
    t0 = time.monotonic()
    main(["--gwas", "--grm", str(workdir / "grm")] + args + ["--out", str(workdir / "mlm")])
    seconds["gwas_grm"] = time.monotonic() - t0
    seconds.update({f"gwas_grm.{k}": v for k, v in timers.elapsed.items()})
    launches = {name: fn.launches for name, fn in counters.items()}
    log("main path launches: " + json.dumps(launches))
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    return launches, seconds


# ----------------------------------------------------------------- phase 5 --
def phase_checks(workdir, prefix, causal, device):
    from dissect_tpu_torch.gwas.mlm import mlm_gwas_ml_refit
    from dissect_tpu_torch.gwas.moments_kernels import plain_refit_moments
    from dissect_tpu_torch.io.bed import read_plink
    from dissect_tpu_torch.io.grm_io import read_grm

    grm = read_grm(str(workdir / "grm"))
    k, c = grm["kernel"], grm["counts"]
    check(k.shape == (N_INDIVIDUALS, N_INDIVIDUALS) and np.isfinite(k).all(), "GRM not finite")
    check(np.array_equal(k, k.T) and np.array_equal(c, c.T), "GRM not symmetric")
    check(c.max() <= N_SNPS and c.min() > 0.9 * N_SNPS, "GRM counts out of range")
    mean_diag = float(np.mean(np.diag(k)))
    check(abs(mean_diag - 1.0) < 0.05, f"GRM mean diagonal {mean_diag}")

    rows = _read_gwas(workdir / "mlm.gwas.snps")
    unfitted_path = workdir / "mlm.gwas.unfitted"
    unfitted = unfitted_path.read_text().split() if unfitted_path.exists() else []
    check(len(rows) + len(unfitted) == N_SNPS, "GWAS rows + unfitted != SNPs")
    check(len(unfitted) < 0.01 * N_SNPS, f"{len(unfitted)} unfitted SNPs")
    vals = np.array(list(rows.values()))
    check(np.isfinite(vals).all(), "non-finite GWAS output")
    names = list(rows)
    top = [names[i] for i in np.argsort(vals[:, 2])[:N_CAUSAL]]
    hits = sum(1 for nm in top if nm in causal)
    enrichment = hits / N_CAUSAL / (N_CAUSAL / N_SNPS)
    log(f"causal SNPs among the {N_CAUSAL} smallest p-values: {hits} "
        f"({enrichment:.1f}x the base rate); {len(unfitted)} unfitted")
    check(enrichment >= 10.0, "causal SNPs not enriched among the smallest p-values")

    # 512-SNP subset: refit through K3 vs through its plain version, on the card
    data = read_plink(str(prefix))
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
    return {"causal_in_top": hits, "enrichment": enrichment, "unfitted": len(unfitted),
            "grm_mean_diag": mean_diag, "null_variances": list(theta)}


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
    from dissect_tpu_torch.linalg.grm_kernels import grm_fused_triangle_update
    from dissect_tpu_torch.runtime.dtypes import configure_precision

    os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)  # the CLI runs on the card
    configure_precision()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    counters = {"grm_fused_triangle_update": grm_fused_triangle_update,
                "fused_refit_moments": fused_refit_moments}
    workdir = REPO / ".chip_smoke"
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir()
    seconds = {}
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
        prefix, causal = write_cohort(workdir, device)
        seconds["write_cohort"] = time.monotonic() - t0

        torch.cuda.reset_peak_memory_stats(device)
        launches, main_seconds = phase_main(workdir, prefix, counters)
        seconds.update(main_seconds)
        peak_gb = torch.cuda.max_memory_allocated(device) / 1e9

        t0 = time.monotonic()
        summary = phase_checks(workdir, prefix, causal, device)
        seconds["checks"] = time.monotonic() - t0
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    smi = nvidia_smi_line()
    log("phase seconds: " + json.dumps({k: round(v, 3) for k, v in seconds.items()}))
    log("main path: " + json.dumps({**summary, "peak_device_gb": peak_gb,
                                    "individuals": N_INDIVIDUALS, "snps": N_SNPS}))
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
