"""The benchmark's synthetic cohorts, made on the device from the seed.

A frozen copy of the cohort recipe that `chip_smoke.py` proved on the
card (MAF uniform on [0.05, 0.5], 1% missing calls, two quantitative
covariates, one trait with h2 = 0.5 from the causal SNPs; imputed
dosages blurred up to 0.25 off the hard calls), with writers of its own
for PLINK `.bed` (SNP-major, 2-bit) and BGEN v1.2 layout 2 (8-bit
probabilities, zlib).  Nothing here imports the program: the program
reads the files, the plain reference reads the arrays kept beside them,
and both see the same genotypes.

`make_cohort(config, seed, workdir, device)` returns a `Cohort`: file
paths for the program, and host arrays for the reference.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np
import torch

# rows of genotypes drawn at a time: bounds the device's temporaries
DRAW_ROWS = 8192
BED_MAGIC = b"\x6c\x1b\x01"
# .bed 2-bit codes of dosage -1 (missing), 0, 1, 2
BED_CODES = (0b01, 0b00, 0b10, 0b11)
BGEN_MISSING_PLOIDY = 2 | 0x80


@dataclasses.dataclass
class Cohort:
    """Inputs of one run.  `packed` holds the .bed rows (PLINK) and
    `probs` the 8-bit (p11, p12) pairs (BGEN), as written; `traits` (one
    row a phenotype column) and `qcov` are the values the phenotype and
    covariate files hold."""

    kind: str                       # "plink" or "bgen"
    n: int
    m: int
    argv: list                      # the CLI's genotype, phenotype and covariate options
    traits: np.ndarray              # (n_traits, n) float64
    qcov: np.ndarray                # (n, 2) float64
    packed: Optional[np.ndarray] = None   # (m, ceil(n/4)) uint8
    probs: Optional[np.ndarray] = None    # (m, n, 2) uint8; (255, 255) marks missing

    def design(self) -> np.ndarray:
        """The fixed effects as the program builds them: mean, then the
        quantitative covariates."""
        return np.column_stack([np.ones(self.n), self.qcov])


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    return gen


def hard_calls(gen, m, n, missing, device, maf=(0.05, 0.5)):
    """(m, n) int8 dosages, MAF uniform on `maf`, -1 = missing."""
    p = maf[0] + (maf[1] - maf[0]) * torch.rand((m, 1), generator=gen, device=device)
    d = (torch.rand((m, n), generator=gen, device=device) < p).to(torch.int8)
    d += (torch.rand((m, n), generator=gen, device=device) < p).to(torch.int8)
    miss = torch.rand((m, n), generator=gen, device=device) < missing
    return torch.where(miss, torch.full_like(d, -1), d)


def imputed(gen, m, n, missing, blur, device, maf=(0.05, 0.5)):
    """(m, n) float32 dosages: hard calls moved up to `blur` toward a
    neighbouring genotype, NaN = missing."""
    d = hard_calls(gen, m, n, 0.0, device, maf).to(torch.float32)
    step = blur * torch.rand((m, n), generator=gen, device=device)
    up = torch.rand((m, n), generator=gen, device=device) < 0.5
    d = d + torch.where((d == 0) | ((d == 1) & up), step, -step)
    miss = torch.rand((m, n), generator=gen, device=device) < missing
    return torch.where(miss, torch.full_like(d, float("nan")), d)


def pack_bed(d: torch.Tensor) -> torch.Tensor:
    """(m, n) int8 dosages -> (m, ceil(n/4)) uint8 .bed rows on the same
    device: individual j at bits 2 (j mod 4) of byte j // 4."""
    m, n = d.shape
    codes = torch.tensor(BED_CODES, dtype=torch.uint8, device=d.device)[(d + 1).long()]
    width = -(-n // 4) * 4
    if width != n:
        codes = torch.cat([codes, codes.new_zeros((m, width - n))], dim=1)
    c = codes.view(m, width // 4, 4)
    return c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)


def quantize_probs(d: torch.Tensor) -> torch.Tensor:
    """(m, n) dosages -> (m, n, 2) uint8 8-bit (p11, p12): the dosage as a
    p12/p22 mix, rounded to 1/255; (255, 255) marks a missing sample
    (its ploidy byte says missing, the values are never read)."""
    missing = torch.isnan(d)
    dd = torch.where(missing, torch.zeros_like(d), d).to(torch.float64)
    p22 = (dd - 1.0).clamp(0.0, 1.0)
    p12 = (dd - 2.0 * p22).clamp(0.0, 1.0)
    p11 = (1.0 - p12 - p22).clamp(0.0, 1.0)
    v = torch.round(torch.stack([p11, p12], dim=2) * 255.0).to(torch.uint8)
    return torch.where(missing[..., None], torch.full_like(v, 255), v)


def dosage_from_probs(probs: torch.Tensor) -> torch.Tensor:
    """The expected dosage p12 + 2 p22 of (..., 2) uint8 8-bit (p11, p12)
    pairs, float64, NaN where (255, 255) marks a missing sample."""
    v = probs.to(torch.float64) / 255.0
    p11, p12 = v[..., 0], v[..., 1]
    d = p12 + 2.0 * (1.0 - p11 - p12)
    missing = (probs[..., 0] == 255) & (probs[..., 1] == 255)
    return torch.where(missing, torch.full_like(d, float("nan")), d)


def traits(gen, causal_rows: torch.Tensor, config: dict, n_traits: int, device):
    """(traits, qcov): each trait h2 from the causal rows (each row
    standardized, missing as 0) with its own effects and noise, and two
    quantitative covariates with the configured effects.  The first
    trait's draws come first, so it is the same whatever `n_traits`."""
    d = causal_rows
    obs = torch.isfinite(d) if d.is_floating_point() else d >= 0
    df = torch.where(obs, d, torch.zeros_like(d)).to(torch.float64)
    mu = df.sum(1, keepdim=True) / obs.sum(1, keepdim=True)
    zc = torch.where(obs, (df - mu) / df.std(1, keepdim=True), torch.zeros_like(df))
    n = d.shape[1]
    h2 = config["h2"]
    effects = torch.tensor(config["qcovar_effects"], device=device, dtype=torch.float64)
    qcov, out = None, []
    for _ in range(n_traits):
        beta = torch.randn((d.shape[0],), generator=gen, device=device, dtype=torch.float64)
        genetic = beta @ zc
        genetic = genetic / genetic.std() * math.sqrt(h2)
        noise = torch.randn((n,), generator=gen, device=device, dtype=torch.float64)
        if qcov is None:
            qcov = torch.randn((n, 2), generator=gen, device=device, dtype=torch.float64)
        out.append(config["intercept"] + qcov @ effects + genetic + noise * math.sqrt(1.0 - h2))
    return torch.stack(out).cpu().numpy(), qcov.cpu().numpy()


def write_columns(path: Path, ids, columns):
    """`FID IID v...` rows, each value printed so that it reads back exactly."""
    with open(path, "w") as fh:
        for i, (fid, iid) in enumerate(ids):
            fh.write(f"{fid} {iid} " + " ".join(repr(float(c[i])) for c in columns) + "\n")


def snp_names(m):
    return [f"rs{i:07d}" for i in range(m)]


def chromosome(i, m):
    return str(1 + i * 22 // m)


def write_bed(prefix: Path, packed: np.ndarray, ids):
    m = packed.shape[0]
    with open(f"{prefix}.bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(packed.tobytes())
    with open(f"{prefix}.bim", "w") as fh:
        for i, name in enumerate(snp_names(m)):
            fh.write(f"{chromosome(i, m)}\t{name}\t0\t{1000 + 100 * i}\tA\tG\n")
    with open(f"{prefix}.fam", "w") as fh:
        for fid, iid in ids:
            fh.write(f"{fid} {iid} 0 0 0 -9\n")


def _bgen_string(s: str, width: str = "<H") -> bytes:
    b = s.encode()
    return struct.pack(width, len(b)) + b


def layout2_payloads(probs: torch.Tensor) -> np.ndarray:
    """(k, n, 2) uint8 pairs -> (k, 10 + 3n) uint8 uncompressed layout-2
    probability blocks: N, 2 alleles, ploidy 2..2, a ploidy byte a sample
    (missing flag 0x80), unphased, 8 bits, then the pairs."""
    k, n, _ = probs.shape
    head = torch.tensor(list(struct.pack("<IHBB", n, 2, 2, 2)), dtype=torch.uint8,
                        device=probs.device).expand(k, 8)
    missing = (probs[..., 0] == 255) & (probs[..., 1] == 255)
    ploidy = torch.where(missing, BGEN_MISSING_PLOIDY, 2).to(torch.uint8)
    tail = torch.tensor([0, 8], dtype=torch.uint8, device=probs.device).expand(k, 2)
    values = torch.where(missing[..., None], torch.zeros_like(probs), probs).reshape(k, 2 * n)
    return torch.cat([head, ploidy, tail, values], dim=1).cpu().numpy()


def write_bgen(path: Path, probs_rows, m: int, ids, level: int, threads: int):
    """BGEN v1.2, layout 2, zlib at `level`, sample ids in the file.
    `probs_rows` yields (start, (k, n, 2) uint8 tensor) blocks in order."""
    n = len(ids)
    header = struct.pack("<III4s", 20, m, n, b"bgen") + struct.pack("<I", 1 | (2 << 2) | (1 << 31))
    id_bytes = b"".join(_bgen_string(iid) for _, iid in ids)
    samples = struct.pack("<II", 8 + len(id_bytes), n) + id_bytes
    names = snp_names(m)

    def block(payload: np.ndarray) -> bytes:
        comp = zlib.compress(payload.tobytes(), level)
        return struct.pack("<II", len(comp) + 4, payload.size) + comp

    with open(path, "wb") as fh, ThreadPoolExecutor(threads) as pool:
        fh.write(struct.pack("<I", len(header) + len(samples)))
        fh.write(header)
        fh.write(samples)
        for start, probs in probs_rows:
            payloads = layout2_payloads(probs)
            for j, geno in enumerate(pool.map(block, payloads)):
                i = start + j
                fh.write(_bgen_string(names[i]) + _bgen_string(names[i])
                         + _bgen_string(chromosome(i, m)) + struct.pack("<IH", 1000 + 100 * i, 2)
                         + _bgen_string("A", "<I") + _bgen_string("G", "<I") + geno)


def make_cohort(config: dict, seed: int, workdir: Path, device, n_traits: int = 1,
                threads: int = 8) -> Cohort:
    """Draw the configured cohort and `n_traits` phenotype columns from
    `seed` on `device`, write its files under `workdir`, and keep its host
    arrays for the reference."""
    workdir.mkdir(parents=True, exist_ok=True)
    gen = generator(seed, device)
    n, m = config["n_individuals"], config["n_snps"]
    maf, missing = tuple(config["maf"]), config["missing"]
    kind = "bgen" if config["format"] == "bgen" else "plink"
    rows = []
    for s in range(0, m, DRAW_ROWS):
        k = min(DRAW_ROWS, m - s)
        if kind == "plink":
            rows.append(pack_bed(hard_calls(gen, k, n, missing, device, maf)).cpu().numpy())
        else:
            rows.append(quantize_probs(imputed(gen, k, n, missing, config["blur"], device, maf))
                        .cpu().numpy())
    stored = np.concatenate(rows)
    del rows
    causal = torch.randperm(m, generator=gen, device=device)[: config["n_causal"]].sort().values
    causal_np = causal.cpu().numpy()
    if kind == "plink":
        from portbench.reference.genotypes import decode_bed

        causal_rows = decode_bed(torch.as_tensor(stored[causal_np], device=device), n)
    else:
        causal_rows = dosage_from_probs(torch.as_tensor(stored[causal_np], device=device))
    ys, qcov = traits(gen, causal_rows, config, n_traits, device)

    prefix = workdir / "cohort"
    if kind == "plink":
        ids = [(f"F{i}", f"I{i}") for i in range(n)]
        write_bed(prefix, stored, ids)
        argv = ["--bfile", str(prefix)]
    else:
        ids = [(f"S{i}", f"S{i}") for i in range(n)]
        step = 1024
        write_bgen(Path(f"{prefix}.bgen"),
                   ((s, torch.as_tensor(stored[s:s + step], device=device))
                    for s in range(0, m, step)),
                   m, ids, config["zlib_level"], threads)
        argv = ["--bgen", f"{prefix}.bgen"]
    write_columns(workdir / "pheno.txt", ids, list(ys))
    write_columns(workdir / "qcovar.txt", ids, [qcov[:, 0], qcov[:, 1]])
    argv += ["--pheno", str(workdir / "pheno.txt"), "--qcovar", str(workdir / "qcovar.txt")]
    return Cohort(kind=kind, n=n, m=m, argv=argv, traits=ys, qcov=qcov,
                  packed=stored if kind == "plink" else None,
                  probs=stored if kind == "bgen" else None)
