"""PLINK .bed/.bim/.fam ingestion (a copy of dissect_tpu/io/bed.py; the
port decodes with the numpy lookup table and loads no native helper).

Reference parity: genotype.{h,cpp} (readBIMFile/readFAMFile
genotype.cpp:392-547, readBEDFile + parseSNPbyte genotype.cpp:548-787,
per-SNP stats genotype.cpp:736-738, normalizeGenotypes
genotype.cpp:888-970).

Design: instead of per-process block-row seeks + BLACS scatters, the
.bed payload is np.memmap'd on the host, decoded chunkwise with a
vectorized 256-entry lookup table, and shipped to the device as
(snps x individuals) int8 chunks.  Standardization
z = (d - 2 p) / sqrt(2 p (1 - p)), missing -> 0, runs fused on device.

Coding (parity with parseSNPbyte, genotype.cpp:741-787):
  2-bit 0b00 -> 0 copies of allele2   (reference internal code 1)
  2-bit 0b10 -> 1 copy  (het)         (internal 2)
  2-bit 0b11 -> 2 copies              (internal 3)
  2-bit 0b01 -> missing               (internal 0)
Allele frequencies: p1 = freq(allele1), p2 = freq(allele2),
std = sqrt(2 p1 (1 - p1)) == sqrt(2 p2 (1 - p2)) (genotype.cpp:736-738).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np

BED_MAGIC = b"\x6c\x1b\x01"  # SNP-major PLINK bed

# Lookup table: byte -> 4 dosages (allele2 copies), -1 = missing.
_CODE_TO_DOSAGE = np.array([0, -1, 1, 2], dtype=np.int8)  # [0b00,0b01,0b10,0b11]


def _build_byte_lut() -> np.ndarray:
    """(256, 4) int8 table: byte -> dosage of the 4 packed genotypes."""
    bytes_ = np.arange(256, dtype=np.uint16)
    lut = np.empty((256, 4), dtype=np.int8)
    for j in range(4):
        lut[:, j] = _CODE_TO_DOSAGE[(bytes_ >> (2 * j)) & 0x3]
    return lut


_BYTE_LUT = _build_byte_lut()


@dataclasses.dataclass
class SnpInfo:
    """One .bim row (genotype.h:56-73 SNP metadata fields)."""

    chromosome: str
    name: str
    position_cm: float
    position_bp: int
    allele1: str
    allele2: str


@dataclasses.dataclass
class IndividualInfo:
    """One .fam row (genotype.h Individual)."""

    family_id: str
    individual_id: str
    paternal_id: str = "0"
    maternal_id: str = "0"
    sex: str = "0"
    phenotype: str = "-9"

    @property
    def key(self) -> str:
        """FID@IID join key (parity: kernel.cpp:74-76)."""
        return self.family_id + "@" + self.individual_id


@dataclasses.dataclass
class SnpStats:
    """Per-SNP allele statistics (parity: genotype.cpp:736-738).

    Arrays over the SNP axis:
      n_nonmissing  observed genotype count
      p1, p2        allele frequencies (allele1 / allele2)
      std           sqrt(2 p1 (1 - p1))
      mean          2 p2 (mean allele2 dosage used for centering)
    """

    n_nonmissing: np.ndarray
    p1: np.ndarray
    p2: np.ndarray
    std: np.ndarray

    @property
    def mean(self) -> np.ndarray:
        return 2.0 * self.p2

    @property
    def monomorphic(self) -> np.ndarray:
        return self.std == 0.0


def compute_snp_stats(dosage: np.ndarray) -> SnpStats:
    """Stats from an (M, N) int8 dosage matrix with -1 = missing."""
    observed = dosage >= 0
    n_nonmissing = observed.sum(axis=1)
    alt = np.where(observed, dosage, 0).sum(axis=1, dtype=np.int64)
    denom = np.maximum(2 * n_nonmissing, 1)
    p2 = alt / denom
    p1 = 1.0 - p2
    std = np.sqrt(2.0 * p1 * (1.0 - p1))
    return SnpStats(n_nonmissing=n_nonmissing, p1=p1, p2=p2, std=std)


@dataclasses.dataclass
class PlinkData:
    """A loaded PLINK fileset: metadata on host, genotypes decodable in chunks.

    The full (M, N) dosage matrix may be materialized (`dosages()`) for
    small cohorts or streamed chunkwise (`iter_chunks`) for the
    1M-SNP-scale path (reference analog: block-row BED streaming,
    genotype.cpp:639-707).
    """

    snps: List[SnpInfo]
    individuals: List[IndividualInfo]
    bed_path: Optional[str] = None
    _dosage: Optional[np.ndarray] = None  # (M, N) int8, -1 = missing
    _stats: Optional[SnpStats] = None

    @property
    def n_snps(self) -> int:
        return len(self.snps)

    @property
    def n_individuals(self) -> int:
        return len(self.individuals)

    @property
    def individual_keys(self) -> List[str]:
        return [ind.key for ind in self.individuals]

    @property
    def snp_names(self) -> List[str]:
        return [s.name for s in self.snps]

    # --- decode --------------------------------------------------------------
    def _bed_mmap(self) -> np.ndarray:
        n_bytes_per_snp = (self.n_individuals + 3) // 4
        mm = np.memmap(self.bed_path, dtype=np.uint8, mode="r", offset=3)
        expected = self.n_snps * n_bytes_per_snp
        if mm.size < expected:
            raise ValueError(
                f"{self.bed_path}: {mm.size} payload bytes < expected {expected}"
            )
        return mm[:expected].reshape(self.n_snps, n_bytes_per_snp)

    def decode_chunk(self, start: int, stop: int) -> np.ndarray:
        """Dosage rows [start, stop) as (chunk, N) int8 with -1 = missing."""
        if self._dosage is not None:
            return self._dosage[start:stop]
        rows = self._bed_mmap()[start:stop]
        return decode_bed_rows(rows, self.n_individuals)

    def dosages(self) -> np.ndarray:
        """Materialize the full (M, N) int8 dosage matrix."""
        if self._dosage is None:
            self._dosage = self.decode_chunk(0, self.n_snps)
        return self._dosage

    def iter_chunks(self, chunk_size: int):
        for start in range(0, self.n_snps, chunk_size):
            stop = min(start + chunk_size, self.n_snps)
            yield start, stop, self.decode_chunk(start, stop)

    # --- stats ---------------------------------------------------------------
    def stats(self) -> SnpStats:
        if self._stats is None:
            if self._dosage is not None:
                self._stats = compute_snp_stats(self._dosage)
            else:
                parts = [compute_snp_stats(c) for _, _, c in self.iter_chunks(8192)]
                self._stats = SnpStats(
                    n_nonmissing=np.concatenate([p.n_nonmissing for p in parts]),
                    p1=np.concatenate([p.p1 for p in parts]),
                    p2=np.concatenate([p.p2 for p in parts]),
                    std=np.concatenate([p.std for p in parts]),
                )
        return self._stats

    # --- filtering (parity: genotype.cpp:972 filterSNPsAndIndividuals) -------
    def filter(
        self,
        keep_snps: Optional[Sequence[str]] = None,
        keep_individuals: Optional[Sequence[str]] = None,
    ) -> "PlinkData":
        """Subset by SNP names and/or FID@IID keys, keeping the given order."""
        dosage = self.dosages()
        snp_idx = np.arange(self.n_snps)
        ind_idx = np.arange(self.n_individuals)
        snps = self.snps
        individuals = self.individuals
        if keep_snps is not None:
            index = {s.name: i for i, s in enumerate(self.snps)}
            snp_idx = np.array([index[n] for n in keep_snps], dtype=np.int64)
            snps = [self.snps[i] for i in snp_idx]
        if keep_individuals is not None:
            index = {ind.key: i for i, ind in enumerate(self.individuals)}
            ind_idx = np.array([index[k] for k in keep_individuals], dtype=np.int64)
            individuals = [self.individuals[i] for i in ind_idx]
        new_dosage = dosage[np.ix_(snp_idx, ind_idx)]
        return PlinkData(snps=snps, individuals=individuals, _dosage=new_dosage)

    def append_snps(self, other: "PlinkData") -> "PlinkData":
        """Concatenate SNP rows of two filesets over identical individuals
        (parity: appendGenotype same-individuals path, genotype.cpp:1152)."""
        if self.individual_keys != other.individual_keys:
            raise ValueError("append_snps requires identical individuals")
        return PlinkData(
            snps=self.snps + other.snps,
            individuals=self.individuals,
            _dosage=np.concatenate([self.dosages(), other.dosages()], axis=0),
        )


def decode_bed_rows(rows: np.ndarray, n_individuals: int) -> np.ndarray:
    """Decode (chunk, bytes_per_snp) uint8 -> (chunk, N) int8 dosages
    through the 256-entry lookup table."""
    decoded = _BYTE_LUT[rows]  # (chunk, bytes, 4)
    return decoded.reshape(rows.shape[0], -1)[:, :n_individuals]


def read_bim(path: str) -> List[SnpInfo]:
    snps = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            snps.append(
                SnpInfo(
                    chromosome=parts[0],
                    name=parts[1],
                    position_cm=float(parts[2]),
                    position_bp=int(parts[3]),
                    allele1=parts[4],
                    allele2=parts[5],
                )
            )
    return snps


def read_fam(path: str) -> List[IndividualInfo]:
    individuals = []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            individuals.append(IndividualInfo(*parts[:6]))
    return individuals


def read_plink(prefix: str) -> PlinkData:
    """Load a .bed/.bim/.fam fileset (payload stays memmap'd until used)."""
    bed_path = prefix + ".bed"
    with open(bed_path, "rb") as fh:
        magic = fh.read(3)
    if magic != BED_MAGIC:
        raise ValueError(
            f"{bed_path}: bad magic {magic!r} (expected SNP-major PLINK bed)"
        )
    return PlinkData(
        snps=read_bim(prefix + ".bim"),
        individuals=read_fam(prefix + ".fam"),
        bed_path=bed_path,
    )


def write_plink(prefix: str, data: PlinkData):
    """Write .bed/.bim/.fam (used for fixtures and simulation output)."""
    dosage = data.dosages()
    m, n = dosage.shape
    # dosage -> 2-bit codes: 0->0b00, 1->0b10, 2->0b11, missing->0b01
    code = np.array([0b01, 0b00, 0b10, 0b11], dtype=np.uint8)[dosage + 1]
    n_bytes = (n + 3) // 4
    padded = np.zeros((m, n_bytes * 4), dtype=np.uint8)
    padded[:, :n] = code
    packed = (
        padded[:, 0::4]
        | (padded[:, 1::4] << 2)
        | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    )
    os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
    with open(prefix + ".bed", "wb") as fh:
        fh.write(BED_MAGIC)
        fh.write(packed.tobytes())
    with open(prefix + ".bim", "w") as fh:
        for s in data.snps:
            fh.write(
                f"{s.chromosome}\t{s.name}\t{s.position_cm:g}\t{s.position_bp}"
                f"\t{s.allele1}\t{s.allele2}\n"
            )
    with open(prefix + ".fam", "w") as fh:
        for ind in data.individuals:
            fh.write(
                f"{ind.family_id} {ind.individual_id} {ind.paternal_id} "
                f"{ind.maternal_id} {ind.sex} {ind.phenotype}\n"
            )
