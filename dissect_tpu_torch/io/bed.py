"""PLINK .bed/.bim/.fam ingestion (after dissect_tpu/io/bed.py).

Reference parity: genotype.{h,cpp} (readBIMFile/readFAMFile
genotype.cpp:392-547, readBEDFile + parseSNPbyte genotype.cpp:548-787,
per-SNP stats genotype.cpp:736-738, normalizeGenotypes
genotype.cpp:888-970).

Design: instead of per-process block-row seeks + BLACS scatters, the
.bed payload stays np.memmap'd on the host, as in the JAX package, and
genotypes are decoded on the data's device: a chunk's packed rows (2
bits a genotype) are gathered on the host into a pinned buffer, uploaded,
and expanded there by kernel K4 (io/genotype_kernels.py) to (snps x
individuals) int8 dosages; the per-SNP statistics come from kernel K5's
genotype counts.  A filter composes a SNP row index (host) and an
individual index (on the device, gathered by K4 and K5) and copies no
genotypes; `append_snps` chains segments.  Standardization
z = (d - 2 p) / sqrt(2 p (1 - p)), missing -> 0, runs fused on device.

A fileset's .bim and .fam are held as columns (`TextColumns`), however
the fileset was made: `parse_bim`/`parse_fam` split a file into them
(the whole text at once where every line is six tokens, line by line
otherwise), and a PlinkData built from SnpInfo / IndividualInfo lists
converts them once.  Counts, names, keys, filters and appends read the
columns; the records (`snps`, `individuals`) are made on first use.

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
import functools
import os
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from dissect_tpu_torch.io.genotype_kernels import bed_counts, bed_decode
from dissect_tpu_torch.runtime.timers import timers

BED_MAGIC = b"\x6c\x1b\x01"  # SNP-major PLINK bed
# SNP rows per upload and per K4 or K5 launch: 20 MB of packed rows at
# N = 10,000, so a whole-file decode or count never holds more on the card
BLOCK_ROWS = 8192


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


class TextColumns:
    """A .bim's or .fam's fields as columns: `values` holds one list a
    field of `record`, in the record's order (parsed from a file, cM as
    float and bp as int).  `PlinkData` holds its tables so, and makes
    their records only when first asked for."""

    def __init__(self, record: type, values: Sequence[Sequence]):
        self.record, self.values = record, values

    @classmethod
    def from_records(cls, record: type, rows: Sequence) -> "TextColumns":
        """The columns of `rows`, records of type `record`, their values as
        they are."""
        return cls(record, [[getattr(r, f.name) for r in rows]
                            for f in dataclasses.fields(record)])

    def __len__(self) -> int:
        return len(self.values[0])

    def column(self, field: str) -> Sequence:
        return self.values[[f.name for f in dataclasses.fields(self.record)].index(field)]

    def records(self) -> list:
        return list(map(self.record, *self.values))

    def take(self, rows: List[int]) -> "TextColumns":
        return TextColumns(self.record, [[v[i] for i in rows] for v in self.values])

    def __add__(self, other: "TextColumns") -> "TextColumns":
        return TextColumns(self.record, [[*a, *b] for a, b in zip(self.values, other.values)])


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


def snp_stats_from_counts(counts: np.ndarray) -> SnpStats:
    """Stats from (M, 4) int64 genotype counts [missing, 0, 1, 2] (kernel
    K5's), by the float64 expressions of the JAX package's
    compute_snp_stats (dissect_tpu/io/bed.py:104-115) on the same
    integers, so p2 and std are bit for bit the same."""
    counts = np.asarray(counts, dtype=np.int64)
    n_nonmissing = counts[:, 1] + counts[:, 2] + counts[:, 3]
    alt = counts[:, 2] + 2 * counts[:, 3]
    denom = np.maximum(2 * n_nonmissing, 1)
    p2 = alt / denom
    p1 = 1.0 - p2
    std = np.sqrt(2.0 * p1 * (1.0 - p1))
    return SnpStats(n_nonmissing=n_nonmissing, p1=p1, p2=p2, std=std)


def pack_dosage(dosage: np.ndarray) -> np.ndarray:
    """(M, N) int8 dosages (-1 = missing) -> (M, ceil(N/4)) uint8 .bed rows:
    0 -> 0b00, 1 -> 0b10, 2 -> 0b11, missing -> 0b01, individual j at bits
    2 (j mod 4) of byte j // 4, the last byte's unused codes 0."""
    dosage = np.asarray(dosage, dtype=np.int8)
    m, n = dosage.shape
    code = np.array([0b01, 0b00, 0b10, 0b11], dtype=np.uint8)
    packed = np.empty((m, -(-n // 4)), dtype=np.uint8)
    for s in range(0, m, 4096):  # rows in blocks: bounds the temporaries
        padded = np.zeros((min(4096, m - s), packed.shape[1] * 4), dtype=np.uint8)
        padded[:, :n] = code[dosage[s:s + 4096] + 1]
        packed[s:s + 4096] = (
            padded[:, 0::4]
            | (padded[:, 1::4] << 2)
            | (padded[:, 2::4] << 4)
            | (padded[:, 3::4] << 6)
        )
    return packed


@dataclasses.dataclass
class _Segment:
    """A run of a PlinkData's SNP rows read from one packed source."""

    packed: np.ndarray  # (rows, bytes) uint8: a .bed memmap or rows packed in memory
    n_source: int  # individuals coded in each packed row
    rows: np.ndarray  # int64 rows of `packed`, in the data's SNP order
    cols: Optional[torch.Tensor]  # int32 source individuals on the device; None: all, in order

    def __post_init__(self):
        if len(self.rows) and (self.rows.min() < 0 or self.rows.max() >= self.packed.shape[0]):
            raise ValueError(f"segment rows span [{self.rows.min()}, {self.rows.max()}], "
                             f"outside the {self.packed.shape[0]} packed rows")


class PlinkData:
    """A loaded PLINK fileset: metadata on the host, genotypes decoded on
    `device` in chunks of SNP rows.

    The .bim and .fam tables are held as columns (`bim`, `fam`); a
    fileset built from `snps` / `individuals` lists of records converts
    them once.  `decode_rows` gives a chunk as a device tensor (kernel K4
    on the card); `decode_chunk` and `dosages()` give it as numpy, for
    the host workflows; `stats()` counts genotypes with kernel K5.  A
    PlinkData built from an in-memory `_dosage` matrix packs it once, with
    the encoder `write_plink` uses, and decodes through K4 like a file
    (reference analog: block-row BED streaming, genotype.cpp:639-707).
    """

    def __init__(
        self,
        snps: Optional[Sequence[SnpInfo]] = None,
        individuals: Optional[Sequence[IndividualInfo]] = None,
        bed_path: Optional[str] = None,
        _dosage: Optional[np.ndarray] = None,  # (M, N) int8, -1 = missing
        device: Union[str, torch.device] = "cuda",
        *,
        bim: Optional[TextColumns] = None,
        fam: Optional[TextColumns] = None,
        _segments: Optional[List[_Segment]] = None,
        _stats: Optional[SnpStats] = None,
    ):
        self.bim = bim if snps is None else TextColumns.from_records(SnpInfo, snps)
        self.fam = fam if individuals is None else TextColumns.from_records(IndividualInfo,
                                                                            individuals)
        self.bed_path, self.device = bed_path, torch.device(device)
        self._segments, self._stats = _segments, _stats
        if self._segments is not None:
            return
        if _dosage is not None:
            dosage = np.asarray(_dosage)
            if dosage.shape != (self.n_snps, self.n_individuals):
                raise ValueError(
                    f"dosage has shape {dosage.shape}, expected "
                    f"({self.n_snps}, {self.n_individuals})"
                )
            packed = pack_dosage(dosage)
        elif self.bed_path is not None:
            packed = self._bed_mmap()
        else:
            raise ValueError("PlinkData needs a bed_path or a dosage matrix")
        self._segments = [
            _Segment(packed, self.n_individuals, np.arange(self.n_snps, dtype=np.int64), None)
        ]

    @functools.cached_property
    def snps(self) -> List[SnpInfo]:
        """The .bim's records, made on first use."""
        return self.bim.records()

    @functools.cached_property
    def individuals(self) -> List[IndividualInfo]:
        """The .fam's records, made on first use."""
        return self.fam.records()

    @property
    def n_snps(self) -> int:
        return len(self.bim)

    @property
    def n_individuals(self) -> int:
        return len(self.fam)

    @property
    def individual_keys(self) -> List[str]:
        """IndividualInfo.key's FID@IID of each individual."""
        return [f + "@" + i for f, i in zip(self.fam.column("family_id"),
                                            self.fam.column("individual_id"))]

    @property
    def snp_names(self) -> List[str]:
        return list(self.bim.column("name"))

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

    def _packed_rows(self, start: int, stop: int):
        """(segment, packed rows on the device) for each block of at most
        BLOCK_ROWS of the rows [start, stop) that lie in one segment: the
        block's rows are taken on the host into a buffer of its own (pinned
        for a card, from the caching host allocator) and uploaded without a
        wait.  The take is unbuffered (`mode="clip"`; numpy buffers `out` in
        its default mode); it hides no bad row, since a segment's rows are
        checked when the segment is built.  Counter: plink.bytes_staged."""
        pos = 0
        for seg in self._segments:
            lo, hi = max(start, pos), min(stop, pos + len(seg.rows))
            for b in range(lo, hi, BLOCK_ROWS):
                rows = seg.rows[b - pos : min(b + BLOCK_ROWS, hi) - pos]
                with timers.span("plink.gather"):
                    host = torch.empty((len(rows), seg.packed.shape[1]), dtype=torch.uint8,
                                       pin_memory=self.device.type == "cuda")
                    np.take(seg.packed, rows, axis=0, out=host.numpy(), mode="clip")
                    timers.count("plink.bytes_staged", host.numel())
                    packed = host.to(self.device, non_blocking=True)
                yield seg, packed
            pos += len(seg.rows)

    def _decode_into(self, out, start: int):
        """Fill `out` (a device tensor or a numpy array) with the dosage
        rows from `start` on, one block of K4 at a time: K4 writes a device
        tensor's rows in place; a numpy array gets each block copied back."""
        pos = 0
        for seg, packed in self._packed_rows(start, start + len(out)):
            rows = len(packed)
            if isinstance(out, np.ndarray):
                out[pos : pos + rows] = bed_decode(packed, seg.n_source, seg.cols).cpu().numpy()
            else:
                bed_decode(packed, seg.n_source, seg.cols, out=out[pos : pos + rows])
            pos += rows
        return out

    def decode_rows(self, start: int, stop: int) -> torch.Tensor:
        """Dosage rows [start, stop) as a (chunk, N) int8 tensor on the
        data's device, -1 = missing (K4 on the card)."""
        return self._decode_into(
            torch.empty((stop - start, self.n_individuals), dtype=torch.int8, device=self.device),
            start)

    def decode_chunk(self, start: int, stop: int) -> np.ndarray:
        """Dosage rows [start, stop) as (chunk, N) int8 numpy, -1 = missing;
        the device holds one block at a time."""
        return self._decode_into(np.empty((stop - start, self.n_individuals), dtype=np.int8),
                                 start)

    def dosages(self) -> np.ndarray:
        """The full (M, N) int8 dosage matrix as numpy (host workflows)."""
        return self.decode_chunk(0, self.n_snps)

    # --- stats ---------------------------------------------------------------
    @timers.span("plink.stats")
    def stats(self) -> SnpStats:
        """Per-SNP statistics over the data's individuals, from K5's
        genotype counts of blocks of BLOCK_ROWS rows (cached)."""
        if self._stats is None:
            counts = [bed_counts(packed, seg.n_source, seg.cols)
                      for seg, packed in self._packed_rows(0, self.n_snps)]
            counts = (torch.cat(counts).cpu().numpy() if counts
                      else np.zeros((0, 4), dtype=np.int64))
            self._stats = snp_stats_from_counts(counts)
        return self._stats

    # --- filtering (parity: genotype.cpp:972 filterSNPsAndIndividuals) -------
    @timers.span("plink.filter")
    def filter(
        self,
        keep_snps: Optional[Sequence[str]] = None,
        keep_individuals: Optional[Sequence[str]] = None,
    ) -> "PlinkData":
        """Subset by SNP names and/or FID@IID keys, keeping the given order:
        a view that composes the row and individual indexes (no genotype
        is copied or decoded)."""
        bim, fam = self.bim, self.fam
        segments, stats = self._segments, self._stats
        if keep_snps is not None:
            index = dict(zip(self.snp_names, range(self.n_snps)))
            snp_idx = np.array([index[n] for n in keep_snps], dtype=np.int64)
            bim = bim.take(snp_idx.tolist())
            segments = _select_rows(segments, snp_idx)
            if stats is not None:
                stats = SnpStats(*(getattr(stats, f.name)[snp_idx]
                                   for f in dataclasses.fields(SnpStats)))
        if keep_individuals is not None:
            index = dict(zip(self.individual_keys, range(self.n_individuals)))
            ind_idx = np.array([index[k] for k in keep_individuals], dtype=np.int64)
            fam = fam.take(ind_idx.tolist())
            if not np.array_equal(ind_idx, np.arange(self.n_individuals)):
                segments = [_select_cols(seg, ind_idx, self.device) for seg in segments]
                stats = None
        return PlinkData(bim=bim, fam=fam, device=self.device, _segments=segments, _stats=stats)

    def append_snps(self, other: "PlinkData") -> "PlinkData":
        """Concatenate SNP rows of two filesets over identical individuals
        (parity: appendGenotype same-individuals path, genotype.cpp:1152):
        the segments of both, read in turn."""
        if self.individual_keys != other.individual_keys:
            raise ValueError("append_snps requires identical individuals")
        if other.device != self.device:
            raise ValueError(f"append_snps across devices ({self.device}, {other.device})")
        return PlinkData(bim=self.bim + other.bim, fam=self.fam, device=self.device,
                         _segments=self._segments + other._segments)


def _select_rows(segments: List[_Segment], snp_idx: np.ndarray) -> List[_Segment]:
    """The segments of the rows `snp_idx` (positions over all segments, any
    order): each run of consecutive picks from one segment becomes one."""
    starts = np.cumsum([0] + [len(seg.rows) for seg in segments])
    which = np.searchsorted(starts, snp_idx, side="right") - 1
    out = []
    breaks = np.flatnonzero(np.diff(which)) + 1
    for run in np.split(np.arange(len(snp_idx)), breaks):
        if len(run) == 0:
            continue
        seg = segments[which[run[0]]]
        local = snp_idx[run] - starts[which[run[0]]]
        out.append(dataclasses.replace(seg, rows=seg.rows[local]))
    return out


def _select_cols(seg: _Segment, ind_idx: np.ndarray, device) -> _Segment:
    """The segment read for the individuals `ind_idx` of its current columns."""
    idx = torch.as_tensor(ind_idx, dtype=torch.int64, device=device)
    cols = idx if seg.cols is None else seg.cols.long()[idx]
    return dataclasses.replace(seg, cols=cols.to(torch.int32).contiguous())


def _split_text(path: str, width: int):
    """(columns, lines) of a .bim or .fam: `columns`, `width` lists of
    str, where every line holds `width` whitespace-separated tokens (a
    blank line does not), else None; `lines`, the file's lines.  Each
    line's tokens are counted, then the whole text is split once: a
    text-mode read ends lines where a line-by-line read does, and
    str.split() splits them alike, so the columns hold that read's
    tokens.  Counter: plink.text_bytes."""
    with open(path) as fh:
        text = fh.read()
        timers.count("plink.text_bytes", os.fstat(fh.fileno()).st_size)
    lines = text.split("\n")
    if lines[-1] == "":  # after the last line's newline
        lines.pop()
    if all(len(line.split()) == width for line in lines):
        tokens = text.split()
        return [tokens[c::width] for c in range(width)], lines
    return None, lines


def parse_bim(path: str) -> TextColumns:
    """The .bim's columns.  A file that is not six tokens on every line is
    read line by line by the JAX package's rules (dissect_tpu/io/bed.py):
    blank lines skipped, the first six tokens kept, a short line refused
    with IndexError, a cM or bp that float/int refuse with ValueError."""
    columns, lines = _split_text(path, 6)
    if columns is None:
        return TextColumns.from_records(SnpInfo, [
            SnpInfo(p[0], p[1], float(p[2]), int(p[3]), p[4], p[5])
            for p in map(str.split, lines) if p])
    chromosome, name, cm, bp, allele1, allele2 = columns
    return TextColumns(SnpInfo, [chromosome, name, list(map(float, cm)), list(map(int, bp)),
                                 allele1, allele2])


def parse_fam(path: str) -> TextColumns:
    """The .fam's columns.  A file that is not six tokens on every line is
    read line by line by the JAX package's rules, as `parse_bim`: a short
    line takes IndividualInfo's defaults, a one-token line is refused with
    TypeError."""
    columns, lines = _split_text(path, 6)
    if columns is None:
        return TextColumns.from_records(IndividualInfo, [
            IndividualInfo(*p[:6]) for p in map(str.split, lines) if p])
    return TextColumns(IndividualInfo, columns)


@timers.span("plink.read")
def read_plink(prefix: str, device="cuda") -> PlinkData:
    """Load a .bed/.bim/.fam fileset; its payload stays memmap'd, and its
    genotypes decode on `device`.  Spans: plink.open (the .bed's magic),
    plink.read_text (the .bim and .fam parse, each file read and split
    once, into columns; no parse is kept between calls)."""
    bed_path = prefix + ".bed"
    with timers.span("plink.open"):
        with open(bed_path, "rb") as fh:
            magic = fh.read(3)
    if magic != BED_MAGIC:
        raise ValueError(
            f"{bed_path}: bad magic {magic!r} (expected SNP-major PLINK bed)"
        )
    with timers.span("plink.read_text"):
        bim, fam = parse_bim(prefix + ".bim"), parse_fam(prefix + ".fam")
    return PlinkData(bim=bim, fam=fam, bed_path=bed_path, device=device)


def write_plink(prefix: str, data: PlinkData):
    """Write .bed/.bim/.fam (used for fixtures and simulation output)."""
    packed = pack_dosage(data.dosages())
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
