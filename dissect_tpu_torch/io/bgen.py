"""BGEN genotype loader (layouts 1 and 2, biallelic diploid).

After dissect_tpu/io/bgen.py.  Parity: genotypebgen.cpp — reads expected
allele-2 dosages from BGEN probability data, biallelic + diploid only
(genotypebgen.cpp:106-122), computing per-variant mean/std and feeding
the same genotype containers as the PLINK path.  Layout 1 (--bgen-l1,
options.cpp:1118) and layout 2 of the v1.1/1.2/1.3 spec: per-variant
blocks of zlib/zstd-compressed probabilities (layout 1: three uint16s
per individual scaled by 32768; layout 2: bit-packed with per-sample
ploidy).

The reader works a batch of variants at a time: the host decompresses
the blocks on a thread pool (zlib and zstd release the GIL), lays them
end to end in one pinned buffer with their offsets and lengths, and
uploads it; kernel K6 (layout 2) or K7 (layout 1) decodes the batch on
the data's device (io/genotype_kernels.py), and the few blocks a kernel
does not take are parsed on the host, as the JAX package's caller parses
the rows its native decoder refuses.  Departure from the JAX package:
its native decoder also decompresses, in C++; here the host's threads
do: the port has no inflate kernel for the card.
The dosages stay on the device as one float32 tensor, NaN = missing
(GenotypeAttributes::dosages analog), so the GRM and the GWAS read them
with no upload; they equal the JAX package's bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple, Union

try:  # zstd-compressed BGEN (spec v1.3); gated — not all builds ship it
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

import numpy as np
import torch

from dissect_tpu_torch.io.bed import IndividualInfo, SnpInfo, SnpStats
from dissect_tpu_torch.io.genotype_kernels import bgen_decode_l1, bgen_decode_l2
from dissect_tpu_torch.runtime.log import get_logger
from dissect_tpu_torch.runtime.timers import timers

# variants decompressed and decoded per batch: bounds the host memory of
# the decompressed bytes
_BATCH = 1024
# rows per block of stats(): bounds its float64 temporaries
_STATS_ROWS = 4096
# numpy 2.0 sums the contiguous last axis of an array in pieces of this
# many entries (its reduction buffer), pairwise within each piece; numpy
# 2.3 sums a whole row pairwise (`_numpy_piece` probes which)
_NUMPY_BUFFER = 8192


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


@dataclasses.dataclass
class BgenData:
    """BGEN variants and samples, with their dosages as one (M, N) float32
    tensor, NaN = missing, on the device where they were decoded (a numpy
    array given here is kept as a CPU tensor)."""

    snps: List[SnpInfo]
    individuals: List[IndividualInfo]
    dosages: Union[torch.Tensor, np.ndarray]  # (M, N) float32, NaN = missing
    _stats: Optional[SnpStats] = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if not isinstance(self.dosages, torch.Tensor):
            self.dosages = torch.from_numpy(np.ascontiguousarray(self.dosages, dtype=np.float32))

    @property
    def device(self) -> torch.device:
        return self.dosages.device

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

    def stats(self) -> SnpStats:
        """Per-variant dosage statistics in SnpStats form so BGEN data
        flows through the same GRM/GWAS pipeline as PLINK hard calls
        (genotypebgen.cpp on-the-fly mean/std accumulation).  p2 is the
        mean dosage / 2; std is the EMPIRICAL dosage std (the reference
        uses sample std for imputed data, not sqrt(2p(1-p))).  Computed
        on the data's device in blocks of rows, by the JAX package's
        numpy expressions with each sum taken in numpy's order, so the
        results are its own bit for bit; cached."""
        if self._stats is None:
            parts = [_dosage_stats(self.dosages[s:s + _STATS_ROWS])
                     for s in range(0, self.n_snps, _STATS_ROWS)]
            if parts:
                n, mean, var = (torch.cat(p).cpu().numpy() for p in zip(*parts))
            else:
                n, mean, var = np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
            p2 = mean / 2.0
            self._stats = SnpStats(n_nonmissing=n, p1=1.0 - p2, p2=p2, std=np.sqrt(var))
        return self._stats

    # --- PlinkData-protocol compatibility ------------------------------------
    def decode_rows(self, start: int, stop: int) -> torch.Tensor:
        """Rows [start, stop) on the data's device (a view)."""
        return self.dosages[start:stop]

    def decode_chunk(self, start: int, stop: int) -> np.ndarray:
        return self.dosages[start:stop].cpu().numpy()

    def iter_chunks(self, chunk_size: int):
        for start in range(0, self.n_snps, chunk_size):
            stop = min(start + chunk_size, self.n_snps)
            yield start, stop, self.dosages[start:stop]

    def filter(self, keep_snps=None, keep_individuals=None) -> "BgenData":
        dosages = self.dosages
        snps, individuals = self.snps, self.individuals
        if keep_snps is not None:
            index = {s.name: i for i, s in enumerate(self.snps)}
            snp_idx = np.array([index[nm] for nm in keep_snps], dtype=np.int64)
            snps = [self.snps[i] for i in snp_idx]
            dosages = dosages[torch.as_tensor(snp_idx, device=self.device)]
        if keep_individuals is not None:
            index = {ind.key: i for i, ind in enumerate(self.individuals)}
            ind_idx = np.array(
                [index[k] for k in keep_individuals], dtype=np.int64
            )
            individuals = [self.individuals[i] for i in ind_idx]
            dosages = dosages[:, torch.as_tensor(ind_idx, device=self.device)]
        return BgenData(snps=snps, individuals=individuals, dosages=dosages.contiguous())


def _dosage_stats(dosages: torch.Tensor):
    """(non-missing count, mean, sample variance) of each row, NaN =
    missing, as the JAX package's BgenData.stats() computes them: the
    float32 row sums and the float64 sums of squared deviations each in
    numpy's summation order (`_numpy_row_sum`)."""
    observed = ~torch.isnan(dosages)
    n = observed.sum(dim=1)
    total = _numpy_row_sum(torch.where(observed, dosages, 0.0))
    mean = total.to(torch.float64) / n.clamp_min(1).to(torch.float64)
    dev = dosages.to(torch.float64) - mean[:, None]
    var = _numpy_row_sum(torch.where(observed, dev * dev, 0.0)) / (n - 1).clamp_min(1)
    return n, mean, var


def _numpy_row_sum(x: torch.Tensor, piece_len: Optional[int] = None) -> torch.Tensor:
    """Each row's sum, rounded as numpy rounds np.sum(x, axis=1) of a
    C-contiguous array in x's dtype: 0 plus, in turn, the sums of the
    row's pieces of `piece_len` entries (`_numpy_piece()` by default),
    each by numpy's pairwise_sum (eight running sums over at most 128
    entries, halves above)."""
    piece_len = piece_len or _numpy_piece()
    total = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for s in range(0, x.shape[1], piece_len):
        piece = x[:, s:s + piece_len]
        tree = _pairwise_tree(0, piece.shape[1])
        leaves = {}
        for start, n in _tree_leaves(tree):
            leaves.setdefault(n, []).append(start)
        sums = {}
        for n, starts in leaves.items():
            block = _leaf_sums(piece, starts, n)
            sums.update({(start, n): block[:, k] for k, start in enumerate(starts)})
        total = total + _tree_sum(tree, sums)
    return total


@functools.lru_cache(maxsize=None)
def _numpy_piece() -> int:
    """How many entries of a row the installed numpy sums pairwise before
    it adds the next piece: _NUMPY_BUFFER (numpy 2.0's reduction buffer)
    or the whole row (numpy 2.3), found once by summing probe rows whose
    two orders round apart.  Raises if numpy sums them in neither order:
    the statistics would then not be the JAX package's bit for bit."""
    probe = np.random.default_rng(0).uniform(0.0, 1.0, size=(16, _PROBE_LEN)).astype(np.float32)
    want = probe.sum(axis=1)
    for piece_len in (_NUMPY_BUFFER, _WHOLE_ROW):
        if np.array_equal(_numpy_row_sum(torch.from_numpy(probe), piece_len).numpy(), want):
            return piece_len
    raise RuntimeError(
        f"numpy {np.__version__} sums a row in an order BgenData.stats() does not know "
        f"(neither pieces of {_NUMPY_BUFFER} entries nor the whole row)")


_PROBE_LEN = 20_000
_WHOLE_ROW = 1 << 62


def _pairwise_tree(start: int, n: int):
    """numpy's pairwise_sum recursion over entries [start, start + n): a
    leaf (start, n) of at most 128 entries, or a pair of halves split at
    a multiple of 8."""
    if n <= 128:
        return (start, n)
    half = n // 2
    half -= half % 8
    return (_pairwise_tree(start, half), _pairwise_tree(start + half, n - half))


def _tree_leaves(tree):
    if isinstance(tree[0], int):
        yield tree
        return
    for half in tree:
        yield from _tree_leaves(half)


def _tree_sum(tree, sums):
    if isinstance(tree[0], int):
        return sums[tree]
    return _tree_sum(tree[0], sums) + _tree_sum(tree[1], sums)


def _leaf_sums(x, starts, n):
    """numpy's pairwise_sum of the n-entry leaves at `starts` of every row:
    (rows, len(starts)).  Under 8 entries a running sum from 0; else eight
    running sums over the multiples of 8, added in a fixed tree, then the
    rest one by one."""
    idx = torch.as_tensor(starts, device=x.device)[:, None] + torch.arange(n, device=x.device)
    g = x[:, idx]  # (rows, leaves, n)
    if n < 8:
        res = torch.zeros(g.shape[:2], dtype=x.dtype, device=x.device)
        for j in range(n):
            res = res + g[..., j]
        return res
    r = g[..., :8]
    whole = n - n % 8
    for i in range(8, whole, 8):
        r = r + g[..., i:i + 8]
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) + (
        (r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    for i in range(whole, n):
        res = res + g[..., i]
    return res


def _read_string(buf: memoryview, pos: int, len_bytes: int = 2) -> Tuple[str, int]:
    (ln,) = struct.unpack_from("<H" if len_bytes == 2 else "<I", buf, pos)
    pos += len_bytes
    s = bytes(buf[pos : pos + ln]).decode("utf-8", errors="replace")
    return s, pos + ln


@timers.span("bgen.read")
def read_bgen(
    path: str,
    sample_path: Optional[str] = None,
    max_variants: Optional[int] = None,
    device="cuda",
) -> BgenData:
    """Read a BGEN file; its dosages are decoded on, and stay on, `device`.
    `read_bgen.unsupported` counts the blocks K6/K7 did not take, which
    were parsed on the host instead.  Spans (runtime/timers.py): bgen.read,
    and in it bgen.index (the header scan), then per batch bgen.inflate
    (the host's decompression; counter bgen.bytes_inflated) and
    bgen.decode (the batch's pinned buffer, its upload, K6/K7, the status
    read back and the host parse of refused blocks)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    buf = memoryview(raw)
    (offset,) = struct.unpack_from("<I", buf, 0)
    (header_len, n_variants, n_samples) = struct.unpack_from("<III", buf, 4)
    magic = bytes(buf[16:20])
    if magic not in (b"bgen", b"\x00\x00\x00\x00"):
        raise ValueError(f"{path}: bad BGEN magic {magic!r}")
    (flags,) = struct.unpack_from("<I", buf, 4 + header_len - 4)
    compression = flags & 0x3  # 0 none, 1 zlib, 2 zstd
    layout = (flags >> 2) & 0xF
    has_sample_ids = (flags >> 31) & 0x1
    if layout not in (1, 2):
        raise ValueError(f"{path}: unsupported BGEN layout {layout}")
    if compression == 2 and _zstd is None:
        raise ValueError(
            f"{path}: zstd-compressed BGEN needs the zstandard module"
        )

    pos = 4 + header_len
    individuals: List[IndividualInfo] = []
    if has_sample_ids:
        (_block_len, n_ids) = struct.unpack_from("<II", buf, pos)
        pos += 8
        for _ in range(n_ids):
            sid, pos = _read_string(buf, pos)
            individuals.append(IndividualInfo(family_id=sid, individual_id=sid))
    elif sample_path:
        with open(sample_path) as fh:
            lines = [l.split() for l in fh if l.strip()]
        for parts in lines[2:]:  # .sample files have 2 header lines
            individuals.append(IndividualInfo(parts[0], parts[1]))
    else:
        individuals = [IndividualInfo(f"sample_{i}", f"sample_{i}") for i in range(n_samples)]

    # --- pass 1: index the variant blocks (cheap header scan) -------------
    with timers.span("bgen.index"):
        pos = offset + 4
        cand_snps: List[SnpInfo] = []
        offs: List[int] = []
        lens: List[int] = []
        n_to_read = n_variants if max_variants is None else min(max_variants, n_variants)
        for _ in range(n_to_read):
            if layout == 1:
                # v1.1 blocks lead with N and are always biallelic
                (n_block,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            _vid, pos = _read_string(buf, pos)
            rsid, pos = _read_string(buf, pos)
            chrom, pos = _read_string(buf, pos)
            (bp,) = struct.unpack_from("<I", buf, pos)
            pos += 4
            if layout == 1:
                n_alleles = 2
            else:
                (n_alleles,) = struct.unpack_from("<H", buf, pos)
                pos += 2
            alleles = []
            for _ in range(n_alleles):
                a, pos = _read_string(buf, pos, len_bytes=4)
                alleles.append(a)
            if layout == 1:
                if compression == 1:
                    (geno_len,) = struct.unpack_from("<I", buf, pos)
                    pos += 4
                else:
                    geno_len = 6 * n_samples
            else:
                (geno_len,) = struct.unpack_from("<I", buf, pos)
                pos += 4
            if n_alleles == 2:  # biallelic only (genotypebgen.cpp:106-122)
                cand_snps.append(SnpInfo(chrom, rsid, 0.0, bp, alleles[0], alleles[1]))
                offs.append(pos)
                lens.append(geno_len)
            pos += geno_len

    # --- pass 2: decompress on a thread pool, decode a batch on the device --
    device = torch.device(device)
    m = len(cand_snps)
    dosages = torch.empty((m, n_samples), dtype=torch.float32, device=device)
    decoded = np.zeros(m, dtype=bool)
    unsupported = 0
    unpack = lambda i: _decompress(buf[offs[i] : offs[i] + lens[i]], compression, layout)
    with ThreadPoolExecutor(_threads()) as pool:
        for start in range(0, m, _BATCH):
            stop = min(start + _BATCH, m)
            with timers.span("bgen.inflate"):
                datas = list(pool.map(unpack, range(start, stop)))
            timers.count("bgen.bytes_inflated", sum(map(len, datas)))
            with timers.span("bgen.decode"):
                _, decoded[start:stop], n_host = _decode_blocks(
                    datas, n_samples, layout, device, out=dosages[start:stop])
            unsupported += n_host
    read_bgen.unsupported += unsupported
    if unsupported:
        get_logger().message(
            f"{path}: {unsupported} of {m} probability blocks parsed on the host "
            f"(not taken by the layout-{layout} decoder on {device})")

    snps = [s for i, s in enumerate(cand_snps) if decoded[i]]
    if not decoded.all():
        dosages = dosages[torch.as_tensor(np.flatnonzero(decoded), device=device)]
    return BgenData(snps=snps, individuals=individuals, dosages=dosages)


read_bgen.unsupported = 0


def _decode_blocks(datas: List[bytes], n_samples: int, layout: int, device, out=None):
    """A batch of uncompressed probability blocks -> ((k, N) float32
    dosages on `device`, NaN = missing, written into `out` when it is
    given; (k,) bool, whether each block decoded; how many went to the
    host parser).  The blocks go end to end into one pinned buffer, which
    K6 (layout 2) or K7 (layout 1) decodes after one upload; a block the
    kernel does not take (status 1) is parsed on the host, and its row
    stays NaN if that parser refuses it too (the JAX reader then drops the
    variant)."""
    lengths = np.array([len(d) for d in datas], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    host = torch.empty(int(lengths.sum()), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    view = host.numpy()
    for data, off, ln in zip(datas, offsets, lengths):
        view[off:off + ln] = np.frombuffer(data, dtype=np.uint8)
    decode = bgen_decode_l1 if layout == 1 else bgen_decode_l2
    rows, status = decode(host.to(device, non_blocking=True),
                          torch.as_tensor(offsets).to(device, non_blocking=True),
                          torch.as_tensor(lengths).to(device, non_blocking=True), n_samples,
                          out=out)
    status = status.cpu().numpy()
    ok = status == 0
    parse = _parse_layout1_dosage if layout == 1 else _parse_layout2_dosage
    for i in np.flatnonzero(~ok):
        row = parse(datas[i], n_samples)
        if row is not None:
            rows[i] = torch.as_tensor(row).to(device)
            ok[i] = True
    return rows, ok, int((status != 0).sum())


def _decompress(geno_block: memoryview, compression: int, layout: int) -> bytes:
    """The uncompressed probability bytes of one genotype block."""
    if layout == 1:
        return zlib.decompress(bytes(geno_block)) if compression == 1 else bytes(geno_block)
    if compression == 1:
        return zlib.decompress(bytes(geno_block[4:]))
    if compression == 2:
        (uncompressed_len,) = struct.unpack_from("<I", geno_block, 0)
        return _zstd.ZstdDecompressor().decompress(
            bytes(geno_block[4:]), max_output_size=uncompressed_len
        )
    return bytes(geno_block)


def _parse_layout1_dosage(data: bytes, n_samples: int) -> Optional[np.ndarray]:
    """Expected allele-2 dosage from a layout-1 (v1.1) probability block:
    three uint16 probabilities P(AA), P(AB), P(BB) per individual scaled
    by 32768; an all-zero triple marks a missing genotype."""
    if len(data) != 6 * n_samples:
        return None
    probs = np.frombuffer(data, dtype="<u2").reshape(n_samples, 3) / 32768.0
    psum = probs.sum(axis=1)
    missing = psum <= 0.0
    safe = np.where(missing, 1.0, psum)
    dosage = ((probs[:, 1] + 2.0 * probs[:, 2]) / safe).astype(np.float32)
    dosage[missing] = np.nan
    return dosage


def _parse_layout2_dosage(data: bytes, n_samples: int) -> Optional[np.ndarray]:
    """Expected allele-2 dosage from a layout-2 probability block."""
    n, n_alleles, min_pl, max_pl = struct.unpack_from("<IHBB", data, 0)
    if n != n_samples or n_alleles != 2:
        return None
    ploidy = np.frombuffer(data, dtype=np.uint8, count=n, offset=8)
    missing = (ploidy & 0x80) != 0
    ploidy_val = ploidy & 0x3F
    if not np.all(ploidy_val[~missing] == 2):
        return None  # diploid only
    phased, bits = struct.unpack_from("<BB", data, 8 + n)
    probs_raw = np.frombuffer(data, dtype=np.uint8, offset=10 + n)
    denom = float((1 << bits) - 1)
    if phased:
        # 2 haplotypes x 1 stored probability each = P(allele1);
        # expected allele2 dosage = sum over haplotypes of (1 - P(allele1))
        vals = _unpack_bits(probs_raw, bits, 2 * n).reshape(n, 2) / denom
        dosage = (1.0 - vals).sum(axis=1)
    else:
        # 2 stored genotype probabilities: P(11), P(12); P(22) implicit
        vals = _unpack_bits(probs_raw, bits, 2 * n).reshape(n, 2) / denom
        p11, p12 = vals[:, 0], vals[:, 1]
        p22 = np.clip(1.0 - p11 - p12, 0.0, 1.0)
        dosage = p12 + 2.0 * p22
    dosage = dosage.astype(np.float32)
    dosage[missing] = np.nan
    return dosage


def write_bgen(
    path: str,
    data: BgenData,
    bits: int = 8,
    layout: int = 2,
    compression: str = "zlib",
):
    """Write BGEN (fixture generation + interop testing; hard genotypes
    get probability 1).  layout 2: zlib/zstd/none 8/16-bit unphased;
    layout 1 (v1.1): uint16 probability triples, zlib or none.  The
    bytes equal the reference writer's: the probabilities are computed a
    batch of variants at a time by the same float steps, and the blocks
    are compressed in a thread pool."""
    if bits not in (8, 16):
        raise ValueError("writer supports 8- or 16-bit probabilities")
    comp_code = {"none": 0, "zlib": 1, "zstd": 2}[compression]
    if comp_code == 2 and (layout == 1 or _zstd is None):
        raise ValueError("zstd requires layout 2 and the zstandard module")
    n = data.n_individuals
    chunks = []
    # header
    header = struct.pack("<III4s", 20, data.n_snps, n, b"bgen")
    flags = comp_code | (layout << 2) | (1 << 31)
    header += struct.pack("<I", flags)
    # sample identifier block
    ids = b""
    for ind in data.individuals:
        s = ind.individual_id.encode()
        ids += struct.pack("<H", len(s)) + s
    sample_block = struct.pack("<II", 8 + len(ids), n) + ids
    offset = len(header) + len(sample_block)
    chunks.append(struct.pack("<I", offset))
    chunks.append(header)
    chunks.append(sample_block)

    def genotype_block(payload: bytes) -> bytes:
        if layout == 1:
            if comp_code == 1:
                comp = zlib.compress(payload)
                return struct.pack("<I", len(comp)) + comp
            return payload
        if comp_code == 0:
            return struct.pack("<I", len(payload)) + payload
        comp = (
            zlib.compress(payload)
            if comp_code == 1
            else _zstd.ZstdCompressor().compress(payload)
        )
        return struct.pack("<I", len(comp) + 4) + struct.pack("<I", len(payload)) + comp

    with ThreadPoolExecutor(_threads()) as pool:
        for start in range(0, data.n_snps, _BATCH):
            stop = min(start + _BATCH, data.n_snps)
            payloads = _probability_payloads(data.decode_chunk(start, stop), bits, layout)
            genos = pool.map(genotype_block, payloads)
            for snp, geno in zip(data.snps[start:stop], genos):
                chunks.append(_variant_header(snp, n, layout) + geno)
    with open(path, "wb") as fh:
        fh.write(b"".join(chunks))


def _variant_header(snp: SnpInfo, n: int, layout: int) -> bytes:
    vid = snp.name.encode()
    chrom = snp.chromosome.encode()
    var = b"" if layout == 2 else struct.pack("<I", n)
    var += struct.pack("<H", len(vid)) + vid
    var += struct.pack("<H", len(vid)) + vid
    var += struct.pack("<H", len(chrom)) + chrom
    var += struct.pack("<I", snp.position_bp)
    if layout == 2:
        var += struct.pack("<H", 2)
    for allele in (snp.allele1, snp.allele2):
        a = allele.encode()
        var += struct.pack("<I", len(a)) + a
    return var


def _probability_payloads(d: np.ndarray, bits: int, layout: int) -> List[bytes]:
    """Uncompressed probability bytes of each row of a (k, N) dosage
    block: the expected dosage as a p12/p22 mix (hard-call style)."""
    k, n = d.shape
    missing = np.isnan(d)
    dd = np.where(missing, 0.0, d)
    p22 = np.clip(dd - 1.0, 0.0, 1.0)
    p12 = np.clip(dd - 2.0 * p22, 0.0, 1.0)
    p11 = np.clip(1.0 - p12 - p22, 0.0, 1.0)
    if layout == 1:
        probs = np.stack([p11, p12, p22], axis=2)
        vals = np.round(probs * 32768.0).astype("<u2")
        vals[missing] = 0  # all-zero triple = missing (v1.1 spec)
        return [vals[r].tobytes() for r in range(k)]
    probs = np.stack([p11, p12], axis=2)
    vals = np.round(probs * ((1 << bits) - 1)).astype("<u1" if bits == 8 else "<u2")
    ploidy = np.full((k, n), 2, dtype=np.uint8)
    ploidy[missing] = 2 | 0x80
    head = struct.pack("<IHBB", n, 2, 2, 2)
    tail = struct.pack("<BB", 0, bits)
    return [head + ploidy[r].tobytes() + tail + vals[r].tobytes() for r in range(k)]


def _unpack_bits(raw: np.ndarray, bits: int, count: int) -> np.ndarray:
    """Unpack little-endian bit-packed unsigned ints of width `bits`."""
    if bits == 8:
        return raw[:count].astype(np.float64)
    if bits == 16:
        return np.frombuffer(raw.tobytes(), dtype="<u2", count=count).astype(np.float64)
    if bits == 32:
        return np.frombuffer(raw.tobytes(), dtype="<u4", count=count).astype(np.float64)
    expanded = np.unpackbits(raw, bitorder="little")
    usable = (len(expanded) // bits) * bits
    chunks = expanded[:usable].reshape(-1, bits)[:count]
    weights = (1 << np.arange(bits)).astype(np.float64)
    return chunks @ weights
