"""K4-K7 — the genotype decoders on the card.

Port of dissect_tpu/native/bed_native.py and bgen_native.py, the JAX
package's ctypes bindings to its OpenMP host decoders
(native/bed_decode.cpp, native/bgen_decode.cpp).  Here each decoder is a
CUDA kernel (csrc/bed_decode.cu, csrc/bgen_decode.cu) with its plain
PyTorch version beside it:

  K4 `bed_decode`      packed .bed rows -> int8 dosages (-1 = missing),
                       optionally gathering and reordering individuals;
  K5 `bed_counts`      packed .bed rows -> per-SNP int64 counts
                       [missing, 0, 1, 2] over the kept individuals;
  K6 `bgen_decode_l2`  decompressed layout-2 probability blocks ->
                       float32 expected allele-2 dosages, NaN = missing,
                       and a status per variant (0 ok, 1 unsupported);
  K7 `bgen_decode_l1`  the same for layout-1 (v1.1) blocks.

Each wrapper launches its kernel for tensors on the card (or raises) and
runs its plain version only for tensors on the CPU.  `launches` counts
the kernel's launches (K4's and K5's also by row count,
`launches_by_rows`); `card_calls` on each plain version counts its calls
on a CUDA tensor, which no path of the port makes.
"""

from __future__ import annotations

from collections import Counter

import torch

from dissect_tpu_torch.runtime import cuda_lib

# 2-bit .bed code -> dosage of allele 2: [0b00, 0b01, 0b10, 0b11]
_CODE_TO_DOSAGE = (0, -1, 1, 2)
_LUTS = {}


def _byte_lut(device) -> torch.Tensor:
    """(256, 4) int8: the dosages of a byte's four packed genotypes."""
    key = str(device)
    lut = _LUTS.get(key)
    if lut is None:
        b = torch.arange(256)
        codes = torch.stack([(b >> (2 * j)) & 0x3 for j in range(4)], dim=1)
        lut = torch.tensor(_CODE_TO_DOSAGE, dtype=torch.int8)[codes].to(device)
        _LUTS[key] = lut
    return lut


def _note_plain(fn, t: torch.Tensor):
    if t.device.type == "cuda":
        fn.card_calls += 1


def _check(name, t, dtype, ndim, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dimensions, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bed(packed, n_individuals, cols, what):
    if packed.device.type != "cuda":
        raise ValueError(f"no {what} kernel for device {packed.device}")
    _check("packed", packed, torch.uint8, 2, packed.device)
    if packed.shape[1] != (n_individuals + 3) // 4:
        raise ValueError(
            f"packed rows have {packed.shape[1]} bytes, {n_individuals} individuals need "
            f"{(n_individuals + 3) // 4}")
    if cols is not None:
        _check("cols", cols, torch.int32, 1, packed.device)


# ------------------------------------------------------------------- K4 ---
def _decode_out(out, n_rows, n_out, device):
    """K4's destination: `out` checked as a contiguous (n_rows, n_out) int8
    tensor on `device` (a row slice of a larger tensor is one), or a new one."""
    if out is None:
        return torch.empty((n_rows, n_out), dtype=torch.int8, device=device)
    _check("out", out, torch.int8, 2, device)
    if tuple(out.shape) != (n_rows, n_out):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(n_rows, n_out)}")
    return out


def plain_bed_decode(packed, n_individuals: int, cols=None, out=None):
    """The plain version of K4: the 256 x 4 lookup table as a gather
    (dissect_tpu/io/bed.py decode_bed_rows), then the column index; into
    `out` when it is given (and returned)."""
    _note_plain(plain_bed_decode, packed)
    d = _lut_decode(packed, n_individuals, cols)
    if out is None:
        return d
    return _decode_out(out, d.shape[0], d.shape[1], packed.device).copy_(d)


plain_bed_decode.card_calls = 0


def _lut_decode(packed, n_individuals, cols):
    rows, n_bytes = packed.shape
    d = _byte_lut(packed.device)[packed.long()].reshape(rows, 4 * n_bytes)[:, :n_individuals]
    return d if cols is None else d[:, cols.long()]


def bed_decode(packed, n_individuals: int, cols=None, out=None):
    """K4: (R, ceil(N/4)) uint8 .bed rows -> (R, N') int8 dosages of allele
    2, -1 = missing, where N' = N, or N' = len(cols) and column c is source
    individual cols[c] (int32, any order).  `out`, when given, is the
    contiguous (R, N') int8 tensor the dosages are written into (and which
    is returned), e.g. a row slice of a larger one.

    On the card this launches csrc/bed_decode.cu (or raises); only tensors
    on the CPU take the plain version."""
    if packed.device.type == "cpu":
        return plain_bed_decode(packed, n_individuals, cols, out)
    _check_bed(packed, n_individuals, cols, "bed_decode")
    n_rows = packed.shape[0]
    n_out = n_individuals if cols is None else cols.shape[0]
    out = _decode_out(out, n_rows, n_out, packed.device)
    if n_rows == 0 or n_out == 0:
        return out
    kernel = cuda_lib.entry("bed_decode", "bed_decode", 3, 3)
    with torch.cuda.device(packed.device):
        rc = kernel(packed.data_ptr(), 0 if cols is None else cols.data_ptr(), out.data_ptr(),
                    n_rows, packed.shape[1], n_out, cuda_lib.stream_handle(packed.device))
    if rc != 0:
        raise RuntimeError(f"bed_decode: CUDA error {rc}")
    bed_decode.launches += 1
    bed_decode.launches_by_rows[n_rows] += 1
    return out


bed_decode.launches = 0
bed_decode.launches_by_rows = Counter()


# ------------------------------------------------------------------- K5 ---
def plain_bed_counts(packed, n_individuals: int, cols=None):
    """The plain version of K5: the plain decode, then per-row counts of
    each dosage."""
    _note_plain(plain_bed_counts, packed)
    d = _lut_decode(packed, n_individuals, cols)
    return torch.stack([(d == v).sum(dim=1) for v in (-1, 0, 1, 2)], dim=1).to(torch.int64)


plain_bed_counts.card_calls = 0


def bed_counts(packed, n_individuals: int, cols=None):
    """K5: (R, ceil(N/4)) uint8 .bed rows -> (R, 4) int64 counts of
    [missing, 0, 1, 2] over the individuals `cols` names (all N without
    it); the padding codes of each row's last byte are not counted.

    On the card this launches csrc/bed_decode.cu (or raises); only tensors
    on the CPU take the plain version."""
    if packed.device.type == "cpu":
        return plain_bed_counts(packed, n_individuals, cols)
    _check_bed(packed, n_individuals, cols, "bed_counts")
    n_rows = packed.shape[0]
    out = torch.empty((n_rows, 4), dtype=torch.int64, device=packed.device)
    if n_rows == 0:
        return out
    n_out = n_individuals if cols is None else cols.shape[0]
    kernel = cuda_lib.entry("bed_decode", "bed_counts", 3, 4)
    with torch.cuda.device(packed.device):
        rc = kernel(packed.data_ptr(), 0 if cols is None else cols.data_ptr(), out.data_ptr(),
                    n_rows, packed.shape[1], n_individuals, n_out,
                    cuda_lib.stream_handle(packed.device))
    if rc != 0:
        raise RuntimeError(f"bed_counts: CUDA error {rc}")
    bed_counts.launches += 1
    bed_counts.launches_by_rows[n_rows] += 1
    return out


bed_counts.launches = 0
bed_counts.launches_by_rows = Counter()


# ---------------------------------------------------------------- K6, K7 ---
def _byte_reader(buf):
    """at(pos, valid): buf[pos] as int64 where `valid`, else 0."""
    last = buf.numel() - 1

    def at(pos, valid):
        if last < 0:
            return torch.zeros(pos.shape, dtype=torch.int64, device=buf.device)
        idx = torch.where(valid, pos, 0).clamp(0, last)
        return torch.where(valid, buf[idx].to(torch.int64), 0)

    return at


def plain_bgen_decode_l2(buf, offsets, lengths, n_samples: int, out=None):
    """The plain version of K6: the native layout-2 probability decode
    (dissect_tpu/native/bgen_decode.cpp:86-151, the float64 steps of
    dissect_tpu/io/bgen.py _parse_layout2_dosage) as torch ops over all
    blocks at once.  Returns ((V, N) float32 dosages, NaN = missing and
    every entry of an unsupported row, into `out` when it is given; (V,)
    int32 status)."""
    _note_plain(plain_bgen_decode_l2, buf)
    dev, n = buf.device, n_samples
    off, ln = offsets.to(torch.int64), lengths.to(torch.int64)
    at = _byte_reader(buf)
    k = torch.arange(10, device=dev)
    head = at(off[:, None] + k, ln[:, None] > k)
    count = head[:, 0] | head[:, 1] << 8 | head[:, 2] << 16 | head[:, 3] << 24
    ok = (ln >= 10) & (ln >= 10 + n) & (count == n) & ((head[:, 4] | head[:, 5] << 8) == 2)
    tail = at(off[:, None] + 8 + n + torch.arange(2, device=dev), ok[:, None].expand(-1, 2))
    phased, bits = tail[:, 0], tail[:, 1]
    ok &= (bits >= 1) & (bits <= 32)
    s = torch.arange(n, device=dev)
    ploidy = at(off[:, None] + 8 + s, ok[:, None].expand(-1, n))
    ok &= ((ploidy & 0x3F) == 2).all(dim=1)
    bits = torch.where(ok, bits, 1)[:, None]  # any width for the rows that fail
    mask = torch.bitwise_left_shift(torch.ones_like(bits), bits) - 1
    base, plen = (off + 10 + n)[:, None], (ln - 10 - n)[:, None]

    def value(slot):
        """Value `slot` of each sample: the native read_bits, / (2^bits - 1)."""
        bit_off = slot[None, :] * bits
        byte_off, shift = bit_off >> 3, bit_off & 7
        need = (shift + bits + 7) >> 3
        v = torch.zeros_like(bit_off)
        for i in range(5):  # 32 bits at a shift of 7 span 5 bytes
            valid = ok[:, None] & (i < need) & (byte_off + i < plen)
            v |= at(base + byte_off + i, valid) << (8 * i)
        return ((v >> shift) & mask).to(torch.float64) / mask.to(torch.float64)

    v0, v1 = value(2 * s), value(2 * s + 1)
    p22 = (1.0 - v0 - v1).clamp(0.0, 1.0)
    d = torch.where(phased[:, None] != 0, (1.0 - v0) + (1.0 - v1), v1 + 2.0 * p22)
    d = torch.where(((ploidy & 0x80) != 0) | ~ok[:, None], float("nan"), d.to(torch.float32))
    return _into(out, d, buf.device), (~ok).to(torch.int32)


plain_bgen_decode_l2.card_calls = 0


def plain_bgen_decode_l1(buf, offsets, lengths, n_samples: int, out=None):
    """The plain version of K7: three little-endian uint16 per sample,
    ((p1 + 2 p2) / 32768) / psum in float64 with psum = (p0 + p1 + p2) /
    32768 (dissect_tpu/native/bgen_decode.cpp:154-183), NaN for an
    all-zero triple and every entry of a block that is not 6 N bytes;
    into `out` when it is given."""
    _note_plain(plain_bgen_decode_l1, buf)
    dev, n = buf.device, n_samples
    off, ln = offsets.to(torch.int64), lengths.to(torch.int64)
    ok = ln == 6 * n
    raw = _byte_reader(buf)(off[:, None] + torch.arange(6 * n, device=dev),
                            ok[:, None].expand(-1, 6 * n))
    p = (raw[:, 0::2] | raw[:, 1::2] << 8).reshape(-1, n, 3)
    psum = (p[..., 0] + p[..., 1] + p[..., 2]).to(torch.float64) / 32768.0
    num = (p[..., 1].to(torch.float64) + 2.0 * p[..., 2].to(torch.float64)) / 32768.0
    d = torch.where((psum <= 0.0) | ~ok[:, None], float("nan"), (num / psum).to(torch.float32))
    return _into(out, d, buf.device), (~ok).to(torch.int32)


plain_bgen_decode_l1.card_calls = 0


def _dosage_out(out, n_variants, n_samples, device):
    """K6's and K7's destination: `out` checked as a contiguous (V, N)
    float32 tensor on `device` (a row slice of a larger tensor is one), or
    a new one."""
    if out is None:
        return torch.empty((n_variants, n_samples), dtype=torch.float32, device=device)
    _check("out", out, torch.float32, 2, device)
    if tuple(out.shape) != (n_variants, n_samples):
        raise ValueError(f"out has shape {tuple(out.shape)}, expected {(n_variants, n_samples)}")
    return out


def _into(out, d, device):
    return d if out is None else _dosage_out(out, d.shape[0], d.shape[1], device).copy_(d)


def _bgen_launch(wrapper, plain, buf, offsets, lengths, n_samples, out):
    function = wrapper.__name__
    if buf.device.type == "cpu":
        return plain(buf, offsets, lengths, n_samples, out)
    if buf.device.type != "cuda":
        raise ValueError(f"no {function} kernel for device {buf.device}")
    _check("buf", buf, torch.uint8, 1, buf.device)
    _check("offsets", offsets, torch.int64, 1, buf.device)
    _check("lengths", lengths, torch.int64, 1, buf.device)
    n_variants = offsets.shape[0]
    if lengths.shape[0] != n_variants:
        raise ValueError(f"{n_variants} offsets but {lengths.shape[0]} lengths")
    out = _dosage_out(out, n_variants, n_samples, buf.device)
    status = torch.empty((n_variants,), dtype=torch.int32, device=buf.device)
    if n_variants == 0:
        return out, status
    kernel = cuda_lib.entry("bgen_decode", function, 5, 2)
    with torch.cuda.device(buf.device):
        rc = kernel(buf.data_ptr(), offsets.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                    status.data_ptr(), n_variants, n_samples,
                    cuda_lib.stream_handle(buf.device))
    if rc != 0:
        raise RuntimeError(f"{function}: CUDA error {rc}")
    wrapper.launches += 1
    return out, status


def bgen_decode_l2(buf, offsets, lengths, n_samples: int, out=None):
    """K6: the decompressed layout-2 blocks buf[offsets[v] : offsets[v] +
    lengths[v]] (uint8 buffer, int64 offsets and lengths) -> ((V, N)
    float32 expected allele-2 dosages, NaN = missing; (V,) int32 status,
    1 for a block K6 does not take: its row is all NaN).  `out`, when
    given, is the contiguous (V, N) float32 tensor the dosages are written
    into (and which is returned), e.g. a row slice of a larger one.

    On the card this launches csrc/bgen_decode.cu (or raises); only
    tensors on the CPU take the plain version."""
    return _bgen_launch(bgen_decode_l2, plain_bgen_decode_l2, buf, offsets, lengths, n_samples,
                        out)


bgen_decode_l2.launches = 0


def bgen_decode_l1(buf, offsets, lengths, n_samples: int, out=None):
    """K7: as K6 for layout-1 (v1.1) blocks of 6 N bytes.

    On the card this launches csrc/bgen_decode.cu (or raises); only
    tensors on the CPU take the plain version."""
    return _bgen_launch(bgen_decode_l1, plain_bgen_decode_l1, buf, offsets, lengths, n_samples,
                        out)


bgen_decode_l1.launches = 0
