"""K6 `bgen_decode_l2` and K7 `bgen_decode_l1` (io/genotype_kernels.py,
csrc/bgen_decode.cu) as the kernels compute them, modelled in numpy on
the CPU and held against their plain versions and the JAX package's
native decoder (dissect_tpu/native/bgen_decode.cpp, built here with g++).

The kernels run only on the card (`chip_smoke.py` holds them against
their plain versions there).  What the CPU can hold is their design:
the quotient table, the staging of a block's bytes into shared-memory
slots at every alignment (zeros past the probability stream's end, never
a read outside the buffer's allocation), the walk of 16-byte output
groups and tiles, the split of a variant over several blocks with its
fix-up, K7's single division, and a model of each whole kernel built
from those pieces.  Also the wrappers' out=.

Tolerances: none.  Every comparison is exact (`array_equal`, NaN
positions included): the kernels are bit-exact by design.
"""

import struct

import numpy as np
import pytest
import torch

from dissect_tpu.io import bgen as jax_bgen
from dissect_tpu.native import bgen_native
from dissect_tpu_torch.io import bgen
from dissect_tpu_torch.io import genotype_kernels as gk

# csrc/bgen_decode.cu's constants
THREADS, GROUP, TILE_GROUPS, STAGES, SLACK = 256, 4, 2, 4, 16
TILE = THREADS * TILE_GROUPS * GROUP
TABLE_BITS, REPLICAS = 11, 8
TABLE_DOUBLES = 1 << TABLE_BITS
ALLOCATION = 512  # PyTorch's caching allocator rounds every block to this


def staged_bytes(range_bytes):
    return SLACK + ((range_bytes + 15 + 15) & ~15) + SLACK


PLOIDY_SLOT = staged_bytes(TILE)
PROBS_SLOT = staged_bytes(2 * TILE + 1)
L1_SLOT = staged_bytes(6 * TILE)
SMEM_LIMIT = 48 * 1024


@pytest.fixture(scope="module")
def native():
    if not bgen_native.available():
        pytest.fail("the JAX package's native BGEN decoder did not build")
    return bgen_native


# ------------------------------------------------------------ the model --
class Memory:
    """The card's memory under a buffer: its bytes from address `base` on
    (any alignment), in an allocation rounded up to 512 bytes, the rest
    0xEE; a staged word that left the allocation would fail here."""

    def __init__(self, raw, base=0):
        size = -(-(base + len(raw)) // ALLOCATION) * ALLOCATION
        self.bytes = np.full(size, 0xEE, dtype=np.uint8)
        self.bytes[base:base + len(raw)] = np.frombuffer(raw, dtype=np.uint8)
        self.base = base

    def stage(self, lo, hi, part):
        """stage(): every aligned 16-byte word holding a byte of [lo, hi)
        into part[SLACK:], the byte at lo landing at SLACK + (lo & 15)."""
        if hi <= lo:
            return
        first = lo & ~15
        words = (hi - first + 15) >> 4
        assert 0 <= first and first + 16 * words <= len(self.bytes), "a read outside the allocation"
        part[SLACK:SLACK + 16 * words] = self.bytes[first:first + 16 * words]


def local(lo):
    return SLACK + (lo & 15)


def word_at(part, at):
    """word_at(): 32 bits from byte `at` on, as the funnel shift of the
    two aligned words under it."""
    w = part.view("<u4")
    i = at >> 2
    return ((int(w[i + 1]) << 32 | int(w[i])) >> (8 * (at & 3))) & 0xFFFFFFFF


def bits_at(part, at, mask):
    """bits_at(): the value from bit `at` on, from the two aligned words
    under it."""
    w = part.view("<u4")
    i = at >> 5
    return ((int(w[i + 1]) << 32 | int(w[i])) >> (at & 31)) & mask


def table_of(bits):
    """K6's quotient table: REPLICAS copies (fewer past 8 bits) of each
    e / (2^bits - 1), entry e's copy r at e * reps + r."""
    reps = min(REPLICAS, TABLE_DOUBLES >> bits)
    quotients = np.arange(1 << bits, dtype=np.float64) / float((1 << bits) - 1)
    return np.repeat(quotients, reps), reps


def dosage(v0, v1, phased, missing):
    if phased:
        d = (1.0 - v0) + (1.0 - v1)
    else:
        p22 = 1.0 - v0 - v1
        if p22 < 0.0:
            p22 = 0.0
        if p22 > 1.0:
            p22 = 1.0
        d = v1 + 2.0 * p22
    return np.float32(np.nan) if missing else np.float32(d)


def l1_dosage(p0, p1, p2):
    """K7: one float32 division of the exact integers."""
    total = p0 + p1 + p2
    return np.float32(np.nan) if total == 0 else np.float32(p1 + 2 * p2) / np.float32(total)


class Row:
    """The row's 16-byte output groups and tiles: the row starts `a`
    floats past a 16-byte boundary, group g holds samples 4 g - a ..
    4 g - a + 3, tile t the groups [t span, (t + 1) span)."""

    def __init__(self, row_float, n, shift):
        self.n, self.a, self.span = n, row_float & 3, (THREADS * TILE_GROUPS) >> shift
        self.groups = (n + self.a + GROUP - 1) // GROUP if n else 0
        self.tiles = -(-self.groups // self.span)

    def lo(self, t):
        return max(0, GROUP * t * self.span - self.a)

    def hi(self, t):
        return min(self.n, GROUP * (t + 1) * self.span - self.a)


def splits_for(n_variants, n, capacity):
    """The launcher: few variants split into contiguous tile ranges, at
    most `capacity` blocks (one wave)."""
    span = THREADS * TILE_GROUPS
    tiles = ((n + 2 * GROUP - 2) // GROUP + span - 1) // span
    splits = capacity // n_variants if n_variants < capacity else 1
    return max(1, min(splits, tiles))


def bad_ploidy(memory, lo, hi, part):
    """The ploidy test of the staged words: (byte & 0x3F) ^ 2 over the
    bytes of [lo, hi) of each word, by word masks."""
    first = lo & ~15
    words = (hi - first + 15) >> 4
    bad = 0
    for k in range(words):
        at = first + 16 * k
        b0, b1 = max(lo - at, 0), min(hi - at, 16)
        x = part[SLACK + 16 * k:SLACK + 16 * k + 16].copy().view("<u4")
        for j in range(4):
            l, h = min(max(b0 - 4 * j, 0), 4), min(max(b1 - 4 * j, 0), 4)
            mask = ((1 << (8 * h)) - (1 << (8 * l))) & 0xFFFFFFFF
            bad |= ((int(x[j]) & 0x3F3F3F3F) ^ 0x02020202) & mask
    return bad != 0


def model_kernel(layout, memory, offsets, lengths, n, out_shift=0, capacity=660):
    """The whole of bgen_kernel<layout> and its launcher: ((V, N) float32
    dosages as written into a float buffer `out_shift` floats past a
    16-byte boundary, the floats around them 77; (V,) status)."""
    v_count = len(offsets)
    out = np.full(out_shift + v_count * n + 4, 77.0, dtype=np.float32)
    status = np.full(v_count, -1, dtype=np.int32)
    splits = splits_for(v_count, n, capacity)
    fixup = layout == 2 and splits > 1
    if fixup:
        status[:] = 0
    stale = np.random.default_rng(5)  # a slot holds earlier tiles' bytes
    for v in range(v_count):
        u, length = memory.base + int(offsets[v]), int(lengths[v])
        byte = memory.bytes
        phased, bits = 0, 8
        if layout == 2:
            ok = length >= 10 and length >= 10 + n
            if ok:
                ok = (int(byte[u:u + 4].view("<u4")[0]) == n
                      and (int(byte[u + 4]) | int(byte[u + 5]) << 8) == 2)
            if ok:
                phased, bits = int(byte[u + 8 + n]), int(byte[u + 9 + n])
                ok = 1 <= bits <= 32
            if not ok:
                bits = 8
        else:
            ok = length == 6 * n
        row_float = out_shift + v * n
        r = Row(row_float, n, 0 if bits <= 8 else 1 if bits <= 16 else 2)
        probs, plen = u + 10 + n, length - 10 - n
        mask = (1 << bits) - 1
        in_table = bits <= TABLE_BITS
        table, reps = table_of(bits) if in_table else (None, 1)
        for x in range(splits):
            t_begin, t_end = r.tiles * x // splits, r.tiles * (x + 1) // splits
            failed = not ok
            if ok:
                for t in range(t_begin, t_end):
                    s0, s1 = r.lo(t), r.hi(t)
                    slot = stale.integers(0, 256, size=L1_SLOT if layout == 1 else
                                          PLOIDY_SLOT + PROBS_SLOT, dtype=np.uint8)
                    if layout == 2:
                        ps, qs = slot[:PLOIDY_SLOT], slot[PLOIDY_SLOT:]
                        memory.stage(u + 8 + s0, u + 8 + s1, ps)
                        pb0, pb1 = (2 * s0 * bits) >> 3, (2 * s1 * bits + 7) >> 3
                        assert pb1 - pb0 <= 2 * TILE + 1
                        memory.stage(probs + pb0, probs + min(pb1, plen), qs)
                        if bad_ploidy(memory, u + 8 + s0, u + 8 + s1, ps):
                            failed = True
                            break
                        lq = local(probs + pb0)
                        if pb1 > plen:
                            qs[lq + max(plen, pb0) - pb0:lq + pb1 - pb0] = 0
                        lp = local(u + 8 + s0)
                        lq_bits = 8 * lq + ((2 * s0 * bits) & 7)
                        for thread in range(r.span):
                            g = t * r.span + thread
                            if g >= r.groups:
                                continue
                            rep = thread & (reps - 1)

                            def q(e):
                                return table[e * reps + rep] if in_table else e / float(mask)

                            def one(s):
                                at = lq_bits + 2 * (s - s0) * bits
                                return dosage(q(bits_at(qs, at, mask)), q(bits_at(qs, at + bits, mask)),
                                              phased, ps[lp + s - s0] & 0x80)

                            c = GROUP * g - r.a
                            if c >= 0 and c + GROUP <= n:
                                assert (4 * (row_float + c)) % 16 == 0
                                if bits == 8:  # the 8-bit path: three funnel-shifted words
                                    pw = word_at(ps, lp + c - s0)
                                    at = (lq_bits >> 3) + 2 * (c - s0)
                                    e = [word_at(qs, at), word_at(qs, at + 4)]
                                    vals = []
                                    for j in range(GROUP):
                                        w = e[j >> 1] >> (16 * (j & 1))
                                        vals.append(dosage(q(w & 0xFF), q((w >> 8) & 0xFF), phased,
                                                           (pw >> (8 * j)) & 0x80))
                                else:
                                    vals = [one(c + j) for j in range(GROUP)]
                                out[row_float + c:row_float + c + GROUP] = vals
                            else:
                                for s in range(max(c, 0), min(c + GROUP, n)):
                                    out[row_float + s] = one(s)
                    else:
                        memory.stage(u + 6 * s0, u + 6 * s1, slot)
                        lb = local(u + 6 * s0)
                        for thread in range(r.span):
                            g = t * r.span + thread
                            if g >= r.groups:
                                continue
                            c = GROUP * g - r.a
                            if c >= 0 and c + GROUP <= n:
                                at = lb + 6 * (c - s0)
                                xs = [word_at(slot, at + 4 * k) for k in range(6)]
                                h = [x & 0xFFFF for x in xs], [x >> 16 for x in xs]
                                halves = [h[i & 1][i >> 1] for i in range(12)]
                                out[row_float + c:row_float + c + GROUP] = [
                                    l1_dosage(*halves[3 * j:3 * j + 3]) for j in range(GROUP)]
                            else:
                                for s in range(max(c, 0), min(c + GROUP, n)):
                                    b = slot[lb + 6 * (s - s0):lb + 6 * (s - s0) + 6].astype(np.int64)
                                    out[row_float + s] = l1_dosage(b[0] | b[1] << 8, b[2] | b[3] << 8,
                                                                   b[4] | b[5] << 8)
            if failed:
                if t_begin < t_end:
                    out[row_float + r.lo(t_begin):row_float + r.hi(t_end - 1)] = np.nan
                status[v] = 1
            elif layout == 1 or splits == 1:
                status[v] = 0
    if fixup:
        for v in np.flatnonzero(status):
            out[out_shift + v * n:out_shift + (v + 1) * n] = np.nan
    assert (out[:out_shift] == 77).all() and (out[out_shift + v_count * n:] == 77).all()
    return out[out_shift:out_shift + v_count * n].reshape(v_count, n), status


# ------------------------------------------------------------ the inputs --
def layout2_block(rng, n, bits, phased, ploidy=None, cut=0):
    """An uncompressed layout-2 block of random `bits`-bit values, a few
    samples missing; `cut` bytes short of its full probability stream."""
    if ploidy is None:
        ploidy = np.full(n, 2, dtype=np.uint8)
        ploidy[rng.choice(n, size=max(1, n // 20), replace=False)] = 0x82
    vals = rng.integers(0, 2 ** bits, size=2 * n, dtype=np.uint64)
    planes = (vals[:, None] >> np.arange(bits, dtype=np.uint64)) & np.uint64(1)
    probs = np.packbits(planes.astype(np.uint8).ravel(), bitorder="little").tobytes()
    block = struct.pack("<IHBB", n, 2, 2, 2) + bytes(ploidy) + bytes([phased, bits]) + probs
    return block[:len(block) - cut]


def in_buffer(blocks, align=False):
    """The blocks end to end, or with `align` block i at an offset = i
    mod 16 after 0xA5 filler: (raw, offsets, lengths)."""
    parts, offsets, at = [], [], 0
    for i, block in enumerate(blocks):
        pad = (i - at) % 16 if align else 0
        parts += [b"\xa5" * pad, block]
        offsets.append(at + pad)
        at += pad + len(block)
    return (b"".join(parts), np.array(offsets, dtype=np.int64),
            np.array([len(b) for b in blocks], dtype=np.int64))


def plain(decoder, raw, offsets, lengths, n):
    out, status = decoder(torch.frombuffer(bytearray(raw), dtype=torch.uint8),
                          torch.as_tensor(offsets), torch.as_tensor(lengths), n)
    return out.numpy(), status.numpy()


def assert_same(a, b):
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_array_equal(np.nan_to_num(a, nan=0.0), np.nan_to_num(b, nan=0.0))


# ----------------------------------------------------------------- tests --
def test_slots_fit_five_blocks_an_sm():
    """K6's ring and table fit in 48 KB (no opt-in), K7's ring in what a
    block may opt in to, and five K6 blocks (the launch bounds' count) in
    an SM's 228 KB, 1 KB reserved a block; a slot holds a tile's ploidy
    bytes and its probability bytes at any offset, and the widest read of
    each (two words after a value's first byte)."""
    k6 = STAGES * (PLOIDY_SLOT + PROBS_SLOT) + 8 * TABLE_DOUBLES
    assert k6 <= SMEM_LIMIT and 5 * (k6 + 1024) <= 228 * 1024
    assert STAGES * L1_SLOT <= 227 * 1024
    assert SLACK + 15 + TILE - GROUP + 8 <= PLOIDY_SLOT
    assert SLACK + 15 + 2 * TILE + 1 + 8 <= PROBS_SLOT
    assert SLACK + 15 + 6 * TILE - 24 + 28 <= L1_SLOT


def _most_lanes_on_a_bank_pair(entries, copies, reps):
    """The most lanes of a half-warp whose 8-byte reads of table entries
    (copy copies[l] of entry entries[l]) fall in one bank pair at
    different addresses: the passes the access takes."""
    addresses = entries * reps + copies
    by_pair = {}
    for address in set(addresses.tolist()):
        by_pair[address % 16] = by_pair.get(address % 16, 0) + 1
    return max(by_pair.values())


@pytest.mark.parametrize("bits", range(1, TABLE_BITS + 1))
def test_table_holds_the_native_quotients(bits):
    """Every copy of every entry e of the table is e / (2^bits - 1), the
    native's float64 division, and it fits TABLE_DOUBLES.  The 16 lanes
    of a half-warp read copy lane mod reps: with 8 copies (8 bits and
    narrower) at most two of them share a bank pair, whatever the values;
    filling it, lane l writes copy (l + k) mod reps of entry l in step k,
    again at most 16 / reps to a bank pair."""
    table, reps = table_of(bits)
    assert len(table) <= TABLE_DOUBLES and reps == min(REPLICAS, TABLE_DOUBLES >> bits)
    e = np.arange(1 << bits)
    native = np.array([float(x) / float((1 << bits) - 1) for x in e.tolist()])
    for r in range(reps):
        np.testing.assert_array_equal(table[e * reps + r], native)
    lanes = np.arange(16)
    rng = np.random.default_rng(bits)
    for _ in range(50):
        picks = rng.integers(0, 1 << bits, size=16)
        assert _most_lanes_on_a_bank_pair(picks, lanes % reps, reps) <= 16 // reps
    for k in range(reps):
        writers = lanes[lanes < (1 << bits)]
        assert _most_lanes_on_a_bank_pair(writers, (writers + k) % reps, reps) <= max(1, 16 // reps)


@pytest.mark.parametrize("bits", [1, 3, 8, 12, 16, 31, 32])
def test_staged_tile_holds_the_block_with_zeros_past_plen(rng, bits):
    """A tile's probability bytes staged from a block at every start
    alignment mod 16, followed by the next block's bytes, its stream whole
    or cut (mid-tile, at the tile's start, before it): after the zero
    pass the slot holds exactly the stream's bytes up to plen and zeros
    from there to the tile's last byte, and no staged word leaves the
    buffer's allocation, whatever the buffer's own alignment."""
    shift = 0 if bits <= 8 else 1 if bits <= 16 else 2
    s0, s1 = 128, 128 + (TILE >> shift) - 5  # a tile of its width class, short of full
    n = s1 + 9
    full = (2 * n * bits + 7) // 8
    pb0, pb1 = (2 * s0 * bits) >> 3, (2 * s1 * bits + 7) >> 3
    for plen in (full, pb0 + (pb1 - pb0) // 2, pb0, pb0 - 3):
        stream = rng.integers(1, 256, size=plen, dtype=np.uint8).tobytes()
        for a in range(16):
            for base in (0, 5):
                raw = b"\x11" * a + stream + b"\xff" * 40
                memory = Memory(raw, base)
                probs = base + a
                part = np.full(PROBS_SLOT, 0xCD, dtype=np.uint8)
                memory.stage(probs + pb0, probs + min(pb1, plen), part)
                lq = local(probs + pb0)
                if pb1 > plen:
                    part[lq + max(plen, pb0) - pb0:lq + pb1 - pb0] = 0
                want = np.zeros(pb1 - pb0, dtype=np.uint8)
                kept = max(0, min(pb1, plen) - pb0)
                want[:kept] = np.frombuffer(stream, dtype=np.uint8)[pb0:pb0 + kept]
                np.testing.assert_array_equal(part[lq:lq + pb1 - pb0], want)


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024, 1025, 2047, 2048, 2049, 4095, 4096, 4097,
                               5003])
def test_tile_walk_covers_every_sample_once(n):
    """At every row alignment (a = 0..3 floats past a 16-byte boundary),
    every width class (1,024, 512 and 256 samples a tile) and several
    splits of a variant over blocks: each sample is written once, by a
    full group (16-byte aligned store) or a partial one at the row's ends,
    inside its tile's staged range, and a tile never holds more than a
    slot's ploidy and probability bytes."""
    for a in range(4):
        for shift, bits in ((0, 8), (1, 16), (2, 32)):
            r = Row(a, n, shift)
            for splits in (1, 2, 3, 7):
                hits = np.zeros(n, dtype=np.int64)
                for x in range(splits):
                    for t in range(r.tiles * x // splits, r.tiles * (x + 1) // splits):
                        s0, s1 = r.lo(t), r.hi(t)
                        assert s1 - s0 <= TILE >> shift
                        assert ((2 * s1 * bits + 7) >> 3) - ((2 * s0 * bits) >> 3) <= 2 * TILE + 1
                        for thread in range(r.span):
                            g = t * r.span + thread
                            if g >= r.groups:
                                continue
                            c = GROUP * g - a
                            if c >= 0 and c + GROUP <= n:
                                assert (4 * (a + c)) % 16 == 0
                            samples = np.arange(max(c, 0), min(c + GROUP, n))
                            assert ((samples >= s0) & (samples < s1)).all()
                            hits[samples] += 1
                assert (hits == 1).all()


def test_splits_fill_at_most_one_wave():
    """Few variants split into at most capacity / V blocks each, never
    more than a variant's tiles; a full batch runs one block a variant."""
    assert splits_for(1024, 10_000, 660) == 1
    assert splits_for(424, 10_000, 660) == 1
    assert splits_for(64, 487_409, 660) == 10
    assert splits_for(4, 5003, 660) == 3
    assert splits_for(3, 1001, 660) == 1
    assert splits_for(25, 4100, 100) == 3
    assert splits_for(1, 0, 660) == 1


def _edge_triples():
    top = 32768
    return np.array([(0, 0, 0), (top, 0, 0), (0, top, 0), (0, 0, top), (1, 1, 1), (top, top, top),
                     (65535, 65535, 65535), (0, 0, 65535), (65535, 0, 0), (0, 65535, 0), (1, 0, 0),
                     (0, 1, 0), (0, 0, 1), (1, 2, 3), (top - 1, 1, 0)], dtype=np.int64)


def test_k7_single_division_equals_the_native_expression(rng):
    """((p1 + 2 p2) / 32768) / ((p0 + p1 + p2) / 32768) in float64, then
    float32 (the native) equals one float32 division of the exact
    integers p1 + 2 p2 and p0 + p1 + p2, bit for bit; an all-zero triple
    is NaN in both."""
    p = np.concatenate([_edge_triples(), rng.integers(0, 65536, size=(1_000_000, 3)),
                        rng.integers(0, 8, size=(100_000, 3)),
                        rng.integers(32760, 32769, size=(100_000, 3))])
    with np.errstate(invalid="ignore", divide="ignore"):
        psum = (p[:, 0] + p[:, 1] + p[:, 2]) / 32768.0
        native = (((p[:, 1] + 2.0 * p[:, 2]) / 32768.0) / psum).astype(np.float32)
        native[psum <= 0.0] = np.nan
        total = p[:, 0] + p[:, 1] + p[:, 2]
        ours = (p[:, 1] + 2 * p[:, 2]).astype(np.float32) / total.astype(np.float32)
        ours[total == 0] = np.nan
    assert (total < 2 ** 24).all()
    assert_same(ours, native)
    row = np.array([l1_dosage(*t) for t in _edge_triples().tolist()], dtype=np.float32)
    assert_same(row, native[:len(_edge_triples())])


def _layout2_set(rng, n):
    """Every width class and path: 1-32 bits, phased, all missing, streams
    cut short (8 bits at half, 12 bits mid-value), a haploid sample in
    the last tile, and refused headers."""
    blocks = [layout2_block(rng, n, bits, phased)
              for bits in (1, 3, 8, 11, 12, 16, 24, 31, 32) for phased in (0, 1)]
    blocks.append(layout2_block(rng, n, 8, 0, ploidy=[0x82] * n))
    blocks.append(layout2_block(rng, n, 8, 0, cut=n))
    blocks.append(layout2_block(rng, n, 12, 1, cut=7))
    haploid = [2] * n
    haploid[-1] = 1
    blocks.append(layout2_block(rng, n, 8, 0, ploidy=haploid))
    good = layout2_block(rng, n, 8, 0)
    blocks += [struct.pack("<I", n + 1) + good[4:], good[:9 + n], good[:9]]
    return blocks, [0] * 21 + [1] * 4


@pytest.mark.parametrize("align", [False, True], ids=["end_to_end", "every_offset"])
@pytest.mark.parametrize("n, out_shift, capacity", [
    (37, 0, 660), (1001, 1, 8), (1002, 2, 8), (2050, 3, 100), (4100, 0, 100), (4100, 1, 8)])
def test_model_k6_matches_plain_and_native(native, rng, n, out_shift, capacity, align):
    """The model of K6 (staging, tests, zero pass, table, both decode
    paths, partial groups, the split with its fix-up when the capacity is
    small) on every path's blocks, at N % 4 in {0, 1, 2, 3} and out=
    rows at every alignment, equals the plain K6 and the native decoder
    bit for bit."""
    blocks, statuses = _layout2_set(rng, n)
    raw, offsets, lengths = in_buffer(blocks, align)
    ours, status = model_kernel(2, Memory(raw, base=3 * out_shift), offsets, lengths, n,
                                out_shift, capacity)
    want, want_status = plain(gk.bgen_decode_l2, raw, offsets, lengths, n)
    theirs, their_status = native.decode_blocks(raw, offsets, lengths, n, 0, 2)
    np.testing.assert_array_equal(status, statuses)
    np.testing.assert_array_equal(want_status, statuses)
    np.testing.assert_array_equal(their_status, statuses)
    assert_same(ours, want)
    ok = status == 0
    assert_same(ours[ok], theirs[ok])
    assert np.isnan(ours[~ok]).all()


@pytest.mark.parametrize("n, out_shift, capacity", [(23, 0, 660), (1001, 1, 8), (2050, 3, 100),
                                                    (4100, 2, 8)])
def test_model_k7_matches_plain_and_native(native, rng, n, out_shift, capacity):
    """The model of K7 (staged triples at every offset mod 16, six funnel-
    shifted words a group, one float32 division) equals the plain K7 and
    the native decoder bit for bit, missing triples and refused lengths
    included."""
    triples = rng.integers(0, 32769, size=(17, n, 3)).astype("<u2")
    triples[:, 1] = 0
    triples[3, :] = [[0, 32768, 0]]
    blocks = [t.tobytes() for t in triples] + [b"\x00" * (6 * n - 1), b"\x01" * (6 * n + 6)]
    raw, offsets, lengths = in_buffer(blocks, align=True)
    ours, status = model_kernel(1, Memory(raw, base=7), offsets, lengths, n, out_shift, capacity)
    want, want_status = plain(gk.bgen_decode_l1, raw, offsets, lengths, n)
    theirs, their_status = native.decode_blocks(raw, offsets, lengths, n, 0, 1)
    np.testing.assert_array_equal(status, [0] * 17 + [1, 1])
    np.testing.assert_array_equal(want_status, status)
    np.testing.assert_array_equal(their_status, status)
    assert_same(ours, want)
    assert_same(ours[:17], theirs[:17])
    assert np.isnan(ours[17:]).all()


# ------------------------------------------------------------------ out= --
def _decoder_cases():
    return {"l2": (gk.bgen_decode_l2, lambda rng, n: [layout2_block(rng, n, 8, 0),
                                                      layout2_block(rng, n, 16, 1)]),
            "l2_plain": (gk.plain_bgen_decode_l2, lambda rng, n: [layout2_block(rng, n, 3, 0)]),
            "l1": (gk.bgen_decode_l1, lambda rng, n: [
                rng.integers(0, 32769, size=(n, 3)).astype("<u2").tobytes()] * 2),
            "l1_plain": (gk.plain_bgen_decode_l1, lambda rng, n: [
                rng.integers(0, 32769, size=(n, 3)).astype("<u2").tobytes()])}


@pytest.mark.parametrize("case", list(_decoder_cases()))
def test_bgen_decode_out_is_written_in_place(native, rng, case):
    """out= is a row slice of a larger tensor: the dosages land in it, the
    same tensor comes back, and the rows around it are not touched."""
    decoder, make = _decoder_cases()[case]
    n = 31
    blocks = make(rng, n)
    raw, offsets, lengths = in_buffer(blocks)
    store = torch.full((len(blocks) + 2, n), 77.0)
    dst = store[1:len(blocks) + 1]
    got, status = decoder(torch.frombuffer(bytearray(raw), dtype=torch.uint8),
                          torch.as_tensor(offsets), torch.as_tensor(lengths), n, out=dst)
    assert got is dst and (status.numpy() == 0).all()
    layout = 2 if case.startswith("l2") else 1
    want, _ = native.decode_blocks(raw, offsets, lengths, n, 0, layout)
    assert_same(store[1:len(blocks) + 1].numpy(), want)
    assert (store[0] == 77).all() and (store[-1] == 77).all()


def _bad_outs():
    wide = torch.zeros((2, 12))
    return {
        "rows": torch.zeros((1, 10)),
        "columns": torch.zeros((2, 9)),
        "float64": torch.zeros((2, 10), dtype=torch.float64),
        "flat": torch.zeros((20,)),
        "column_slice": wide[:, :10],
        "transposed": torch.zeros((10, 2)).T,
        "meta": torch.empty((2, 10), device="meta"),
    }


@pytest.mark.parametrize("bad", list(_bad_outs()))
@pytest.mark.parametrize("case", list(_decoder_cases()))
def test_bgen_decode_out_is_checked(rng, case, bad):
    """out= must be a contiguous (V, N) float32 tensor on the buffer's
    device."""
    decoder, _ = _decoder_cases()[case]
    blocks = [layout2_block(rng, 10, 8, 0)] * 2 if case.startswith("l2") else [b"\x00" * 60] * 2
    raw, offsets, lengths = in_buffer(blocks)
    with pytest.raises((ValueError, TypeError)):
        decoder(torch.frombuffer(bytearray(raw), dtype=torch.uint8), torch.as_tensor(offsets),
                torch.as_tensor(lengths), 10, out=_bad_outs()[bad])


def test_read_bgen_decodes_each_batch_in_place(tmp_path, rng, monkeypatch):
    """read_bgen hands K6 each batch's rows of its dosages (out=), and a
    block parsed on the host still overwrites its row; the result equals
    the JAX reader's."""
    monkeypatch.setattr(bgen, "_BATCH", 4)
    targets = []

    def spy(buf, offsets, lengths, n, out=None):
        targets.append(None if out is None else out.data_ptr())
        result = gk.bgen_decode_l2(buf, offsets, lengths, n, out=out)
        if len(targets) == 2:  # refuse the batch's second block: the host parses it
            result[1][1] = 1
            out[1] = float("nan")
        return result

    monkeypatch.setattr(bgen, "bgen_decode_l2", spy)
    n, m = 26, 11
    d = rng.random((m, n)) * 2.0
    d[rng.random((m, n)) < 0.1] = np.nan
    jd = jax_bgen.BgenData(
        snps=[jax_bgen.SnpInfo("1", f"rs{i}", 0.0, 100 + i, "A", "G") for i in range(m)],
        individuals=[jax_bgen.IndividualInfo(f"s{i}", f"s{i}") for i in range(n)],
        dosages=d.astype(np.float32))
    path = tmp_path / "c.bgen"
    jax_bgen.write_bgen(str(path), jd, bits=8)
    ours = bgen.read_bgen(str(path), device="cpu")
    theirs = jax_bgen.read_bgen(str(path), native=False)
    row_bytes = n * 4
    start = ours.dosages.data_ptr()
    assert targets == [start + r * row_bytes for r in (0, 4, 8)]
    assert_same(ours.dosages.numpy(), theirs.dosages)
