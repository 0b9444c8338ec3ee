"""The port's genotype decoders (io/genotype_kernels.py: K4 `bed_decode`,
K5 `bed_counts`, K6 `bgen_decode_l2`, K7 `bgen_decode_l1`, their plain
versions on the CPU) and the readers built on them (io/bed.py PlinkData,
io/bgen.py read_bgen) held against the JAX package on the CPU.

Tolerances: the decoders, the readers, `filter` and `stats` are exact
(`array_equal`, NaN positions included): the plain K4-K7 against the JAX
package's native OpenMP decoders (dissect_tpu/native, built here with
g++) and its numpy decoders and per-variant parsers, bit for bit.  The
GRM through the new store at tests/test_torch_grm.py's tolerance (kernel
rtol 1e-6, counts exactly); the CLI runs against the JAX CLI at rtol
2e-5 (tests/test_golden.py).
"""

import dataclasses
import os
import pathlib
import struct
import zlib

import numpy as np
import pytest
import torch

from dissect_tpu.analysis.dispatcher import main as jax_main
from dissect_tpu.io import bed as jax_bed
from dissect_tpu.io import bgen as jax_bgen
from dissect_tpu.model.kernels import grm_from_plink as jax_grm_from_plink
from dissect_tpu.native import bed_native, bgen_native
from dissect_tpu.runtime.mesh import set_mesh_context
from dissect_tpu_torch.analysis.dispatcher import main
from dissect_tpu_torch.io import bed, bgen
from dissect_tpu_torch.io import genotype_kernels as gk
from dissect_tpu_torch.io.grm_io import read_grm
from dissect_tpu_torch.model.kernels import grm_from_plink
from tests.conftest import make_dosage, make_plink
from tests.test_golden import _diff_files

GOLDEN = pathlib.Path(__file__).parent / "golden"
STATS_FIELDS = ("n_nonmissing", "p1", "p2", "std")


@pytest.fixture(scope="module")
def native():
    """The JAX package's native decoders, built with g++ at first use."""
    if not (bed_native.available() and bgen_native.available()):
        pytest.fail("the JAX package's native decoders did not build")
    return bed_native, bgen_native


def _numpy_lut_decode(rows, n):
    """JAX's numpy decode: the 256 x 4 lookup table (dissect_tpu/io/bed.py)."""
    return jax_bed._BYTE_LUT[rows].reshape(rows.shape[0], -1)[:, :n]


def _packed_rows(rng, m, n):
    """(m, ceil(n/4)) random .bed rows, every code in the padding too, and
    one all-missing row."""
    rows = rng.integers(0, 256, size=(m, (n + 3) // 4), dtype=np.uint8)
    rows[1] = 0b01010101
    return rows


# ------------------------------------------------------------------ K4, K5 --
@pytest.mark.parametrize("n", [1, 2, 3, 4, 37, 38, 39, 40])
def test_plain_k4_matches_jax_decoders(native, rng, n):
    """Plain K4 on every N % 4 against the native decoder and the numpy
    lookup table; padding codes past N are never decoded."""
    rows = _packed_rows(rng, 13, n)
    ours = gk.bed_decode(torch.as_tensor(rows), n)
    assert ours.dtype == torch.int8 and tuple(ours.shape) == (13, n)
    np.testing.assert_array_equal(ours.numpy(), native[0].decode(rows, n))
    np.testing.assert_array_equal(ours.numpy(), _numpy_lut_decode(rows, n))
    assert (ours.numpy()[1] == -1).all()


@pytest.mark.parametrize("n", [5, 38, 41])
def test_plain_k4_gathers_individuals(native, rng, n):
    """An individual index that drops and reorders columns: the decode of
    the whole row, then the columns."""
    rows = _packed_rows(rng, 9, n)
    cols = np.array([n - 1, 0, 3, 2, n // 2, 3], dtype=np.int32)
    ours = gk.bed_decode(torch.as_tensor(rows), n, torch.as_tensor(cols))
    np.testing.assert_array_equal(ours.numpy(), native[0].decode(rows, n)[:, cols])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 37, 38, 39, 40])
def test_plain_k5_matches_jax_counts_and_stats(native, rng, n):
    """Plain K5 against the native counts, and the SnpStats derived from
    them against JAX's compute_snp_stats on the decoded rows, bit for bit."""
    rows = _packed_rows(rng, 17, n)
    counts = gk.bed_counts(torch.as_tensor(rows), n)
    assert counts.dtype == torch.int64
    np.testing.assert_array_equal(counts.numpy(), native[0].genotype_counts(rows, n))
    ours = bed.snp_stats_from_counts(counts.numpy())
    ref = jax_bed.compute_snp_stats(_numpy_lut_decode(rows, n))
    for name in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(ref, name), err_msg=name)


def test_plain_k5_counts_kept_individuals_only(rng):
    n = 39
    rows = _packed_rows(rng, 11, n)
    cols = np.array([7, 38, 0, 12, 12], dtype=np.int32)
    counts = gk.bed_counts(torch.as_tensor(rows), n, torch.as_tensor(cols)).numpy()
    d = _numpy_lut_decode(rows, n)[:, cols]
    np.testing.assert_array_equal(counts, np.stack([(d == v).sum(1) for v in (-1, 0, 1, 2)], 1))


@pytest.mark.parametrize("wrapper", [gk.bed_decode, gk.bed_counts])
def test_bed_wrappers_never_fall_back(wrapper):
    """On a device that is neither the CPU nor a card the wrappers raise:
    only CPU tensors take the plain version, and nothing launched."""
    rows = torch.empty((3, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="no bed_"):
        wrapper(rows, 10)
    assert gk.bed_decode.launches == gk.bed_counts.launches == 0
    assert gk.plain_bed_decode.card_calls == gk.plain_bed_counts.card_calls == 0


# ------------------------------------------------------------ K4's out= --
@pytest.mark.parametrize("with_cols", [False, True], ids=["all", "index"])
@pytest.mark.parametrize("decoder", [gk.bed_decode, gk.plain_bed_decode])
def test_bed_decode_out_is_written_in_place(native, rng, decoder, with_cols):
    """out= is a row slice of a larger tensor: the dosages land in it, the
    same tensor comes back, and the rows around it are not touched."""
    n, m = 39, 7
    rows = _packed_rows(rng, m, n)
    cols = np.array([38, 0, 5, 21, 4, 17, 9, 30], dtype=np.int32) if with_cols else None
    n_out = n if cols is None else len(cols)
    buf = torch.full((m + 2, n_out), 77, dtype=torch.int8)
    out = buf[1 : m + 1]
    got = decoder(torch.as_tensor(rows), n, None if cols is None else torch.as_tensor(cols),
                  out=out)
    assert got is out
    want = native[0].decode(rows, n)
    np.testing.assert_array_equal(buf[1 : m + 1].numpy(), want if cols is None else want[:, cols])
    assert (buf[0] == 77).all() and (buf[m + 1] == 77).all()


@pytest.mark.parametrize("with_cols", [False, True], ids=["all", "index"])
def test_bed_decoders_take_no_rows(with_cols):
    """Zero rows decode to (0, N') and count to (0, 4)."""
    rows = torch.zeros((0, 3), dtype=torch.uint8)
    cols = torch.tensor([2, 0], dtype=torch.int32) if with_cols else None
    assert tuple(gk.bed_decode(rows, 10, cols).shape) == (0, 2 if with_cols else 10)
    counts = gk.bed_counts(rows, 10, cols)
    assert tuple(counts.shape) == (0, 4) and counts.dtype == torch.int64


def _bad_outs():
    wide = torch.zeros((5, 12), dtype=torch.int8)
    return {
        "rows": torch.zeros((4, 10), dtype=torch.int8),
        "columns": torch.zeros((5, 9), dtype=torch.int8),
        "uint8": torch.zeros((5, 10), dtype=torch.uint8),
        "int16": torch.zeros((5, 10), dtype=torch.int16),
        "flat": torch.zeros((50,), dtype=torch.int8),
        "column_slice": wide[:, :10],
        "transposed": torch.zeros((10, 5), dtype=torch.int8).T,
        "meta": torch.empty((5, 10), dtype=torch.int8, device="meta"),
    }


@pytest.mark.parametrize("bad", list(_bad_outs()))
@pytest.mark.parametrize("decoder", [gk.bed_decode, gk.plain_bed_decode])
def test_bed_decode_out_is_checked(rng, decoder, bad):
    """out= must be a contiguous (R, N') int8 tensor on the rows' device."""
    rows = torch.as_tensor(_packed_rows(rng, 5, 10))
    out = _bad_outs()[bad]
    with pytest.raises((ValueError, TypeError)):
        decoder(rows, 10, out=out)


def test_decode_rows_writes_each_block_in_place(tmp_path, rng, monkeypatch):
    """decode_rows hands K4 each block's rows of its destination (out=),
    through an individual index, and still equals the JAX decode."""
    monkeypatch.setattr(bed, "BLOCK_ROWS", 4)
    targets = []

    def spy(packed, n, cols=None, out=None):
        targets.append(None if out is None else out.data_ptr())
        return gk.bed_decode(packed, n, cols, out)

    monkeypatch.setattr(bed, "bed_decode", spy)
    d = make_dosage(rng, 11, 26, missing_rate=0.1)
    prefix, _ = make_plink(tmp_path, d, prefix="a")
    theirs = jax_bed.read_plink(prefix)
    keys = [theirs.individual_keys[i] for i in (25, 3, 0, 14, 9, 8)]
    ours = bed.read_plink(prefix, device="cpu").filter(keep_individuals=keys)
    got = ours.decode_rows(1, 11)
    np.testing.assert_array_equal(got.numpy(), theirs.filter(keep_individuals=keys).dosages()[1:11])
    row_bytes = got.shape[1] * got.element_size()
    assert targets == [got.data_ptr() + r * row_bytes for r in (0, 4, 8)]


# ------------------------------------- the integer identities of K4 and K5 --
# numpy models of csrc/bed_decode.cu's arithmetic, held against the plain
# versions: the nibble spread and __byte_perm selector map of K4, the bit
# plane popcounts of K5, and how each kernel cuts a row at the alignment of
# its address.
DOSAGE_BYTES = 0x0201FF00  # byte k: the dosage of code k (0, -1, 1, 2)
LO_BITS = 0x55555555


def _nibbles8(b):
    b = (b | (b << 4)) & 0x0F0F
    return (b | (b << 2)) & 0x3333


def _byte_perm(x, y, s):
    """CUDA's __byte_perm(x, y, s): byte k of the result is byte
    (s >> 4k) & 7 of the eight bytes of y:x."""
    s = np.asarray(s, dtype=np.uint64)
    assert ((s >> 3) & 0x1111 == 0).all()  # the selectors here are all below 8
    pool = np.uint64(x) | (np.uint64(y) << np.uint64(32))
    out = np.zeros_like(s)
    for k in range(4):
        sel = (s >> np.uint64(4 * k)) & np.uint64(7)
        out |= ((pool >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * k)
    return out


def _dosages4(nibbles):
    return _byte_perm(DOSAGE_BYTES, 0, nibbles)


def _decode_word(w):
    """decode_word: a packed uint32 word to four uint32 words of dosages."""
    w = np.asarray(w, dtype=np.uint64)
    halves = []
    for part in (w & np.uint64(0xFFFF), w >> np.uint64(16)):
        part = (part | (part << np.uint64(8))) & np.uint64(0x00FF00FF)
        part = (part | (part << np.uint64(4))) & np.uint64(0x0F0F0F0F)
        part = (part | (part << np.uint64(2))) & np.uint64(0x33333333)
        halves += [_dosages4(part & np.uint64(0xFFFF)), _dosages4(part >> np.uint64(16))]
    return np.stack(halves, axis=-1)


def _word_bytes(words):
    """uint32 words (any shape) -> their little-endian int8 bytes, flat."""
    return np.asarray(words, dtype="<u4").reshape(-1).view(np.int8)


def _plain_k4(rows, n, cols=None):
    return gk.plain_bed_decode(torch.as_tensor(rows), n,
                               None if cols is None else torch.as_tensor(cols)).numpy()


def _plain_k5(rows, n, cols=None):
    return gk.plain_bed_counts(torch.as_tensor(rows), n,
                               None if cols is None else torch.as_tensor(cols)).numpy()


def test_byte_perm_selector_map_decodes_every_byte():
    """Each of the 256 packed bytes: its codes spread one to a nibble and
    __byte_perm(0x0201FF00, 0, nibbles) give the plain decode's 4 dosages."""
    every = np.arange(256, dtype=np.uint8)[:, None]
    ours = _word_bytes(_dosages4(_nibbles8(every.astype(np.uint64)))).reshape(256, 4)
    np.testing.assert_array_equal(ours, _plain_k4(every, 4))


def test_word_decode_matches_plain_k4(rng):
    """decode_word on random and every-code words: 16 dosages a word."""
    words = np.concatenate([rng.integers(0, 2 ** 32, size=500, dtype=np.uint64),
                            np.array([0, 0x55555555, 0xAAAAAAAA, 0xFFFFFFFF], np.uint64)])
    rows = words.astype("<u4").view(np.uint8).reshape(-1, 4)
    ours = _word_bytes(_decode_word(words)).reshape(-1, 16)
    np.testing.assert_array_equal(ours, _plain_k4(rows, 16))


def _tally(w, m):
    """K5's bit planes: counts of codes 0b01, 0b10, 0b11 among the fields
    of the words w that m keeps."""
    w, m = np.asarray(w, dtype=np.uint64), np.asarray(m, dtype=np.uint64)
    lo, hi = w & m, (w >> np.uint64(1)) & m
    both = lo & hi
    popc = np.vectorize(lambda v: bin(int(v)).count("1"))
    return np.array([popc(lo ^ both).sum(), popc(hi ^ both).sum(), popc(both).sum()])


def _as_counts(c, n_counted):
    return np.array([c[0], n_counted - c.sum(), c[1], c[2]])


@pytest.mark.parametrize("rem", [0, 1, 2, 3])
def test_bitplane_counts_match_plain_k5(rng, rem):
    """K5 without an index: popc(lo & ~hi), popc(hi & ~lo), popc(lo & hi)
    of each word, the codes past N masked off in the last byte, equal the
    plain counts; all 256 byte values in one row, random words in others."""
    every = np.tile(np.arange(256, dtype=np.uint8), 2)  # a row of 512 bytes
    for row in [every, *rng.integers(0, 256, size=(6, 37), dtype=np.uint8)]:
        n = 4 * (len(row) - 1) + (rem or 4)
        full, last = n >> 2, row[n >> 2] if rem else None
        padded = np.zeros(-(-full // 4) * 4, dtype=np.uint8)
        padded[:full] = row[:full]
        c = _tally(padded.view("<u4"), LO_BITS)
        if rem:
            c += _tally(last, LO_BITS & ((1 << (2 * rem)) - 1))
        np.testing.assert_array_equal(_as_counts(c, n), _plain_k5(row[None, :], n)[0])


@pytest.mark.parametrize("n", [37, 38, 39, 40, 1001])
def test_masked_bitplane_counts_match_plain_counts_with_an_index(rng, n):
    """K5 with an index: the kept individuals as a mask (bit 2 (j mod 16) of
    word j / 16), each row counted through it from every start alignment
    (the mask word cut by the funnel shift), equal the plain counts."""
    rows = _packed_rows(rng, 5, n)
    cols = rng.permutation(n)[: n - n // 3].astype(np.int32)
    n_bytes = rows.shape[1]
    mask = np.zeros(n_bytes // 4 + 2, dtype=np.uint64)
    for j in cols:
        mask[j >> 4] |= np.uint64(1 << (2 * (j & 15)))
    mask_bytes = mask.astype("<u4").view(np.uint8)
    for r, row in enumerate(rows):
        for address in range(4):  # the row's start, mod 4
            head = min(n_bytes, (4 - address) & 3)
            words = (n_bytes - head) >> 2
            done = head + 4 * words
            c = sum(_tally(row[b], mask_bytes[b]) for b in [*range(head), *range(done, n_bytes)])
            body = row[head:done].copy().view("<u4")
            pairs = (mask[1 : words + 1] << np.uint64(32)) | mask[:words]
            cut = (pairs >> np.uint64(8 * head)) & np.uint64(0xFFFFFFFF)
            c = c + _tally(body, cut)
            np.testing.assert_array_equal(_as_counts(np.asarray(c), len(cols)),
                                          _plain_k5(rows, n, cols)[r])


@pytest.mark.parametrize("n_rows, n", [(1, 4), (3, 8), (5, 1004), (7, 1008), (2, 1012), (9, 2500)])
def test_flat_stream_cut_at_every_alignment(rng, n_rows, n):
    """K4 without an index at N % 4 == 0: the whole buffer as one stream,
    the bytes before the first 4-byte boundary of `packed` and after the
    last word one at a time, the words in runs of 128 (lane l of a warp
    words l, l + 32, l + 64, l + 96 of a run; a short last run word by
    word), each word to 16 dosages, covers every output byte once, as the
    plain decode, for each start of `packed` mod 4."""
    rows = _packed_rows(rng, n_rows, n) if n_rows > 1 else rng.integers(
        0, 256, size=(1, n // 4), dtype=np.uint8)
    flat = rows.reshape(-1)
    total = len(flat)
    want = _plain_k4(rows, n).reshape(-1)
    run_words, lanes = 128, 32
    for address in range(4):
        out = np.full(4 * total, 99, dtype=np.int8)
        writes = np.zeros(4 * total, dtype=np.int64)
        head = min(total, (4 - address) & 3)
        words = (total - head) >> 2
        done = head + 4 * words
        body = flat[head:done].copy().view("<u4")
        for run in range(0, words, run_words):
            ks = (run + np.arange(lanes)[:, None] + lanes * np.arange(run_words // lanes)).ravel()
            for k in ks[ks < words]:
                at = 4 * head + 16 * k
                out[at : at + 16] = _word_bytes(_decode_word(body[k]))
                writes[at : at + 16] += 1
        for t in range(head + total - done):
            b = t if t < head else done + t - head
            out[4 * b : 4 * b + 4] = _word_bytes(_dosages4(_nibbles8(np.uint64(flat[b]))))
            writes[4 * b : 4 * b + 4] += 1
        assert (writes == 1).all()
        np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 7, 37, 1001, 1002, 1003])
def test_row_words_cut_at_every_output_alignment(rng, n):
    """K4 without an index at N % 4 != 0: each output row from its first
    4-byte boundary (h head columns) on in words, word k read from the one
    or two packed bytes under columns h + 4k .. h + 4k + 3, and the head
    and tail columns one by one, as the plain decode."""
    rows = _packed_rows(rng, 3, n) if n > 4 else rng.integers(0, 256, size=(3, 1), dtype=np.uint8)
    want = _plain_k4(rows, n)
    code = np.array([0, -1, 1, 2], dtype=np.int8)
    for r, row in enumerate(rows):
        for address in range(4):  # the output row's start, mod 4
            out = np.full(n, 99, dtype=np.int8)
            h = min(n, (4 - address) & 3)
            words = (n - h) >> 2
            for k in range(words):
                c = h + 4 * k
                bits = int(row[c >> 2])
                if h:
                    bits = (bits | (int(row[(c >> 2) + 1]) << 8)) >> (2 * h)
                out[c : c + 4] = _word_bytes(_dosages4(_nibbles8(np.uint64(bits & 0xFF))))
            for c in [*range(h), *range(h + 4 * words, n)]:
                out[c] = code[(row[c >> 2] >> (2 * (c & 3))) & 3]
            np.testing.assert_array_equal(out, want[r])


@pytest.mark.parametrize("n_bytes", [1, 5, 15, 16, 17, 31, 32, 33, 251, 252, 253, 2500])
def test_staged_row_mirrors_the_row_at_every_alignment(rng, n_bytes):
    """K4 with an index copies a row into shared memory as every 16-byte
    word that holds one of its bytes, buf[i] = the byte at (row start
    rounded down to 16) + i, and gathers from buf + (start mod 16): every
    row byte lands where the gather reads it, inside the buffer the
    launcher sizes (round16(n_bytes + 15))."""
    row = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    buf_bytes = (n_bytes + 15 + 15) & ~15
    for a in range(16):
        memory = np.full(a + n_bytes + 32, 255, dtype=np.uint8)  # the row at offset a of a 16-byte word
        memory[a : a + n_bytes] = row
        words = (a + n_bytes + 15) >> 4
        assert 16 * words <= buf_bytes
        buf = memory[: 16 * words]
        np.testing.assert_array_equal(buf[a : a + n_bytes], row)


@pytest.mark.parametrize("n_out", [1, 9, 904, 908, 911, 1008, 4096, 4097, 9000, 9001])
def test_gather_groups_cover_every_column_once(n_out):
    """K4 with an index: ceil(n_out / 4,096) tiles share the columns evenly
    (tile_cols = ceil(n_out / tiles) rounded up to W); 256 threads x 16
    columns a tile, in groups of W consecutive columns (16, 8, 4 or 1: the
    widest dividing n_out, as for an aligned output), thread t's group g at
    tile + (256 g + t) W: every output column is written by one thread,
    W-aligned, and no tile is wider than 4,096 columns."""
    threads, per_thread = 256, 16
    for width in (16, 8, 4, 1):
        if n_out % width:
            continue
        hits = np.zeros(n_out, dtype=np.int64)
        tiles = -(-n_out // (threads * per_thread))
        tile_cols = -(-(-(-n_out // tiles)) // width) * width
        assert tile_cols <= threads * per_thread and tiles * tile_cols >= n_out
        for x in range(tiles):
            tile, end = x * tile_cols, min(n_out, (x + 1) * tile_cols)
            for g in range(per_thread // width):
                c0 = tile + (g * threads + np.arange(threads)) * width
                c0 = c0[c0 < end]
                assert (c0 % width == 0).all() and (c0 + width <= end).all()
                for e in range(width):
                    np.add.at(hits, c0 + e, 1)
        assert (hits == 1).all()


def test_gather_shift_places_each_code_in_its_nibble():
    """K4 with an index: ((byte << 16) >> (2 (j mod 4) + 16 - 4 e)) &
    (3 << 4 e) is code j mod 4 of the byte in nibble e, for every byte,
    every j mod 4 and every place e of a 4-column word."""
    byte = np.arange(256, dtype=np.uint64)
    for jm in range(4):
        for e in range(4):
            sh = 2 * jm + 16 - 4 * e
            got = ((byte << np.uint64(16)) >> np.uint64(sh)) & np.uint64(3 << (4 * e))
            np.testing.assert_array_equal(got, ((byte >> np.uint64(2 * jm)) & np.uint64(3))
                                          << np.uint64(4 * e))


@pytest.mark.parametrize("n", [1, 3, 4, 63, 64, 65, 67, 1001, 1004, 10_000])
def test_count_rows_cut_at_every_alignment(rng, n):
    """K5 without an index: bytes [0, N // 4) in 16-byte chunks from the
    row's first 16-byte boundary, the bytes before it and after the last
    chunk one per lane, and byte N // 4 masked to its N % 4 codes: each
    byte counted once, as the plain counts."""
    rows = _packed_rows(rng, 2, n) if n > 4 else rng.integers(
        0, 256, size=(2, (n + 3) // 4), dtype=np.uint8)
    full, rem = n >> 2, n & 3
    want = _plain_k5(rows, n)
    for r, row in enumerate(rows):
        for address in range(16):
            head = min(full, (16 - address) & 15)
            chunks = (full - head) >> 4
            done = head + 16 * chunks
            seen = np.zeros(len(row), dtype=np.int64)
            c = np.zeros(3, dtype=np.int64)
            for b in [*range(head), *range(done, full)]:
                c += _tally(row[b], 0x55)
                seen[b] += 1
            if chunks:
                c += _tally(row[head:done].copy().view("<u4"), LO_BITS)
                seen[head:done] += 1
            if rem:
                c += _tally(row[full], 0x55 & ((1 << (2 * rem)) - 1))
                seen[full] += 1
            assert (seen == 1).all()
            np.testing.assert_array_equal(_as_counts(c, n), want[r])


# ------------------------------------------------------------------ K6, K7 --
def _layout2_block(rng, n, bits, phased, ploidy=None):
    """An uncompressed layout-2 block of random `bits`-bit values, sample
    3 missing."""
    vals = rng.integers(0, 2 ** bits, size=2 * n)
    acc = 0
    for i, v in enumerate(vals.tolist()):
        acc |= v << (i * bits)
    if ploidy is None:
        ploidy = [2] * n
        ploidy[3 % n] = 0x82
    probs = acc.to_bytes((2 * n * bits + 7) // 8, "little")
    return struct.pack("<IHBB", n, 2, 2, 2) + bytes(ploidy) + bytes([phased, bits]) + probs


def _unsupported_blocks(rng, n):
    """Blocks neither decoder takes (status 1), each for its own reason."""
    good = _layout2_block(rng, n, 8, 0)
    haploid = bytearray(good)
    haploid[8 + 5] = 1
    missing_haploid = bytearray(good)
    missing_haploid[8 + 6] = 0x81
    three_alleles = bytearray(good)
    three_alleles[4] = 3
    zero_bits = bytearray(good)
    zero_bits[9 + n] = 0
    wide = bytearray(good)
    wide[9 + n] = 33
    other_n = struct.pack("<I", n + 1) + good[4:]
    return [bytes(haploid), bytes(missing_haploid), bytes(three_alleles), bytes(zero_bits),
            bytes(wide), other_n, good[:9], good[:9 + n]]


def _stored(block, compression):
    """A layout-2 genotype block as the file stores it."""
    if compression == 0:
        return block
    payload = zlib.compress(block) if compression == 1 else _zstd().compress(block)
    return struct.pack("<I", len(block)) + payload


def _zstd():
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor()


def _as_file(blocks):
    offsets = np.cumsum([0] + [len(b) for b in blocks[:-1]]).astype(np.int64)
    lengths = np.array([len(b) for b in blocks], dtype=np.int64)
    return b"".join(blocks), offsets, lengths


def _plain_decode(decoder, blocks, n):
    raw, offsets, lengths = _as_file(blocks)
    out, status = decoder(torch.frombuffer(bytearray(raw), dtype=torch.uint8),
                          torch.as_tensor(offsets), torch.as_tensor(lengths), n)
    return out.numpy(), status.numpy()


@pytest.mark.parametrize("compression", [0, 1, 2], ids=["none", "zlib", "zstd"])
def test_plain_k6_matches_native_and_parser(native, rng, compression):
    """Plain K6 on the decompressed blocks against the native decoder on
    the stored ones and JAX's per-variant parser, bit for bit: bit widths
    1, 3, 8, 12, 16 and 32, unphased and phased, a missing sample each,
    all-missing samples, and blocks of status 1."""
    n = 29
    blocks = [_layout2_block(rng, n, bits, phased)
              for bits in (1, 3, 8, 12, 16, 32) for phased in (0, 1)]
    blocks.append(_layout2_block(rng, n, 8, 0, ploidy=[0x82] * n))
    blocks += _unsupported_blocks(rng, n)
    ours, status = _plain_decode(gk.bgen_decode_l2, blocks, n)
    stored = [_stored(b, compression) for b in blocks]
    theirs, their_status = native[1].decode_blocks(*_as_file(stored), n, compression, 2)
    np.testing.assert_array_equal(status, their_status)
    np.testing.assert_array_equal(status[:13], 0)
    np.testing.assert_array_equal(status[13:], 1)
    ok = status == 0
    np.testing.assert_array_equal(ours[ok], theirs[ok])
    assert np.isnan(ours[~ok]).all() and np.isnan(ours[12]).all()
    for block, row, st in zip(blocks, ours, status):
        if st == 0:
            np.testing.assert_array_equal(row, jax_bgen._parse_layout2_dosage(block, n))
    for block in (bgen._decompress(memoryview(s), compression, 2) for s in stored):
        assert block in blocks


@pytest.mark.parametrize("compression", [0, 1], ids=["none", "zlib"])
def test_plain_k7_matches_native_and_parser(native, rng, compression):
    """Plain K7 against the native layout-1 decoder and JAX's parser:
    random probability triples, an all-zero (missing) one, and blocks of
    the wrong length (status 1)."""
    n = 23
    triples = rng.integers(0, 32769, size=(6, n, 3)).astype("<u2")
    triples[0, 4] = 0
    blocks = [t.tobytes() for t in triples] + [b"\x00" * (6 * n - 1), b"\x01" * (6 * n + 6)]
    ours, status = _plain_decode(gk.bgen_decode_l1, blocks, n)
    stored = [zlib.compress(b) if compression else b for b in blocks]
    theirs, their_status = native[1].decode_blocks(*_as_file(stored), n, compression, 1)
    np.testing.assert_array_equal(status, their_status)
    np.testing.assert_array_equal(status, [0] * 6 + [1, 1])
    np.testing.assert_array_equal(ours[:6], theirs[:6])
    assert np.isnan(ours[0, 4]) and np.isnan(ours[6:]).all()
    for block, row in zip(blocks[:6], ours):
        np.testing.assert_array_equal(row, jax_bgen._parse_layout1_dosage(block, n))


@pytest.mark.parametrize("wrapper", [gk.bgen_decode_l2, gk.bgen_decode_l1])
def test_bgen_wrappers_never_fall_back(wrapper):
    buf = torch.zeros(60, dtype=torch.uint8, device="meta")
    offsets = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="no bgen_decode"):
        wrapper(buf, offsets, offsets, 10)
    assert gk.bgen_decode_l2.launches == gk.bgen_decode_l1.launches == 0


# ------------------------------------------------------------------ readers --
def _same_stats(ours, theirs):
    for name in STATS_FIELDS:
        np.testing.assert_array_equal(getattr(ours, name), getattr(theirs, name), err_msg=name)


def test_read_plink_filter_stats_decode_rows_match_jax():
    """The golden cohort through read_plink, filter (a SNP subset in
    another order, individuals dropped and reordered, then filtered
    again), stats and decode_rows, against the JAX reader."""
    ours = bed.read_plink(str(GOLDEN / "cohort"), device="cpu")
    theirs = jax_bed.read_plink(str(GOLDEN / "cohort"))
    _same_stats(ours.stats(), theirs.stats())
    d = ours.decode_rows(3, 11)
    assert isinstance(d, torch.Tensor) and d.dtype == torch.int8
    np.testing.assert_array_equal(d.numpy(), theirs.decode_chunk(3, 11))
    np.testing.assert_array_equal(ours.dosages(), theirs.dosages())
    snps = [theirs.snp_names[i] for i in (17, 2, 9, 0, 19, 5)]
    keys = [theirs.individual_keys[i] for i in (23, 0, 11, 4, 7, 16, 1)]
    a = ours.filter(keep_snps=snps, keep_individuals=keys)
    b = theirs.filter(keep_snps=snps, keep_individuals=keys)
    assert a.snp_names == b.snp_names and a.individual_keys == b.individual_keys
    _same_stats(a.stats(), b.stats())
    np.testing.assert_array_equal(a.decode_rows(0, a.n_snps).numpy(), b.dosages())
    again = [keys[i] for i in (6, 2, 0)]
    _same_stats(a.filter(keep_individuals=again).stats(), b.filter(keep_individuals=again).stats())
    np.testing.assert_array_equal(a.filter(keep_individuals=again).dosages(),
                                  b.filter(keep_individuals=again).dosages())


def test_appended_filesets_decode_across_segments(tmp_path, rng):
    """append_snps chains the two files' segments: a chunk that spans
    both, a SNP filter that interleaves them, and stats, against JAX."""
    d1, d2 = make_dosage(rng, 12, 30, missing_rate=0.1), make_dosage(rng, 9, 30, missing_rate=0.1)
    p1, _ = make_plink(tmp_path, d1, prefix="a")
    p2, _ = make_plink(tmp_path, d2, prefix="b")
    ours = bed.read_plink(p1, device="cpu").append_snps(bed.read_plink(p2, device="cpu"))
    theirs = jax_bed.read_plink(p1).append_snps(jax_bed.read_plink(p2))
    np.testing.assert_array_equal(ours.decode_chunk(8, 17), theirs.decode_chunk(8, 17))
    _same_stats(ours.stats(), theirs.stats())
    picks = [theirs.snp_names[i] for i in (14, 2, 20, 3, 11, 12)]
    np.testing.assert_array_equal(ours.filter(keep_snps=picks).dosages(),
                                  theirs.filter(keep_snps=picks).dosages())


@pytest.mark.parametrize("block_rows", [3, 5])
def test_decodes_go_in_bounded_blocks(tmp_path, rng, monkeypatch, block_rows):
    """decode_rows, decode_chunk and stats upload and decode at most
    BLOCK_ROWS rows at a time, across segments and through an individual
    index, and equal the JAX reader; write_plink of such a view writes the
    same fileset as JAX's."""
    monkeypatch.setattr(bed, "BLOCK_ROWS", block_rows)
    sizes = []
    monkeypatch.setattr(bed, "bed_decode", lambda packed, n, cols=None, out=None: (
        sizes.append(packed.shape[0]), gk.bed_decode(packed, n, cols, out))[1])
    d1, d2 = make_dosage(rng, 11, 23, missing_rate=0.1), make_dosage(rng, 8, 23, missing_rate=0.1)
    p1, _ = make_plink(tmp_path, d1, prefix="a")
    p2, _ = make_plink(tmp_path, d2, prefix="b")
    theirs = jax_bed.read_plink(p1).append_snps(jax_bed.read_plink(p2))
    keys = [theirs.individual_keys[i] for i in (20, 3, 0, 14, 9)]
    theirs = theirs.filter(keep_individuals=keys)
    ours = bed.read_plink(p1, device="cpu").append_snps(bed.read_plink(p2, device="cpu"))
    ours = ours.filter(keep_individuals=keys)
    np.testing.assert_array_equal(ours.decode_rows(2, 19).numpy(), theirs.decode_chunk(2, 19))
    np.testing.assert_array_equal(ours.dosages(), theirs.dosages())
    _same_stats(ours.stats(), theirs.stats())
    assert sizes and max(sizes) <= block_rows
    bed.write_plink(str(tmp_path / "ours"), ours)
    jax_bed.write_plink(str(tmp_path / "theirs"), theirs)
    for ext in (".bed", ".bim", ".fam"):
        assert (tmp_path / ("ours" + ext)).read_bytes() == (tmp_path / ("theirs" + ext)).read_bytes()


def test_in_memory_plink_data_packs_once(rng):
    """PlinkData(_dosage=...) is packed with write_plink's encoder and
    decodes through K4 (its plain version here) like a file."""
    d = make_dosage(rng, 14, 39, missing_rate=0.1)
    snps = [bed.SnpInfo("1", f"s{i}", 0.0, i, "A", "C") for i in range(14)]
    inds = [bed.IndividualInfo(f"F{i}", f"I{i}") for i in range(39)]
    data = bed.PlinkData(snps=snps, individuals=inds, _dosage=d, device="cpu")
    np.testing.assert_array_equal(data.decode_chunk(0, 14), d)
    np.testing.assert_array_equal(data._segments[0].packed, jax_bed_pack(d))
    _same_stats(data.stats(), jax_bed.compute_snp_stats(d))


def jax_bed_pack(d):
    """The .bed payload the JAX package's write_plink writes for `d`."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path, _ = make_plink(pathlib.Path(tmp), d, prefix="p")
        raw = np.fromfile(path + ".bed", dtype=np.uint8)[3:]
    return raw.reshape(d.shape[0], -1)


def _staging_case(tmp_path, rng, case):
    """A PlinkData of 20 + 13 SNPs over 23 individuals read as `case`."""
    d1, d2 = make_dosage(rng, 20, 23, missing_rate=0.1), make_dosage(rng, 13, 23, missing_rate=0.1)
    if case == "in_memory":
        snps = [bed.SnpInfo("1", f"s{i}", 0.0, i, "A", "C") for i in range(20)]
        inds = [bed.IndividualInfo(f"F{i}", f"I{i}") for i in range(23)]
        return bed.PlinkData(snps=snps, individuals=inds, _dosage=d1, device="cpu")
    data = bed.read_plink(make_plink(tmp_path, d1, prefix="a")[0], device="cpu")
    if case == "appended":
        return data.append_snps(bed.read_plink(make_plink(tmp_path, d2, prefix="b")[0],
                                               device="cpu"))
    if case == "runs":
        return data.filter(keep_snps=[data.snp_names[i] for i in [*range(2, 9), *range(12, 19)]])
    if case == "shuffled":
        return data.filter(keep_snps=[data.snp_names[i] for i in rng.permutation(20)[:15]])
    return data


@pytest.mark.parametrize("block_rows", [1, 3, 8192])
@pytest.mark.parametrize("case", ["unfiltered", "runs", "shuffled", "appended", "in_memory"])
def test_staged_blocks_are_the_packed_rows_taken(tmp_path, rng, monkeypatch, case, block_rows):
    """_packed_rows gives, block by block, the bytes numpy's default
    (buffered) np.take gives for the same rows."""
    monkeypatch.setattr(bed, "BLOCK_ROWS", block_rows)
    data = _staging_case(tmp_path, rng, case)
    rows = np.concatenate([seg.rows for seg in data._segments])
    seg_of = np.concatenate([np.full(len(seg.rows), i) for i, seg in enumerate(data._segments)])
    for start, stop in ((0, data.n_snps), (1, data.n_snps - 2)):
        blocks = list(data._packed_rows(start, stop))
        assert all(0 < len(packed) <= block_rows for _, packed in blocks)
        pos = start
        for seg, packed in blocks:
            assert (seg_of[pos : pos + len(packed)] == seg_of[pos]).all()
            assert seg is data._segments[seg_of[pos]]
            np.testing.assert_array_equal(packed.numpy(),
                                          np.take(seg.packed, rows[pos : pos + len(packed)], axis=0))
            pos += len(packed)
        assert pos == stop


def test_blocks_held_at_once_on_the_cpu_are_distinct_buffers(tmp_path, rng, monkeypatch):
    """On the CPU `.to` hands back the staging buffer itself: each block
    gets its own, so blocks held together keep their own rows."""
    monkeypatch.setattr(bed, "BLOCK_ROWS", 3)
    data = _staging_case(tmp_path, rng, "unfiltered")
    blocks = [packed for _, packed in data._packed_rows(0, data.n_snps)]
    assert len({p.data_ptr() for p in blocks}) == len(blocks)
    packed = data._segments[0].packed
    for i, p in enumerate(blocks):
        np.testing.assert_array_equal(p.numpy(), packed[3 * i : 3 * i + 3])
    assert not np.array_equal(blocks[0].numpy(), blocks[1].numpy())


@pytest.mark.parametrize("rows", [[0, 3], [-1, 1], [5]])
def test_a_segment_with_a_row_out_of_range_is_refused_when_built(rng, rows):
    """Rows are checked once, against the packed rows, where a segment is
    built (the staging take clips and would hide a bad row)."""
    packed = bed.pack_dosage(make_dosage(rng, 3, 9))
    bed._Segment(packed, 9, np.array([2, 0, 1]), None)
    with pytest.raises(ValueError, match="outside the 3 packed rows"):
        bed._Segment(packed, 9, np.array(rows, dtype=np.int64), None)
    seg = bed._Segment(packed, 9, np.arange(3), None)
    with pytest.raises(ValueError, match="outside the 3 packed rows"):
        dataclasses.replace(seg, rows=np.array(rows, dtype=np.int64))


def test_read_bgen_matches_jax_native_reader():
    """read_bgen on the golden cohort against the JAX reader through its
    native decoder; the dosages stay a float32 tensor on the device."""
    read_before = bgen.read_bgen.unsupported
    ours = bgen.read_bgen(str(GOLDEN / "cohort.bgen"), device="cpu")
    theirs = jax_bgen.read_bgen(str(GOLDEN / "cohort.bgen"))
    assert isinstance(ours.dosages, torch.Tensor) and ours.dosages.dtype == torch.float32
    np.testing.assert_array_equal(ours.dosages.numpy(), theirs.dosages)
    assert bgen.read_bgen.unsupported == read_before
    _same_stats(ours.stats(), theirs.stats())


def test_read_bgen_counts_blocks_parsed_on_the_host(tmp_path, rng):
    """A file with one block K6 does not take (a haploid sample): it is
    parsed on the host, counted, and dropped as the JAX reader drops it."""
    n, m = 10, 4
    d = rng.uniform(0, 2, size=(m, n)).astype(np.float32)
    data = bgen.BgenData(snps=[bed.SnpInfo("1", f"r{i}", 0.0, i, "A", "G") for i in range(m)],
                         individuals=[bed.IndividualInfo(f"S{i}", f"S{i}") for i in range(n)],
                         dosages=d)
    path = tmp_path / "h.bgen"
    bgen.write_bgen(str(path), data, bits=8, compression="none")
    raw = bytearray(path.read_bytes())
    first = raw.index(bgen._probability_payloads(d[1:2], 8, 2)[0])
    raw[first + 8 + 2] = 1  # variant 1, sample 2: ploidy 1
    path.write_bytes(bytes(raw))
    before = bgen.read_bgen.unsupported
    ours = bgen.read_bgen(str(path), device="cpu")
    assert bgen.read_bgen.unsupported - before == 1
    theirs = jax_bgen.read_bgen(str(path))
    assert ours.snp_names == theirs.snp_names == ["r0", "r2", "r3"]
    np.testing.assert_array_equal(ours.dosages.numpy(), theirs.dosages)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 127, 128, 129, 300, 8191, 8192, 8193, 10_000, 20_001])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_numpy_row_sum_rounds_as_numpy(rng, n, dtype):
    """BgenData.stats() sums rows on the device in numpy's order: the same
    bits as np.sum over the last axis, at every size the pieces and the
    pairwise halves take."""
    x = rng.uniform(-1, 3, size=(3, n)).astype(dtype)
    np.testing.assert_array_equal(bgen._numpy_row_sum(torch.as_tensor(x)).numpy(), x.sum(axis=1))


def test_numpy_order_probe_tells_the_orders_apart():
    """The probe rows round differently in numpy 2.0's buffered order and
    in the whole-row pairwise order, so `_numpy_piece` can tell which
    this numpy uses."""
    probe = np.random.default_rng(0).uniform(0.0, 1.0, size=(16, bgen._PROBE_LEN)).astype(
        np.float32)
    x = torch.from_numpy(probe)
    assert not torch.equal(bgen._numpy_row_sum(x, bgen._NUMPY_BUFFER),
                           bgen._numpy_row_sum(x, bgen._PROBE_LEN))
    assert bgen._numpy_piece() in (bgen._NUMPY_BUFFER, bgen._WHOLE_ROW)


def test_numpy_order_probe_raises_on_an_unknown_order(monkeypatch):
    """A numpy whose row sums match neither known order stops stats()
    instead of giving statistics that differ from the JAX package's."""
    monkeypatch.setattr(bgen, "_numpy_row_sum", lambda x, piece_len=None: x.sum(dim=1) + 1)
    bgen._numpy_piece.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="does not know"):
            bgen._numpy_piece()
    finally:
        monkeypatch.undo()
        bgen._numpy_piece.cache_clear()


# ---------------------------------------------------------------------- GRM --
@pytest.mark.parametrize("chunk_size", [2048, 5])
def test_grm_from_plink_through_filtered_store_matches_jax(chunk_size):
    """grm_from_plink on a filtered view of the golden cohort (individuals
    dropped and reordered, SNPs subset), chunks decoded by plain K4, the
    statistics from plain K5, against JAX's: kernel at rtol 1e-6, counts
    exactly."""
    keys = jax_bed.read_plink(str(GOLDEN / "cohort")).individual_keys
    keep = [keys[i] for i in (20, 3, 5, 0, 9, 14, 11, 22, 1, 17)]
    snps = [f"snp{i}" for i in range(20) if i % 3 != 1]
    ours = grm_from_plink(bed.read_plink(str(GOLDEN / "cohort"), device="cpu").filter(
        keep_snps=snps, keep_individuals=keep), chunk_size=chunk_size, device="cpu")
    ref = jax_grm_from_plink(jax_bed.read_plink(str(GOLDEN / "cohort")).filter(
        keep_snps=snps, keep_individuals=keep), chunk_size=chunk_size)
    assert ours.individual_keys == ref.individual_keys and ours.snp_names == ref.snp_names
    np.testing.assert_allclose(ours.matrix.numpy(), np.asarray(ref.matrix), rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ours.counts.numpy(), np.asarray(ref.counts))


# ---------------------------------------------------------------------- CLI --
@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Both CLIs on the golden cohort: `--make-grm --keep --extract` and
    `--gwas --grm` on that GRM."""
    out = tmp_path_factory.mktemp("torch_decode_cli")
    keep = [i for i in np.random.default_rng(8).permutation(24) if i not in (3, 10, 17, 22)]
    (out / "keep.txt").write_text("".join(f"F{i} I{i}\n" for i in keep))
    (out / "extract.txt").write_text("".join(f"snp{i}\n" for i in range(20) if i != 4))
    base = ["--bfile", str(GOLDEN / "cohort"), "--mesh", "none"]
    runs = lambda d: [
        ["--make-grm"] + base + ["--keep", str(out / "keep.txt"), "--extract",
                                 str(out / "extract.txt"), "--out", f"{d}/k"],
        ["--gwas", "--grm", f"{d}/k"] + base + ["--pheno", str(GOLDEN / "pheno.txt"),
                                                "--out", f"{d}/k.mlm"],
    ]
    saved = os.environ.get("DISSECT_TPU_TORCH_DEVICE")
    os.environ["DISSECT_TPU_TORCH_DEVICE"] = "cpu"
    try:
        for side, fn in (("jax", jax_main), ("torch", main)):
            (out / side).mkdir()
            for argv in runs(out / side):
                try:
                    fn(argv)
                finally:
                    set_mesh_context(None)
    finally:
        if saved is None:
            os.environ.pop("DISSECT_TPU_TORCH_DEVICE", None)
        else:
            os.environ["DISSECT_TPU_TORCH_DEVICE"] = saved
    return out


def test_make_grm_keep_extract_matches_jax_cli(cli_runs):
    for ext in ("grm.ids", "grm.snps"):
        assert (cli_runs / "torch" / f"k.{ext}").read_bytes() == \
            (cli_runs / "jax" / f"k.{ext}").read_bytes()
    new, old = read_grm(f"{cli_runs}/torch/k"), read_grm(f"{cli_runs}/jax/k")
    assert new["kernel"].shape == (20, 20)
    np.testing.assert_allclose(new["kernel"], old["kernel"], rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(new["counts"], old["counts"])


@pytest.mark.parametrize("name", ["k.mlm.gwas.snps", "k.mlm.gwas.mean"])
def test_gwas_grm_matches_jax_cli(cli_runs, name):
    _diff_files(cli_runs / "torch" / name, cli_runs / "jax" / name, rtol=2e-5)
