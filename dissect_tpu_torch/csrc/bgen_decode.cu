// K6, K7: BGEN probability blocks decoded on the card into expected
// allele-2 dosages.
//
// Replaces the probability decode of the JAX package's native host decoder,
//   dissect_tpu/native/bgen_decode.cpp: dissect_decode_bgen_l2 (:86-151) and
//   dissect_decode_bgen_l1 (:154-183), OpenMP loops over variants.
// Decompression is not ported: the host decompresses (zlib, zstd) on a
// thread pool, lays the uncompressed blocks end to end in one buffer, and
// this file decodes the buffer, given each block's offset and length.
//
// Contract.  out is (n_variants, n_samples) float32, NaN = missing;
// status[v] is 0 when block v decoded and 1 when it is unsupported (the
// caller then parses it on the host, as the JAX caller does).  A row with
// status 1 is all NaN.
//   K6, layout 2: a block is [n u32 | alleles u16 | min, max ploidy u8 |
//   n ploidy bytes | phased u8 | bits u8 | bit-packed probabilities].  It is
//   unsupported when it is shorter than 10 bytes or than 10 + n, when
//   n != n_samples, alleles != 2, bits is not in 1..32, or any ploidy byte
//   (missing ones too: their entries still occupy the stream) is not 2.
//   Each sample s reads two values e0, e1 of `bits` bits at bit offsets
//   2 s bits and (2 s + 1) bits, little-endian, bytes past the block's end
//   read as 0 (the native read_bits); v = e / (2^bits - 1) in float64;
//   unphased d = v1 + 2 clip(1 - v0 - v1, 0, 1), phased
//   d = (1 - v0) + (1 - v1); NaN where the ploidy byte's 0x80 bit is set.
//   K7, layout 1: a block is three little-endian uint16 per sample; it is
//   unsupported unless it is exactly 6 n_samples bytes; with
//   psum = (p0 + p1 + p2) / 32768, d = ((p1 + 2 p2) / 32768) / psum in
//   float64, NaN where psum <= 0 (an all-zero triple).
//
// Bit-equality with the JAX package's dosages.  This file is compiled
// without --use_fast_math: float64 and float32 division are IEEE
// round-to-nearest on the card as on the host.
//  K6: every v0, v1 is the native's double e / (2^bits - 1).  At widths up
//   to TABLE_BITS it is read from a table that each block fills with that
//   same float64 division for every e below 2^bits; wider widths divide in
//   line.  The rest is the native's expression in the native's order,
//   1 - v0 - v1, the clip, v1 + 2 p22 (or (1 - v0) + (1 - v1)), and one
//   rounding to float32.  nvcc may contract v1 + 2.0 * p22 into one fused
//   multiply-add; that is exact here, because 2.0 * x is exact in float64
//   (a power-of-two scaling of a finite value far from overflow), so
//   fma(2, x, y) rounds the same exact sum y + 2x once, as the unfused add
//   does.  1 - v0 - v1 and (1 - v0) + (1 - v1) hold no product and are not
//   contracted.
//  K7: both scalings by 1/32768 = 2^-15 are exact in float64 (integers
//   below 2^17 scaled by a power of two), so the native's quotient is
//   RN64((p1 + 2 p2) / (p0 + p1 + p2)), rounded once more to float32.  Both
//   integers are below 98,305 < 2^24, exact in float32, and a float32
//   division of them rounds the same quotient once; rounding it first to
//   float64 and then to float32 gives the same float32, because float64's
//   53 bits are at least 2 x 24 + 2 (a quotient of 24-bit numbers is never
//   a float32 tie, nor close enough to one for the first rounding to make
//   it one).  So K7 divides once, __fdiv_rn on the exact integers.  psum
//   <= 0 is p0 + p1 + p2 == 0.
//
// What bounds them on the H100: bytes.  At the BGEN path's batch (1,024
// variants of 10 + 3N bytes, 8-bit, unphased, N = 10,000) K6 reads 30.7 MB
// and writes 41 MB, 21.4 us at 3.35 TB/s; K7 at 1,024 x 10,000 reads 61.4
// MB and writes 41 MB, 30.6 us.  The float64 work is what could come close
// to that.  The first K6 divided twice per sample in float64 (about ten
// float64-pipe instructions each on sm_90: a reciprocal estimate, Newton
// steps and a slow-path test) and converted two integers to float64 (16 a
// cycle per SM): about 2-3 x 10^8 float64 instructions a batch, 15-20 us
// at 132 SMs x 64 lanes x ~1.75 GHz, as large as the byte bound.  With the
// table, K6 does 5 float64 operations (two subtractions, two compares, one
// fused multiply-add) and one float64-to-float32 conversion per sample:
// 5 x 10^7 and 10^7 a batch, about 3.5 us and 3 us.  K7 does one float32
// division (about eight float32-pipe instructions) per sample, and no
// float64 at all.  What is left is latency: a block waits on its header,
// then on its tiles, and K6's decode is a chain of dependent float64
// operations; more blocks an SM and more samples a tile hide it (below).
//
// Design.  A block owns a variant (grid (splits, V)) and walks its sample
// tiles through a ring of STAGES shared-memory slots, so that the copies
// of the next tiles fly while this one is decoded.
//  Staging.  Block offsets are arbitrary (a layout-2 block is 10 + 3N
//   bytes), so a tile's bytes are copied as the aligned 16-byte words that
//   hold them, by cp.async: the byte at global address lo + k lands at
//   slot + SLACK + (lo & 15) + k.  K6 stages two ranges a tile, its ploidy
//   bytes and its probability bytes; K7 one, its 6-byte triples.  Trap 1:
//   the blocks lie end to end, so a staged word past a block's end holds
//   the next block's bytes, which the native reads as 0.  K6 stages
//   probability bytes only up to the stream's end (plen), and a tile that
//   reaches past it zeroes its bytes from plen on before it decodes (the
//   test is the same for the whole block, so is its extra barrier).  K7's
//   block is exactly 6N bytes, and no triple reads past it.  Trap 2: the
//   first and last word of a range may reach up to 15 bytes before or
//   after the buffer; each staged word holds at least one byte of the
//   buffer, and an aligned 16-byte word never crosses a 512-byte boundary,
//   to which PyTorch's allocator rounds every allocation (and a page,
//   within which memory is mapped whole), so the read stays inside memory
//   the buffer's allocation owns.  The bytes of the words that lie outside
//   a range are never read as data.
//  Tiles and stores.  A group is 4 consecutive samples, written with one
//   16-byte store.  Groups follow the output row's 16-byte words: a row
//   starts `a` floats past a 16-byte boundary (rows are 4N bytes, 16-byte
//   aligned only when N % 4 == 0 and out is), so group g holds samples
//   4 g - a .. 4 g - a + 3, and the partial groups at the row's two ends
//   store their samples one by one.  A thread decodes TILE_GROUPS groups
//   a tile, THREADS apart, so each store instruction of a warp covers 512
//   contiguous bytes.  A tile is 2,048 samples at widths up to 8 bits,
//   half that up to 16 bits and a quarter up to 32 (a slot holds at most
//   4,097 probability bytes).  Measured on an H100 (bgen_kernel_variants.py,
//   K6 at the BGEN path's batch): 2 groups a thread took 0.039 ms, 1 group
//   0.047 (more bytes in flight, half the barriers); a ring 4 deep beat 6
//   (0.042) and 8 (0.046), whose slots leave room for fewer blocks.
//  Ploidy.  Each thread tests the ploidy bytes of the words it copied
//   itself (visible to it once its copies landed), and the ring's one
//   barrier a tile is __syncthreads_or of those tests: a tile writes
//   dosages only after every tile up to it has passed.  A tile that finds
//   a byte that is not 2 stops the block, which writes NaN over its
//   samples and sets status 1 (earlier tiles' dosages are overwritten).
//  8 bits, UK Biobank's width, the only one on the main path: a group's 4
//   ploidy bytes and 8 probability bytes come out of shared memory as 32-
//   bit words (funnel shifts undo the byte offset) and its 8 values index
//   the table.  The table holds REPLICAS copies of each entry, lane l
//   reading copy l mod 8: the 16 lanes of a half-warp share shared
//   memory's 32 banks in one pass for 8-byte loads, and with 8 copies at
//   most two of them meet in a bank pair, whatever the values.  Each
//   block fills the table after it has started its first tiles' copies;
//   lane l writes copy (l + k) mod reps of its entry in step k, so the
//   lanes of a half-warp do not all write one bank pair.  Other widths read each
//   value as a 64-bit window of two 32-bit shared-memory words, shifted
//   and masked as the native's read_bits; up to TABLE_BITS (16 KB of
//   table) with fewer copies (2,048 >> bits, at most 8), wider in line.
//   The table's 16 KB, the ring's 24 KB and at most 48 registers
//   (MIN_BLOCKS) let 5 blocks share an SM: with a 12-bit table (32 KB, 16
//   copies) and 64 registers 4 did, and K6 took 0.042 ms a batch.
//  Few variants.  One block a variant leaves SMs idle when V is below the
//   blocks the card holds at once (64 variants of a UK Biobank width, or
//   the last batch of a file).  The launcher then splits each variant's
//   tiles into `splits` contiguous ranges, one block each, so that at most
//   one wave of blocks runs (bgen_kernel_variants.py, 64 variants of N =
//   487,409: K6 0.104 ms split, 0.292 not; K7 0.128 and 0.260).  K7's
//   status depends only on the block's
//   length, the same in every block of a variant.  K6's split blocks each
//   test their own tiles: the launcher zeroes the statuses first, a block
//   that fails writes 1, and a fix-up kernel after it, in the same call,
//   writes NaN over every row whose status is 1.  One launch per call is
//   counted: the wrapper's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 4;         // consecutive samples of a group: one 16-byte store
constexpr int TILE_GROUPS = 2;   // groups a thread decodes a tile
constexpr int TILE = THREADS * TILE_GROUPS * GROUP;  // samples of a tile at widths up to 8 bits
constexpr int STAGES = 4;              // the ring of staged tiles
constexpr int SLACK = 16;              // bytes before and after a staged range
constexpr int TABLE_BITS = 11;         // K6 reads its quotients from the table up to this width
constexpr int TABLE_DOUBLES = 1 << TABLE_BITS;  // 16 KB
constexpr int REPLICAS = 8;            // copies of each entry at widths up to 8 bits
constexpr int MIN_BLOCKS = 5;          // resident blocks an SM must fit: at most 48 registers
static_assert((TABLE_DOUBLES >> 8) >= REPLICAS, "8 bits takes all the copies");
constexpr int MAX_GRID_Y = 65535;
constexpr size_t DEFAULT_SMEM = 48 * 1024;  // dynamic shared memory without opting in

// A slot for a range of `range` bytes at any offset from a 16-byte word,
// with SLACK bytes on each side (the word reads of a range's last bytes
// go up to 11 bytes past them).
constexpr int staged_bytes(int range) { return SLACK + ((range + 15 + 15) & ~15) + SLACK; }
// K6's slot: a tile's ploidy bytes and its probability bytes (2 TILE at 8
// bits; a wider width takes fewer samples, and a stream cut mid-byte one
// byte more)
constexpr int PLOIDY_SLOT = staged_bytes(TILE);
constexpr int L2_SLOT = PLOIDY_SLOT + staged_bytes(2 * TILE + 1);
constexpr int L1_SLOT = staged_bytes(6 * TILE);

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Where the global byte lo lands in a slot: bytes lo + k go to slot +
// local(lo) + k.
__device__ __forceinline__ int local(const uint8_t* lo) {
  return SLACK + (int)((uintptr_t)lo & 15);
}

// Starts copying the global bytes [lo, hi) into `slot`: every aligned
// 16-byte word that holds one of them, word k by thread k mod THREADS.
__device__ __forceinline__ void stage(const uint8_t* lo, const uint8_t* hi, uint8_t* slot) {
  if (hi <= lo) return;
  const uint8_t* first = reinterpret_cast<const uint8_t*>((uintptr_t)lo & ~(uintptr_t)15);
  const int words = (int)((hi - first + 15) >> 4);
  for (int k = threadIdx.x; k < words; k += THREADS)
    cp_async16(slot + SLACK + 16 * k, first + 16 * k);
}

// Bytes [lo, hi) of a 32-bit word, each bound clamped to [0, 4].
__device__ __forceinline__ uint32_t byte_mask(int lo, int hi) {
  lo = min(max(lo, 0), 4);
  hi = min(max(hi, 0), 4);
  return (uint32_t)((1ull << (8 * hi)) - (1ull << (8 * lo)));
}

// After this thread's copies of the ploidy bytes [lo, hi) landed: whether
// one of the bytes it copied is not 2 in its low 6 bits.
__device__ __forceinline__ bool bad_ploidy(const uint8_t* lo, const uint8_t* hi,
                                           const uint8_t* slot) {
  const uintptr_t first = (uintptr_t)lo & ~(uintptr_t)15;
  const int words = (int)(((uintptr_t)hi - first + 15) >> 4);
  uint32_t bad = 0;
  for (int k = threadIdx.x; k < words; k += THREADS) {
    const uint4 w = *reinterpret_cast<const uint4*>(slot + SLACK + 16 * k);
    const uintptr_t at = first + 16 * (uintptr_t)k;
    const int b0 = lo > (const uint8_t*)at ? (int)((uintptr_t)lo - at) : 0;
    const uintptr_t end = (uintptr_t)hi - at;
    const int b1 = end < 16 ? (int)end : 16;
    const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bad |= ((x[j] & 0x3F3F3F3Fu) ^ 0x02020202u) & byte_mask(b0 - 4 * j, b1 - 4 * j);
  }
  return bad != 0;
}

// 32 bits of a slot from byte `at` on, any alignment.
__device__ __forceinline__ uint32_t word_at(const uint8_t* slot, int at) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(slot) + (at >> 2);
  return __funnelshift_r(w[0], w[1], 8 * (at & 3));
}

// The native read_bits on a staged stream: `mask` (bits ones) of the bits
// from bit `at` of the slot on; a 32-bit value at a shift of up to 31 lies
// within the two words under it.
__device__ __forceinline__ uint32_t bits_at(const uint8_t* slot, int at, uint32_t mask) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(slot) + (at >> 5);
  const uint64_t x = ((uint64_t)w[1] << 32) | w[0];
  return (uint32_t)(x >> (at & 31)) & mask;
}

// The native's float64 dosage, rounded once to float32.
__device__ __forceinline__ float dosage(double v0, double v1, int phased, bool missing) {
  double d;
  if (phased) {
    d = (1.0 - v0) + (1.0 - v1);
  } else {
    double p22 = 1.0 - v0 - v1;
    if (p22 < 0.0) p22 = 0.0;
    if (p22 > 1.0) p22 = 1.0;
    d = v1 + 2.0 * p22;
  }
  return missing ? NAN : (float)d;
}

// x < 2^23 as a float32, exactly (2^23 + x, less 2^23).
__device__ __forceinline__ float exact_float(uint32_t x) {
  return __uint_as_float(0x4B000000u | x) - 8388608.0f;
}

__device__ __forceinline__ float l1_dosage(uint32_t p0, uint32_t p1, uint32_t p2) {
  const uint32_t sum = p0 + p1 + p2;
  return sum == 0 ? NAN : __fdiv_rn(exact_float(p1 + 2 * p2), exact_float(sum));
}

__device__ __forceinline__ uint32_t lo16(uint32_t x) { return x & 0xFFFFu; }
__device__ __forceinline__ uint32_t hi16(uint32_t x) { return x >> 16; }

// e / (2^bits - 1) in float64: from the table (entry e, copy `rep` of
// `reps`) or divided in line.
struct Quotients {
  const double* table;
  int reps, rep;
  double denom;
  bool in_table;
  __device__ __forceinline__ double operator()(uint32_t e) const {
    return in_table ? table[e * reps + rep] : (double)e / denom;
  }
};

// A row's groups and tiles.  The row's first sample lies `a` floats past
// a 16-byte boundary; group g holds samples 4 g - a .. 4 g - a + 3 (those
// in [0, n)); tile t groups [t span, (t + 1) span).
struct Row {
  int n, a, span, groups, tiles;
  __device__ Row(const float* row, int n_samples, int shift) {
    n = n_samples;
    a = (int)(((uintptr_t)row & 15) >> 2);
    span = (THREADS * TILE_GROUPS) >> shift;
    groups = n ? (n + a + GROUP - 1) / GROUP : 0;
    tiles = (groups + span - 1) / span;
  }
  __device__ int lo(int t) const { return max(0, GROUP * t * span - a); }
  __device__ int hi(int t) const { return min(n, GROUP * (t + 1) * span - a); }
};

// K6: group g (samples c = 4 g - a ..) of the tile staged in `slot`,
// whose first sample is s0.  lp: where sample s0's ploidy byte lies in the
// slot; lq: where the bits of its first value begin (a bit offset into
// the probability part).
template <bool EIGHT>
__device__ __forceinline__ void group_l2(const Row& r, int g, int s0, const uint8_t* slot,
                                         int lp, int lq, int bits, uint32_t mask, int phased,
                                         const Quotients& q, float* row) {
  const uint8_t* ps = slot;
  const uint8_t* qs = slot + PLOIDY_SLOT;
  const int c = GROUP * g - r.a;
  if (c >= 0 && c + GROUP <= r.n) {
    float d[GROUP];
    if constexpr (EIGHT) {  // 4 ploidy bytes, 8 value bytes: 3 funnel-shifted words
      const uint32_t pw = word_at(ps, lp + (c - s0));
      const int at = (lq >> 3) + 2 * (c - s0);
      const uint32_t e[2] = {word_at(qs, at), word_at(qs, at + 4)};
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const uint32_t w = e[j >> 1] >> (16 * (j & 1));
        d[j] = dosage(q.table[(w & 0xFFu) * REPLICAS + q.rep],
                      q.table[((w >> 8) & 0xFFu) * REPLICAS + q.rep], phased,
                      (pw >> (8 * j)) & 0x80u);
      }
    } else {
#pragma unroll
      for (int j = 0; j < GROUP; ++j) {
        const int at = lq + 2 * (c + j - s0) * bits;
        d[j] = dosage(q(bits_at(qs, at, mask)), q(bits_at(qs, at + bits, mask)), phased,
                      ps[lp + (c + j - s0)] & 0x80u);
      }
    }
    *reinterpret_cast<float4*>(row + c) = make_float4(d[0], d[1], d[2], d[3]);
  } else {  // a partial group at either end of the row
    for (int s = max(c, 0); s < min(c + GROUP, r.n); ++s) {
      const int at = lq + 2 * (s - s0) * bits;
      row[s] = dosage(q(bits_at(qs, at, mask)), q(bits_at(qs, at + bits, mask)), phased,
                      ps[lp + (s - s0)] & 0x80u);
    }
  }
}

// K7: group g of the tile staged in `slot`; sample s0's triple lies at
// byte lb of the slot.
__device__ __forceinline__ void group_l1(const Row& r, int g, int s0, const uint8_t* slot,
                                         int lb, float* row) {
  const int c = GROUP * g - r.a;
  if (c >= 0 && c + GROUP <= r.n) {  // 24 bytes: 6 funnel-shifted words
    const int at = lb + 6 * (c - s0);
    const uint32_t* w = reinterpret_cast<const uint32_t*>(slot) + (at >> 2);
    const int sh = 8 * (at & 3);
    uint32_t x[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = __funnelshift_r(w[j], w[j + 1], sh);
    *reinterpret_cast<float4*>(row + c) = make_float4(
        l1_dosage(lo16(x[0]), hi16(x[0]), lo16(x[1])), l1_dosage(hi16(x[1]), lo16(x[2]), hi16(x[2])),
        l1_dosage(lo16(x[3]), hi16(x[3]), lo16(x[4])), l1_dosage(hi16(x[4]), lo16(x[5]), hi16(x[5])));
  } else {
    for (int s = max(c, 0); s < min(c + GROUP, r.n); ++s) {
      const uint8_t* b = slot + lb + 6 * (s - s0);
      row[s] = l1_dosage(b[0] | (b[1] << 8), b[2] | (b[3] << 8), b[4] | (b[5] << 8));
    }
  }
}

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// LAYOUT 2 (K6) or 1 (K7).  Block (x, y) decodes tiles [x tiles / splits,
// (x + 1) tiles / splits) of variants y, y + gridDim.y, ...
template <int LAYOUT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bgen_kernel(const uint8_t* __restrict__ buf, const int64_t* __restrict__ offsets,
            const int64_t* __restrict__ lengths, int n_variants, int n,
            float* __restrict__ out, int32_t* __restrict__ status, int splits) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int SLOT = LAYOUT == 2 ? L2_SLOT : L1_SLOT;
  double* table = reinterpret_cast<double*>(smem + STAGES * SLOT);
  int table_bits = 0;  // the width the table holds
  for (int v = blockIdx.y; v < n_variants; v += gridDim.y) {
    const uint8_t* u = buf + offsets[v];
    const int64_t len = lengths[v];
    float* row = out + (size_t)v * (size_t)n;
    bool ok;
    int phased = 0, bits = 8;
    if constexpr (LAYOUT == 2) {
      ok = len >= 10 && len >= 10 + (int64_t)n;
      if (ok) ok = le32(u) == (uint32_t)n && (u[4] | (u[5] << 8)) == 2;
      if (ok) {
        phased = u[8 + n];
        bits = u[9 + n];
        ok = bits >= 1 && bits <= 32;
      }
      if (!ok) bits = 8;
    } else {
      ok = len == 6 * (int64_t)n;
    }
    const Row r(row, n, bits <= 8 ? 0 : bits <= 16 ? 1 : 2);
    const int t_begin = (int)((long long)r.tiles * blockIdx.x / splits);
    const int t_end = (int)((long long)r.tiles * (blockIdx.x + 1) / splits);
    const uint8_t* probs = u + 10 + n;
    const int64_t plen = len - 10 - n;
    Quotients q;
    q.table = table;
    q.reps = bits <= TABLE_BITS ? min(REPLICAS, TABLE_DOUBLES >> bits) : 1;
    q.rep = (int)threadIdx.x & (q.reps - 1);
    q.denom = (double)((((uint64_t)1) << bits) - 1);
    q.in_table = bits <= TABLE_BITS;
    const uint32_t mask = (uint32_t)((((uint64_t)1) << bits) - 1);
    bool failed = !ok;
    if (ok && t_begin < t_end) {
      // tile t_begin + i into slot i mod STAGES (an empty group past the last)
      auto issue = [&](int i) {
        const int t = t_begin + i;
        if (t < t_end) {
          uint8_t* slot = smem + (i % STAGES) * SLOT;
          const int s0 = r.lo(t), s1 = r.hi(t);
          if constexpr (LAYOUT == 2) {
            stage(u + 8 + s0, u + 8 + s1, slot);
            const int64_t pb0 = (2 * (int64_t)s0 * bits) >> 3;
            const int64_t pb1 = (2 * (int64_t)s1 * bits + 7) >> 3;  // staged up to plen
            stage(probs + pb0, probs + (pb1 < plen ? pb1 : plen), slot + PLOIDY_SLOT);
          } else {
            stage(u + 6 * (int64_t)s0, u + 6 * (int64_t)s1, slot);
          }
        }
        cp_async_commit();
      };
#pragma unroll
      for (int i = 0; i < STAGES - 1; ++i) issue(i);
      if constexpr (LAYOUT == 2) {
        // while the first tiles' copies fly: the previous variant's readers
        // are past its closing barrier, and the first tile's barrier comes
        // before any read of this one.  Lane l writes copy (l + k) mod reps
        // of its entry in step k: the lanes of a half-warp hit distinct bank
        // pairs (at 16 copies).
        if (q.in_table && bits != table_bits) {
          for (int e = threadIdx.x; e < (1 << bits); e += THREADS) {
            const double val = (double)e / q.denom;
            for (int k = 0; k < q.reps; ++k)
              table[e * q.reps + ((threadIdx.x + k) & (q.reps - 1))] = val;
          }
          table_bits = bits;
        }
      }
      for (int i = 0; t_begin + i < t_end; ++i) {
        const int t = t_begin + i;
        const int s0 = r.lo(t), s1 = r.hi(t);
        uint8_t* slot = smem + (i % STAGES) * SLOT;
        cp_async_wait<STAGES - 2>();  // this thread's copies of tile t landed
        bool bad = false;
        if constexpr (LAYOUT == 2) bad = bad_ploidy(u + 8 + s0, u + 8 + s1, slot);
        // every copy of tile t landed and passed; every thread is done
        // with the slot the next copy refills
        if (__syncthreads_or(bad)) {
          failed = true;
          break;
        }
        issue(i + STAGES - 1);
        if constexpr (LAYOUT == 2) {
          const int64_t pb0 = (2 * (int64_t)s0 * bits) >> 3;
          const int64_t pb1 = (2 * (int64_t)s1 * bits + 7) >> 3;
          const int lq = local(probs + pb0);
          if (pb1 > plen) {  // the stream ends inside this tile: zeros from plen on
            const int from = lq + (int)((plen > pb0 ? plen : pb0) - pb0), to = lq + (int)(pb1 - pb0);
            for (int k = from + (int)threadIdx.x; k < to; k += THREADS)
              slot[PLOIDY_SLOT + k] = 0;
            __syncthreads();
          }
          const int lp = local(u + 8 + s0);
          const int lq_bits = 8 * lq + (int)((2 * (int64_t)s0 * bits) & 7);
#pragma unroll
          for (int k = 0; k < TILE_GROUPS; ++k) {  // this thread's groups of the tile
            const int place = k * THREADS + (int)threadIdx.x, g = t * r.span + place;
            if (place >= r.span || g >= r.groups) break;
            if (bits == 8)
              group_l2<true>(r, g, s0, slot, lp, lq_bits, bits, mask, phased, q, row);
            else
              group_l2<false>(r, g, s0, slot, lp, lq_bits, bits, mask, phased, q, row);
          }
        } else {
          const int lb = local(u + 6 * (int64_t)s0);
#pragma unroll
          for (int k = 0; k < TILE_GROUPS; ++k) {
            const int g = t * r.span + k * THREADS + (int)threadIdx.x;
            if (g >= r.groups) break;
            group_l1(r, g, s0, slot, lb, row);
          }
        }
      }
      cp_async_wait<0>();
    }
    if (failed) {  // NaN over this block's samples (K6 split: the fix-up does the rest)
      const int s_end = t_begin < t_end ? r.hi(t_end - 1) : 0;
      for (int s = (t_begin < t_end ? r.lo(t_begin) : 0) + (int)threadIdx.x; s < s_end;
           s += THREADS)
        row[s] = NAN;
      if (threadIdx.x == 0) status[v] = 1;
    } else if (threadIdx.x == 0 && (LAYOUT == 1 || splits == 1)) {
      status[v] = 0;
    }
    __syncthreads();  // the slots and the table are free for the next variant
  }
}

// K6 split over several blocks a variant: NaN over every row whose status
// a failing block set to 1.
__global__ void __launch_bounds__(THREADS)
bgen_fixup_kernel(float* __restrict__ out, const int32_t* __restrict__ status, int n_variants,
                  int n) {
  for (int v = blockIdx.x; v < n_variants; v += gridDim.x) {
    if (!status[v]) continue;
    float* row = out + (size_t)v * (size_t)n;
    for (int s = threadIdx.x; s < n; s += THREADS) row[s] = NAN;
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 132;
}

template <int LAYOUT>
int launch(const void* buf, const void* offsets, const void* lengths, void* out, void* status,
           int n_variants, int n, void* stream) {
  if (n_variants == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  auto kernel = bgen_kernel<LAYOUT>;
  const size_t smem = STAGES * (size_t)(LAYOUT == 2 ? L2_SLOT : L1_SLOT) +
                      (LAYOUT == 2 ? TABLE_DOUBLES * sizeof(double) : 0);
  if (smem > DEFAULT_SMEM) {  // past 48 KB a kernel must ask
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  static int per_sm = 0;  // resident blocks an SM holds (a property of the kernel)
  if (per_sm == 0) {
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    per_sm = per_sm > 0 ? per_sm : 1;
  }
  // few variants: split each into contiguous tile ranges, at most one wave
  const int capacity = sm_count() * per_sm;
  const int span = THREADS * TILE_GROUPS;  // a tile's groups at 8 bits
  const int tiles = ((n + 2 * GROUP - 2) / GROUP + span - 1) / span;  // 8-bit tiles, a <= 3
  int splits = n_variants < capacity ? capacity / n_variants : 1;
  splits = splits < tiles ? splits : tiles;
  splits = splits > 1 ? splits : 1;
  const bool fixup = LAYOUT == 2 && splits > 1;
  if (fixup) {
    cudaError_t err = cudaMemsetAsync(status, 0, sizeof(int32_t) * (size_t)n_variants, s);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned rows = (unsigned)(n_variants < MAX_GRID_Y ? n_variants : MAX_GRID_Y);
  kernel<<<dim3((unsigned)splits, rows), THREADS, smem, s>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths, n_variants, n,
      (float*)out, (int32_t*)status, splits);
  if (fixup)
    bgen_fixup_kernel<<<rows, THREADS, 0, s>>>((float*)out, (const int32_t*)status, n_variants, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bgen_decode_l2(const void* buf, const void* offsets, const void* lengths,
                              void* out, void* status, int n_variants, int n_samples,
                              void* stream) {
  return launch<2>(buf, offsets, lengths, out, status, n_variants, n_samples, stream);
}

extern "C" int bgen_decode_l1(const void* buf, const void* offsets, const void* lengths,
                              void* out, void* status, int n_variants, int n_samples,
                              void* stream) {
  return launch<1>(buf, offsets, lengths, out, status, n_variants, n_samples, stream);
}
