// K4: PLINK .bed rows decoded on the card; K5: per-SNP genotype counts.
//
// Replaces the JAX package's native host decoder,
//   dissect_tpu/native/bed_decode.cpp: dissect_decode_bed (:36) and
//   dissect_bed_counts (:59), an OpenMP lookup-table decode over SNP rows.
//
// Contract.  `packed` is (n_rows, n_bytes) uint8, the SNP-major .bed payload
// rows as stored: individual j of a row sits at bits 2 (j mod 4) and
// 2 (j mod 4) + 1 of byte floor(j / 4), and the 2-bit codes mean
//   0b00 -> 0, 0b01 -> missing (-1), 0b10 -> 1, 0b11 -> 2
// copies of allele 2 (parseSNPbyte, genotype.cpp:752-776).  `cols`, when
// given, is an int32 index of n_out source individuals (each < n_source):
// output column c decodes source individual cols[c], which is how a
// PlinkData filtered by individuals (any order, a subset) is read without
// a host copy.  Without it, n_out = n_source and column c is individual c.
// The codes past n_source in a row's last byte are never read.
//   K4 writes (n_rows, n_out) int8 dosages, -1 = missing.
//   K5 writes (n_rows, 4) int64 counts [missing, 0, 1, 2] over the n_out
//   output columns only (the kept individuals).
// `packed` and the output may start at any address (a row slice of a
// larger tensor is offset by whole rows, and rows need not be 4-byte
// aligned); the launchers read the real alignment and pick the widest
// loads and stores it allows.  There is no float anywhere and no atomic
// whose order could show: each output element has one writer.
//
// What bounds them on the H100: bytes.  At the main path's chunk (2,048 SNP
// rows, N = 10,000: 2,500 bytes a row) K4 reads 5.1 MB and writes 20.5 MB,
// 7.6 us at 3.35 TB/s; K5 on an 8,192-row block reads 20.5 MB, 6.2 us.  A
// first design (one thread per output byte, byte loads and stores) ran at
// the rate its load and store instructions issued, about 15% of that.
//
// Design: few instructions per byte, wide loads and stores.
//  K4, no index, N % 4 == 0 (the GRM path): output byte 4 i + k decodes
//   code k of input byte i over the whole flat (n_rows, n_bytes) buffer, so
//   it is one stream.  A warp takes runs of 128 packed 4-byte words, lane l
//   words l, l + 32, l + 64 and l + 96, and writes each word's 16 dosages
//   with one 16-byte store, so every load and store of the warp covers
//   consecutive addresses (a thread that loads 16 bytes and stores 64
//   writes with a 64-byte stride: each store of the warp then covers
//   every 32-byte sector only in halves).  A packed byte's four
//   codes are spread one to a nibble (shifts and masks) and
//   __byte_perm(0x0201FF00, 0, nibbles) maps them to their dosage bytes:
//   code 0 -> 0x00, 1 -> 0xFF, 2 -> 0x01, 3 -> 0x02.  The bytes before the
//   first 4-byte boundary of `packed` and after the last word go one thread
//   each; the store width (16, 4 or 1 bytes) follows the output's alignment.
//  K4, no index, N % 4 != 0: a row's last byte holds padding codes, so rows
//   stay apart: each thread writes one 4-byte word of a row, aligned in the
//   output, from the one or two packed bytes under it (`bed_rows_kernel`).
//  K4 with an index: the output columns are shared evenly among
//   ceil(n_out / 4,096) column tiles (3,000 columns each at n_out = 9,000;
//   with a small last tile, an SM whose resident blocks all held it idled);
//   a block owns a tile, 16 columns per thread, whose `cols` entries it
//   reads once (16-byte loads where aligned) and keeps in registers, and
//   walks its rows: each packed row is copied into shared memory by 16-byte
//   cp.async through a ring of STAGES buffers, so the next rows' copies fly
//   while this row's codes are gathered from shared memory (the first
//   rows' copies fly while the index is read).  A thread's columns go out
//   16, 8, 4 or 1 at a time, the widest that the output's base and row
//   stride allow (n_out = 9,000 rows are 8-byte aligned).  A random index
//   costs shared-memory bank conflicts; one in file order has few.  Rows
//   over STAGE_LIMIT bytes are gathered from global memory.
//  K5, no index: one warp per row, several rows per block, no shared memory
//   and no barrier.  The row is read by 16-byte loads (its head and tail up
//   to a 16-byte boundary by single bytes) and counted by bit planes: for a
//   word w, lo = w & 0x55555555 and hi = (w >> 1) & 0x55555555 hold each
//   code's low and high bit; popc(lo & hi) counts code 0b11, popc(hi & ~lo)
//   0b10, popc(lo & ~hi) 0b01, and the rest are 0b00.  The codes past N in
//   the last byte are masked off.  One warp reduction per row.
//  K5 with an index: the counts do not depend on the columns' order, so a
//   block first turns the index into a bit mask of the kept individuals in
//   shared memory (2 bits per source individual: 2.5 KB at N = 10,000, in
//   place of 36 KB of int32 indices; one block per SM builds it) and then
//   counts each row as without an index, with the mask in place of
//   0x55555555: by 4-byte loads, each matched by one conflict-free
//   shared-memory word.  An index that names an individual twice (found
//   while the mask is built) or a mask over MASK_LIMIT makes the block
//   gather codes through the index instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int INDEX_COUNT_THREADS = 1024;  // K5 with an index: one block per SM
constexpr int BLOCKS_PER_SM = 8;
constexpr int GATHER_BLOCKS_PER_SM = 4;  // resident at once: one wave, many rows each
constexpr int FLAT_RUN = 128;  // packed words a warp decodes at a time (K4, no index)
constexpr int GATHER_COLS = 16;                     // output columns a thread owns
constexpr int GATHER_THREADS = 256;
constexpr int GATHER_TILE = GATHER_THREADS * GATHER_COLS;  // a block's column tile
constexpr int MAX_GRID_Y = 65535;
constexpr int STAGES = 4;               // K4's ring of staged rows
constexpr int STAGE_LIMIT = 20 * 1024;  // a staged row buffer (N up to about 80,000)
constexpr int MASK_LIMIT = 192 * 1024;  // K5's index mask in shared memory
constexpr int DEFAULT_SMEM = 48 * 1024;  // dynamic shared memory without opting in
constexpr uint32_t DOSAGE_BYTES = 0x0201FF00u;  // byte k: the dosage of code k
constexpr uint32_t LO_BITS = 0x55555555u;       // each code's low bit

__device__ __forceinline__ int code_at(const uint8_t* row, int j) {
  return (row[j >> 2] >> (2 * (j & 3))) & 0x3;
}

// The four codes of the low byte of b, one per nibble of the low 16 bits.
__device__ __forceinline__ uint32_t nibbles8(uint32_t b) {
  b = (b | (b << 4)) & 0x0F0Fu;
  return (b | (b << 2)) & 0x3333u;
}

// Four codes, one per nibble, to their four dosage bytes.
__device__ __forceinline__ uint32_t dosages4(uint32_t nibbles) {
  return __byte_perm(DOSAGE_BYTES, 0, nibbles);
}

// One packed 32-bit word (16 genotypes) to its 16 dosage bytes.
__device__ __forceinline__ uint4 decode_word(uint32_t w) {
  uint32_t a = w & 0xFFFFu, b = w >> 16;  // two packed bytes each
  a = (a | (a << 8)) & 0x00FF00FFu;
  a = (a | (a << 4)) & 0x0F0F0F0Fu;
  a = (a | (a << 2)) & 0x33333333u;
  b = (b | (b << 8)) & 0x00FF00FFu;
  b = (b | (b << 4)) & 0x0F0F0F0Fu;
  b = (b | (b << 2)) & 0x33333333u;
  return make_uint4(dosages4(a), dosages4(a >> 16), dosages4(b), dosages4(b >> 16));
}

template <int STORE>  // 16, 4 or 1: the alignment of `o`
__device__ __forceinline__ void store16(uint8_t* o, uint4 v) {
  if constexpr (STORE == 16) {
    *reinterpret_cast<uint4*>(o) = v;
  } else if constexpr (STORE == 4) {
    uint32_t* w = reinterpret_cast<uint32_t*>(o);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else {
    const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = (uint8_t)(words[i >> 2] >> (8 * (i & 3)));
  }
}

template <int STORE>
__device__ __forceinline__ void store4(uint8_t* o, uint32_t v) {
  if constexpr (STORE >= 4) {
    *reinterpret_cast<uint32_t*>(o) = v;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) o[i] = (uint8_t)(v >> (8 * i));
  }
}

// ---------------------------------------------------------------- K4 -----
// The flat stream (no index, N % 4 == 0): bytes [0, head) of `packed` lie
// before its first 4-byte boundary; `out` + 4 head is STORE-aligned.  A
// warp takes runs of 128 packed words, lane l the words l, l + 32, l + 64,
// l + 96 of a run, so each load and each 16-byte store of the warp covers
// consecutive addresses.
template <int STORE>
__global__ void __launch_bounds__(THREADS)
bed_flat_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ out,
                long long total, int head) {
  const long long words = (total - head) >> 2;
  const long long done = head + (words << 2);
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long warps = ((long long)gridDim.x * THREADS) >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t* in = reinterpret_cast<const uint32_t*>(packed + head);
  uint8_t* o = out + 4 * (long long)head;
  for (long long run = (t0 >> 5) * FLAT_RUN; run < words; run += warps * FLAT_RUN) {
    if (run + FLAT_RUN <= words) {
      uint32_t w[FLAT_RUN / 32];
#pragma unroll
      for (int i = 0; i < FLAT_RUN / 32; ++i) w[i] = __ldg(in + run + lane + 32 * i);
#pragma unroll
      for (int i = 0; i < FLAT_RUN / 32; ++i)
        store16<STORE>(o + 16 * (run + lane + 32 * i), decode_word(w[i]));
    } else {
      for (long long k = run + lane; k < words; k += 32)
        store16<STORE>(o + 16 * k, decode_word(__ldg(in + k)));
    }
  }
  // the head and the tail: at most 3 bytes each, one thread a byte
  if (t0 < head + (total - done)) {
    const long long b = t0 < head ? t0 : done + (t0 - head);
    store4<STORE>(out + 4 * b, dosages4(nibbles8(packed[b])));
  }
}

// One row at a time (no index, N % 4 != 0): thread k of a row writes the
// output word of columns h + 4k .. h + 4k + 3, where the h < 4 head columns
// bring the row's output to a 4-byte boundary; thread `words` writes the
// head and tail columns byte by byte.
__global__ void __launch_bounds__(THREADS)
bed_rows_kernel(const uint8_t* __restrict__ packed, uint8_t* __restrict__ out, int n_rows,
                int n_bytes, int n) {
  const int k = blockIdx.x * THREADS + threadIdx.x;
  for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const uint8_t* p = packed + (size_t)r * (size_t)n_bytes;
    uint8_t* o = out + (size_t)r * (size_t)n;
    const int h = min(n, (int)((4 - ((uintptr_t)o & 3)) & 3));
    const int words = (n - h) >> 2;
    if (k < words) {
      const int c = h + 4 * k;  // c mod 4 == h: the word starts at bit 2 h of byte c / 4
      uint32_t bits = p[c >> 2];
      if (h) bits = (bits | ((uint32_t)p[(c >> 2) + 1] << 8)) >> (2 * h);
      *reinterpret_cast<uint32_t*>(o + c) = dosages4(nibbles8(bits & 0xFFu));
    } else if (k == words) {
      for (int c = 0; c < h; ++c) o[c] = (uint8_t)dosages4(code_at(p, c));
      for (int c = h + 4 * words; c < n; ++c) o[c] = (uint8_t)dosages4(code_at(p, c));
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Starts copying packed row `p` into `buf`, where buf[i] mirrors the byte at
// (p rounded down to 16) + i: every 16-byte word that holds a byte of the
// row, by cp.async, and commits them as one group (empty past the last row).
// The first and last words may hold bytes of the rows around it, or up to 15
// bytes past the tensor's ends; an aligned 16-byte word lies within one
// page, mapped wherever one of its bytes is, and those bytes are never read.
__device__ __forceinline__ void stage_row(const uint8_t* p, int n_bytes, uint8_t* buf) {
  if (p) {
    const uint8_t* first = reinterpret_cast<const uint8_t*>((uintptr_t)p & ~(uintptr_t)15);
    const int words = (int)((p + n_bytes - first + 15) >> 4);
    for (int k = threadIdx.x; k < words; k += blockDim.x) cp_async16(buf + 16 * k, first + 16 * k);
  }
  cp_async_commit();
}

// The gather of one row (an index) into the block's columns [tile, end):
// W consecutive output columns per group, GATHER_COLS / W groups per
// thread, group g of thread t at columns tile + (g GATHER_THREADS + t) W
// onwards, whose source individuals are j[g W ..].  Source individual jk
// sits at bits 2 (jk mod 4) of row byte jk / 4, so ((byte << 16) >> (2 (jk
// mod 4) + 16 - 4 e)) & (3 << 4 e) puts its code in nibble e of a word.
template <int W>
__device__ __forceinline__ void gather_row(const uint8_t* row, uint8_t* o,
                                           const int (&j)[GATHER_COLS], int tile, int end) {
  constexpr int GROUPS = GATHER_COLS / W;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int c0 = tile + (g * GATHER_THREADS + (int)threadIdx.x) * W;
    if (c0 >= end) break;
    uint32_t words[(W + 3) / 4];
#pragma unroll
    for (int q = 0; q < (W + 3) / 4; ++q) {
      uint32_t nib = 0;
#pragma unroll
      for (int e = 0; e < (W < 4 ? W : 4); ++e) {
        const int jk = j[g * W + 4 * q + e];
        nib |= (((uint32_t)row[jk >> 2] << 16) >> (2 * (jk & 3) + 16 - 4 * e)) & (0x3u << (4 * e));
      }
      words[q] = dosages4(nib);
    }
    if constexpr (W == 16) {
      *reinterpret_cast<uint4*>(o + c0) = make_uint4(words[0], words[1], words[2], words[3]);
    } else if constexpr (W == 8) {
      *reinterpret_cast<uint2*>(o + c0) = make_uint2(words[0], words[1]);
    } else if constexpr (W == 4) {
      *reinterpret_cast<uint32_t*>(o + c0) = words[0];
    } else {
      o[c0] = (uint8_t)words[0];
    }
  }
}

// K4 with an index: a block owns the columns [x tile_cols, (x + 1) tile_cols)
// of x = blockIdx.x (tile_cols <= GATHER_TILE, a multiple of W: the tiles
// share the columns evenly) and walks rows blockIdx.y, blockIdx.y +
// gridDim.y, ...  STAGED: rows go through a ring of STAGES shared-memory
// buffers of buf_bytes each.
template <int W, bool STAGED>
__global__ void __launch_bounds__(GATHER_THREADS)
bed_gather_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ cols,
                  uint8_t* __restrict__ out, int n_rows, int n_bytes, int n_out, int tile_cols,
                  int buf_bytes) {
  extern __shared__ __align__(16) uint8_t smem[];
  constexpr int GROUPS = GATHER_COLS / W;
  const int t = threadIdx.x;
  const int tile = blockIdx.x * tile_cols;
  const int end = min(n_out, tile + tile_cols);
  const int stride = gridDim.y;
  int r = blockIdx.y;
  auto row_at = [&](int rr) {
    return rr < n_rows ? packed + (size_t)rr * (size_t)n_bytes : nullptr;
  };
  if constexpr (STAGED) {  // the first rows' copies fly while the index is read
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      stage_row(row_at(r + s * stride), n_bytes, smem + s * buf_bytes);
  }
  int j[GATHER_COLS];  // the index entries of this thread's columns, for all its rows
  const bool cols16 = ((uintptr_t)cols & 15) == 0;
#pragma unroll
  for (int g = 0; g < GROUPS; ++g) {
    const int c0 = tile + (g * GATHER_THREADS + t) * W;  // end % W == 0: a group is all in or out
    if constexpr (W >= 4) {
      if (cols16) {  // c0 % 4 == 0: 16-byte loads
#pragma unroll
        for (int e = 0; e < W; e += 4) {
          const int4 v = c0 < end ? __ldg(reinterpret_cast<const int4*>(cols + c0 + e))
                                  : make_int4(0, 0, 0, 0);
          j[g * W + e] = v.x;
          j[g * W + e + 1] = v.y;
          j[g * W + e + 2] = v.z;
          j[g * W + e + 3] = v.w;
        }
        continue;
      }
    }
#pragma unroll
    for (int e = 0; e < W; ++e) j[g * W + e] = c0 < end ? __ldg(cols + c0 + e) : 0;
  }

  if constexpr (!STAGED) {
    for (; r < n_rows; r += stride)
      gather_row<W>(row_at(r), out + (size_t)r * (size_t)n_out, j, tile, end);
  } else {
    // a ring of STAGES row buffers, STAGES - 1 rows in flight ahead of the
    // gather; one barrier a row: after it, every thread is done with the
    // buffer the row before used, which the next copy refills
    for (int i = 0; r < n_rows; r += stride, ++i) {
      cp_async_wait<STAGES - 2>();  // row r's group has landed
      __syncthreads();
      stage_row(row_at(r + (STAGES - 1) * stride), n_bytes,
                smem + ((i + STAGES - 1) % STAGES) * buf_bytes);
      const uintptr_t p = (uintptr_t)row_at(r);
      gather_row<W>(smem + (i % STAGES) * buf_bytes + (p & 15), out + (size_t)r * (size_t)n_out,
                    j, tile, end);
    }
  }
}

// ---------------------------------------------------------------- K5 -----
// Adds the codes 0b01, 0b10 and 0b11 of the 2-bit fields of w that `m`
// keeps (m holds each kept field's low bit) to c[0], c[1], c[2].
__device__ __forceinline__ void tally(uint32_t w, uint32_t m, uint32_t (&c)[3]) {
  const uint32_t lo = w & m, hi = (w >> 1) & m, both = lo & hi;
  c[0] += __popc(lo ^ both);  // lo & ~hi: 0b01, missing
  c[1] += __popc(hi ^ both);  // hi & ~lo: 0b10, one copy
  c[2] += __popc(both);       // 0b11, two copies
}

__device__ __forceinline__ void tally16(uint4 v, uint32_t (&c)[3]) {
  tally(v.x, LO_BITS, c);
  tally(v.y, LO_BITS, c);
  tally(v.z, LO_BITS, c);
  tally(v.w, LO_BITS, c);
}

// The warp's sums, as [missing, 0, 1, 2] over n_counted codes, by lane 0.
__device__ __forceinline__ void write_counts(long long* counts, int r, const uint32_t (&c)[3],
                                             int n_counted, int lane) {
  const unsigned miss = __reduce_add_sync(0xffffffffu, c[0]);
  const unsigned one = __reduce_add_sync(0xffffffffu, c[1]);
  const unsigned two = __reduce_add_sync(0xffffffffu, c[2]);
  if (lane == 0) {
    longlong2* o = reinterpret_cast<longlong2*>(counts + 4 * (size_t)r);
    o[0] = make_longlong2((long long)miss,
                          (long long)n_counted - (long long)miss - (long long)one - (long long)two);
    o[1] = make_longlong2((long long)one, (long long)two);
  }
}

// No index: a warp per row.  Bytes [0, full) count whole; of byte `full`
// only the first n_source % 4 codes.
__global__ void __launch_bounds__(THREADS)
bed_counts_kernel(const uint8_t* __restrict__ packed, long long* __restrict__ counts,
                  int n_rows, int n_bytes, int n_source) {
  const int lane = threadIdx.x & 31;
  const int full = n_source >> 2, rem = n_source & 3;
  const int warps = gridDim.x * (THREADS / 32);
  for (int r = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5); r < n_rows; r += warps) {
    const uint8_t* p = packed + (size_t)r * (size_t)n_bytes;
    uint32_t c[3] = {0u, 0u, 0u};
    const int head = min(full, (int)((16 - ((uintptr_t)p & 15)) & 15));
    const int chunks = (full - head) >> 4;
    const int done = head + (chunks << 4);
    if (lane < head) tally(p[lane], LO_BITS, c);
    if (lane < full - done) tally(p[done + lane], LO_BITS, c);
    if (rem && lane == 31) tally(p[full], LO_BITS & ((1u << (2 * rem)) - 1u), c);
    const uint4* q = reinterpret_cast<const uint4*>(p + head);
    int k = lane;
    for (; k + 96 < chunks; k += 128) {  // four loads in flight per lane
      const uint4 v0 = __ldg(q + k), v1 = __ldg(q + k + 32);
      const uint4 v2 = __ldg(q + k + 64), v3 = __ldg(q + k + 96);
      tally16(v0, c);
      tally16(v1, c);
      tally16(v2, c);
      tally16(v3, c);
    }
    for (; k < chunks; k += 32) tally16(__ldg(q + k), c);
    write_counts(counts, r, c, n_source, lane);
  }
}

// With an index.  mask_words > 0: build the kept-individual mask (bit
// 2 (j mod 16) of word j / 16 for individual j) in shared memory, then count
// through it; mask_words == 0, or an individual named twice: gather.
__global__ void __launch_bounds__(INDEX_COUNT_THREADS)
bed_counts_index_kernel(const uint8_t* __restrict__ packed, const int32_t* __restrict__ cols,
                        long long* __restrict__ counts, int n_rows, int n_bytes, int n_out,
                        int mask_words) {
  extern __shared__ __align__(16) uint32_t mask[];
  __shared__ int repeated;
  const int lane = threadIdx.x & 31;
  bool by_mask = mask_words > 0;
  if (by_mask) {
    for (int w = threadIdx.x; w < mask_words; w += blockDim.x) mask[w] = 0u;
    if (threadIdx.x == 0) repeated = 0;
    __syncthreads();
    bool twice = false;  // OR: any order, one result
    if (((uintptr_t)cols & 15) == 0) {  // 16-byte loads of the index
      for (int i = 4 * threadIdx.x; i < n_out; i += 4 * blockDim.x) {
        int j[4];
        if (i + 4 <= n_out) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(cols + i));
          j[0] = v.x, j[1] = v.y, j[2] = v.z, j[3] = v.w;
        } else {
          for (int e = 0; e < 4; ++e) j[e] = i + e < n_out ? __ldg(cols + i + e) : -1;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (j[e] < 0) continue;
          const uint32_t bit = 1u << (2 * (j[e] & 15));
          twice |= (atomicOr(&mask[j[e] >> 4], bit) & bit) != 0;
        }
      }
    } else {
      for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
        const int j = __ldg(cols + i);
        const uint32_t bit = 1u << (2 * (j & 15));
        twice |= (atomicOr(&mask[j >> 4], bit) & bit) != 0;
      }
    }
    if (twice) repeated = 1;
    __syncthreads();
    by_mask = !repeated;
  }
  const uint8_t* mask_bytes = reinterpret_cast<const uint8_t*>(mask);
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int r = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5); r < n_rows; r += warps) {
    const uint8_t* p = packed + (size_t)r * (size_t)n_bytes;
    uint32_t c[3] = {0u, 0u, 0u};
    if (by_mask) {
      // 4-byte loads from the row's first 4-byte boundary: word k holds row
      // bytes head + 4k .. head + 4k + 3, whose mask the funnel shift cuts
      // from mask words k and k + 1 (the mask has a word of padding)
      const int head = min(n_bytes, (int)((4 - ((uintptr_t)p & 3)) & 3));
      const int words = (n_bytes - head) >> 2;
      const int done = head + (words << 2);
      const int shift = 8 * head;
      if (lane < head) tally(p[lane], mask_bytes[lane], c);
      if (lane < n_bytes - done) tally(p[done + lane], mask_bytes[done + lane], c);
      const uint32_t* q = reinterpret_cast<const uint32_t*>(p + head);
      int k = lane;
      for (; k + 96 < words; k += 128) {
        const uint32_t w0 = __ldg(q + k), w1 = __ldg(q + k + 32);
        const uint32_t w2 = __ldg(q + k + 64), w3 = __ldg(q + k + 96);
        tally(w0, __funnelshift_r(mask[k], mask[k + 1], shift), c);
        tally(w1, __funnelshift_r(mask[k + 32], mask[k + 33], shift), c);
        tally(w2, __funnelshift_r(mask[k + 64], mask[k + 65], shift), c);
        tally(w3, __funnelshift_r(mask[k + 96], mask[k + 97], shift), c);
      }
      for (; k < words; k += 32)
        tally(__ldg(q + k), __funnelshift_r(mask[k], mask[k + 1], shift), c);
    } else {
      for (int i = lane; i < n_out; i += 32) {
        const int code = code_at(p, __ldg(cols + i));
        c[0] += code == 1;
        c[1] += code == 2;
        c[2] += code == 3;
      }
    }
    write_counts(counts, r, c, n_out, lane);
  }
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 132;
}

// Lets `kernel` take `bytes` of dynamic shared memory (past 48 KB it must ask).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= (size_t)DEFAULT_SMEM) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int W, bool STAGED>
int launch_gather(const uint8_t* packed, const int32_t* cols, uint8_t* out, int n_rows,
                  int n_bytes, int n_out, int buf_bytes, cudaStream_t stream) {
  const int tiles = (n_out + GATHER_TILE - 1) / GATHER_TILE;
  const int tile_cols = ((n_out + tiles - 1) / tiles + W - 1) / W * W;
  int rows = sm_count() * GATHER_BLOCKS_PER_SM / tiles;
  rows = rows < 1 ? 1 : rows;
  rows = rows < n_rows ? rows : n_rows;
  rows = rows < MAX_GRID_Y ? rows : MAX_GRID_Y;
  const size_t smem = STAGED ? STAGES * (size_t)buf_bytes : 0;
  auto kernel = bed_gather_kernel<W, STAGED>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)tiles, (unsigned)rows), GATHER_THREADS, smem, stream>>>(
      packed, cols, out, n_rows, n_bytes, n_out, tile_cols, buf_bytes);
  return (int)cudaGetLastError();
}

template <bool STAGED>
int gather_by_width(const uint8_t* packed, const int32_t* cols, uint8_t* out, int n_rows,
                    int n_bytes, int n_out, int buf_bytes, cudaStream_t stream) {
  // every row start is W-aligned: the output's base and its row stride
  const uintptr_t o = (uintptr_t)out;
  if (o % 16 == 0 && n_out % 16 == 0)
    return launch_gather<16, STAGED>(packed, cols, out, n_rows, n_bytes, n_out, buf_bytes, stream);
  if (o % 8 == 0 && n_out % 8 == 0)
    return launch_gather<8, STAGED>(packed, cols, out, n_rows, n_bytes, n_out, buf_bytes, stream);
  if (o % 4 == 0 && n_out % 4 == 0)
    return launch_gather<4, STAGED>(packed, cols, out, n_rows, n_bytes, n_out, buf_bytes, stream);
  return launch_gather<1, STAGED>(packed, cols, out, n_rows, n_bytes, n_out, buf_bytes, stream);
}

template <int STORE>
int launch_flat(const uint8_t* packed, uint8_t* out, long long total, int head,
                cudaStream_t stream) {
  const long long runs = (((total - head) >> 2) + FLAT_RUN - 1) / FLAT_RUN;
  long long blocks = (runs + THREADS / 32 - 1) / (THREADS / 32);
  const long long cap = (long long)sm_count() * BLOCKS_PER_SM;
  blocks = blocks < cap ? blocks : cap;
  blocks = blocks < 1 ? 1 : blocks;  // the head and tail bytes need a thread each
  bed_flat_kernel<STORE><<<(unsigned)blocks, THREADS, 0, stream>>>(packed, out, total, head);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bed_decode(const void* packed, const void* cols, void* out, int n_rows,
                          int n_bytes, int n_out, void* stream) {
  if (n_rows == 0 || n_out == 0) return 0;
  const uint8_t* in = (const uint8_t*)packed;
  uint8_t* o = (uint8_t*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (cols) {
    const int buf_bytes = (n_bytes + 15 + 15) & ~15;  // a row and its offset from 16
    if (buf_bytes <= STAGE_LIMIT)
      return gather_by_width<true>(in, (const int32_t*)cols, o, n_rows, n_bytes, n_out,
                                   buf_bytes, s);
    return gather_by_width<false>(in, (const int32_t*)cols, o, n_rows, n_bytes, n_out, 0, s);
  }
  if (n_out % 4 == 0) {  // n_bytes == n_out / 4: one flat stream
    const long long total = (long long)n_rows * (long long)n_bytes;
    const long long to_boundary = (4 - ((uintptr_t)in & 3)) & 3;
    const int head = (int)(to_boundary < total ? to_boundary : total);
    const uintptr_t body = (uintptr_t)(o + 4 * (long long)head);
    if (body % 16 == 0) return launch_flat<16>(in, o, total, head, s);
    if ((uintptr_t)o % 4 == 0) return launch_flat<4>(in, o, total, head, s);
    return launch_flat<1>(in, o, total, head, s);
  }
  const dim3 grid((unsigned)(((n_out >> 2) + 1 + THREADS - 1) / THREADS),
                  (unsigned)(n_rows < MAX_GRID_Y ? n_rows : MAX_GRID_Y));
  bed_rows_kernel<<<grid, THREADS, 0, s>>>(in, o, n_rows, n_bytes, n_out);
  return (int)cudaGetLastError();
}

extern "C" int bed_counts(const void* packed, const void* cols, void* counts, int n_rows,
                          int n_bytes, int n_source, int n_out, void* stream) {
  if (n_rows == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int sms = sm_count();
  if (!cols) {
    const int per_block = THREADS / 32;
    int blocks = (n_rows + per_block - 1) / per_block;
    blocks = blocks < sms * BLOCKS_PER_SM ? blocks : sms * BLOCKS_PER_SM;
    bed_counts_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
        (const uint8_t*)packed, (long long*)counts, n_rows, n_bytes, n_source);
    return (int)cudaGetLastError();
  }
  const int mask_words = n_bytes / 4 + 2;  // the row's words and one of padding
  const size_t mask_bytes = 4 * (size_t)mask_words;
  const bool by_mask = mask_bytes <= (size_t)MASK_LIMIT;
  const size_t smem = by_mask ? mask_bytes : 0;
  cudaError_t err = allow_smem(bed_counts_index_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = INDEX_COUNT_THREADS / 32;
  int blocks = (n_rows + per_block - 1) / per_block;
  blocks = blocks < sms ? blocks : sms;
  bed_counts_index_kernel<<<(unsigned)blocks, INDEX_COUNT_THREADS, smem, s>>>(
      (const uint8_t*)packed, (const int32_t*)cols, (long long*)counts, n_rows, n_bytes, n_out,
      by_mask ? mask_words : 0);
  return (int)cudaGetLastError();
}
