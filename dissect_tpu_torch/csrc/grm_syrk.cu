// K1: fused int8 standardize + triangle-only dual syrk, one streaming-GRM step.
//
// Replaces: grm_fused_triangle_update / _grm_fused_kernel,
//   dissect_tpu/linalg/pallas_syrk.py:155-290 (pl.pallas_call at :268).
//
// Contract (kept from the TPU kernel): an (m, n) int8 dosage chunk with
// -1 = missing and per-SNP mean / inv_std; z = obs * (d - mean) * inv_std
// with obs = [d >= 0].  The lower-triangle BN x BN tiles of Z^T Z and of
// O^T O are ADDED IN PLACE to two packed (T*BN, BN) float32 buffers, tile t
// holding output tile (i, j), j <= i, in the order (0,0), (1,0), (1,1),
// (2,0), ... (pallas_syrk._pair_maps).  Diagonal tiles are stored whole.
//
// What bounds it on the H100: float32 FMAs for Z^T Z.  Products stay IEEE
// float32 on the CUDA cores (no TF32: the GRM is held to rtol 1e-6).  The
// count product O^T O is exact in integers (0/1 products, int32 sums), so
// it runs on the int8 tensor cores (mma.sync m16n8k32 s8), some 30x the
// float32 FMA rate; its int32 sums are added to the float32 counts buffer,
// exact below 2^24 as before.
//
// Design.  The launch geometry is a work list made by the wrapper
// (linalg/grm_kernels.py `grm_work_items`): one item per 128 x 128
// sub-tile of a packed tile and per product, so a block computes EITHER
// the Z^T Z sub-tile on the FMA pipes (role 0) OR the O^T O sub-tile on the
// tensor cores (role 1).  Each role keeps one 64-register accumulator set,
// so two blocks fit per SM (a block doing both holds both sets, one block
// per SM, and was slower on the H100).  The Z^T Z items come first: they
// are the long ones.
// Sub-tiles wholly past N are not listed (they would add zeros); on a
// diagonal tile the strict upper sub-tiles are not listed either: the
// block of the mirror sub-tile also adds its transpose there.  Each output
// element is then added by exactly one thread of one block: no atomics.
// A Z^T Z block adds its 8 x 8 register tiles to the packed tile with
// float4 read-modify-writes (scalar ones at ragged edges and for a mirror's
// transpose); a count block's MMA fragments are scattered, so it copies them
// to shared memory and adds them along the packed tile's rows.  With this
// epilogue the main path's instantiation (VEC) does not spill at 128
// registers (-Xptxas -v).
//
// Both roles stream the chunk 32 SNP rows per stage through a ring of four
// shared-memory stages (three in flight while one is converted), and
// convert each stage once into a double-buffered operand, so one barrier
// per stage suffices.
//   role 0: the int8 rows of both column ranges (2 x 128 bytes) arrive by
//      16-byte cp.async, the stage's mean and inv_std by 4-byte cp.async;
//      z is converted to float32 without int-to-float instructions
//      (exponent trick), [row][column]; each of the 256 threads keeps an
//      8 x 8 micro-tile, 4 float4 shared loads feed 64 FMAs.
//   role 1: int8 MMA takes both operands K-major (SNP rows contiguous per
//      column), and ldmatrix.trans is 16-bit only.  So a first kernel packs
//      the observed mask once per call, transposed: one 32-bit word per
//      column and 32 rows (mask_bits_kernel).  A count block stages 1 KB
//      of these words per stage instead of 8 KB of bytes (the bytes every
//      block re-read from L2 bounded this role), and expands each word to
//      the 0/1 bytes of its column with a multiply; each warp owns a
//      32 x 64 region of the sub-tile, 16 MMAs per stage, in int32
//      fragments.
// Out-of-range rows and columns (the chunk's last rows, the ragged N edge,
// N % BN) are masked as missing at conversion, so the host never pads.
// Shapes whose rows are not 16-byte aligned (n % 16 != 0, BN % 16 != 0)
// stage with byte loads instead of cp.async (not a main-path shape).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;        // output sub-tile edge
constexpr int BK = 32;         // SNP rows per stage (one k32 MMA step)
constexpr int THREADS = 256;   // 8 warps
constexpr int RING = 4;        // raw stages
constexpr int ROW_BYTES = 2 * TS;  // one staged row: side i | side j

struct Ring {
  uint8_t raw[RING][BK][ROW_BYTES];  // 16-byte chunks XOR-swizzled by row / 4
  float mean[RING][BK];
  float istd[RING][BK];
};

struct SmemZ {  // role 0
  Ring ring;
  float z[2][BK][2 * TS];
};

struct SmemO {  // role 1
  uint32_t bits[RING][2 * TS];       // one 32-row mask word per column
  uint32_t mask[2][2 * TS][BK / 4];  // word (col, kw) swizzled
};

// The epilogue's copy of a block's 128 x 128 result, over the stage buffers
// once they are dead.  Rows are padded by one float, so a warp reading down
// a column (the mirror's transpose) hits 32 banks.
struct SmemOut {
  float c[TS][TS + 1];
};

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int SMEM_BYTES = cmax(cmax(sizeof(SmemZ), sizeof(SmemO)), sizeof(SmemOut));

struct Work {
  int t, ti, tj, a0, b0, role, mirror, pad;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// byte offset of word cw (0..63) of staged row `row`
__device__ __forceinline__ int raw_offset(int row, int cw) {
  return (((cw >> 2) ^ ((row >> 2) & 7)) << 4) + ((cw & 3) << 2);
}

// word index of mask (col, kw): conflict-free for the MMA fragment loads
__device__ __forceinline__ int mask_word(int col, int kw) {
  return col * (BK / 4) + (kw ^ (((col >> 2) & 1) << 2));
}

struct Chunk {
  const int8_t* dosage;
  const float* mean;
  const float* istd;
  int m, n, block_n;
  int ci0, cj0;   // individual index of each side's first column
  int a0, b0;     // local offsets of the sub-tile in its packed tile

  // Bitmask (bit b) of the valid columns among bytes 4cw..4cw+3.
  __device__ unsigned col_valid(int cw) const {
    const int side = cw >> 5;
    const int col = (cw & 31) * 4;
    const int loc = (side ? b0 : a0) + col;
    const int glob = (side ? cj0 : ci0) + col;
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (loc + b < block_n && glob + b < n) v |= 1u << b;
    return v;
  }

  // Issue the copies of stage s into ring slot s % RING (one commit group).
  // VEC: rows and tile edges are 16-byte aligned (cp.async staging).
  template <bool VEC>
  __device__ void load(Ring& ring, int s, int stages) const {
    if (s < stages) {
      const int slot = s % RING;
      const int k0 = s * BK;
      const int tid = threadIdx.x;
      if constexpr (VEC) {
#pragma unroll
        for (int l = 0; l < 2; ++l) {
          const int e = tid + THREADS * l;
          const int row = e >> 4, ch = e & 15;
          const int side = ch >> 3;
          const int col = (ch & 7) * 16;
          const int loc = (side ? b0 : a0) + col;
          const int glob = (side ? cj0 : ci0) + col;
          const int r = k0 + row;
          // n and BN are multiples of 16 here: a chunk is wholly in or out
          if (r < m && loc < block_n && glob < n)
            cp_async16(&ring.raw[slot][row][(ch ^ ((row >> 2) & 7)) << 4],
                       dosage + (size_t)r * (size_t)n + glob);
        }
      } else {
#pragma unroll
        for (int l = 0; l < 8; ++l) {
          const int w = tid + THREADS * l;
          const int row = w >> 6, cw = w & 63;
          const int side = cw >> 5;
          const int col = (cw & 31) * 4;
          const int loc = (side ? b0 : a0) + col;
          const int glob = (side ? cj0 : ci0) + col;
          const int r = k0 + row;
          uint32_t word = 0xffffffffu;  // missing
          if (r < m) {
            const int8_t* src = dosage + (size_t)r * (size_t)n + glob;
#pragma unroll
            for (int b = 0; b < 4; ++b)
              if (loc + b < block_n && glob + b < n) {
                word &= ~(0xffu << (8 * b));
                word |= ((uint32_t)(uint8_t)src[b]) << (8 * b);
              }
          }
          *reinterpret_cast<uint32_t*>(&ring.raw[slot][row][raw_offset(row, cw)]) = word;
        }
      }
      if (tid < 2 * BK) {
        const int row = tid % BK;
        if (k0 + row < m) {
          if (tid < BK) cp_async4(&ring.mean[slot][row], mean + k0 + row);
          else cp_async4(&ring.istd[slot][row], istd + k0 + row);
        }
      }
    }
    cp_async_commit();
  }
};

// ------------------------------------------------------------------- Z ----
// Bytes of invalid columns (bit b of cvalid clear) read as missing.
__device__ __forceinline__ uint32_t invalid_bytes(unsigned cvalid) {
  uint32_t v = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b)
    if (!((cvalid >> b) & 1u)) v |= 0xffu << (8 * b);
  return v;
}

// Stage s (slot s % RING) -> z[buf], standardized float32.  Thread: word
// cw = tid % 64 of rows tid / 64 + 4 l.  float(d) = bits(1.5 2^23 + d) -
// 1.5 2^23 exactly, with no int-to-float conversion (a slower pipe).
__device__ __forceinline__ void convert_z(SmemZ& sm, const Chunk& ck, int s, int stages,
                                          uint32_t invalid) {
  if (s >= stages) return;
  const int slot = s % RING, buf = s & 1;
  const int cw = threadIdx.x & 63;
  const int k0 = s * BK;
#pragma unroll
  for (int l = 0; l < BK / 4; ++l) {
    const int row = (threadIdx.x >> 6) + 4 * l;
    uint32_t word =
        *reinterpret_cast<const uint32_t*>(&sm.ring.raw[slot][row][raw_offset(row, cw)]);
    word |= k0 + row < ck.m ? invalid : 0xffffffffu;
    const float mu = sm.ring.mean[slot][row];
    const float is = sm.ring.istd[slot][row];
    float z[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int d = (int)(word << (24 - 8 * b)) >> 24;  // byte b, sign-extended
      const float fd = __int_as_float(0x4b400000 + d) - 12582912.0f;
      z[b] = d >= 0 ? (fd - mu) * is : 0.0f;
    }
    *reinterpret_cast<float4*>(&sm.z[buf][row][4 * cw]) = make_float4(z[0], z[1], z[2], z[3]);
  }
}

__device__ __forceinline__ void compute_z(const SmemZ& sm, int buf, float (&acc)[8][8]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const float(*zs)[2 * TS] = sm.z[buf];
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a_lo = *reinterpret_cast<const float4*>(&zs[kk][ty * 4]);
    const float4 a_hi = *reinterpret_cast<const float4*>(&zs[kk][64 + ty * 4]);
    const float4 b_lo = *reinterpret_cast<const float4*>(&zs[kk][TS + tx * 4]);
    const float4 b_hi = *reinterpret_cast<const float4*>(&zs[kk][TS + 64 + tx * 4]);
    const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
    const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
}

// ------------------------------------------------------------------- O ----
// The observed mask, packed: bits[w * n + c] holds bit j = [row 32 w + j
// of column c is observed] (0 past m).  One thread per column and word;
// the warp's byte loads of one row are contiguous.
__global__ void mask_bits_kernel(const int8_t* __restrict__ dosage, uint32_t* __restrict__ bits,
                                 int m, int n) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n) return;
  const int r0 = blockIdx.y * 32;
  uint32_t w = 0;
  for (int j = 0; j < 32 && r0 + j < m; ++j)
    w |= (uint32_t)(dosage[(size_t)(r0 + j) * n + c] >= 0) << j;
  bits[(size_t)blockIdx.y * n + c] = w;
}

// Stage s: column t's mask word (thread t = column t of side i | side j).
__device__ __forceinline__ void load_bits(SmemO& sm, const Chunk& ck, const uint32_t* bits,
                                          int s, int stages, bool col_ok, int glob) {
  if (s < stages && col_ok)
    cp_async4(&sm.bits[s % RING][threadIdx.x], bits + (size_t)s * ck.n + glob);
  cp_async_commit();
}

// Stage s -> mask[buf]: column t's word expanded to 8 words of 4 bytes
// 0/1, byte j of word kw = bit 4 kw + j (a nibble times 0x00204081 puts
// its bits 8 apart), written as two float4-sized halves.
__device__ __forceinline__ void expand_mask(SmemO& sm, int s, int stages, bool col_ok) {
  if (s >= stages) return;
  const int col = threadIdx.x;
  const uint32_t w = col_ok ? sm.bits[s % RING][col] : 0u;
  uint32_t v[8];
#pragma unroll
  for (int kw = 0; kw < 8; ++kw) v[kw] = (((w >> (4 * kw)) & 0xfu) * 0x00204081u) & 0x01010101u;
  uint4* dst = reinterpret_cast<uint4*>(&sm.mask[s & 1][col][0]);
  const int swap = (col >> 2) & 1;  // mask_word's swizzle swaps the halves
  dst[swap] = make_uint4(v[0], v[1], v[2], v[3]);
  dst[1 - swap] = make_uint4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Warp w owns rows 32 (w % 4) .. + 32 and columns 64 (w / 4) .. + 64 of the
// sub-tile: 2 x 8 MMA tiles of 16 x 8.
__device__ __forceinline__ void compute_mask(const SmemO& sm, int buf, int (&acc)[2][8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t* mk = sm.mask[buf][0];
  uint32_t a[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int row = (warp & 3) * 32 + mt * 16 + g;
    a[mt][0] = mk[mask_word(row, t)];
    a[mt][1] = mk[mask_word(row + 8, t)];
    a[mt][2] = mk[mask_word(row, t + 4)];
    a[mt][3] = mk[mask_word(row + 8, t + 4)];
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = TS + (warp >> 2) * 64 + nt * 8 + g;
    const uint32_t b0 = mk[mask_word(col, t)];
    const uint32_t b1 = mk[mask_word(col, t + 4)];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      mma_s8(acc[mt][nt], a[mt][0], a[mt][1], a[mt][2], a[mt][3], b0, b1);
  }
}

// Adds the staged result to packed tile w.t of `out`: entry (i, j) at
// (a0 + i, b0 + j), and for a mirror item also at (b0 + j, a0 + i).  A
// warp's 32 threads run along one row of the packed tile in both passes.
// Offsets within a tile are ints (BN^2 < 2^31), here and in the Z^T Z
// epilogue.
__device__ __forceinline__ void add_staged(const SmemOut& so, float* out, const Work& w,
                                           int block_n) {
  float* tile = out + (size_t)w.t * block_n * block_n;
#pragma unroll 4
  for (int e = threadIdx.x; e < TS * TS; e += THREADS) {
    const int i = e / TS, j = e % TS;
    if (w.a0 + i < block_n && w.b0 + j < block_n)
      tile[(w.a0 + i) * block_n + w.b0 + j] += so.c[i][j];
  }
  if (w.mirror) {  // the transpose: entry (j, i) goes to row b0 + i, column a0 + j
#pragma unroll 4
    for (int e = threadIdx.x; e < TS * TS; e += THREADS) {
      const int i = e / TS, j = e % TS;
      if (w.a0 + j < block_n && w.b0 + i < block_n)
        tile[(w.b0 + i) * block_n + w.a0 + j] += so.c[j][i];
    }
  }
}

// One instantiation per staging, so the main path's kernel carries none of
// the byte path's registers.  VEC: 16-byte cp.async staging and float4 adds
// to a 16-byte aligned kernel buffer.
template <bool VEC>
__global__ void __launch_bounds__(THREADS, 2) grm_fused_kernel(
    const int8_t* __restrict__ dosage, const float* __restrict__ mean,
    const float* __restrict__ inv_std, float* __restrict__ kern, float* __restrict__ cnt,
    const uint32_t* __restrict__ bits, const Work* __restrict__ work, int m, int n,
    int block_n, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Work w = work[blockIdx.x];

  Chunk ck;
  ck.dosage = dosage;
  ck.mean = mean;
  ck.istd = inv_std;
  ck.m = m;
  ck.n = n;
  ck.block_n = block_n;
  ck.a0 = w.a0;
  ck.b0 = w.b0;
  ck.ci0 = w.ti * block_n + w.a0;
  ck.cj0 = w.tj * block_n + w.b0;

  if (w.role == 0) {
    SmemZ& sm = *reinterpret_cast<SmemZ*>(smem_raw);
#pragma unroll
    for (int s = 0; s < RING; ++s) ck.load<VEC>(sm.ring, s, stages);
    const uint32_t invalid = invalid_bytes(ck.col_valid(threadIdx.x & 63));
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
    }
    cp_async_wait<RING - 1>();
    __syncthreads();
    convert_z(sm, ck, 0, stages, invalid);
    for (int s = 0; s < stages; ++s) {
      cp_async_wait<RING - 2>();            // stage s + 1 has landed
      __syncthreads();                        // ... for all; buffer s & 1 is converted
      ck.load<VEC>(sm.ring, s + RING, stages);  // into the slot stage s left
      convert_z(sm, ck, s + 1, stages, invalid);
      compute_z(sm, s & 1, acc);
    }
    // this thread's tile: rows ty*4 + (0..3) and 64 + ty*4 + (0..3), columns
    // tx*4 + (0..3) and 64 + tx*4 + (0..3) of the sub-tile
    const int tx = threadIdx.x % 16;
    const int ty = threadIdx.x / 16;
    float* tile = kern + (size_t)w.t * block_n * block_n;
    const bool vec4 = VEC && (block_n & 3) == 0;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int a = w.a0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int b = w.b0 + h * 64 + tx * 4;
        if (a < block_n) {
          if (vec4 && b + 3 < block_n) {
            float4* q = reinterpret_cast<float4*>(tile + a * block_n + b);
            float4 v = *q;
            v.x += acc[r][4 * h];
            v.y += acc[r][4 * h + 1];
            v.z += acc[r][4 * h + 2];
            v.w += acc[r][4 * h + 3];
            *q = v;
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (b + c < block_n) tile[a * block_n + b + c] += acc[r][4 * h + c];
          }
        }
      }
    }
    if (w.mirror) {  // the transpose, at (b, a)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int a = w.a0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int b = w.b0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + (c - 4));
          if (a < block_n && b < block_n) tile[b * block_n + a] += acc[r][c];
        }
      }
    }
  } else {
    SmemO& sm = *reinterpret_cast<SmemO*>(smem_raw);
    // this thread's column: t < 128 on side i, else side j
    const int side = threadIdx.x >> 7, lc = threadIdx.x & 127;
    const int glob = (side ? ck.cj0 : ck.ci0) + lc;
    const bool col_ok = (side ? w.b0 : w.a0) + lc < block_n && glob < n;
#pragma unroll
    for (int s = 0; s < RING; ++s) load_bits(sm, ck, bits, s, stages, col_ok, glob);
    int acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;
      }
    }
    cp_async_wait<RING - 1>();
    expand_mask(sm, 0, stages, col_ok);  // the thread's own word: no barrier
    for (int s = 0; s < stages; ++s) {
      cp_async_wait<RING - 2>();
      __syncthreads();
      load_bits(sm, ck, bits, s + RING, stages, col_ok, glob);
      expand_mask(sm, s + 1, stages, col_ok);
      compute_mask(sm, s & 1, acc);
    }
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the stage buffers
    SmemOut& so = *reinterpret_cast<SmemOut*>(smem_raw);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          so.c[(warp & 3) * 32 + mt * 16 + g + (i >= 2 ? 8 : 0)]
              [(warp >> 2) * 64 + nt * 8 + 2 * t + (i & 1)] = (float)acc[mt][nt][i];
      }
    }
    __syncthreads();
    add_staged(so, cnt, w, block_n);
  }
}

}  // namespace

// work: n_work items of 8 int32 (t, ti, tj, a0, b0, role, mirror, 0), from
// linalg/grm_kernels.py grm_work_items; stages = ceil(m / 32); bits:
// (stages, n) int32 scratch for the packed observed mask; vec: rows, tile
// edges, the dosage and the kernel buffer are 16-byte aligned (cp.async
// staging, float4 adds).
extern "C" int grm_fused_triangle_update(
    const void* dosage, const void* mean, const void* inv_std, void* kern, void* cnt,
    const void* work, void* bits, int m, int n, int block_n, int n_work, int stages, int vec,
    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = SMEM_BYTES;
  if ((long long)block_n * block_n >= (1LL << 31)) return (int)cudaErrorInvalidValue;  // add_staged
  const auto kernel = vec ? grm_fused_kernel<true> : grm_fused_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  mask_bits_kernel<<<dim3((unsigned)((n + THREADS - 1) / THREADS), (unsigned)stages), THREADS, 0,
                     st>>>((const int8_t*)dosage, (uint32_t*)bits, m, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n_work, THREADS, smem, st>>>(
      (const int8_t*)dosage, (const float*)mean, (const float*)inv_std, (float*)kern,
      (float*)cnt, (const uint32_t*)bits, (const Work*)work, m, n, block_n, stages);
  return (int)cudaGetLastError();
}
