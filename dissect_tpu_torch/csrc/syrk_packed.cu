// K2: triangle-only syrk of a float32 operand into a fresh packed buffer.
//
// Replaces: syrk_triangle_packed / _syrk_kernel,
//   dissect_tpu/linalg/pallas_syrk.py:61 (kernel body :38, pl.pallas_call at :101).
//
// Contract (kept from the TPU kernel): z is an (m, n) float32 operand that
// is already standardized (the streaming GRM calls it twice per chunk of
// imputed dosages: on Z and on the 0/1 observed mask O).  The output is a
// FRESH packed (T*BN, BN) float32 buffer: tile t holds the BN x BN output
// tile (i, j), j <= i, of Z^T Z in the order (0,0), (1,0), (1,1), (2,0), ...
// (pallas_syrk._pair_maps).  Diagonal tiles are stored whole, strict upper
// half included, because unpack_triangle reads them as they are.  Every
// entry is written: an entry whose row or column is past n is 0, as in the
// TPU kernel's zero-padded operand, so the buffers compare tile for tile.
//
// What bounds it on the H100: float32 FMAs.  At the main path's shape
// (m = 2,048, n = 10,000, BN = 512) the work is 2 m n(n+1)/2 = 2.05e11 flop,
// 3.06 ms at the 67 TFLOP/s float32 peak, against 82 MB of z read and 220 MB
// of packed tiles written, 0.09 ms at 3.35 TB/s: operations-bound, some 30x
// above the balance point.  Products stay IEEE float32 on the CUDA cores (no
// TF32: the GRM is held to rtol 1e-6, and on the mask O the result must be
// the exact count, a float32 sum of 0/1 products, exact below 2^24).
//
// Design, K1's tiling without the int8 decode: each block owns one 128 x 128
// sub-tile of one packed tile (grid.x = packed tile t, grid.y = sub-tile) and
// decodes t -> (i, j) itself.  Per stage it stages BK rows of both column
// ranges in shared memory, a warp reading 128 consecutive floats of one row
// as float4s; each of the 256 threads then keeps an 8 x 8 output micro-tile
// in registers, so 4 float4 shared loads feed 64 FMAs and the kernel stays
// on the FMA pipes.  The next stage's floats are fetched into registers
// while the current stage computes.  Rows past m, columns past n and
// columns past the tile's BN edge load as 0, so the host never pads z, and
// a sub-tile lying wholly past n writes its zeros and returns.  Each output
// entry belongs to one thread of one block: no atomics, no pre-zeroing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;       // output sub-tile edge
constexpr int BK = 16;        // rows of z per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int LOADS = 4;      // float4s a thread stages per stage (2 per side)

__device__ __forceinline__ void tile_pair(int t, int* ti, int* tj) {
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = i;
  *tj = t - i * (i + 1) / 2;
}

// Staging of one stage: BK rows x (128 + 128) columns = 2 x 512 float4s,
// float4 q = threadIdx + 256 * l for l < 4; l < 2 are the row tile's (side
// i), l >= 2 the column tile's (side j).  Within a side, float4 q % 512 is
// row (q % 512) / 32 and columns 4 * (q % 32) .. + 3, so a warp reads one
// row's 512 contiguous bytes.
struct Stager {
  const float* z;
  int m, n, block_n;
  int a0, b0;      // local offsets of the sub-tile's rows / columns in the tile
  long ci0, cj0;   // individual index of the sub-tile's first column, each side
  bool vec;        // every float4 of a side starts 16-byte aligned
  float4 reg[LOADS];

  __device__ void fetch(int k0) {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int q = (int)threadIdx.x + THREADS * (l & 1);
      const int row = q / 32;
      const int col = 4 * (q % 32);
      const bool side_j = l >= 2;
      const int loc = (side_j ? b0 : a0) + col;          // column local to the tile
      const long glob = (side_j ? cj0 : ci0) + col;      // column as an individual
      const int r = k0 + row;
      float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (r < m) {
        const float* src = z + (size_t)r * (size_t)n + glob;
        if (vec && loc + 3 < block_n && glob + 3 < n) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src));
          v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (loc + c < block_n && glob + c < n) v[c] = __ldg(src + c);
        }
      }
      reg[l] = make_float4(v[0], v[1], v[2], v[3]);
    }
  }

  __device__ void store(float (*zi)[TS], float (*zj)[TS]) const {
#pragma unroll
    for (int l = 0; l < LOADS; ++l) {
      const int q = (int)threadIdx.x + THREADS * (l & 1);
      float* dst = l >= 2 ? &zj[q / 32][4 * (q % 32)] : &zi[q / 32][4 * (q % 32)];
      *reinterpret_cast<float4*>(dst) = reg[l];
    }
  }
};

__global__ void __launch_bounds__(THREADS, 1) syrk_packed_kernel(
    const float* __restrict__ z, float* __restrict__ out, int m, int n,
    int block_n, bool vec) {
  __shared__ __align__(16) float zi[BK][TS];
  __shared__ __align__(16) float zj[BK][TS];

  const int t = blockIdx.x;
  const int sub_edge = (block_n + TS - 1) / TS;
  const int a0 = (blockIdx.y / sub_edge) * TS;  // local row offset in the tile
  const int b0 = (blockIdx.y % sub_edge) * TS;  // local column offset
  int ti, tj;
  tile_pair(t, &ti, &tj);
  const long ci0 = (long)ti * block_n + a0;  // individual index of local row a0
  const long cj0 = (long)tj * block_n + b0;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;
  }

  // a sub-tile wholly past n (the ragged edge) computes nothing: its
  // entries are the zeros of the padded operand
  if (ci0 < n && cj0 < n) {
    Stager st;
    st.z = z;
    st.m = m;
    st.n = n;
    st.block_n = block_n;
    st.a0 = a0;
    st.b0 = b0;
    st.ci0 = ci0;
    st.cj0 = cj0;
    st.vec = vec;
    st.fetch(0);
    for (int k0 = 0; k0 < m; k0 += BK) {
      st.store(zi, zj);
      __syncthreads();
      if (k0 + BK < m) st.fetch(k0 + BK);  // in flight while this stage computes
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a_lo = *reinterpret_cast<const float4*>(&zi[kk][ty * 4]);
        const float4 a_hi = *reinterpret_cast<const float4*>(&zi[kk][64 + ty * 4]);
        const float4 b_lo = *reinterpret_cast<const float4*>(&zj[kk][tx * 4]);
        const float4 b_hi = *reinterpret_cast<const float4*>(&zj[kk][64 + tx * 4]);
        const float a[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        const float b[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
#pragma unroll
          for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int a = a0 + (r < 4 ? ty * 4 + r : 64 + ty * 4 + (r - 4));
    if (a >= block_n) continue;
    const size_t row_off = ((size_t)t * block_n + a) * (size_t)block_n;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int b = b0 + (c < 4 ? tx * 4 + c : 64 + tx * 4 + (c - 4));
      if (b >= block_n) continue;
      out[row_off + b] = acc[r][c];
    }
  }
}

}  // namespace

extern "C" int syrk_triangle_packed(const void* z, void* out, int m, int n,
                                    int block_n, int n_tiles, void* stream) {
  const int sub_edge = (block_n + TS - 1) / TS;
  const dim3 grid((unsigned)n_tiles, (unsigned)(sub_edge * sub_edge));
  const bool vec = (n % 4 == 0) && (block_n % 4 == 0) && ((uintptr_t)z % 16 == 0);
  syrk_packed_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)z, (float*)out, m, n, block_n, vec);
  return (int)cudaGetLastError();
}
