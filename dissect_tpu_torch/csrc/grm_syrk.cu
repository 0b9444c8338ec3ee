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
// What bounds it on the H100: float32 FMAs.  The work is 2 products x
// m * (lower-triangle entries) FMAs against 1 byte per dosage read, far
// above the card's float32 balance point.  Products stay IEEE float32 on
// the CUDA cores (no TF32: the GRM is held to rtol 1e-6, and the O^T O
// counts must stay exact sums of 0/1 products, exact in float32 below 2^24).
//
// Design: the BN x BN packed tile is a layout, not a work unit.  Each block
// owns one 128 x 128 sub-tile of one packed tile (grid.x = packed tile t,
// grid.y = sub-tile) and decodes t -> (i, j) itself.  Per stage it stages
// BK int8 rows of both column ranges in shared memory, standardized to
// float32 (z and obs); each of the 256 threads then keeps an 8 x 8 output
// micro-tile of both products in registers, so 8 float4 shared loads feed
// 128 FMAs and the kernel stays on the FMA pipes.  The next stage's bytes
// are fetched into registers while the current stage computes.  Out-of-
// range rows and columns (the ragged N edge, N % BN, the chunk's last rows)
// load as missing, so the host never pads the chunk, and a sub-tile lying
// wholly past N returns at once (it would only add zeros).  Each output
// element belongs to one thread of one block: the in-place add needs no
// atomics.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TS = 128;       // output sub-tile edge
constexpr int BK = 16;        // SNP rows per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int SEG = 16;       // columns one thread stages per stage

__device__ __forceinline__ void tile_pair(int t, int* ti, int* tj) {
  int i = (int)((sqrtf(8.0f * (float)t + 1.0f) - 1.0f) * 0.5f);
  while (i > 0 && i * (i + 1) / 2 > t) --i;
  while ((i + 1) * (i + 2) / 2 <= t) ++i;
  *ti = i;
  *tj = t - i * (i + 1) / 2;
}

// Staging role of a thread: one SNP row (threadIdx / 16) and SEG
// consecutive columns of one side (segments 0-7: the row tile's columns,
// 8-15: the column tile's).
struct Stager {
  const int8_t* dosage;
  const float* mean;
  const float* inv_std;
  int m, n, block_n;
  int row;        // row within the stage
  int loc;        // first column, local to the packed tile
  long glob;      // first column, as an individual index
  bool side_j;
  int col;        // first column within the side's 128
  uint32_t raw[SEG / 4];
  float mu, is;

  __device__ void fetch(int k0) {
    const int r = k0 + row;
    const bool ok = r < m;
    mu = ok ? mean[r] : 0.0f;
    is = ok ? inv_std[r] : 0.0f;
    const int8_t* drow = dosage + (size_t)(ok ? r : 0) * (size_t)n;
#pragma unroll
    for (int w = 0; w < SEG / 4; ++w) {
      uint32_t packed = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int c = w * 4 + b;
        int d = -1;
        if (ok && loc + c < block_n && glob + c < n) d = drow[glob + c];
        packed |= ((uint32_t)(uint8_t)(int8_t)d) << (8 * b);
      }
      raw[w] = packed;
    }
  }

  __device__ void store(float (*zi)[TS], float (*oi)[TS], float (*zj)[TS],
                        float (*oj)[TS]) const {
    float* zdst = side_j ? &zj[row][col] : &zi[row][col];
    float* odst = side_j ? &oj[row][col] : &oi[row][col];
#pragma unroll
    for (int w = 0; w < SEG / 4; ++w) {
      float zv[4], ov[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int d = (int)(int8_t)((raw[w] >> (8 * b)) & 0xffu);
        const float o = d >= 0 ? 1.0f : 0.0f;
        ov[b] = o;
        zv[b] = o * ((float)d - mu) * is;
      }
      *reinterpret_cast<float4*>(zdst + 4 * w) = make_float4(zv[0], zv[1], zv[2], zv[3]);
      *reinterpret_cast<float4*>(odst + 4 * w) = make_float4(ov[0], ov[1], ov[2], ov[3]);
    }
  }
};

__global__ void __launch_bounds__(THREADS, 1) grm_fused_kernel(
    const int8_t* __restrict__ dosage, const float* __restrict__ mean,
    const float* __restrict__ inv_std, float* __restrict__ kern,
    float* __restrict__ cnt, int m, int n, int block_n) {
  __shared__ __align__(16) float zi[BK][TS];
  __shared__ __align__(16) float oi[BK][TS];
  __shared__ __align__(16) float zj[BK][TS];
  __shared__ __align__(16) float oj[BK][TS];

  const int t = blockIdx.x;
  const int sub_edge = (block_n + TS - 1) / TS;
  const int a0 = (blockIdx.y / sub_edge) * TS;  // local row offset in the tile
  const int b0 = (blockIdx.y % sub_edge) * TS;  // local column offset
  int ti, tj;
  tile_pair(t, &ti, &tj);
  const long ci0 = (long)ti * block_n + a0;  // individual index of local row a0
  const long cj0 = (long)tj * block_n + b0;
  if (ci0 >= n || cj0 >= n || a0 >= block_n || b0 >= block_n) return;  // adds only zeros
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  Stager st;
  st.dosage = dosage;
  st.mean = mean;
  st.inv_std = inv_std;
  st.m = m;
  st.n = n;
  st.block_n = block_n;
  st.row = threadIdx.x / 16;
  const int seg = threadIdx.x % 16;
  st.side_j = seg >= 8;
  st.col = (seg % 8) * SEG;
  st.loc = (st.side_j ? b0 : a0) + st.col;
  st.glob = (st.side_j ? cj0 : ci0) + st.col;

  float acc_k[8][8];
  float acc_c[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc_k[r][c] = 0.0f;
      acc_c[r][c] = 0.0f;
    }
  }

  st.fetch(0);
  for (int k0 = 0; k0 < m; k0 += BK) {
    st.store(zi, oi, zj, oj);
    __syncthreads();
    if (k0 + BK < m) st.fetch(k0 + BK);  // in flight while this stage computes
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 za0 = *reinterpret_cast<const float4*>(&zi[kk][ty * 4]);
      const float4 za1 = *reinterpret_cast<const float4*>(&zi[kk][64 + ty * 4]);
      const float4 oa0 = *reinterpret_cast<const float4*>(&oi[kk][ty * 4]);
      const float4 oa1 = *reinterpret_cast<const float4*>(&oi[kk][64 + ty * 4]);
      const float4 zb0 = *reinterpret_cast<const float4*>(&zj[kk][tx * 4]);
      const float4 zb1 = *reinterpret_cast<const float4*>(&zj[kk][64 + tx * 4]);
      const float4 ob0 = *reinterpret_cast<const float4*>(&oj[kk][tx * 4]);
      const float4 ob1 = *reinterpret_cast<const float4*>(&oj[kk][64 + tx * 4]);
      const float za[8] = {za0.x, za0.y, za0.z, za0.w, za1.x, za1.y, za1.z, za1.w};
      const float oa[8] = {oa0.x, oa0.y, oa0.z, oa0.w, oa1.x, oa1.y, oa1.z, oa1.w};
      const float zb[8] = {zb0.x, zb0.y, zb0.z, zb0.w, zb1.x, zb1.y, zb1.z, zb1.w};
      const float ob[8] = {ob0.x, ob0.y, ob0.z, ob0.w, ob1.x, ob1.y, ob1.z, ob1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          acc_k[r][c] = fmaf(za[r], zb[c], acc_k[r][c]);
          acc_c[r][c] = fmaf(oa[r], ob[c], acc_c[r][c]);
        }
      }
    }
    __syncthreads();
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
      kern[row_off + b] += acc_k[r][c];
      cnt[row_off + b] += acc_c[r][c];
    }
  }
}

}  // namespace

extern "C" int grm_fused_triangle_update(
    const void* dosage, const void* mean, const void* inv_std, void* kern,
    void* cnt, int m, int n, int block_n, int n_tiles, void* stream) {
  const int sub_edge = (block_n + TS - 1) / TS;
  const dim3 grid((unsigned)n_tiles, (unsigned)(sub_edge * sub_edge));
  grm_fused_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)dosage, (const float*)mean, (const float*)inv_std,
      (float*)kern, (float*)cnt, m, n, block_n);
  return (int)cudaGetLastError();
}
