// K3: fused per-SNP weighted moments for one Fisher step of the ML refit.
//
// Replaces: fused_refit_moments / _moments_kernel,
//   dissect_tpu/gwas/pallas_moments.py:47-143 (pl.pallas_call at :118).
//
// For every SNP row r with weights w1 = 1/(t1*lam + t2), w2 = w1^2,
// w3 = w2*lam (t1, t2 = thetas[r]):
//   m1 = w1 . feats (K)   m2 = w2 . feats (K)
//   gs_k = (w_k * g_r) . s (q each, k = 1..3)   gg_k = sum w_k * g_r^2
// packed per moment_columns: [m1 | m2 | gs1 | gs2 | gs3 | gg1 gg2 gg3],
// total = 2K + 3q + 3 columns per row (no 128-lane padding: that limit was
// the TPU's lane group, and this kernel takes any q and K).
//
// What bounds it on the H100: at the main path's shape (q = 4, K = 23) each
// element of g costs about 2 * 61 float32 flops against 4 bytes read, which
// sits just above the card's float32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20 flop/byte): operation-bound, with g's single read close
// behind.
//
// Design: g is read from device memory once per call, coalesced: one warp
// per SNP row, lanes striding over the n eigenbasis entries.  The weights
// live only in registers, computed from the row's theta and lam.  The
// shared columns lam, s and feats are staged in shared memory, BK entries
// at a time, and reused by the block's 16 rows; the staging copies are
// asynchronous (cp.async) into two buffers, so stage k+1 is in flight while
// stage k computes, and they read transposed (column-major) copies of s and
// feats so consecutive threads read consecutive addresses.  Each lane
// accumulates its partial sums in registers and the warp reduces them with
// shuffles at the end, so each output row is written once.  Columns are
// processed in chunks of FC feature and QC s columns (grid.y); a chunk
// reads g only if it holds s columns or the gg sums (chunk 0), so for
// q <= QC (the main path's q = 4, K = 23 is one chunk) g is read once and
// larger designs re-read it per s chunk.  A chunk's unused feature and s rows are zeroed once in both
// buffers, so the inner loops run to the compile-time FC and QC without
// per-element masks.  The TPU kernel's padding of thetas, lam and n
// becomes the row and stage masks.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int FC = 24;       // feature columns per chunk
constexpr int QC = 4;        // shared s columns per chunk
constexpr int BK = 128;      // eigenbasis entries per shared-memory stage
constexpr int WARPS = 16;    // SNP rows per block, one warp each
constexpr int THREADS = WARPS * 32;
constexpr int PER_LANE = BK / 32;

struct Stage {
  float lam[BK];
  float f[FC][BK + 1];
  float s[QC][BK + 1];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Issue the asynchronous copies of stage k0 (kb valid entries) into st.
__device__ __forceinline__ void stage_async(Stage& st, const float* __restrict__ lam,
                                            const float* __restrict__ s_t,
                                            const float* __restrict__ feats_t, int n,
                                            int k0, int kb, int f0, int nf, int s0, int ns) {
  for (int e = threadIdx.x; e < kb; e += THREADS)
    __pipeline_memcpy_async(&st.lam[e], &lam[k0 + e], sizeof(float));
  for (int e = threadIdx.x; e < nf * BK; e += THREADS) {
    const int j = e / BK, kk = e % BK;
    if (kk < kb)
      __pipeline_memcpy_async(&st.f[j][kk], &feats_t[(size_t)(f0 + j) * n + k0 + kk],
                              sizeof(float));
  }
  for (int e = threadIdx.x; e < ns * BK; e += THREADS) {
    const int i = e / BK, kk = e % BK;
    if (kk < kb)
      __pipeline_memcpy_async(&st.s[i][kk], &s_t[(size_t)(s0 + i) * n + k0 + kk],
                              sizeof(float));
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS) moments_kernel(
    const float* __restrict__ g, const float* __restrict__ thetas,
    const float* __restrict__ lam, const float* __restrict__ s_t,
    const float* __restrict__ feats_t, float* __restrict__ out, int m, int n,
    int q, int kf) {
  __shared__ Stage stages[2];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  const bool row_ok = row < m;
  const int f0 = blockIdx.y * FC;
  const int nf = max(0, min(FC, kf - f0));
  const int s0 = blockIdx.y * QC;
  const int ns = max(0, min(QC, q - s0));
  const bool do_gg = blockIdx.y == 0;
  const bool need_g = ns > 0 || do_gg;
  const int total = 2 * kf + 3 * q + 3;

  const float t1 = row_ok ? thetas[2 * (size_t)row] : 1.0f;
  const float t2 = row_ok ? thetas[2 * (size_t)row + 1] : 1.0f;

  float am1[FC], am2[FC], ags1[QC], ags2[QC], ags3[QC];
#pragma unroll
  for (int j = 0; j < FC; ++j) {
    am1[j] = 0.0f;
    am2[j] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < QC; ++i) {
    ags1[i] = 0.0f;
    ags2[i] = 0.0f;
    ags3[i] = 0.0f;
  }
  float agg1 = 0.0f, agg2 = 0.0f, agg3 = 0.0f;

  // rows past the chunk's columns stay zero: they add nothing below
  for (int e = threadIdx.x; e < 2 * (FC - nf) * (BK + 1); e += THREADS) {
    const int b = e / ((FC - nf) * (BK + 1)), r = e % ((FC - nf) * (BK + 1));
    stages[b].f[nf + r / (BK + 1)][r % (BK + 1)] = 0.0f;
  }
  for (int e = threadIdx.x; e < 2 * (QC - ns) * (BK + 1); e += THREADS) {
    const int b = e / ((QC - ns) * (BK + 1)), r = e % ((QC - ns) * (BK + 1));
    stages[b].s[ns + r / (BK + 1)][r % (BK + 1)] = 0.0f;
  }
  const float* grow = g + (size_t)(row_ok ? row : 0) * (size_t)n;
  const int n_stages = (n + BK - 1) / BK;
  stage_async(stages[0], lam, s_t, feats_t, n, 0, min(BK, n), f0, nf, s0, ns);
  for (int sk = 0; sk < n_stages; ++sk) {
    const int k0 = sk * BK;
    const int kb = min(BK, n - k0);
    if (sk + 1 < n_stages) {
      const int k1 = k0 + BK;
      stage_async(stages[(sk + 1) & 1], lam, s_t, feats_t, n, k1, min(BK, n - k1), f0, nf,
                  s0, ns);
      __pipeline_wait_prior(1);  // stage sk has landed; sk + 1 stays in flight
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const Stage& st = stages[sk & 1];
    if (row_ok) {
      float gv[PER_LANE];
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int kk = lane + 32 * i;
        gv[i] = (need_g && kk < kb) ? grow[k0 + kk] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < PER_LANE; ++i) {
        const int kk = lane + 32 * i;
        if (kk >= kb) break;
        const float l = st.lam[kk];
        const float w1 = 1.0f / (t1 * l + t2);
        const float w2 = w1 * w1;
#pragma unroll
        for (int j = 0; j < FC; ++j) {
          const float f = st.f[j][kk];
          am1[j] = fmaf(w1, f, am1[j]);
          am2[j] = fmaf(w2, f, am2[j]);
        }
        if (need_g) {
          const float g1 = w1 * gv[i];
          const float g2 = w2 * gv[i];
          const float g3 = g2 * l;
#pragma unroll
          for (int c = 0; c < QC; ++c) {
            const float sv = st.s[c][kk];
            ags1[c] = fmaf(g1, sv, ags1[c]);
            ags2[c] = fmaf(g2, sv, ags2[c]);
            ags3[c] = fmaf(g3, sv, ags3[c]);
          }
          agg1 = fmaf(g1, gv[i], agg1);
          agg2 = fmaf(g2, gv[i], agg2);
          agg3 = fmaf(g3, gv[i], agg3);
        }
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }
  if (!row_ok) return;

  float* orow = out + (size_t)row * total;
  const int c_m2 = kf, c_gs1 = 2 * kf, c_gs2 = c_gs1 + q, c_gs3 = c_gs2 + q;
  const int c_gg = c_gs3 + q;
#pragma unroll
  for (int j = 0; j < FC; ++j) {
    if (j < nf) {
      const float v1 = warp_sum(am1[j]);
      const float v2 = warp_sum(am2[j]);
      if (lane == 0) {
        orow[f0 + j] = v1;
        orow[c_m2 + f0 + j] = v2;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < QC; ++i) {
    if (i < ns) {
      const float v1 = warp_sum(ags1[i]);
      const float v2 = warp_sum(ags2[i]);
      const float v3 = warp_sum(ags3[i]);
      if (lane == 0) {
        orow[c_gs1 + s0 + i] = v1;
        orow[c_gs2 + s0 + i] = v2;
        orow[c_gs3 + s0 + i] = v3;
      }
    }
  }
  if (do_gg) {
    const float v1 = warp_sum(agg1);
    const float v2 = warp_sum(agg2);
    const float v3 = warp_sum(agg3);
    if (lane == 0) {
      orow[c_gg] = v1;
      orow[c_gg + 1] = v2;
      orow[c_gg + 2] = v3;
    }
  }
}

}  // namespace

// s_t (q, n) and feats_t (kf, n) are the shared columns transposed.
extern "C" int fused_refit_moments(
    const void* g, const void* thetas, const void* lam, const void* s_t,
    const void* feats_t, void* out, int m, int n, int q, int kf, void* stream) {
  const int chunks = std::max(1, std::max((kf + FC - 1) / FC, (q + QC - 1) / QC));
  const dim3 grid((unsigned)((m + WARPS - 1) / WARPS), (unsigned)chunks);
  moments_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)thetas, (const float*)lam,
      (const float*)s_t, (const float*)feats_t, (float*)out, m, n, q, kf);
  return (int)cudaGetLastError();
}
