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
// total = 2K + 3q + 3 columns per row, for any q and K.
//
// What bounds it on the H100: float32 FMAs.  At the main path's shape
// (q = 4, K = 23) each element of g costs 61 FMAs (2K + 3q + 3) against
// 4 bytes read: 0.91 ms at 67 TFLOP/s for M = 50,000, n = 10,000, above
// g's single read (0.60 ms at 3.35 TB/s).
//
// Design.  The wrapper packs the shared columns of entry k into one
// 32-float row Y[k] = [24 feature columns | 4 s columns | lam | 0 0 0]
// (moments_kernels.py `pack_shared_columns`; larger q or K take several
// such column chunks, grid.y).  A block owns 64 SNP rows and walks its
// entries 16 per stage:
//   1. weights: the block's 128 threads compute w1 and w2 of its 64 rows
//      for the next stage's 16 entries, each (row, entry) ONCE, with the
//      correctly rounded reciprocal (__frcp_rn, equal to 1.0f / x), into
//      a double-buffered shared-memory area;
//   2. moments: each warp owns one group of moment columns for all 64
//      rows, each lane 2 rows (a register tile of 2 rows x 16 columns):
//      warps 0-2 the m1 and m2 columns of 8 features each, warp 3 the
//      12 gs columns and the 3 gg sums.  Per entry a lane reads its 2
//      rows' weights (conflict-free) and its group's 8 shared values (two
//      float4 loads all lanes share), and does 32 FMAs: each shared value
//      feeds 4 FMAs, each weight 8.
// Precision: the refit's gradient is a difference of sums over all n
// entries (about 1e4 at the main shape) held to 1e-2, and how many SNPs
// pass that test depends on how accurate the float32 sums are: one
// sequence of 10,000 terms per lane failed several times as many SNPs as
// the earlier kernel (32 lanes of n / 32 terms, then a shuffle tree).  So
// a lane sums FLUSH stages (64 entries) in fresh registers and adds them
// to its totals with Kahan's compensated addition (a third register set),
// which makes the additions at the scale of the total nearly exact.
// g tiles (64 rows x 16 entries) and Y rows are staged with 16-byte
// cp.async into a ring of three stages: while stage s computes, stage s + 1
// has landed (its weights are being computed) and s + 2 is in flight; one
// barrier per stage.  Entries past the end are zero-filled by the copy and
// their weights set to 0.
//
// Small M (the refit's retry on a few hundred SNPs) would give a handful
// of blocks, so the wrapper splits the n axis across blocks (grid.z): each
// split writes its partial moments to a scratch buffer, and a second
// kernel sums the splits in a fixed order, so results do not vary from
// run to run (no atomics).

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 64;      // SNP rows per block
constexpr int THREADS = 128;  // 4 warps: 4 column groups
constexpr int RPT = ROWS / 32;  // rows per lane
constexpr int BK = 16;        // eigenbasis entries per stage
constexpr int RING = 3;
constexpr int FC = 24;        // feature columns per column chunk (3 groups of 8)
constexpr int QC = 4;         // s columns per column chunk
constexpr int YW = 32;        // packed row: feats | s | lam | pad
constexpr int Y_S = FC;
constexpr int Y_LAM = FC + QC;
constexpr int GS = BK + 4;    // padded g row: conflict-free float4 loads
constexpr int ACC = 8 * RPT * 2;  // accumulators per lane
constexpr int FLUSH = 4;      // stages summed in fresh registers (64 entries)
static_assert(THREADS % ROWS == 0 && BK % (THREADS / ROWS) == 0, "weights: whole rows");

struct Stage {
  float g[ROWS][GS];
  float y[BK][YW];
};

struct Smem {
  Stage ring[RING];
  float w1[2][BK][ROWS];
  float w2[2][BK][ROWS];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Loader {
  const float* g;
  const float* y;  // this chunk's packed rows, (n, YW)
  int m, n, row0, k_begin, k_end, stages;
  bool vec;

  __device__ int entry0(int s) const { return k_begin + s * BK; }  // stage s's first entry

  __device__ void load(Smem& sm, int s) const {
    if (s < stages) {
      Stage& st = sm.ring[s % RING];
      const int k0 = entry0(s);
      for (int e = threadIdx.x; e < ROWS * (BK / 4); e += THREADS) {
        const int r = e / (BK / 4), c4 = e % (BK / 4);
        const int row = row0 + r, k = k0 + 4 * c4;
        float* dst = &st.g[r][4 * c4];
        const bool rok = row < m;
        if (vec) {
          const int valid = rok ? max(0, min(4, k_end - k)) : 0;
          cp_async16(dst, valid ? g + (size_t)row * n + k : g, 4 * valid);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool ok = rok && k + j < k_end;
            cp_async4(dst + j, ok ? g + (size_t)row * n + k + j : g, ok ? 4 : 0);
          }
        }
      }
      for (int e = threadIdx.x; e < BK * (YW / 4); e += THREADS) {
        const int kk = e / (YW / 4), c = e % (YW / 4);
        const bool ok = k0 + kk < k_end;
        cp_async16(&st.y[kk][4 * c], ok ? y + (size_t)(k0 + kk) * YW + 4 * c : y, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  }
};

// Warps 0-2: m1 (acc[8 i + j]) and m2 (acc[8 RPT + 8 i + j]) of features
// 8 w .. 8 w + 7 for the lane's rows i.
__device__ __forceinline__ void moments_features(float (&acc)[ACC], const Smem& sm,
                                                 const Stage& st, int buf, int group,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 fa = *reinterpret_cast<const float4*>(&st.y[kk][8 * group]);
    const float4 fb = *reinterpret_cast<const float4*>(&st.y[kk][8 * group + 4]);
    const float f[8] = {fa.x, fa.y, fa.z, fa.w, fb.x, fb.y, fb.z, fb.w};
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float w1 = sm.w1[buf][kk][lane + 32 * i];
      const float w2 = sm.w2[buf][kk][lane + 32 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[8 * i + j] = fmaf(w1, f[j], acc[8 * i + j]);
        acc[8 * RPT + 8 * i + j] = fmaf(w2, f[j], acc[8 * RPT + 8 * i + j]);
      }
    }
  }
}

// Warp 3: gs1, gs2, gs3 (acc[15 i + c], [15 i + 4 + c], [15 i + 8 + c])
// and gg1..3 (acc[15 i + 12 ..]) for the lane's rows i.
__device__ __forceinline__ void moments_genotype(float (&acc)[ACC], const Smem& sm,
                                                 const Stage& st, int buf, int lane) {
#pragma unroll
  for (int k4 = 0; k4 < BK / 4; ++k4) {
    float gv[RPT][4];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(&st.g[lane + 32 * i][4 * k4]);
      gv[i][0] = v.x;
      gv[i][1] = v.y;
      gv[i][2] = v.z;
      gv[i][3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kk = 4 * k4 + j;
      const float4 sv = *reinterpret_cast<const float4*>(&st.y[kk][Y_S]);
      const float s[4] = {sv.x, sv.y, sv.z, sv.w};
      const float lam = st.y[kk][Y_LAM];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float gx = gv[i][j];
        const float h1 = sm.w1[buf][kk][lane + 32 * i] * gx;
        const float h2 = sm.w2[buf][kk][lane + 32 * i] * gx;
        const float h3 = h2 * lam;
        float* a = &acc[15 * i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          a[c] = fmaf(h1, s[c], a[c]);
          a[4 + c] = fmaf(h2, s[c], a[4 + c]);
          a[8 + c] = fmaf(h3, s[c], a[8 + c]);
        }
        a[12] = fmaf(h1, gx, a[12]);
        a[13] = fmaf(h2, gx, a[13]);
        a[14] = fmaf(h3, gx, a[14]);
      }
    }
  }
}

// w1, w2 of stage s: thread t takes row t % ROWS and
// the entries of half t / ROWS of the stage.  An entry past the end
// (zero-filled) must add nothing, even where t2 = 0 would make its weight
// infinite.
__device__ __forceinline__ void stage_weights(Smem& sm, const Loader& ld, int s, float t1,
                                              float t2) {
  if (s >= ld.stages) return;
  const Stage& st = sm.ring[s % RING];
  const int buf = s & 1;
  const int row = threadIdx.x % ROWS;
  const int kk0 = (threadIdx.x / ROWS) * (BK * ROWS / THREADS);
  const int kb = ld.k_end - ld.entry0(s);  // valid entries (>= BK: all)
#pragma unroll
  for (int j = 0; j < BK * ROWS / THREADS; ++j) {
    const int kk = kk0 + j;
    const float w1 = kk < kb ? __frcp_rn(fmaf(t1, st.y[kk][Y_LAM], t2)) : 0.0f;
    sm.w1[buf][kk][row] = w1;
    sm.w2[buf][kk][row] = w1 * w1;
  }
}

__global__ void __launch_bounds__(THREADS, 3) moments_kernel(
    const float* __restrict__ g, const float* __restrict__ thetas,
    const float* __restrict__ y_packed, float* __restrict__ out, int m, int n, int q, int kf,
    int n_per_split, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int chunk = blockIdx.y;
  const int split = blockIdx.z;
  Loader ld;
  ld.g = g;
  ld.y = y_packed + (size_t)chunk * n * YW;
  ld.m = m;
  ld.n = n;
  ld.row0 = blockIdx.x * ROWS;
  ld.k_begin = split * n_per_split;
  ld.k_end = min(n, ld.k_begin + n_per_split);
  ld.stages = (ld.k_end - ld.k_begin + BK - 1) / BK;
  ld.vec = vec != 0;

#pragma unroll
  for (int s = 0; s < RING - 1; ++s) ld.load(sm, s);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // this thread's row for the weights
  const int wrow = ld.row0 + threadIdx.x % ROWS;
  const float t1 = wrow < m ? thetas[2 * (size_t)wrow] : 1.0f;
  const float t2 = wrow < m ? thetas[2 * (size_t)wrow + 1] : 1.0f;

  // acc: the entries since the last flush; total (with Kahan's
  // compensation comp): all entries before it
  float acc[ACC], total[ACC], comp[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = total[i] = comp[i] = 0.0f;

  cp_async_wait<RING - 2>();  // stage 0 has landed
  __syncthreads();
  stage_weights(sm, ld, 0, t1, t2);
  for (int s = 0; s < ld.stages; ++s) {
    cp_async_wait<0>();         // stage s + 1 has landed
    __syncthreads();            // ... for all; stage s's weights are written,
                                // stage s - 1 and its weights are consumed
    ld.load(sm, s + RING - 1);  // into the slot stage s - 1 left
    stage_weights(sm, ld, s + 1, t1, t2);
    const Stage& st = sm.ring[s % RING];
    if (warp < 3) moments_features(acc, sm, st, s & 1, warp, lane);
    else moments_genotype(acc, sm, st, s & 1, lane);
    if (s % FLUSH == FLUSH - 1 || s == ld.stages - 1) {
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const float y = acc[i] - comp[i];
        const float t = total[i] + y;
        comp[i] = (t - total[i]) - y;
        total[i] = t;
        acc[i] = 0.0f;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) total[i] -= comp[i];

  const int width = 2 * kf + 3 * q + 3;
  float* base = out + (size_t)split * m * width;
  const int c_gs1 = 2 * kf, c_gs2 = c_gs1 + q, c_gs3 = c_gs2 + q, c_gg = c_gs3 + q;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = ld.row0 + lane + 32 * i;
    if (row >= m) continue;
    float* orow = base + (size_t)row * width;
    if (warp < 3) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int f = chunk * FC + 8 * warp + j;
        if (8 * warp + j < FC && f < kf) {
          orow[f] = total[8 * i + j];
          orow[kf + f] = total[8 * RPT + 8 * i + j];
        }
      }
    } else {
#pragma unroll
      for (int c = 0; c < QC; ++c) {
        const int sc = chunk * QC + c;
        if (sc < q) {
          orow[c_gs1 + sc] = total[15 * i + c];
          orow[c_gs2 + sc] = total[15 * i + 4 + c];
          orow[c_gs3 + sc] = total[15 * i + 8 + c];
        }
      }
      if (chunk == 0) {
        orow[c_gg] = total[15 * i + 12];
        orow[c_gg + 1] = total[15 * i + 13];
        orow[c_gg + 2] = total[15 * i + 14];
      }
    }
  }
}

// out[i] = sum over the splits of partial[s][i], in split order.
__global__ void sum_splits_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                  long count, int splits) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < count;
       i += (long)gridDim.x * blockDim.x) {
    float v = 0.0f;
    for (int s = 0; s < splits; ++s) v += partial[(size_t)s * count + i];
    out[i] = v;
  }
}

}  // namespace

// y_packed: (chunks, n, 32) shared columns; partial: (splits, m, total)
// scratch, used only when splits > 1.  Geometry from the wrapper
// (gwas/moments_kernels.py `refit_geometry`): row_blocks x chunks x splits
// blocks, n_per_split a multiple of 16 entries; vec: g rows are 16-byte
// aligned (cp.async of 16 bytes).
extern "C" int fused_refit_moments(const void* g, const void* thetas, const void* y_packed,
                                   void* out, void* partial, int m, int n, int q, int kf,
                                   int row_blocks, int chunks, int splits, int n_per_split,
                                   int vec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)sizeof(Smem);
  cudaError_t err =
      cudaFuncSetAttribute(moments_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)row_blocks, (unsigned)chunks, (unsigned)splits);
  float* dst = splits > 1 ? (float*)partial : (float*)out;
  moments_kernel<<<grid, THREADS, smem, st>>>((const float*)g, (const float*)thetas,
                                              (const float*)y_packed, dst, m, n, q, kf,
                                              n_per_split, vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long count = (long)m * (2 * kf + 3 * q + 3);
  const int blocks = (int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024);
  sum_splits_kernel<<<blocks, 256, 0, st>>>((const float*)partial, (float*)out, count, splits);
  return (int)cudaGetLastError();
}
