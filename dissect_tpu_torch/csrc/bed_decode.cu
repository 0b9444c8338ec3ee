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
//
// What bounds them on the H100: bytes.  At the main path's chunk (2,048 SNP
// rows, N = 10,000: 2,500 bytes a row) K4 reads 5.1 MB and writes 20.5 MB,
// 7.6 us at 3.35 TB/s; it does no arithmetic to speak of.  K5 over the
// whole 50,000-SNP file reads 125 MB, 37 us.
//
// Design, kept simple (speed is for a later change).  K4: one thread per
// output byte; grid.x covers a row's columns, grid.y walks rows with a
// stride, so consecutive threads write consecutive bytes and read bytes of
// the same packed row (L1-resident: 2.5 KB a row).  K5: one 256-thread block
// per row; each thread counts the codes of its strided bytes (or of its
// strided index entries) in registers, then a warp shuffle and a shared-
// memory step add the four counts, and thread 0 writes them.  No atomics:
// every output element has one writer, so results do not vary by run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DECODE_THREADS = 256;
constexpr int COUNT_THREADS = 256;
constexpr int MAX_GRID_Y = 65535;

__device__ __forceinline__ int code_at(const uint8_t* row, int j) {
  return (row[j >> 2] >> (2 * (j & 3))) & 0x3;
}

// Adds one code to the per-code tallies, held in registers (a dynamically
// indexed array would live in local memory).
__device__ __forceinline__ void tally(int code, int (&n)[4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) n[k] += (code == k);
}

__global__ void bed_decode_kernel(const uint8_t* __restrict__ packed,
                                  const int32_t* __restrict__ cols,
                                  int8_t* __restrict__ out, int n_rows,
                                  int n_bytes, int n_out) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_out) return;
  const int j = cols ? cols[c] : c;
  for (int r = blockIdx.y; r < n_rows; r += gridDim.y) {
    const uint8_t* row = packed + (size_t)r * (size_t)n_bytes;
    const int code = code_at(row, j);
    // 0b00 -> 0, 0b01 -> -1, 0b10 -> 1, 0b11 -> 2
    out[(size_t)r * (size_t)n_out + c] = (int8_t)(code >= 2 ? code - 1 : -code);
  }
}

__global__ void bed_counts_kernel(const uint8_t* __restrict__ packed,
                                  const int32_t* __restrict__ cols,
                                  long long* __restrict__ counts, int n_rows,
                                  int n_bytes, int n_source, int n_out) {
  __shared__ int partial[COUNT_THREADS / 32][4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int r = blockIdx.x; r < n_rows; r += gridDim.x) {
    const uint8_t* row = packed + (size_t)r * (size_t)n_bytes;
    int local[4] = {0, 0, 0, 0};  // by 2-bit code
    if (cols) {
      for (int c = threadIdx.x; c < n_out; c += blockDim.x) tally(code_at(row, cols[c]), local);
    } else {
      const int full = n_source >> 2;  // bytes whose four codes all count
      for (int b = threadIdx.x; b < full; b += blockDim.x) {
        const int byte = row[b];
#pragma unroll
        for (int k = 0; k < 4; ++k) tally((byte >> (2 * k)) & 0x3, local);
      }
      if (threadIdx.x == 0) {
        for (int j = full << 2; j < n_source; ++j) tally(code_at(row, j), local);
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      int v = local[k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) partial[warp][k] = v;
    }
    __syncthreads();
    if (threadIdx.x < 4) {
      long long total = 0;
      for (int w = 0; w < COUNT_THREADS / 32; ++w) total += partial[w][threadIdx.x];
      // code 0b00 (dosage 0) -> bucket 1, 0b01 (missing) -> bucket 0,
      // 0b10 (1) -> 2, 0b11 (2) -> 3: buckets [missing, 0, 1, 2]
      const int bucket = threadIdx.x < 2 ? 1 - (int)threadIdx.x : (int)threadIdx.x;
      counts[(size_t)r * 4 + bucket] = total;
    }
    __syncthreads();  // `partial` is reused by the next row
  }
}

}  // namespace

extern "C" int bed_decode(const void* packed, const void* cols, void* out,
                          int n_rows, int n_bytes, int n_out, void* stream) {
  if (n_rows == 0 || n_out == 0) return 0;
  const dim3 grid((unsigned)((n_out + DECODE_THREADS - 1) / DECODE_THREADS),
                  (unsigned)(n_rows < MAX_GRID_Y ? n_rows : MAX_GRID_Y));
  bed_decode_kernel<<<grid, DECODE_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int32_t*)cols, (int8_t*)out, n_rows, n_bytes, n_out);
  return (int)cudaGetLastError();
}

extern "C" int bed_counts(const void* packed, const void* cols, void* counts,
                          int n_rows, int n_bytes, int n_source, int n_out,
                          void* stream) {
  if (n_rows == 0) return 0;
  bed_counts_kernel<<<(unsigned)n_rows, COUNT_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const int32_t*)cols, (long long*)counts, n_rows, n_bytes,
      n_source, n_out);
  return (int)cudaGetLastError();
}
