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
// Bit-equality with the JAX package's dosages.  Every step is the native's
// float64 expression in the native's order, rounded once to float32 at the
// end.  This file is compiled without --use_fast_math: float64 division is
// IEEE round-to-nearest on the card as on the host.  nvcc may contract
// v1 + 2.0 * p22 (and p1 + 2.0 * p2) into one fused multiply-add; that is
// exact here, because 2.0 * x is exact in float64 (a power-of-two scaling of
// a finite value far from overflow), so fma(2, x, y) rounds the same exact
// sum y + 2x once, as the unfused add does.  1 - v0 - v1 and
// (1 - v0) + (1 - v1) hold no product and are not contracted.
//
// What bounds them on the H100: bytes.  At the BGEN path's batch (1,024
// variants of 10 + 3N bytes, 8-bit, unphased, N = 10,000) K6 reads 30.7 MB
// and writes 41 MB, 21 us at 3.35 TB/s; its two float64 divisions per
// sample (2e7 a batch) cost less than that on the float64 pipes.
//
// Design, kept simple: one 256-thread block per variant (grid-stride).  All
// threads read the header (broadcast loads), test the ploidy bytes of their
// strided samples and agree with __syncthreads_or; then each thread decodes
// its strided samples, reading each value byte by byte (at most 5 bytes for
// 32 bits at a bit shift of 7).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID = 65535;

__device__ __forceinline__ uint32_t le32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// The native read_bits: `bits` (1..32) bits at bit offset `bit_off` of a
// little-endian stream of `len` bytes; bytes past the end read as 0.
__device__ __forceinline__ uint64_t read_bits(const uint8_t* buf, int64_t len,
                                              uint64_t bit_off, int bits) {
  const uint64_t byte_off = bit_off >> 3;
  const int shift = (int)(bit_off & 7);
  const int need = (shift + bits + 7) / 8;
  uint64_t v = 0;
  for (int i = 0; i < need && (int64_t)byte_off + i < len; ++i) {
    v |= (uint64_t)buf[byte_off + i] << (8 * i);
  }
  v >>= shift;
  return v & (((uint64_t)1 << bits) - 1);
}

__global__ void bgen_l2_kernel(const uint8_t* __restrict__ buf,
                               const int64_t* __restrict__ offsets,
                               const int64_t* __restrict__ lengths, int n_variants,
                               int n_samples, float* __restrict__ out,
                               int32_t* __restrict__ status) {
  for (int v = blockIdx.x; v < n_variants; v += gridDim.x) {
    const uint8_t* u = buf + offsets[v];
    const int64_t ulen = lengths[v];
    float* dst = out + (size_t)v * (size_t)n_samples;
    bool ok = ulen >= 10 && ulen >= 10 + (int64_t)n_samples;
    int phased = 0, bits = 0;
    if (ok) {
      const uint32_t n = le32(u);
      const uint32_t alleles = (uint32_t)u[4] | ((uint32_t)u[5] << 8);
      ok = n == (uint32_t)n_samples && alleles == 2;
    }
    if (ok) {
      phased = u[8 + n_samples];
      bits = u[9 + n_samples];
      ok = bits >= 1 && bits <= 32;
    }
    int bad = 0;
    if (ok) {
      for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
        bad |= (u[8 + s] & 0x3F) != 2;
      }
    }
    // `ok` is the same in every thread of the block, so all reach this
    ok = ok && !__syncthreads_or(bad);
    if (!ok) {
      for (int s = threadIdx.x; s < n_samples; s += blockDim.x) dst[s] = NAN;
      if (threadIdx.x == 0) status[v] = 1;
      continue;
    }
    const uint8_t* probs = u + 10 + n_samples;
    const int64_t plen = ulen - 10 - n_samples;
    const double denom = (double)((((uint64_t)1) << bits) - 1);
    for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
      const uint64_t bit0 = (uint64_t)(2 * (int64_t)s) * (uint64_t)bits;
      const double v0 = (double)read_bits(probs, plen, bit0, bits) / denom;
      const double v1 = (double)read_bits(probs, plen, bit0 + bits, bits) / denom;
      double d;
      if (phased) {
        d = (1.0 - v0) + (1.0 - v1);
      } else {
        double p22 = 1.0 - v0 - v1;
        if (p22 < 0.0) p22 = 0.0;
        if (p22 > 1.0) p22 = 1.0;
        d = v1 + 2.0 * p22;
      }
      dst[s] = (u[8 + s] & 0x80) ? NAN : (float)d;
    }
    if (threadIdx.x == 0) status[v] = 0;
  }
}

__global__ void bgen_l1_kernel(const uint8_t* __restrict__ buf,
                               const int64_t* __restrict__ offsets,
                               const int64_t* __restrict__ lengths, int n_variants,
                               int n_samples, float* __restrict__ out,
                               int32_t* __restrict__ status) {
  for (int v = blockIdx.x; v < n_variants; v += gridDim.x) {
    const uint8_t* u = buf + offsets[v];
    float* dst = out + (size_t)v * (size_t)n_samples;
    const bool ok = lengths[v] == 6 * (int64_t)n_samples;
    for (int s = threadIdx.x; s < n_samples; s += blockDim.x) {
      if (!ok) {
        dst[s] = NAN;
        continue;
      }
      const uint8_t* t = u + 6 * (size_t)s;
      const int p0 = t[0] | (t[1] << 8);
      const int p1 = t[2] | (t[3] << 8);
      const int p2 = t[4] | (t[5] << 8);
      const double psum = (p0 + p1 + p2) / 32768.0;
      dst[s] = psum <= 0.0 ? NAN : (float)(((p1 + 2.0 * p2) / 32768.0) / psum);
    }
    if (threadIdx.x == 0) status[v] = ok ? 0 : 1;
  }
}

}  // namespace

extern "C" int bgen_decode_l2(const void* buf, const void* offsets, const void* lengths,
                              void* out, void* status, int n_variants, int n_samples,
                              void* stream) {
  if (n_variants == 0) return 0;
  const unsigned grid = (unsigned)(n_variants < MAX_GRID ? n_variants : MAX_GRID);
  bgen_l2_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths, n_variants,
      n_samples, (float*)out, (int32_t*)status);
  return (int)cudaGetLastError();
}

extern "C" int bgen_decode_l1(const void* buf, const void* offsets, const void* lengths,
                              void* out, void* status, int n_variants, int n_samples,
                              void* stream) {
  if (n_variants == 0) return 0;
  const unsigned grid = (unsigned)(n_variants < MAX_GRID ? n_variants : MAX_GRID);
  bgen_l1_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)buf, (const int64_t*)offsets, (const int64_t*)lengths, n_variants,
      n_samples, (float*)out, (int32_t*)status);
  return (int)cudaGetLastError();
}
