// Warp-level tile helpers shared by the attention kernels (flash_attention.cu,
// block_sparse_attention.cu), CUDA C++ for sm_90a.
//
// Products run on mma.sync m16n8k16 (bf16 in, fp32 accumulate); the fp32
// instances (the parity checks) run the same tiles with scalar FMAs in the
// mma fragment layout, so the softmax code around them is shared by both
// element types.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "elem16.cuh"

#define NEG_INF (-1e30f)

namespace {

typedef elem16 bf16;  // bf16, or fp16 under DS_ELEM_F16 (elem16.cuh)

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 x) { return elem16_to_f(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return f_to_elem16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ------------------------------------------------------- warp tile products
// C (16 x 8*N8) += A (16 x K) * B. Lane = 4*g + t owns C fragment elements
// c[n][0..1] at (row g, cols 8n + 2t + {0,1}) and c[n][2..3] at row g + 8
// (the mma.sync m16n8 accumulator layout). A is row-major [16][lda].
// mma_nk: B stored [n][k] (k contiguous); mma_kn: B stored [k][n].

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return elem16_bits(lo) | (elem16_bits(hi) << 16);
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32." DS_MMA_T "." DS_MMA_T ".f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

template <int N8>
__device__ __forceinline__ void mma_nk(float (&c)[N8][4], const bf16* A, int lda, const bf16* B,
                                       int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(A + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(A + g * lda + k0 + 8 + 2 * t);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k0 + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const bf16* bp = B + (n * 8 + g) * ldb + k0 + 2 * t;
      mma16816(c[n], a0, a1, a2, a3, ld32(bp), ld32(bp + 8));
    }
  }
}

template <int N8>
__device__ __forceinline__ void mma_kn(float (&c)[N8][4], const bf16* A, int lda, const bf16* B,
                                       int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k0 = 0; k0 < K; k0 += 16) {
    const uint32_t a0 = ld32(A + g * lda + k0 + 2 * t);
    const uint32_t a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
    const uint32_t a2 = ld32(A + g * lda + k0 + 8 + 2 * t);
    const uint32_t a3 = ld32(A + (g + 8) * lda + k0 + 8 + 2 * t);
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const bf16* bp = B + (k0 + 2 * t) * ldb + n * 8 + g;
      const uint32_t b0 = pack2(bp[0], bp[ldb]);
      const uint32_t b1 = pack2(bp[8 * ldb], bp[9 * ldb]);
      mma16816(c[n], a0, a1, a2, a3, b0, b1);
    }
  }
}

template <int N8>
__device__ __forceinline__ void mma_nk(float (&c)[N8][4], const float* A, int lda, const float* B,
                                       int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float lo = A[g * lda + k], hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const float b0 = B[(n * 8 + 2 * t) * ldb + k], b1 = B[(n * 8 + 2 * t + 1) * ldb + k];
      c[n][0] = fmaf(lo, b0, c[n][0]);
      c[n][1] = fmaf(lo, b1, c[n][1]);
      c[n][2] = fmaf(hi, b0, c[n][2]);
      c[n][3] = fmaf(hi, b1, c[n][3]);
    }
  }
}

template <int N8>
__device__ __forceinline__ void mma_kn(float (&c)[N8][4], const float* A, int lda, const float* B,
                                       int ldb, int K) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int k = 0; k < K; ++k) {
    const float lo = A[g * lda + k], hi = A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const float b0 = B[k * ldb + n * 8 + 2 * t], b1 = B[k * ldb + n * 8 + 2 * t + 1];
      c[n][0] = fmaf(lo, b0, c[n][0]);
      c[n][1] = fmaf(lo, b1, c[n][1]);
      c[n][2] = fmaf(hi, b0, c[n][2]);
      c[n][3] = fmaf(hi, b1, c[n][3]);
    }
  }
}

// -------------------------------------------------------------- tile I/O

// rows [row0, row0 + ROWS) of a strided (T, D) slab into shared [ROWS][ld],
// by the CTA's NTHR threads; rows at or past T are zero (16-byte vectors;
// the wrappers guarantee alignment).
template <typename T, int D, int ROWS, int NTHR>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, long long st, int row0,
                                          int T_) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = D / VEC;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NTHR) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T_) val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

// sum over the head dim of do * o for each of a warp's 16 rows [row0,
// row0 + 16) (zero at or past T), minus dlse where given: the backward's
// delta, returned to the lanes owning rows g and g + 8 of the mma fragment
// (d[0], d[1]); every lane of the warp must call it.
template <typename T, int D>
__device__ __forceinline__ void warp_row_delta(float (&d)[2], const T* dout, long long sdo,
                                               const T* o, long long so, const float* dlse,
                                               int row0, int T_) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  d[0] = d[1] = 0.f;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = row0 + rr;
    if (row >= T_) break;
    float s = 0.f;
    for (int e = lane; e < D; e += 32)
      s += to_f<T>(dout[(long long)row * sdo + e]) * to_f<T>(o[(long long)row * so + e]);
    s = warp_sum(s);
    if (dlse) s -= dlse[row];
    if (rr == g) d[0] = s;
    if (rr == g + 8) d[1] = s;
  }
}

}  // namespace
