// Tile helpers shared by the port's GEMM-shaped kernels (grouped_matmul.cu,
// mlp_matmul.cu), CUDA C++ for sm_90a: 128-thread CTAs (4 warps) over
// 64-column output tiles, a 4-stage cp.async ring, mma.sync m16n8k16
// (bf16 -> fp32; fp32 instances do scalar FMAs in the same fragment
// layout), and the in-kernel walk of the group sizes that maps a logical
// tile to its group and rows.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int NW = 4;
constexpr int NT = NW * 32;
constexpr int BN = 64;      // output columns per CTA
constexpr int STAGES = 4;   // cp.async ring depth

typedef __nv_bfloat16 bf16;

// K slice per stage: 128 bytes of a row either way
template <typename T> struct Slice;
template <> struct Slice<bf16> { static constexpr int BK = 64; };
template <> struct Slice<float> { static constexpr int BK = 32; };

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void ldsm_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                        const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C (16 x 8*N8) += A (16 x BK) * B (BK x 8*N8). A is stored [m][k] (row-
// major), or [k][m] when AT; B is stored [k][n], or [n][k] when BT. Lane
// 4g+t owns c[n][0..1] at (row g, cols 8n+2t+{0,1}) and c[n][2..3] at row
// g+8. ldmatrix lane l addresses row l&7 of 8x8 matrix l>>3.
template <int N8, int BK, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&c)[N8][4], const bf16* A, int lda, const bf16* B,
                                         int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lr = lane & 7, lm = (lane >> 3) & 1, lh = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    uint32_t a0, a1, a2, a3;
    if (AT) {  // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), each transposed
      ldsm_x4_trans(a0, a1, a2, a3, A + (k0 + lh * 8 + lr) * lda + lm * 8);
    } else {
      a0 = ld32(A + g * lda + k0 + 2 * t);
      a1 = ld32(A + (g + 8) * lda + k0 + 2 * t);
      a2 = ld32(A + g * lda + k0 + 8 + 2 * t);
      a3 = ld32(A + (g + 8) * lda + k0 + 8 + 2 * t);
    }
#pragma unroll
    for (int p = 0; p < N8 / 2; ++p) {
      uint32_t b0, b1, b2, b3;
      if (BT)  // matrices (n 16p.. | 16p+8..) x (k 0-7 | 8-15)
        ldsm_x4(b0, b1, b2, b3, B + (p * 16 + lh * 8 + lr) * ldb + k0 + lm * 8);
      else     // matrices 0/1: k rows k0..k0+15 at cols 16p..16p+7, 2/3: cols +8
        ldsm_x4_trans(b0, b1, b2, b3, B + (k0 + (lane & 15)) * ldb + p * 16 + lh * 8);
      mma16816(c[2 * p], a0, a1, a2, a3, b0, b1);
      mma16816(c[2 * p + 1], a0, a1, a2, a3, b2, b3);
    }
  }
}

template <int N8, int BK, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&c)[N8][4], const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    const float lo = AT ? A[k * lda + g] : A[g * lda + k];
    const float hi = AT ? A[k * lda + g + 8] : A[(g + 8) * lda + k];
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int col = n * 8 + 2 * t;
      const float b0 = BT ? B[col * ldb + k] : B[k * ldb + col];
      const float b1 = BT ? B[(col + 1) * ldb + k] : B[k * ldb + col + 1];
      c[n][0] = fmaf(lo, b0, c[n][0]);
      c[n][1] = fmaf(lo, b1, c[n][1]);
      c[n][2] = fmaf(hi, b0, c[n][2]);
      c[n][3] = fmaf(hi, b1, c[n][3]);
    }
  }
}

// rows [row0, row0+BM) x cols [k0, k0+BK) of x into shared [BM][lda];
// rows >= M and cols >= K are zero.
template <typename T, int BM, int BK>
__device__ __forceinline__ void load_x(T* dst, int lda, const T* x, int M, int K, int row0,
                                       int k0, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = BK / VEC;
  for (int i = threadIdx.x; i < BM * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    const int row = row0 + r, col = k0 + c;
    T* d = dst + r * lda + c;
    const T* s = x + (long long)row * K + col;
    if (vec && row < M && col + VEC <= K) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = (row < M && col + v < K) ? s[v] : from_f<T>(0.f);
    }
  }
}

// Resolve logical tile `idx` to (segment, physical m-tile, row range).
// Segments: the non-empty groups in order, then the tail [total, M).
// Returns the group (0..E-1), -1 for a tail visit, -2 past the live count.
template <int BM>
__device__ int resolve_tile(const int* group_sizes, int E, int M, int idx, int& mt, int& lo,
                             int& hi) {
  int start = 0;
  for (int e = 0; e <= E; ++e) {
    int s, en;
    if (e < E) {
      const int size = max(group_sizes[e], 0);
      s = min(start, M);
      en = min(start + size, M);
      start = en;
    } else {
      s = min(start, M);
      en = M;
    }
    if (en <= s) continue;
    const int t0 = s / BM, t1 = (en + BM - 1) / BM;
    if (idx < t1 - t0) {
      mt = t0 + idx;
      lo = max(s, mt * BM);
      hi = min(en, mt * BM + BM);
      return e < E ? e : -1;
    }
    idx -= t1 - t0;
  }
  return -2;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
