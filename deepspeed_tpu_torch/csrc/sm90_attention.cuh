// Hopper helpers for the attention tile (sm_90a), beside sm90_gemm.cuh
// (whose mbarrier, TMA load / store, descriptor and fence helpers they
// extend): the wgmma forms of K1's Hopper forward (flash_attention.cu,
// flash_fwd_sm90_kernel), a 4-d TMA store, and the host encoder of a
// tensor map over a (B, H, T, D) operand addressed through its (b, h, t)
// strides.
//
//   S = Q K^T: wgmma m64n128k16 with A (Q) and B (K) both K-major (d
//     contiguous) from swizzled shared memory; scale_d = 0 on the first
//     16-deep slice starts the accumulator at zero.
//   O += P V: wgmma m64nDk16 (D = 64 or 128) with A = P in registers (the
//     RS form: the S accumulator's fragments, rounded to bf16 in pairs, are
//     A's fragments of the same rows and keys) and B = V MN-major (d
//     contiguous; the transpose bit).
//
// K2's Hopper backward (flash_dkdv_sm90_kernel, flash_dq_sm90_kernel,
// flash_bwd_qmajor_sm90_kernel) adds the m64n64k16 SS form (S, S^T and dP
// over 64-row streamed tiles at D = 128) and the SS forms with B MN-major
// (dV += P^T dO and dK += dS^T Q with P^T, dS^T staged in shared memory as
// K-major A tiles, wgmma_pv_ss).
//
// K5's paged forward (paged_attention.cu, paged_chunk_sm90_kernel) runs
// K1's consumer loop on K / V blocks found through a block table:
// make_tiled_map gives the maps over its pools and its (C, H, D) q. K11's
// block-sparse forward (block_sparse_attention.cu, bsa_fwd_sm90_kernel)
// runs it on the blocks a pair of query blocks' lists name; K11's backward
// (bsa_dq_sm90_kernel, bsa_dkv_sm90_kernel) runs K2's per-tile products
// on the blocks one block's list names, and shares K2's bwd_p_ds,
// pack_frag and stage_bf16 (below).
//
// K8's bf16 grouped_swiglu_up (grouped_matmul.cu,
// grouped_swiglu_up_sm90_kernel) adds the SS forms with A MN-major (the
// transpose bit, wgmma_tn: m64n{16,80,128}k16): A = 64 features x 16 k of
// a weight box whose 128-byte lines are 64 features of one k, B = the
// run's rows of x, K-major.
//
// A (B, H, T, D) operand's map has dims (D, T, H, B), the 128-byte swizzle
// and a box of 64 d x ``rows``: one box covers a 64-wide half of the head
// dim, so D = 128 takes two boxes a tile. A box row is 128 bytes and rows
// are packed, so 8 rows make one 1024-byte swizzle atom: the K-major
// descriptor's stride byte offset is 1024, its k advances 32 bytes a 16-wide
// slice inside a half; the MN-major descriptor (V) advances 16 rows (2048
// bytes) a slice and finds the second 64-wide half one box away (its
// leading byte offset).

#pragma once

#include "sm90_gemm.cuh"

namespace sm90 {

// Keeps the compiler from moving register reads or writes across the
// asynchronous wgmma issue / wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Keeps an in-flight wgmma's register A operand live (unreused) until here,
// after the wait that retires it: the compiler takes an asm's inputs as
// read at the issue.
template <int N>
__device__ __forceinline__ void keep_regs(const uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" ::"r"(r[i]) : "memory");
}

// d (64 x 128, fp32 fragments) = A (64 x 16) * B (16 x 128) + (scale_d ? d : 0),
// A K-major and B K-major (TB = 0) or MN-major (TB = 1) from shared memory.
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (64 x 64, fp32 fragments) = A (64 x 16) * B (16 x 64) + (scale_d ? d : 0),
// A K-major and B K-major (TB = 0) or MN-major (TB = 1) from shared memory.
template <int TB = 0>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da, uint64_t db,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
}

// d (64 x 16, fp32 fragments) += A (64 x 16) * B (16 x 16), both from
// shared memory: A MN-major (the transpose bit), B K-major.
__device__ __forceinline__ void wgmma_m64n16k16_tn(float (&d)[8], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 80, fp32 fragments) += A (64 x 16) * B (16 x 80), both from
// shared memory: A MN-major (the transpose bit), B K-major.
__device__ __forceinline__ void wgmma_m64n80k16_tn(float (&d)[40], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, %40, %41, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "l"(da), "l"(db), "r"(1));
}

// d (64 x 128, fp32 fragments) += A (64 x 16) * B (16 x 128), both from
// shared memory: A MN-major (the transpose bit), B K-major.
__device__ __forceinline__ void wgmma_m64n128k16_tn(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// One 16-deep slice of the transposed product d (64 x N) += A B, A MN-major
// and B K-major (K8's bf16 grouped_swiglu_up: A = 64 features of a weight
// box, B = the run's N = 16, 80 or 128 rows of x).
template <int N>
__device__ __forceinline__ void wgmma_tn(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 16)
    wgmma_m64n16k16_tn(d, da, db);
  else if constexpr (N == 80)
    wgmma_m64n80k16_tn(d, da, db);
  else
    wgmma_m64n128k16_tn(d, da, db);
}

// One 16-deep slice of an S-shaped product, d (64 x N) = A B^T (+ d), A and
// B K-major (N = 64 or 128 rows of B).
template <int N>
__device__ __forceinline__ void wgmma_nt(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss<0>(d, da, db, scale_d);
  else
    wgmma_m64n128k16_ss<0>(d, da, db, scale_d);
}

// d (64 x D) += A (64 x 16, K-major) * B (16 x D, MN-major), both from
// shared memory.
template <int D>
__device__ __forceinline__ void wgmma_pv_ss(float (&d)[D / 2], uint64_t da, uint64_t db) {
  if constexpr (D == 64)
    wgmma_m64n64k16_ss<1>(d, da, db, 1);
  else
    wgmma_m64n128k16_ss<1>(d, da, db, 1);
}

// d (64 x 64, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 64) from shared memory, MN-major (the
// transpose bit).
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 128) from shared memory, MN-major (the
// transpose bit).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." DS_MMA_T "." DS_MMA_T " {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64)
    wgmma_m64n64k16_rs(d, a, db);
  else
    wgmma_m64n128k16_rs(d, a, db);
}

// Two fp32 values as a bf16 pair (lo in the low half), each rounded to
// nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return pack_elem16(lo, hi);
}

// 2^x (ex2.approx: relative error about 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// ---------------------------------------------- backward helpers (K2, K11)

constexpr int BOX_BYTES = 64 * 128;  // a 64-row, 64-d TMA box: 8 KB
constexpr float BWD_LOG2E = 1.4426950408889634f;

// p = exp(s - lse) (0 on a masked pair) from lse2 = lse log2(e), and
// ds = p (dp - delta) in dp: one instruction sequence for every backward
// kernel (K2, K2-qmajor, K11), so that designs that walk the same pairs
// agree bitwise.
__device__ __forceinline__ void bwd_p_ds(float& s, float& dp, float lse2, float dl, bool ok) {
  const float p = ok ? ex2(fmaf(s, BWD_LOG2E, -lse2)) : 0.f;
  dp = p * (dp - dl);
  s = p;
}

// bf16 pairs of a 64 x N fp32 fragment: the A fragments of an RS product
// over its N columns (16-deep slice kk in a[4 kk .. 4 kk + 3]).
template <int N>
__device__ __forceinline__ void pack_frag(const float (&x)[N / 2], uint32_t (&a)[N / 4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    a[2 * n] = pack_bf16(x[4 * n], x[4 * n + 1]);
    a[2 * n + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
  }
}

// A consumer's 64 x D fp32 accumulator rounded to bf16 into ``st`` in the
// TMA box layout (64-d halves one box apart, 16-byte chunk c of row r at
// c ^ (r % 8)).
template <int D>
__device__ __forceinline__ void stage_bf16(const float (&acc)[D / 2], unsigned char* st, int tid) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = frag_row(tid, 2 * i), c = frag_col(tid, n, 0) & 63;
      unsigned char* dst =
          st + (n >> 3) * BOX_BYTES + r * 128 + (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
      *reinterpret_cast<uint32_t*>(dst) = pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
    }
  }
}

// One TMA store of a box at (c0, c1, c2, c3) from shared memory; completes
// in the issuing thread's bulk group (sm90_gemm.cuh's tma_store_commit /
// tma_store_wait_read / tma_store_wait_all).
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A map over a bf16 tensor of ``rank`` dims, innermost first (dims[0]
// contiguous), through the element strides of dims 1 .. rank - 1 (each a
// multiple of 8), with the 128-byte swizzle and the box ``box`` (box[0] =
// 64: one 128-byte swizzle row). K5's paged forward reads its pools and
// its (C, H, D) q through such maps.
inline cudaError_t make_tiled_map(CUtensorMap* map, const void* base, int rank,
                                  const long long* dims, const long long* strides,
                                  const int* box) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t d[5], st[4];
  cuuint32_t bx[5], unit[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
    unit[i] = 1;
    if (i > 0) st[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  const CUresult res = fn(map, DS_TMA_ELEM, rank, const_cast<void*>(base), d,
                          st, bx, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A map over a bf16 (B, H, T, D) operand through its element strides (b, h,
// t), d contiguous: dims (D, T, H, B), box 64 d x ``rows``, 128-byte
// swizzle. A dim of extent 1 gets the packed stride of the dims inside it
// (its coordinate is always 0).
inline cudaError_t make_bhtd_map(CUtensorMap* map, const void* base, int B, int H, int T, int D,
                                 long long sb, long long sh, long long st, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)H, (cuuint64_t)B};
  long long s_t = T > 1 ? st : D;
  long long s_h = H > 1 ? sh : s_t * T;
  long long s_b = B > 1 ? sb : s_h * H;
  const cuuint64_t strides[3] = {(cuuint64_t)s_t * 2, (cuuint64_t)s_h * 2, (cuuint64_t)s_b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, DS_TMA_ELEM, 4, const_cast<void*>(base), dims,
                          strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace sm90
