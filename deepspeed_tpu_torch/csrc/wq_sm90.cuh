// K7's Hopper design (sm_90a): the weight-only quantized projection
//
//   out[s, n] = round(scale[n] * sum_k x[s, k] code[k, n])
//
// (mlp_matmul.cu wq_matmul_sm90_launch; it replaces
// deepspeed_tpu/ops/pallas/mlp_matmul.py _mm_wq_kernel via _mm_wq) on
// wgmma + TMA. Codes are int8 (K, N) or int4 packed two a byte along k
// (K / 2, N; the low nibble is the even k), the scale (N,) fp32 multiplies
// the fp32 accumulator once, and the output rounds once to bf16. Codes
// -127..127 are exact in bf16, so bf16 wgmma products equal the JAX
// kernel's fp32 ones up to the order of the sum.
//
// The weight is the register operand. The kernel forms the transposed
// product out^T = code^T x^T, the TPU kernel's own out_t branch
// (mlp_matmul.py:303-306): the widened codes are wgmma's A operand from
// registers (the RS form, as K1's P V in sm90_attention.cuh) and x is B,
// K-major from 128-byte swizzled shared memory; no bf16 copy of the weight
// is ever written anywhere.
//
// The CTA (384 threads) owns 128 features x NR rows of out (NR = 8, 64, 128
// or 256: wgmma's n, chosen by the wrapper from the row count) over one
// split of K:
//   warpgroup 0, the producer: one thread TMA-loads each 64-deep k slice
//     into an mbarrier ring: x's box (64 k x NR rows, bf16, 128-byte
//     swizzle) and the codes' box as raw bytes (128 features x 64 rows at
//     int8, 32 packed rows at int4; uint8, 128-byte swizzle);
//   warpgroups 1 and 2, the consumers: each owns 64 features, 16 a warp.
//     A warp's 16 features are one 16-byte chunk of a code row, so one
//     ldmatrix.x4.trans (int4; two at int8) fetches its A fragments for the
//     whole slice: transposing 16-bit elements (feature pairs) hands each
//     lane the bytes of features (2g, 2g + 1) at two code rows, and the
//     rows each lane sees are chosen by the row addresses: at int4 packed
//     rows t and t + 4 of a 16-k slice, which are exactly its (k, k + 1)
//     pairs at k = 2t and 2t + 8; at int8 rows 2t, 2t + 1 (+8). So A's
//     row g is feature 2g and its row g + 8 feature 2g + 1 (the epilogue
//     knows), and each fragment register is one byte (int4) or two (int8)
//     of those loads, widened to a bf16 pair by prmt + magic exponent: int4
//     nibbles as 0x4300 | (s + 8) minus 136 in bf16, int8 bytes as fp32
//     2^23 + (s + 128) minus 2^23 + 128, then one cvt to bf16x2. The slice's
//     four wgmma m64nNRk16 run while the next slice's codes are widened into
//     the second fragment buffer; the wait that retires them frees the
//     slot (one arrive per consumer warp).
//   Epilogue: each thread holds features (F, F + 1) at rows (s, s + 1) of a
//     column block, so it stores bf16 pairs (or fp32 pairs of the split's
//     partial) straight to device memory, a warp 4 rows x 32 bytes a store.
//
// Filling the card: 128-feature tiles give Llama-2-7B 86 tiles (N = 11008)
// or 32 (N = 4096) on 132 SMs (one CTA an SM: 384 threads x 168
// registers), so the wrapper (mlp_matmul.wq_plan) splits K into the most
// parts S whose items still run in one wave (86 -> 1, 32 -> 4: a second
// wave's start and the partials' round trip outweigh the work a split
// takes off each CTA). Split z takes k slices
// [z nst / S, (z + 1) nst / S) and writes fp32 partials (S, M, N);
// wq_merge_kernel sums them in split order, applies the scale and rounds
// once: no atomics, calls repeat bitwise.
//
// Bound: operations at the 256-row chunk (2 M K N flops: 0.0233 ms at
// Llama-2-7B's FFN products), bytes at decode (the codes read once: 22.5 MB
// int4, 45.1 MB int8 a product). The ring is as deep as 227 KB allows (5-6
// stages at NR = 256, 16 at NR = 8) to keep enough bytes in flight.
//
// The CTA body is wq_cta, shared with K9's grouped design
// (grouped_matmul.cu wq_grouped_sm90_kernel, replacing grouped_matmul.py
// _gmm_wq_kernel and _swiglu_up_wq_kernel), which adds:
//   the grouped walk: the code maps gain the expert dim ((N, K or K / 2,
//     E) bytes), and a CTA's run (a group's NR rows from its segment's
//     first row, resolved on the device from the sizes) selects the expert
//     coordinate and x's first row; the epilogue stores only the run's rows
//     with its expert's scales;
//   two code boxes a stage (NQ = 2) sharing each x slice: the fused
//     SwiGLU's w1 and w3 at the same 128 features (two accumulators, s1 and
//     s3 on the fp32 sums, silu * mul in fp32, one rounding), or the down
//     projection's one weight at 256 features (wide: half the x slices a
//     feature);
//   the register budget: a consumer holds NQ accumulators of NR / 2 and two
//     fragment buffers of 16 registers a box (the slice in flight, the next
//     one widening): 2 x 64 + 64 = 192 at NR = 128 under the 232 that
//     setmaxnreg gives the consumers (ptxas: 168 at the launch bound, 0
//     spilled, chip_smoke.py phase 0b).

#pragma once

#include "sm90_attention.cuh"

namespace wq90 {

typedef __nv_bfloat16 bf16;

constexpr int FT = 128;  // features a CTA (two consumers of 64)
constexpr int KS = 64;   // k a slice: one 128-byte swizzle row of x
constexpr int THREADS = 384;

template <int NR>
__host__ __device__ constexpr int x_bytes() {
  return NR * KS * 2;
}
template <int BITS>
__host__ __device__ constexpr int q_rows() {
  return BITS == 8 ? KS : KS / 2;
}
template <int BITS>
__host__ __device__ constexpr int q_bytes() {
  return q_rows<BITS>() * FT;
}
// ring depth and shared memory with NQ code boxes a stage (2: K9's fused
// SwiGLU, w1's and w3's)
template <int BITS, int NR, int NQ = 1>
__host__ __device__ constexpr int stages() {
  constexpr int fit = (232448 - 1024 - 512) / (x_bytes<NR>() + NQ * q_bytes<BITS>());
  return fit < 16 ? fit : 16;
}
template <int BITS, int NR, int NQ = 1>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + stages<BITS, NR, NQ>() * (x_bytes<NR>() + NQ * q_bytes<BITS>() + 16);
}

struct Args {
  const float* scale;  // (N,) fp32
  bf16* out;           // (M, N) bf16, contiguous
  float* part;         // (S, M, N) fp32 partials (S > 1)
  int M, K, N, S;
};

// ------------------------------------------------------------------ device

// d (64 x 8, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 8) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n8k16_rs_k(float (&d)[4], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 16) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n16k16_rs_k(float (&d)[8], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 64) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n64k16_rs_k(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 80, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 80) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n80k16_rs_k(float (&d)[40], const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 128) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n128k16_rs_k(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 256, fp32 fragments) += A (64 x 16, bf16 pairs in registers, the
// accumulator layout) * B (16 x 256) from shared memory, K-major.
__device__ __forceinline__ void wgmma_m64n256k16_rs_k(float (&d)[128], const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
        "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]),
        "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int NR>
__device__ __forceinline__ void wgmma_rs(float (&d)[NR / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (NR == 8)
    wgmma_m64n8k16_rs_k(d, a, db);
  else if constexpr (NR == 16)
    wgmma_m64n16k16_rs_k(d, a, db);
  else if constexpr (NR == 64)
    wgmma_m64n64k16_rs_k(d, a, db);
  else if constexpr (NR == 80)
    wgmma_m64n80k16_rs_k(d, a, db);
  else if constexpr (NR == 128)
    wgmma_m64n128k16_rs_k(d, a, db);
  else
    wgmma_m64n256k16_rs_k(d, a, db);
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The four bytes of ``r`` (each a (k, k + 1) pair of signed nibbles, k in
// the low one) as four bf16 pairs: each nibble goes in offset form (s + 8)
// into the mantissa of 128.0 (0x4300), and 136 comes off.
__device__ __forceinline__ void widen_int4(uint32_t r, uint32_t* f) {
  const uint32_t w = r ^ 0x88888888u;
  const uint32_t lo = w & 0x0F0F0F0Fu, hi = (w >> 4) & 0x0F0F0F0Fu;
  const __nv_bfloat162 bias = __floats2bfloat162_rn(136.f, 136.f);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // bytes: lo's byte j, 0 (lo's byte j sign-replicated: its msb is 0),
    // hi's byte j, 0
    const uint32_t v = prmt(lo, hi, j | ((8 | j) << 4) | ((4 + j) << 8) | ((12 + j) << 12)) |
                       0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), bias);
    f[j] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// Bytes ``lo`` and ``hi`` of ``w`` (int8 codes in offset form, s + 128) as
// one bf16 pair: each byte is the low mantissa byte of 2^23 in fp32.
__device__ __forceinline__ uint32_t widen_int8(uint32_t w, int lo, int hi) {
  const float a = __uint_as_float(prmt(w, 0x4B000000u, lo | 0x7650)) - 8388736.f;
  const float b = __uint_as_float(prmt(w, 0x4B000000u, hi | 0x7650)) - 8388736.f;
  return sm90::pack_bf16(a, b);
}

// One CTA's product: the NR x rows from ``row0`` times NQ code boxes of
// 128 features (box 0 of map mq at features from ``f0``; box 1 of map mq3
// at features from ``f1``) over the k slices [s_lo, s_lo + steps) of the
// codes of expert ``e`` (the code maps' third coordinate; 0 and a rank-2
// map for K7's dense weight). NQ = 2 is K9's fused SwiGLU (w1's and w3's
// codes at the same features) or its wide down projection (one weight's
// codes at f0 and f0 + 128): either way both boxes share each x slice.
// Each consumer thread ends by calling ``epi(acc, F, t)``: acc[j][4 b + e]
// is box j's sum for its feature F + (e >> 1) (F counted from f0 for box
// 0, from f1 for box 1) at row row0 + 8 b + 2 t + (e & 1).
template <int BITS, int NR, int NQ, class Epi>
__device__ __forceinline__ void wq_cta(const CUtensorMap& mx, const CUtensorMap& mq,
                                       const CUtensorMap& mq3, int q_rank, int f0, int f1,
                                       int row0, int e, int s_lo, int steps, const Epi& epi) {
  constexpr int ST = stages<BITS, NR, NQ>();
  constexpr int XB = x_bytes<NR>(), QB = q_bytes<BITS>(), QR = q_rows<BITS>();
  unsigned char* base =
      sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* xs = base;            // [ST][XB]
  unsigned char* qs = base + ST * XB;  // [ST][NQ][QB]
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + ST * NQ * QB);
  uint64_t* empty = full + ST;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int s = 0; s < steps; ++s) {
        sm90::mbar_wait(&empty[stage], phase ^ 1);
        sm90::mbar_expect_tx(&full[stage], XB + NQ * QB);
        const int kq = (s_lo + s) * QR;
        sm90::tma_load(xs + stage * XB, &mx, &full[stage], 2, (s_lo + s) * KS, row0, 0, 0);
        sm90::tma_load(qs + stage * NQ * QB, &mq, &full[stage], q_rank, f0, kq, e, 0);
        if constexpr (NQ == 2)
          sm90::tma_load(qs + (stage * NQ + 1) * QB, &mq3, &full[stage], q_rank, f1, kq, e, 0);
        if (++stage == ST) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, warp = tid >> 5, lane = tid & 31;
    const int chunk = 4 * cw + warp;  // this warp's 16 features in a code row
    // this lane's ldmatrix row: int4, matrix j = 16-k slice j, its row i =
    // packed row (i >> 1) + 4 (i & 1); int8, matrix j = (slice 2u + j / 2,
    // half j % 2), row i = k 8 (j % 2) + i of that slice
    const int j = lane >> 3, i = lane & 7;
    const int row = BITS == 4 ? 8 * j + (i >> 1) + 4 * (i & 1) : 16 * (j >> 1) + 8 * (j & 1) + i;
    const uint32_t q_off = row * FT + ((chunk ^ (row & 7)) << 4);
    const uint32_t q_base = sm90::smem_u32(qs) + q_off;

    // A fragments of code operand ``op`` in slice ``stg``: 16-k slice kk
    // in f[4 kk .. 4 kk + 3]
    auto load_a = [&](int stg, int op, uint32_t (&f)[16]) {
      const uint32_t q = q_base + (stg * NQ + op) * QB;
      if constexpr (BITS == 4) {
        uint32_t r[4];
        ldsm_x4_trans(r, q);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) widen_int4(r[kk], f + 4 * kk);
      } else {
        uint32_t r[2][4];
        ldsm_x4_trans(r[0], q);
        ldsm_x4_trans(r[1], q + 32 * FT);  // slices 2, 3: k rows 32-63
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t w0 = r[kk >> 1][2 * (kk & 1)] ^ 0x80808080u;      // k 2t, 2t + 1
          const uint32_t w1 = r[kk >> 1][2 * (kk & 1) + 1] ^ 0x80808080u;  // k 2t + 8, 2t + 9
          f[4 * kk] = widen_int8(w0, 0, 2);      // feature 2g
          f[4 * kk + 1] = widen_int8(w0, 1, 3);  // feature 2g + 1
          f[4 * kk + 2] = widen_int8(w1, 0, 2);
          f[4 * kk + 3] = widen_int8(w1, 1, 3);
        }
      }
    };

    float acc[NQ][NR / 2];
#pragma unroll
    for (int o = 0; o < NQ; ++o)
#pragma unroll
      for (int x = 0; x < NR / 2; ++x) acc[o][x] = 0.f;
    uint32_t fa[NQ][16], fb[NQ][16];
#pragma unroll
    for (int o = 0; o < NQ; ++o)
#pragma unroll
      for (int x = 0; x < 16; ++x) fb[o][x] = 0u;
    int stage = 0, prev = -1;
    uint32_t phase = 0;
    // slice s from ``cur`` (issued), then slice s + 1's fragments into
    // ``nxt`` while it runs; ``nxt`` held slice s - 1's, retired by the wait
    auto step = [&](uint32_t (&cur)[NQ][16], uint32_t (&nxt)[NQ][16], int s) {
#pragma unroll
      for (int o = 0; o < NQ; ++o) sm90::fence_regs(acc[o]);
      sm90::wgmma_fence();
      const unsigned char* xb = xs + stage * XB;
#pragma unroll
      for (int o = 0; o < NQ; ++o)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint32_t f4[4] = {cur[o][4 * kk], cur[o][4 * kk + 1], cur[o][4 * kk + 2],
                                  cur[o][4 * kk + 3]};
          wgmma_rs<NR>(acc[o], f4, sm90::smem_desc(xb + kk * 32, 16, 1024));
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait<1>();
#pragma unroll
      for (int o = 0; o < NQ; ++o) {
        sm90::fence_regs(acc[o]);
        sm90::keep_regs(nxt[o]);
      }
      if (prev >= 0 && lane == 0) sm90::mbar_arrive(&empty[prev]);
      prev = stage;
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
      if (s + 1 < steps) {
        sm90::mbar_wait(&full[stage], phase);
#pragma unroll
        for (int o = 0; o < NQ; ++o) load_a(stage, o, nxt[o]);
      }
    };
    if (steps > 0) {
      sm90::mbar_wait(&full[0], 0);
#pragma unroll
      for (int o = 0; o < NQ; ++o) load_a(0, o, fa[o]);
    }
    for (int s = 0; s < steps; s += 2) {
      step(fa, fb, s);
      if (s + 1 < steps) step(fb, fa, s + 1);
    }
    sm90::wgmma_wait<0>();
#pragma unroll
    for (int o = 0; o < NQ; ++o) {
      sm90::fence_regs(acc[o]);
      sm90::keep_regs(fa[o]);
      sm90::keep_regs(fb[o]);
    }
    epi(acc, 64 * cw + 16 * warp + 2 * (lane >> 2), lane & 3);
  }
}

// K7's epilogue: the scale and one rounding to bf16 (one split), or the
// split's fp32 partial; rows below M.
struct DenseEpi {
  Args a;
  int row0, z;
  int f0;
  template <int N>
  __device__ __forceinline__ void operator()(const float (&acc)[1][N], int f, int t4) const {
    const int F = f0 + f;
    if (F >= a.N) return;
    if (a.S == 1) {
      const float s0 = a.scale[F], s1 = a.scale[F + 1];
#pragma unroll
      for (int b = 0; b < N / 4; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + 8 * b + 2 * t4 + e;
          if (r < a.M)
            *reinterpret_cast<uint32_t*>(a.out + (long long)r * a.N + F) =
                sm90::pack_bf16(acc[0][4 * b + e] * s0, acc[0][4 * b + 2 + e] * s1);
        }
    } else {
      float* p = a.part + (long long)z * a.M * a.N;
#pragma unroll
      for (int b = 0; b < N / 4; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = row0 + 8 * b + 2 * t4 + e;
          if (r < a.M)
            *reinterpret_cast<float2*>(p + (long long)r * a.N + F) =
                make_float2(acc[0][4 * b + e], acc[0][4 * b + 2 + e]);
        }
    }
  }
};

template <int BITS, int NR>
__global__ void __launch_bounds__(THREADS, 1)
    wq_matmul_sm90_kernel(const __grid_constant__ CUtensorMap mx,
                          const __grid_constant__ CUtensorMap mq, Args a) {
  const int f0 = blockIdx.x * FT, row0 = blockIdx.y * NR, z = blockIdx.z;
  const int nst = (a.K + KS - 1) / KS;
  const int s_lo = (int)((long long)z * nst / a.S);
  const int steps = (int)((long long)(z + 1) * nst / a.S) - s_lo;
  wq_cta<BITS, NR, 1>(mx, mq, mq, 2, f0, f0, row0, 0, s_lo, steps, DenseEpi{a, row0, z, f0});
}

// out = round(scale * sum_z part[z]) with the partials summed in split
// order, four features a thread (N % 16 == 0).
__global__ void __launch_bounds__(256) wq_merge_kernel(Args a) {
  const long long quads = (long long)a.M * (a.N / 4), mn = (long long)a.M * a.N;
  for (long long u = blockIdx.x * 256LL + threadIdx.x; u < quads; u += (long long)gridDim.x * 256) {
    const long long off = u * 4;
    const int f = (int)(off % a.N);
    float4 s = *reinterpret_cast<const float4*>(a.part + off);
    for (int z = 1; z < a.S; ++z) {
      const float4 p = *reinterpret_cast<const float4*>(a.part + z * mn + off);
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const float4 sc = *reinterpret_cast<const float4*>(a.scale + f);
    uint2 o;
    o.x = sm90::pack_bf16(s.x * sc.x, s.y * sc.y);
    o.y = sm90::pack_bf16(s.z * sc.z, s.w * sc.w);
    *reinterpret_cast<uint2*>(a.out + off) = o;
  }
}

// A map over the (KR, N) code bytes of each of E experts (contiguous (E,
// KR, N); rank 2 when E = 1): box 128 features x QR rows, 128-byte swizzle.
inline cudaError_t make_code_map(CUtensorMap* map, const void* q, int KR, int N, int rows,
                                 int E = 1) {
  const sm90::EncodeTiledFn fn = sm90::encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)N, (cuuint64_t)KR, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)N, (cuuint64_t)KR * N};
  const cuuint32_t box[3] = {FT, (cuuint32_t)rows, 1}, unit[3] = {1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, E > 1 ? 3 : 2, const_cast<void*>(q),
                          dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BITS, int NR>
cudaError_t launch(const void* x, const void* q, const Args& a, cudaStream_t s) {
  CUtensorMap mx, mq;
  int rank, dim2_q;
  cudaError_t e = sm90::make_operand_map(&mx, x, a.K, a.M, a.K, 1, 0, 1, 0, NR, &rank, &dim2_q);
  if (e == cudaSuccess) e = make_code_map(&mq, q, BITS == 8 ? a.K : a.K / 2, a.N, q_rows<BITS>());
  if (e != cudaSuccess) return e;
  auto kernel = wq_matmul_sm90_kernel<BITS, NR>;
  constexpr int smem = smem_bytes<BITS, NR>();
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    smem_set = true;
  }
  const dim3 grid((a.N + FT - 1) / FT, (a.M + NR - 1) / NR, a.S);
  kernel<<<grid, THREADS, smem, s>>>(mx, mq, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.S == 1) return e;
  const long long blocks = ((long long)a.M * (a.N / 4) + 255) / 256;
  wq_merge_kernel<<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(a);
  return cudaGetLastError();
}

template <int BITS>
cudaError_t launch_bits(const void* x, const void* q, const Args& a, int row_tile,
                        cudaStream_t s) {
  switch (row_tile) {
    case 8: return launch<BITS, 8>(x, q, a, s);
    case 64: return launch<BITS, 64>(x, q, a, s);
    case 128: return launch<BITS, 128>(x, q, a, s);
    case 256: return launch<BITS, 256>(x, q, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wq90
