// Weight-only quantized GEMM (W8A16 / W4A16), CUDA C++ for sm_90a: the
// kernel behind K7 (mlp_matmul.cu wq_matmul_launch, replacing
// deepspeed_tpu/ops/pallas/mlp_matmul.py _mm_wq_kernel) and K9
// (grouped_matmul.cu grouped_gmm_wq_launch / grouped_swiglu_up_wq_launch,
// replacing grouped_matmul.py _gmm_wq_kernel / _swiglu_up_wq_kernel).
//
//   out[s, n] = round(scale[g, n] * sum_k x[s, k] code[g, k, n])
//
// and for swiglu_up h = silu(s1 * (x code1)) * (s3 * (x code3)): the scales
// multiply the fp32 accumulators before silu * mul (grouped_matmul.py:
// 565-569). Codes are int8 (K code rows) or int4 packed two per byte
// along k (K / 2 rows; byte r holds code 2r in its low nibble and code
// 2r + 1 in its high nibble, both sign-extended). The code bytes stage
// [row][n] in a ring of 16-byte cp.async copies, and each lane builds its
// mma B fragment straight from shared memory: the codes (k, k + 1) at its
// column (one byte at int4, two at int8) widen to one bf16x2 register.
// Codes -127..127 are exact in bf16, so mma.sync bf16 -> fp32 gives the
// JAX kernel's fp32 products up to summation order. Widening costs more
// instructions than the mma it feeds, so each warp owns all BM rows x 16
// columns and widens each fragment once for its BM / 16 m16 tiles. The scale
// lies on the non-contracted dim, so it multiplies the fp32 accumulator
// once in the epilogue, then the output rounds once to x's dtype. fp32 x
// takes scalar FMAs in the same fragment layout (the parity checks).
//
// Grouped (group_sizes != null): K8's grid and resolution. A logical tile
// is a (group or tail segment, BM-row physical tile) pair resolved from
// the E sizes in device memory (no host sync); a visit writes only its
// segment's rows, with its own expert's scales, and the tail past the
// groups is written as zeros. Dense (group_sizes == null, E == 1): logical
// tile i is physical tile i.
//
// Bound: bytes on the serving paths. A decode call streams each touched
// expert's codes once (Mixtral-8x7B: 5 of 8 experts at 16 routed rows, 2 x
// 58.7 MB of int8 codes per expert for swiglu_up) or the dense weight's
// once (Llama-2-7B int4: 22.5 MB per FFN product at 8 rows), against
// 16 x 2 FLOP per code. BM = 16 at decode (an 8-stage ring for the
// one-weight products: a call is a few long-K streams), 64 above with 4
// stages; 64 output columns per CTA. K7's and K9's bf16 products have
// Hopper designs (wq_sm90.cuh: the widened codes as wgmma's register
// operand, TMA loads; K7 with a K split, K9 on a grouped walk), faster on
// the card at every K9 row count chip_smoke.py phase 14 times (Mixtral's
// 16-row decode and 512-row chunk); this kernel serves K7's and K9's fp32
// instances and the bf16 operands TMA cannot address (K not a multiple of
// 8, N not a multiple of 16, bases off 16 bytes).

#pragma once

#include "gemm_common.cuh"

struct WqArgs {
  const void* x;           // (M, K) contiguous, x's dtype
  const int8_t* q1;        // (E, K | K/2, N) codes, contiguous
  const int8_t* q3;        // swiglu_up: w3's codes (q1's shape); else unused
  const float* s1;         // (E, 1, N) fp32 scales of q1
  const float* s3;         // swiglu_up: the scales of q3
  const int* group_sizes;  // (E,) int32 in device memory; null = dense
  void* out;               // (M, N) contiguous, x's dtype
  int M, K, N, E;
  int vec_x;               // x rows may be staged as 16-byte vectors
  int vec_w;               // code rows may be staged as 16-byte vectors
};

namespace {

constexpr int LDQ = BN + 16;  // bytes per staged code row

// code (k, n) of a staged tile (n relative to the tile's columns)
template <int WQ>
__device__ __forceinline__ int code_at(const int8_t* B, int k, int n) {
  if (WQ == 8) return B[k * LDQ + n];
  const int b = B[(k >> 1) * LDQ + n];
  return (k & 1) ? (b >> 4) : (((b & 0xF) ^ 8) - 8);
}

// codes (k, n) and (k + 1, n), k even, as a bf16x2 register (k low)
template <int WQ>
__device__ __forceinline__ uint32_t code_pair(const int8_t* B, int k, int n) {
  int lo, hi;
  if (WQ == 8) {
    lo = B[k * LDQ + n];
    hi = B[(k + 1) * LDQ + n];
  } else {
    const int b = B[(k >> 1) * LDQ + n];
    lo = ((b & 0xF) ^ 8) - 8;
    hi = b >> 4;
  }
  const __nv_bfloat162 v = __floats2bfloat162_rn((float)lo, (float)hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// C (16*MT x 8*N8) += A (16*MT x BK, stored [m][k]) * codes (BK x 8*N8).
// Each B fragment is widened once and feeds the MT m16 tiles. The B
// fragment of lane 4g+t holds k rows 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of
// column g.
template <int MT, int N8, int BK, int WQ>
__device__ __forceinline__ void mma_tile_q(float (&c)[MT][N8][4], const bf16* A, int lda,
                                           const int8_t* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    uint32_t b[N8][2];
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      b[n][0] = code_pair<WQ>(B, k0 + 2 * t, n * 8 + g);
      b[n][1] = code_pair<WQ>(B, k0 + 2 * t + 8, n * 8 + g);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const bf16* a = A + m * 16 * lda + k0 + 2 * t;
      const uint32_t a0 = ld32(a + g * lda);
      const uint32_t a1 = ld32(a + (g + 8) * lda);
      const uint32_t a2 = ld32(a + g * lda + 8);
      const uint32_t a3 = ld32(a + (g + 8) * lda + 8);
#pragma unroll
      for (int n = 0; n < N8; ++n) mma16816(c[m][n], a0, a1, a2, a3, b[n][0], b[n][1]);
    }
  }
}

template <int MT, int N8, int BK, int WQ>
__device__ __forceinline__ void mma_tile_q(float (&c)[MT][N8][4], const float* A, int lda,
                                           const int8_t* B) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float b[N8][2];
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      b[n][0] = (float)code_at<WQ>(B, k, n * 8 + 2 * t);
      b[n][1] = (float)code_at<WQ>(B, k, n * 8 + 2 * t + 1);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float lo = A[(m * 16 + g) * lda + k], hi = A[(m * 16 + g + 8) * lda + k];
#pragma unroll
      for (int n = 0; n < N8; ++n) {
        c[m][n][0] = fmaf(lo, b[n][0], c[m][n][0]);
        c[m][n][1] = fmaf(lo, b[n][1], c[m][n][1]);
        c[m][n][2] = fmaf(hi, b[n][0], c[m][n][2]);
        c[m][n][3] = fmaf(hi, b[n][1], c[m][n][3]);
      }
    }
  }
}

// code rows [r0, r0+ROWS) x cols [n0, n0+BN) of one (KR, N) code matrix
// into shared [ROWS][LDQ]; rows >= KR and cols >= N are zero.
template <int ROWS>
__device__ __forceinline__ void load_codes(int8_t* dst, const int8_t* q, int KR, int N, int r0,
                                           int n0, bool vec) {
  constexpr int CPR = BN / 16;
  for (int i = threadIdx.x; i < ROWS * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * 16;
    const int kr = r0 + r, n = n0 + c;
    int8_t* d = dst + r * LDQ + c;
    const int8_t* s = q + (long long)kr * N + n;
    if (vec && kr < KR && n + 16 <= N) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int v = 0; v < 16; ++v) d[v] = (kr < KR && n + v < N) ? s[v] : (int8_t)0;
    }
  }
}

// code rows per stage: one K slice of Slice<T>::BK values
template <typename T, int WQ>
__host__ __device__ constexpr int code_rows() {
  return WQ == 4 ? Slice<T>::BK / 2 : Slice<T>::BK;
}

// cp.async ring depth: deeper for a one-weight product at BM = 16, where a
// call is a few long-K streams (decode) and bytes in flight set the rate
// (the fused SwiGLU stages two code tiles a step and keeps 4: 8 halved
// its CTAs per SM and ran slower)
template <int BM, bool SWIGLU>
__host__ __device__ constexpr int wq_stages() {
  return BM == 16 && !SWIGLU ? 8 : STAGES;
}

template <typename T, int BM, bool SWIGLU, int WQ>
__global__ void __launch_bounds__(NT) wq_kernel(WqArgs a) {
  constexpr int BK = Slice<T>::BK;
  constexpr int KR = code_rows<T, WQ>();
  constexpr int QB = KR * LDQ;         // bytes of one staged code tile
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LDA = BK + PAD;
  constexpr int NWT = SWIGLU ? 2 : 1;  // code tiles per stage
  constexpr int QS = wq_stages<BM, SWIGLU>();
  constexpr int MT = BM / 16;          // m16 tiles per warp: every warp
  constexpr int N8 = BN / NW / 8;      // takes all BM rows x 16 columns

  __shared__ int info[4];
  if (threadIdx.x == 0) {
    int g = 0, mt = blockIdx.x;
    int lo = mt * BM, hi = min(a.M, mt * BM + BM);
    if (a.group_sizes != nullptr)
      g = resolve_tile<BM>(a.group_sizes, a.E, a.M, blockIdx.x, mt, lo, hi);
    info[0] = g;
    info[1] = mt;
    info[2] = lo;
    info[3] = hi;
  }
  __syncthreads();
  const int g = info[0], mt = info[1], lo = info[2], hi = info[3];
  if (g == -2) return;  // past the live visits
  const int n0 = blockIdx.y * BN;
  T* out = reinterpret_cast<T*>(a.out);

  if (g == -1) {  // rows past the groups: exactly zero
    for (int i = threadIdx.x; i < (hi - lo) * BN; i += NT) {
      const int r = lo + i / BN, n = n0 + i % BN;
      if (n < a.N) out[(long long)r * a.N + n] = from_f<T>(0.f);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);                      // [QS][BM][LDA]
  int8_t* Bs = reinterpret_cast<int8_t*>(As + QS * BM * LDA);  // [QS][NWT][KR][LDQ]

  const T* x = reinterpret_cast<const T*>(a.x);
  const int rows = WQ == 4 ? a.K / 2 : a.K;  // code rows of one weight
  const long long qoff = (long long)g * rows * a.N;
  const int8_t* q[2] = {a.q1 + qoff, SWIGLU ? a.q3 + qoff : nullptr};
  const int row0 = mt * BM;
  const int nk = (a.K + BK - 1) / BK;
  const bool vx = a.vec_x != 0, vw = a.vec_w != 0;

  auto load_stage = [&](int slot, int kt) {
    load_x<T, BM, BK>(As + slot * BM * LDA, LDA, x, a.M, a.K, row0, kt * BK, vx);
#pragma unroll
    for (int j = 0; j < NWT; ++j)
      load_codes<KR>(Bs + (slot * NWT + j) * QB, q[j], rows, a.N, kt * KR, n0, vw);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b_off = warp * (BN / NW);  // this warp's first column
  float acc[NWT][MT][N8][4];
#pragma unroll
  for (int j = 0; j < NWT; ++j)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < N8; ++n)
        acc[j][m][n][0] = acc[j][m][n][1] = acc[j][m][n][2] = acc[j][m][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < QS - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<QS - 2>();
    __syncthreads();  // tile kt landed; slot (kt - 1) % QS is free
    const int nxt = kt + QS - 1;
    if (nxt < nk) load_stage(nxt % QS, nxt);
    cp_async_commit();
    const int slot = kt % QS;
#pragma unroll
    for (int j = 0; j < NWT; ++j)
      mma_tile_q<MT, N8, BK, WQ>(acc[j], As + slot * BM * LDA, LDA,
                                 Bs + (slot * NWT + j) * QB + b_off);
  }
  cp_async_wait<0>();

  // epilogue: only this segment's rows; the scales on the fp32
  // accumulators, fp32 silu * mul, one rounding
  const float* s1 = a.s1 + (long long)g * a.N;
  const float* s3 = SWIGLU ? a.s3 + (long long)g * a.N : nullptr;
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + m * 16 + gq + (e >> 1) * 8;
        const int col = n0 + b_off + n * 8 + 2 * t4 + (e & 1);
        if (row < lo || row >= hi || col >= a.N) continue;
        float v = acc[0][m][n][e] * s1[col];
        if (SWIGLU) {
          const float u = acc[NWT - 1][m][n][e] * s3[col];
          v = v / (1.f + expf(-v)) * u;
        }
        out[(long long)row * a.N + col] = from_f<T>(v);
      }
}

template <typename T, int BM, bool SWIGLU, int WQ>
cudaError_t launch_wq(const WqArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = (size_t)wq_stages<BM, SWIGLU>() *
                      ((size_t)BM * (Slice<T>::BK + PAD) * sizeof(T) +
                       (SWIGLU ? 2 : 1) * (size_t)code_rows<T, WQ>() * LDQ);
  auto kernel = wq_kernel<T, BM, SWIGLU, WQ>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int tiles_m = (a.M + BM - 1) / BM;
  const dim3 grid(tiles_m + (a.group_sizes != nullptr ? a.E : 0), (a.N + BN - 1) / BN);
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool SWIGLU, int WQ>
cudaError_t launch_wq_bm(const WqArgs& a, int block_m, cudaStream_t s) {
  if (block_m == 16) return launch_wq<T, 16, SWIGLU, WQ>(a, s);
  if (block_m == 64) return launch_wq<T, 64, SWIGLU, WQ>(a, s);
  return cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16; bits: 8 or 4 (K even); block_m: 16 or
// 64. Returns a cudaError_t (0 = launched).
template <bool SWIGLU>
int wq_dispatch(const WqArgs* a, int dtype, int bits, int block_m, void* stream) {
  if (a == nullptr || a->M <= 0 || a->K <= 0 || a->N <= 0 || a->E <= 0 ||
      (a->N + BN - 1) / BN > 65535 || (bits == 4 && a->K % 2) ||
      (SWIGLU && (a->q3 == nullptr || a->s3 == nullptr)))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1 && bits == 8) return launch_wq_bm<bf16, SWIGLU, 8>(*a, block_m, s);
  if (dtype == 1 && bits == 4) return launch_wq_bm<bf16, SWIGLU, 4>(*a, block_m, s);
  if (dtype == 0 && bits == 8) return launch_wq_bm<float, SWIGLU, 8>(*a, block_m, s);
  if (dtype == 0 && bits == 4) return launch_wq_bm<float, SWIGLU, 4>(*a, block_m, s);
  return cudaErrorInvalidValue;
}

}  // namespace
