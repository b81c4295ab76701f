// Fused unembed + softmax statistics for the training head, CUDA C++ for
// sm_90a. Replaces deepspeed_tpu/ops/pallas/fused_ce.py _ce_kernel (via
// unembed_logits_stats): for h (N, D) and w (V, D), the fp32 scores h w^T,
// columns >= V masked to -1e30 (the ragged last vocab tile is masked here;
// w is never copied padded as fused_ce.py:110-112 does), the logits written
// once in h's dtype, logz = m + log(l) from the pre-round fp32 scores and
// gold = the score at the target (0 for targets outside [0, V),
// fused_ce.py:57-60).
//
// bf16: fused_ce_sm90_kernel + fused_ce_merge_kernel. The product is
// sm90_gemm.cuh's mainloop (TMA + wgmma, warp-specialised, persistent)
// walking vocab-major: all 128-row tiles of one 256-wide vocab tile in a
// row, so each tile of w comes from device memory once and h (25 MB at the
// training shapes) stays in the 50 MB L2. The TPU kernel carries m, l and
// gold in scratch along its sequential vocab axis; CTAs here run in no
// order, so the carry becomes two passes:
//   the tile epilogue (each consumer warpgroup, 64 rows x 256 columns):
//     masks its columns >= V, writes the bf16 logits through a shared
//     staging tile with 16-byte stores, and forms each row's tile max, sum
//     of exp(s - max) and gold with the 4-lane quad shuffles of the wgmma
//     fragment, written to partials (N, ceil(V / 256), 3) fp32;
//   fused_ce_merge_kernel (one warp per row): folds a row's partials in
//     vocab-tile order (coalesced loads of 32 tiles, the fold broadcast by
//     shuffles), logz = M + log(L), gold = the sum of the tiles' golds. The
//     order is fixed and there are no atomics, so a call repeats bitwise.
// Bound: operations at the training shapes (N = 12288, V = 50304, D = 1024:
// 2 N V D = 1.27 TFLOP, 1.28 ms at 989 TFLOP/s, against 1.36 GB moved,
// 0.41 ms). The epilogue's exp (0.6 G a call) and logits stores run while
// the producer loads the next tile.
//
// fp32: fused_ce_kernel, scalar FMAs in the mma.sync m16n8 fragment layout
// (one CTA of 4 warps per 64-row tile of h, a loop over 64-column vocab
// tiles with an online max / sum-exp; the parity checks use it: wgmma has no
// fp32 mode, and TF32 would miss their 1e-4).
//
// The extern "C" launcher returns a cudaError_t (0 = launched); it never
// synchronizes or allocates (the wrapper allocates the partials).

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

#define NEG_INF (-1e30f)

struct CEArgs {
  const void* h;        // (N, D) contiguous
  const void* w;        // (V, D) contiguous
  const int* targets;   // (N,) int32
  void* logits;         // (N, V) in h's dtype
  float* logz;          // (N,)
  float* gold;          // (N,)
  long long N, V;
  int D;
};

namespace {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ bf16: sm90

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

struct CEEpilogue {
  bf16* logits;
  float* partials;  // (N, n_vt, 3): tile max, sum of exp(s - max), gold
  const int* targets;
  int N, V, n_vt, vec;

  __device__ __forceinline__ void operator()(float (&acc)[sm90::BN / 2], int, int i0, int j0,
                                             bf16* stage, int tid, int bar) const {
    constexpr float LOG2E = 1.4426950408889634f;
    int row[2], tc[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = i0 + sm90::frag_row(tid, 2 * h);
      const int t = row[h] < N ? targets[row[h]] : -1;
      tc[h] = t >= 0 && t < V ? t - j0 : -1;  // the target's column in this tile
    }
    if (j0 + sm90::BN > V) {  // the ragged last vocab tile: columns >= V masked
#pragma unroll
      for (int b = 0; b < sm90::BN / 8; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j0 + sm90::frag_col(tid, b, e) >= V) acc[4 * b + e] = NEG_INF;
    }
    float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
#pragma unroll
    for (int b = 0; b < sm90::BN / 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], acc[4 * b + e]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    const float ms[2] = {mx[0] * LOG2E, mx[1] * LOG2E};
#pragma unroll
    for (int b = 0; b < sm90::BN / 8; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += ex2(fmaf(acc[4 * b + e], LOG2E, -ms[e >> 1]));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the lane holding the target's column reads it (one vocab tile in
      // ~200 has it, so the branch is rarely taken)
      if (tc[h] >= 0 && tc[h] < sm90::BN && (tc[h] & 6) == 2 * (tid & 3)) {
#pragma unroll
        for (int b = 0; b < sm90::BN / 8; ++b)
          if (b == tc[h] >> 3) gold[h] = tc[h] & 1 ? acc[4 * b + 2 * h + 1] : acc[4 * b + 2 * h];
      }
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      gold[h] += __shfl_xor_sync(0xffffffffu, gold[h], 1);
      gold[h] += __shfl_xor_sync(0xffffffffu, gold[h], 2);
      if ((tid & 3) == 0 && row[h] < N) {
        float* p = partials + ((long long)row[h] * n_vt + j0 / sm90::BN) * 3;
        p[0] = mx[h];
        p[1] = sum[h];
        p[2] = gold[h];
      }
    }
    sm90::store_tile<false>(acc, stage, logits + (long long)i0 * V + j0, V, N - i0, V - j0,
                            vec != 0, bar, tid);
  }
};

__global__ void __launch_bounds__(sm90::THREADS, 1)
    fused_ce_sm90_kernel(const __grid_constant__ CUtensorMap mh, const __grid_constant__ CUtensorMap mw,
                         sm90::Problem p, CEEpilogue epi) {
  sm90::gemm<0, 0>(mh, mw, p, epi);
}

// One warp per row: logz = M + log(L) and gold from the row's partials,
// folded in vocab-tile order.
__global__ void __launch_bounds__(256) fused_ce_merge_kernel(const float* partials, int n_vt,
                                                             long long N, float* logz, float* gold) {
  const long long row = (long long)blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= N) return;
  const float* pr = partials + row * n_vt * 3;
  float M = NEG_INF, L = 0.f, G = 0.f;
  for (int t0 = 0; t0 < n_vt; t0 += 32) {
    float pm = NEG_INF, pl = 0.f, pg = 0.f;
    if (t0 + lane < n_vt) {
      pm = pr[(t0 + lane) * 3];
      pl = pr[(t0 + lane) * 3 + 1];
      pg = pr[(t0 + lane) * 3 + 2];
    }
    const int n = min(32, n_vt - t0);
    for (int k = 0; k < n; ++k) {
      const float mk = __shfl_sync(0xffffffffu, pm, k);
      const float lk = __shfl_sync(0xffffffffu, pl, k);
      const float gk = __shfl_sync(0xffffffffu, pg, k);
      const float m2 = fmaxf(M, mk);
      L = L * expf(M - m2) + lk * expf(mk - m2);
      M = m2;
      G += gk;
    }
  }
  if (lane == 0) {
    logz[row] = M + logf(L);
    gold[row] = G;
  }
}

cudaError_t launch_sm90(const CEArgs& a, float* partials, int n_vt, cudaStream_t s) {
  if (((uintptr_t)a.h | (uintptr_t)a.w) % 16 != 0 || partials == nullptr ||
      n_vt != (a.V + sm90::BN - 1) / sm90::BN || a.N > 0x7fffffffLL || a.V > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  sm90::Problem p{};
  p.Z = 1;
  p.Q = 1;
  p.I = (int)a.N;
  p.J = (int)a.V;
  p.C = a.D;
  CUtensorMap mh, mw;
  const long long sh[4] = {0, 0, a.D, 1}, sw[4] = {0, 0, 1, a.D};
  cudaError_t e = sm90::make_maps(&mh, &mw, &p, a.h, sh, 0, a.w, sw, 0);
  if (e != cudaSuccess) return e;
  const int grid = sm90::plan(&p, 1 << 30);  // vocab-major: every row tile per vocab tile
  if (grid <= 0) return cudaErrorInvalidValue;
  const int vec = a.V % 8 == 0 && (uintptr_t)a.logits % 16 == 0;
  const CEEpilogue epi{(bf16*)a.logits, partials, a.targets, (int)a.N, (int)a.V, n_vt, vec};
  e = sm90::allow_sm90_smem(fused_ce_sm90_kernel);
  if (e != cudaSuccess) return e;
  fused_ce_sm90_kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(mh, mw, p, epi);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  fused_ce_merge_kernel<<<(unsigned)((a.N + 7) / 8), 256, 0, s>>>(partials, n_vt, a.N, a.logz,
                                                                    a.gold);
  return cudaGetLastError();
}

// ------------------------------------------------------------ fp32: FMAs

constexpr int BM = 64;   // rows of h per CTA
constexpr int BN = 64;   // vocab columns per tile
constexpr int BKD = 64;  // slice of D staged per step
constexpr int NW = 4;
constexpr int NT = NW * 32;

// C (16 x 8*N8) += A (16 x K) * B^T with B stored [n][k]; lane 4g+t owns
// c[n][0..1] at (row g, cols 8n+2t+{0,1}) and c[n][2..3] at row g+8.
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

// rows [row0, row0+64) x cols [d0, d0+BKD) of a contiguous (rows, D) matrix
// into shared [64][ld]; rows >= n_rows and cols >= D are zero. D is a
// multiple of the 16-byte vector (the wrapper checks).
__device__ __forceinline__ void load_slice(float* dst, int ld, const float* src, long long n_rows,
                                           int D, long long row0, int d0) {
  constexpr int VEC = 4;
  constexpr int CPR = BKD / VEC;
  for (int i = threadIdx.x; i < 64 * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && d0 + c < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + d0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

__global__ void __launch_bounds__(NT) fused_ce_kernel(CEArgs a) {
  constexpr int LD = BKD + 4;
  constexpr int NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [BM][LD]
  float* ws = hs + BM * LD;                         // [BN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  int tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) tgt[i] = rows[i] < a.N ? a.targets[rows[i]] : -1;
  const float* hg = reinterpret_cast<const float*>(a.h);
  const float* wg = reinterpret_cast<const float*>(a.w);
  float* lg = reinterpret_cast<float*>(a.logits);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
  for (long long v0 = 0; v0 < a.V; v0 += BN) {
    float s[NTN][4];
#pragma unroll
    for (int n = 0; n < NTN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int d0 = 0; d0 < a.D; d0 += BKD) {
      __syncthreads();
      load_slice(hs, LD, hg, a.N, a.D, row0, d0);
      load_slice(ws, LD, wg, a.V, a.D, v0, d0);
      __syncthreads();
      mma_nk<NTN>(s, hs + warp * 16 * LD, LD, ws, LD, BKD);
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NTN; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const long long col = v0 + n * 8 + 2 * t4 + (e & 1);
        if (col >= a.V) s[n][e] = NEG_INF;
        if (rows[i] < a.N && col < a.V) lg[rows[i] * a.V + col] = s[n][e];
        if (col == tgt[i] && col < a.V) gold[i] += s[n][e];
        mx[i] = fmaxf(mx[i], s[n][e]);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NTN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e >> 1] += expf(s[n][e] - m[e >> 1]);
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + sum[i];
  }

  // merge the four lanes of each row
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float M = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
    float L = l[i] * expf(m[i] - M);
    L += __shfl_xor_sync(0xffffffffu, L, 1);
    L += __shfl_xor_sync(0xffffffffu, L, 2);
    float G = gold[i];
    G += __shfl_xor_sync(0xffffffffu, G, 1);
    G += __shfl_xor_sync(0xffffffffu, G, 2);
    if (t4 == 0 && rows[i] < a.N) {
      a.logz[rows[i]] = M + logf(L);
      a.gold[rows[i]] = G;
    }
  }
}

cudaError_t launch_fp32(const CEArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(float) * (size_t)(BM + BN) * (BKD + 4);
  const long long grid = (a.N + BM - 1) / BM;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_ce_kernel<<<(unsigned)grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (fused_ce_kernel; partials null), 1 = bfloat16
// (fused_ce_sm90_kernel + fused_ce_merge_kernel; partials (N, n_vt, 3)
// fp32 with n_vt = ceil(V / 256)). Returns a cudaError_t (0 = launched).
extern "C" int fused_ce_launch(const CEArgs* a, int dtype, float* partials, int n_vt,
                               void* stream) {
  if (a == nullptr || a->N <= 0 || a->V <= 0 || a->D <= 0 || a->D % 8 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch_sm90(*a, partials, n_vt, s);
  if (dtype == 0) return launch_fp32(*a, s);
  return cudaErrorInvalidValue;
}
