// Fused unembed + online-softmax statistics for the training head, CUDA C++
// for sm_90a.
//
// fused_ce_kernel  replaces deepspeed_tpu/ops/pallas/fused_ce.py _ce_kernel
//                  (via unembed_logits_stats).
//   h (N, D) rows times w (V, D)^T over vocab tiles: one CTA (4 warps) per
//   64-row tile of h, each warp owning 16 rows; a loop over 64-column vocab
//   tiles replaces the TPU's sequential vocab grid axis, and an inner loop
//   over 64-wide slices of D stages h and w in shared memory for mma.sync
//   (m16n8k16, bf16 -> fp32). Per vocab tile the fp32 scores are masked to
//   -1e30 at columns >= V (the ragged last tile is masked here, w is never
//   copied padded as fused_ce.py:110-112 does), written once as logits in
//   h's dtype, and folded into an online max / sum-exp and a gold readout
//   (col == target and col < V, so targets outside [0, V) give 0,
//   fused_ce.py:57-60). Each lane keeps the statistics of its own columns;
//   the four lanes of a row merge them at the end, so logz = m + log(l)
//   comes from the pre-round fp32 scores.
//   Bound: operations at the training shapes (N=12288, V=50304, D=1024:
//   2*N*V*D = 1.27 TFLOP against 1.27 GB of bf16 logits written, ~1000
//   flop/byte, above the 295 ridge). This first version loads synchronously
//   and re-reads w from L2 once per row tile; cp.async/TMA pipelining,
//   larger row tiles and wgmma are later work.
//
// The extern "C" launcher returns cudaGetLastError() (0 = launched); it
// never synchronizes or allocates. fp32 instances do the products with
// scalar FMAs in the same fragment layout (the parity checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

constexpr int BM = 64;   // rows of h per CTA
constexpr int BN = 64;   // vocab columns per tile
constexpr int BKD = 64;  // slice of D staged per step
constexpr int NW = 4;
constexpr int NT = NW * 32;

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma16816(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// C (16 x 8*N8) += A (16 x K) * B^T with B stored [n][k]; lane 4g+t owns
// c[n][0..1] at (row g, cols 8n+2t+{0,1}) and c[n][2..3] at row g+8.
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
template <typename T>
__device__ __forceinline__ void load_slice(T* dst, int ld, const T* src, long long n_rows,
                                           int D, long long row0, int d0) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = BKD / VEC;
  for (int i = threadIdx.x; i < 64 * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && d0 + c < D)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * D + d0 + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = val;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) fused_ce_kernel(CEArgs a) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LD = BKD + PAD;
  constexpr int NTN = BN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);  // [BM][LD]
  T* ws = hs + BM * LD;                     // [BN][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long rows[2] = {row0 + warp * 16 + g, row0 + warp * 16 + g + 8};
  int tgt[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) tgt[i] = rows[i] < a.N ? a.targets[rows[i]] : -1;
  const T* hg = reinterpret_cast<const T*>(a.h);
  const T* wg = reinterpret_cast<const T*>(a.w);
  T* lg = reinterpret_cast<T*>(a.logits);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, gold[2] = {0.f, 0.f};
  for (long long v0 = 0; v0 < a.V; v0 += BN) {
    float s[NTN][4];
#pragma unroll
    for (int n = 0; n < NTN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    for (int d0 = 0; d0 < a.D; d0 += BKD) {
      __syncthreads();
      load_slice<T>(hs, LD, hg, a.N, a.D, row0, d0);
      load_slice<T>(ws, LD, wg, a.V, a.D, v0, d0);
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
        if (rows[i] < a.N && col < a.V) lg[rows[i] * a.V + col] = from_f<T>(s[n][e]);
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

template <typename T>
cudaError_t launch(const CEArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = sizeof(T) * (size_t)(BM + BN) * (BKD + PAD);
  const long long grid = (a.N + BM - 1) / BM;
  fused_ce_kernel<T><<<(unsigned)grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int fused_ce_launch(const CEArgs* a, int dtype, void* stream) {
  if (a == nullptr || a->N <= 0 || a->V <= 0 || a->D <= 0 || a->D % 8 != 0 ||
      (a->N + BM - 1) / BM > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<bf16>(*a, s);
  if (dtype == 0) return launch<float>(*a, s);
  return cudaErrorInvalidValue;
}
