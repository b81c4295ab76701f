// The MLP projection kernels, CUDA C++ for sm_90a.
//
// Weight-only quantized projection (K7): replaces
// deepspeed_tpu/ops/pallas/mlp_matmul.py _mm_wq_kernel (via _mm_wq and
// wq_matmul). out (M, N) = x (M, K) @ dequant(codes), where the codes are
// int8 (K, N) or int4 packed two per byte along k (K/2, N) and the (1, N)
// fp32 scale multiplies the fp32 accumulator in the epilogue. One GEMM
// over all B*T rows at every shape, decode's 8 rows included (the JAX
// wrapper falls back to its jnp _ref_proj_wq there, the same math). Two
// designs (the wrapper's _wq_design picks one per call):
//   sm90 (bf16 x and codes that TMA can address): wq_matmul_sm90_kernel
//     (+ wq_merge_kernel when K is split), wq_sm90.cuh: the widened codes
//     are wgmma's register operand, x TMA-loaded; design and bound there;
//   mma_sync (other bf16) and fp32: wq_gemm.cuh's wq_kernel in its dense
//     mode (one weight, E = 1), cp.async + mma.sync.
// The TPU kernel's x_t / out_t operand orientations are layouts, not
// contracts: the wrapper serves them through transposed views.

#include "sm90_gemm.cuh"
#include "wq_gemm.cuh"
#include "wq_sm90.cuh"

// dtype: 0 = float32, 1 = bfloat16; bits: 8 or 4 (K even); block_m: 16 or
// 64; WqArgs.group_sizes must be null and E 1. Returns a cudaError_t (0 =
// launched); never synchronizes or allocates.
extern "C" int wq_matmul_launch(const WqArgs* a, int dtype, int bits, int block_m, void* stream) {
  if (a == nullptr || a->group_sizes != nullptr || a->E != 1) return cudaErrorInvalidValue;
  return wq_dispatch<false>(a, dtype, bits, block_m, stream);
}

// The bf16 sm90 design: x (M, K) bf16 contiguous, K % 8 == 0, 16-byte
// aligned; codes (K | K / 2, N) int8 contiguous, N % 16 == 0, 16-byte
// aligned; scale (N,) fp32 16-byte aligned; out (M, N) bf16; row_tile 8,
// 64, 128 or 256 (wgmma's n); splits S in [1, ceil(K / 64)] and, when S >
// 1, part an (S, M, N) fp32 scratch. Returns a cudaError_t (0 =
// launched); never synchronizes or allocates.
extern "C" int wq_matmul_sm90_launch(const void* x, const int8_t* q, const float* scale,
                                     void* out, float* part, int M, int K, int N, int bits,
                                     int row_tile, int splits, void* stream) {
  const int nst = (K + wq90::KS - 1) / wq90::KS;
  if (x == nullptr || q == nullptr || scale == nullptr || out == nullptr || M <= 0 || K <= 0 ||
      N <= 0 || K % 8 || N % 16 || (uintptr_t)x % 16 || (uintptr_t)q % 16 ||
      (uintptr_t)scale % 16 || (uintptr_t)out % 16 || (bits != 4 && bits != 8) || splits < 1 ||
      splits > nst || splits > 65535 || (splits > 1 && (part == nullptr || (uintptr_t)part % 16)))
    return cudaErrorInvalidValue;
  const wq90::Args a{scale, (wq90::bf16*)out, part, M, K, N, splits};
  cudaStream_t s = (cudaStream_t)stream;
  return bits == 8 ? wq90::launch_bits<8>(x, q, a, row_tile, s)
                   : wq90::launch_bits<4>(x, q, a, row_tile, s);
}

// ---------------------------------------------------------------------------
// Layout-owning projection (K6): proj_mm_sm90_kernel and proj_mm_kernel
// replace both deepspeed_tpu/ops/pallas/mlp_matmul.py _mm_kernel (via _mm:
// the forward and the dx product) and _dw_kernel (via _dw: the weight
// gradient). One strided GEMM covers both:
//
//   O[z, i, j] = sum_q sum_c A[z, q, i, c] * B[z, q, c, j]
//
// with every operand addressed through its strides (A at z sa_z + q sa_q +
// i sa_i + c sa_c, B and O alike), fp32 accumulation and one rounding to
// the operands' dtype in the epilogue.
//   _mm:  Z = P batches, Q = 1, (I, J, C) = (N, M, K): a (P, N, K) or its
//         (P, K, N) layout (x_t), b (K, M) or (M, K) (b_t), out (P, N, M)
//         or (P, M, N) (out_t) -- the orientations are strides, so neither
//         x_t nor out_t nor a transposed view of w costs a copy;
//   _dw:  Z = 1, Q = P, (I, J, C) = (K, M, N): the contraction runs over
//         every (p, n) row, so the TPU kernel's fp32 accumulator carried
//         along its sequential (p, n) grid axes becomes this CTA's loop.
// proj_mm_kernel stages A in shared memory as it lies: [i][c] when its c
// stride is 1 (A fragments by ldmatrix), [c][i] when its i stride is 1 (the
// T-minor operand of x_t, and x^T in dW; fragments by ldmatrix.trans). B
// likewise: [c][j] (ldmatrix.trans) or [j][c] (ldmatrix). Its output tile
// is written from the fragments through O's strides, so out_t writes
// columns.
//
// Two designs serve it (the wrapper's _k6_design picks one per call):
//
// sm90 (bf16 operands TMA can address: 16-byte aligned bases, every
// stride the tensor map holds a whole number of 16 bytes; every GPT-2
// 350M call):
// proj_mm_sm90_kernel, sm90_gemm.cuh's mainloop (TMA into a 4-stage ring,
// wgmma m64n256k16 from 128-byte swizzled shared memory, a producer and
// two consumer warpgroups, one persistent CTA per SM walking 128 x 256
// tiles in groups of 8 row tiles per column band). Each orientation is a
// TMA box plus the wgmma transpose bit: A [i][c] K-major, A [c][i] (x_t, x
// in dW) MN-major, B [j][c] (b_t, dy in dW under out_t) K-major, B [c][j]
// MN-major; _dw's q is a third map dim whose coordinate advances
// the k-loop over Q x ceil(C / 64) slices. The epilogue rounds to bf16
// into a shared staging tile laid along O's contiguous axis (transposed
// for out_t) and writes 16-byte runs.
//
// mma_sync (other bf16 operands, e.g. K = 100) and fp32: proj_mm_kernel,
// 128 threads = 4 warps (2 along i x 2 along j), a 64 x 128 output tile
// per CTA, 32 x 64 per warp (2 x 8 mma.sync m16n8k16, bf16 -> fp32), a
// 4-stage cp.async ring of 64-deep (bf16) k slices; fp32 instances do
// scalar FMAs in the same fragment layout (the parity checks). Each
// output element is written once by one CTA: no atomics, no split-K.
//
// Bound: operations. At the GPT-2 350M MLP (P = 24, T = 1024, D = 1024,
// F = 4096, bf16) each of the forward, dx and dW products is 2.06e11
// flops (0.208 ms at 989 TFLOP/s) against 58-109 MB of operands
// (0.017-0.033 ms at 3.35 TB/s).

struct MmArgs {
  const void* a;
  const void* b;
  void* out;
  long long sa_z, sa_q, sa_i, sa_c;
  long long sb_z, sb_q, sb_c, sb_j;
  long long so_z, so_i, so_j;
  int Z, Q, I, J, C;
  int a_t;      // A staged [c][i] (sa_i == 1), else [i][c] (sa_c == 1)
  int b_t;      // B staged [j][c] (sb_c == 1), else [c][j] (sb_j == 1)
  int vec_a, vec_b;  // 16-byte cp.async staging allowed
};

namespace {

constexpr int MM_BM = 64, MM_BN = 128;  // CTA tile (i x j)
constexpr int MM_WM = 2, MM_WN = 2;     // warps along i and j
constexpr int MM_M16 = MM_BM / MM_WM / 16;
constexpr int MM_N8 = MM_BN / MM_WN / 8;
static_assert(MM_WM * MM_WN == NW, "4 warps");

// dst[r][c] = src[r * ld + c] for r < rows, c < cols (counts from the tile
// origin; either may be <= 0), else 0; 16-byte cp.async where allowed.
template <typename T, int R, int CW>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src, long long ld, int rows,
                                          int cols, bool vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CPR = CW / VEC;
  for (int i = threadIdx.x; i < R * CPR; i += NT) {
    const int r = i / CPR, c = (i - r * CPR) * VEC;
    T* d = dst + r * ldd + c;
    const T* s = src + (long long)r * ld + c;
    if (vec && r < rows && c + VEC <= cols) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) d[v] = (r < rows && c + v < cols) ? s[v] : from_f<T>(0.f);
    }
  }
}

// C (16 M16 x 8 N8) += A (16 M16 x BK) * B (BK x 8 N8) for one warp; A
// stored [m][k], or [k][m] when AT; B stored [k][n], or [n][k] when BT.
// Fragment layout as gemm_common.cuh's mma_tile, M16 row tiles sharing
// each B fragment.
template <int M16, int N8, int BK, bool AT, bool BT>
__device__ __forceinline__ void mma_warp(float (&c)[M16][N8][4], const bf16* A, int lda,
                                         const bf16* B, int ldb) {
  const int lane = threadIdx.x & 31;
  const int lr = lane & 7, lm = (lane >> 3) & 1, lh = lane >> 4;
#pragma unroll
  for (int k0 = 0; k0 < BK; k0 += 16) {
    uint32_t a[M16][4];
#pragma unroll
    for (int mi = 0; mi < M16; ++mi) {
      if (AT)  // matrices (m 0-7 | 8-15) x (k 0-7 | 8-15), each transposed
        ldsm_x4_trans(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                      A + (k0 + lh * 8 + lr) * lda + mi * 16 + lm * 8);
      else     // the same four matrices from [m][k]
        ldsm_x4(a[mi][0], a[mi][1], a[mi][2], a[mi][3],
                A + (mi * 16 + lm * 8 + lr) * lda + k0 + lh * 8);
    }
#pragma unroll
    for (int p = 0; p < N8 / 2; ++p) {
      uint32_t b0, b1, b2, b3;
      if (BT)
        ldsm_x4(b0, b1, b2, b3, B + (p * 16 + lh * 8 + lr) * ldb + k0 + lm * 8);
      else
        ldsm_x4_trans(b0, b1, b2, b3, B + (k0 + (lane & 15)) * ldb + p * 16 + lh * 8);
#pragma unroll
      for (int mi = 0; mi < M16; ++mi) {
        mma16816(c[mi][2 * p], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b0, b1);
        mma16816(c[mi][2 * p + 1], a[mi][0], a[mi][1], a[mi][2], a[mi][3], b2, b3);
      }
    }
  }
}

template <int M16, int N8, int BK, bool AT, bool BT>
__device__ __forceinline__ void mma_warp(float (&c)[M16][N8][4], const float* A, int lda,
                                         const float* B, int ldb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    float lo[M16], hi[M16];
#pragma unroll
    for (int mi = 0; mi < M16; ++mi) {
      const int r = mi * 16 + g;
      lo[mi] = AT ? A[k * lda + r] : A[r * lda + k];
      hi[mi] = AT ? A[k * lda + r + 8] : A[(r + 8) * lda + k];
    }
#pragma unroll
    for (int n = 0; n < N8; ++n) {
      const int col = n * 8 + 2 * t;
      const float b0 = BT ? B[col * ldb + k] : B[k * ldb + col];
      const float b1 = BT ? B[(col + 1) * ldb + k] : B[k * ldb + col + 1];
#pragma unroll
      for (int mi = 0; mi < M16; ++mi) {
        c[mi][n][0] = fmaf(lo[mi], b0, c[mi][n][0]);
        c[mi][n][1] = fmaf(lo[mi], b1, c[mi][n][1]);
        c[mi][n][2] = fmaf(hi[mi], b0, c[mi][n][2]);
        c[mi][n][3] = fmaf(hi[mi], b1, c[mi][n][3]);
      }
    }
  }
}

// Shared elements of one stage: A then B.
template <typename T, bool AT>
__host__ __device__ constexpr int mm_a_elems() {
  return AT ? Slice<T>::BK * (MM_BM + 16 / (int)sizeof(T))
            : MM_BM * (Slice<T>::BK + 16 / (int)sizeof(T));
}
template <typename T, bool BT>
__host__ __device__ constexpr int mm_b_elems() {
  return BT ? MM_BN * (Slice<T>::BK + 16 / (int)sizeof(T))
            : Slice<T>::BK * (MM_BN + 16 / (int)sizeof(T));
}

template <typename T, bool AT, bool BT>
__global__ void __launch_bounds__(NT) proj_mm_kernel(MmArgs a) {
  constexpr int BK = Slice<T>::BK;
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LDA = AT ? MM_BM + PAD : BK + PAD;
  constexpr int LDB = BT ? BK + PAD : MM_BN + PAD;
  constexpr int AE = mm_a_elems<T, AT>();
  constexpr int BE = mm_b_elems<T, BT>();

  const int j0 = blockIdx.x * MM_BN, i0 = blockIdx.y * MM_BM, z = blockIdx.z;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* As = reinterpret_cast<T*>(smem_raw);  // [STAGES][AE]
  T* Bs = As + STAGES * AE;                 // [STAGES][BE]
  const T* A = reinterpret_cast<const T*>(a.a) + z * a.sa_z;
  const T* B = reinterpret_cast<const T*>(a.b) + z * a.sb_z;
  const int nc = (a.C + BK - 1) / BK;
  const int steps = a.Q * nc;
  const bool va = a.vec_a != 0, vb = a.vec_b != 0;

  auto load_stage = [&](int slot, int st) {
    const int q = st / nc, c0 = (st - q * nc) * BK;
    const T* aq = A + q * a.sa_q;
    const T* bq = B + q * a.sb_q;
    T* ad = As + slot * AE;
    T* bd = Bs + slot * BE;
    if (AT)
      load_tile<T, BK, MM_BM>(ad, LDA, aq + c0 * a.sa_c + i0, a.sa_c, a.C - c0, a.I - i0, va);
    else
      load_tile<T, MM_BM, BK>(ad, LDA, aq + i0 * a.sa_i + c0, a.sa_i, a.I - i0, a.C - c0, va);
    if (BT)
      load_tile<T, MM_BN, BK>(bd, LDB, bq + j0 * a.sb_j + c0, a.sb_j, a.J - j0, a.C - c0, vb);
    else
      load_tile<T, BK, MM_BN>(bd, LDB, bq + c0 * a.sb_c + j0, a.sb_c, a.C - c0, a.J - j0, vb);
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % MM_WM, wn = warp / MM_WM;
  const int a_off = AT ? wm * 32 : wm * 32 * LDA;
  const int b_off = BT ? wn * 64 * LDB : wn * 64;
  float acc[MM_M16][MM_N8][4];
#pragma unroll
  for (int mi = 0; mi < MM_M16; ++mi)
#pragma unroll
    for (int n = 0; n < MM_N8; ++n) acc[mi][n][0] = acc[mi][n][1] = acc[mi][n][2] = acc[mi][n][3] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice st landed; slot (st - 1) % STAGES is free
    const int nxt = st + STAGES - 1;
    if (nxt < steps) load_stage(nxt % STAGES, nxt);
    cp_async_commit();
    const int slot = st % STAGES;
    mma_warp<MM_M16, MM_N8, BK, AT, BT>(acc, As + slot * AE + a_off, LDA, Bs + slot * BE + b_off,
                                        LDB);
  }
  cp_async_wait<0>();

  const int gq = lane >> 2, t4 = lane & 3;
  T* out = reinterpret_cast<T*>(a.out) + z * a.so_z;
#pragma unroll
  for (int mi = 0; mi < MM_M16; ++mi)
#pragma unroll
    for (int n = 0; n < MM_N8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + wm * 32 + mi * 16 + gq + (e >> 1) * 8;
        const int j = j0 + wn * 64 + n * 8 + 2 * t4 + (e & 1);
        if (i < a.I && j < a.J) out[i * a.so_i + j * a.so_j] = from_f<T>(acc[mi][n][e]);
      }
}

template <typename T, bool AT, bool BT>
cudaError_t launch_mm(const MmArgs& a, cudaStream_t s) {
  const size_t smem = sizeof(T) * (size_t)STAGES * (mm_a_elems<T, AT>() + mm_b_elems<T, BT>());
  auto kernel = proj_mm_kernel<T, AT, BT>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.J + MM_BN - 1) / MM_BN, (a.I + MM_BM - 1) / MM_BM, a.Z);
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mm_dispatch(const MmArgs& a, cudaStream_t s) {
  if (a.a_t) return a.b_t ? launch_mm<T, true, true>(a, s) : launch_mm<T, true, false>(a, s);
  return a.b_t ? launch_mm<T, false, true>(a, s) : launch_mm<T, false, false>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (A, B and O). Returns a cudaError_t (0 =
// launched); never synchronizes or allocates.
extern "C" int mlp_mm_launch(const MmArgs* a, int dtype, void* stream) {
  if (a == nullptr || a->Z <= 0 || a->I <= 0 || a->J <= 0 || a->Q < 0 || a->C < 0 ||
      a->Z > 65535 || (a->I + MM_BM - 1) / MM_BM > 65535 ||
      (a->a_t ? a->sa_i != 1 : a->sa_c != 1) || (a->b_t ? a->sb_c != 1 : a->sb_j != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return mm_dispatch<bf16>(*a, s);
  if (dtype == 0) return mm_dispatch<float>(*a, s);
  return cudaErrorInvalidValue;
}

// --------------------------------------------------------- K6, bf16: sm90

namespace {

struct MmEpilogue {
  bf16* out;
  long long so_z, so_i, so_j;
  int I, J;
  int trans;  // O's contiguous axis is i (out_t)
  int vec;    // 16-byte stores allowed

  __device__ __forceinline__ void operator()(float (&acc)[sm90::BN / 2], int z, int i0, int j0,
                                             bf16* stage, int tid, int bar) const {
    bf16* o = out + z * so_z + i0 * so_i + j0 * so_j;
    if (trans)
      sm90::store_tile<true>(acc, stage, o, so_j, I - i0, J - j0, vec != 0, bar, tid);
    else
      sm90::store_tile<false>(acc, stage, o, so_i, I - i0, J - j0, vec != 0, bar, tid);
  }
};

template <int TA, int TB>
__global__ void __launch_bounds__(sm90::THREADS, 1)
    proj_mm_sm90_kernel(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
                        sm90::Problem p, MmEpilogue epi) {
  sm90::gemm<TA, TB>(ma, mb, p, epi);
}

template <int TA, int TB>
cudaError_t launch_mm_sm90(const MmArgs& a, cudaStream_t s) {
  sm90::Problem p{};
  p.Z = a.Z;
  p.Q = a.Q;
  p.I = a.I;
  p.J = a.J;
  p.C = a.C;
  CUtensorMap ma, mb;
  const long long sa[4] = {a.sa_z, a.sa_q, a.sa_i, a.sa_c};
  const long long sb[4] = {a.sb_z, a.sb_q, a.sb_c, a.sb_j};
  cudaError_t e = sm90::make_maps(&ma, &mb, &p, a.a, sa, TA, a.b, sb, TB);
  if (e != cudaSuccess) return e;
  const int grid = sm90::plan(&p, 8);
  if (grid < 0) return cudaErrorInvalidValue;
  if (grid == 0) return cudaSuccess;
  const int trans = a.so_j != 1;
  const long long ld = trans ? a.so_j : a.so_i;
  const MmEpilogue epi{(bf16*)a.out, a.so_z, a.so_i, a.so_j, a.I, a.J, trans,
                       (uintptr_t)a.out % 16 == 0 && ld % 8 == 0 && a.so_z % 8 == 0};
  auto kernel = proj_mm_sm90_kernel<TA, TB>;
  e = sm90::allow_sm90_smem(kernel);
  if (e != cudaSuccess) return e;
  kernel<<<grid, sm90::THREADS, sm90::SMEM_BYTES, s>>>(ma, mb, p, epi);
  return cudaGetLastError();
}

}  // namespace

// The bf16 sm90 design (A, B and O bf16). a_t: A MN-major (sa_i == 1);
// b_t: B K-major (sb_c == 1); O needs a unit stride along i or j. Returns a
// cudaError_t (0 = launched); never synchronizes or allocates.
extern "C" int mlp_mm_sm90_launch(const MmArgs* a, void* stream) {
  if (a == nullptr || a->Z <= 0 || a->I <= 0 || a->J <= 0 || a->Q < 0 || a->C < 0 ||
      (a->a_t ? a->sa_i != 1 : a->sa_c != 1) || (a->b_t ? a->sb_c != 1 : a->sb_j != 1) ||
      (a->so_i != 1 && a->so_j != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (a->a_t) return a->b_t ? launch_mm_sm90<1, 0>(*a, s) : launch_mm_sm90<1, 1>(*a, s);
  return a->b_t ? launch_mm_sm90<0, 0>(*a, s) : launch_mm_sm90<0, 1>(*a, s);
}
