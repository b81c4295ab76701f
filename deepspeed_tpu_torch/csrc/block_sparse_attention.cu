// Block-sparse attention forward and backward, CUDA C++ for sm_90a.
//
// Replaces deepspeed_tpu/ops/pallas/block_sparse_attention.py: bsa_fwd_kernel
// the forward (_fwd_kernel, via _fwd), bsa_dq_kernel the dq pass
// (_bwd_dq_kernel) and bsa_dkv_kernel the dk/dv pass (_bwd_dkv_kernel, both
// via _bwd). Attention is restricted to a (H, n, n) block layout, given as
// per-row lists of present key blocks (rows (H, n, max_row), row_cnt (H, n))
// and their transpose (cols (H, n, max_col), col_cnt (H, n)), int32 in device
// memory: each CTA reads its own count and ids, as the TPU kernels read
// them from scalar prefetch, so work scales with the layout's density and a
// call needs no host sync.
//
// Extern "C" launchers take a BsaArgs struct (mirrored by ctypes in
// ops/cuda/block_sparse_attention.py) and return cudaGetLastError(); they
// never synchronize and never allocate. Operands are folded (B*H, T, D),
// contiguous, the softmax scale already in q; lse and delta are (B*H, T)
// fp32. The layout's head of instance bh is bh mod H. Block sizes (bq = bk =
// BLK) 16, 32, 64, 128; head dims 32, 64, 128; float or bf16.
//
// One CTA of BLK/16 warps (16 rows each, the mma m16 tile) per (q-block,
// b*h) for the forward and dq, and per (k-block, b*h) for dk/dv:
//   bsa_fwd_kernel  streaming softmax (m, l, acc in fp32 registers) over the
//                   row's ids, p rounded to v's dtype before P.V. A row with
//                   no present block writes o = 0 and lse = -1e30.
//   bsa_dq_kernel   delta = rowsum(do * o) for its rows (written to a.delta
//                   for the dk/dv pass, which runs after it on the stream),
//                   then dq += round(p (dp - delta)) k over the row's ids.
//   bsa_dkv_kernel  dv += round(p)^T do, dk += round(ds)^T q over the
//                   column's ids.
// Each output is written once by one CTA: no atomics, a run repeats
// bitwise. causal masks key > query inside a block (blocks above the
// diagonal never reach the lists). Bound: operations (per present block
// pair 4*BLK^2*d flops forward, 10*BLK^2*d backward) at BLK = 64; the
// design keeps scores on chip and feeds mma.sync from shared tiles loaded
// synchronously (no cp.async/TMA pipeline yet: later work).

#include "attention_tiles.cuh"

struct BsaArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;             // forward output; backward input
  float* lse;          // (BH, T): forward output; backward input
  const void* dout;    // backward: dL/do
  float* delta;        // backward: (BH, T), written by the dq pass
  void* dq;
  void* dk;
  void* dv;
  const int* rows;     // (H, n, max_row)
  const int* row_cnt;  // (H, n)
  const int* cols;     // (H, n, max_col)
  const int* col_cnt;  // (H, n)
  int BH, H, T, D, block, causal, max_row, max_col;
};

namespace {

template <typename T, int D, int BLK>
struct Tile {
  static constexpr int NW = BLK / 16;
  static constexpr int NTHR = NW * 32;
  static constexpr int PAD = 16 / sizeof(T);
  static constexpr int LD = D + PAD;    // q/k/v/do tile row
  static constexpr int LP = BLK + PAD;  // p / ds tile row
  static constexpr int NTD = D / 8, NTB = BLK / 8;
  // shared bytes: three (fwd) or four (bwd) BLK x D tiles and one 16 x BLK
  // tile a warp
  static constexpr size_t FWD = sizeof(T) * ((size_t)3 * BLK * LD + (size_t)NW * 16 * LP);
  static constexpr size_t BWD = sizeof(T) * ((size_t)4 * BLK * LD + (size_t)NW * 16 * LP) +
                                sizeof(float) * 2 * BLK;
};

constexpr size_t MAX_SMEM = 232448;

// ------------------------------------------------------------------ forward

template <typename T, int D, int BLK>
__global__ void __launch_bounds__(BLK * 2) bsa_fwd_kernel(BsaArgs a) {
  using C = Tile<T, D, BLK>;
  constexpr int LD = C::LD, LP = C::LP, NTD = C::NTD, NTB = C::NTB, NTHR = C::NTHR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BLK][LD]
  T* ks = qs + BLK * LD;                    // [BLK][LD]
  T* vs = ks + BLK * LD;                    // [BLK][LD]
  T* ps = vs + BLK * LD;                    // [NW][16][LP]

  const int qi = blockIdx.x, bh = blockIdx.y, h = bh % a.H, n = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int q0 = qi * BLK;
  const long long base = (long long)bh * a.T * D;
  const T* qg = reinterpret_cast<const T*>(a.q) + base;
  const T* kg = reinterpret_cast<const T*>(a.k) + base;
  const T* vg = reinterpret_cast<const T*>(a.v) + base;
  const int cnt = a.row_cnt[h * n + qi];
  const int* ids = a.rows + (long long)(h * n + qi) * a.max_row;

  load_tile<T, D, BLK, NTHR>(qs, LD, qg, D, q0, a.T);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
#pragma unroll
  for (int c = 0; c < NTD; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  T* pw = ps + warp * 16 * LP;

  for (int jj = 0; jj < cnt; ++jj) {
    const int kb0 = ids[jj] * BLK;
    __syncthreads();
    load_tile<T, D, BLK, NTHR>(ks, LD, kg, D, kb0, a.T);
    load_tile<T, D, BLK, NTHR>(vs, LD, vg, D, kb0, a.T);
    __syncthreads();

    float s[NTB][4];
#pragma unroll
    for (int c = 0; c < NTB; ++c) s[c][0] = s[c][1] = s[c][2] = s[c][3] = 0.f;
    mma_nk<NTB>(s, qs + warp * 16 * LD, LD, ks, LD, D);

    const bool masked = a.causal && kb0 + BLK - 1 > q0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int c = 0; c < NTB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (masked && kb0 + c * 8 + 2 * t4 + (e & 1) > ((e < 2) ? r0 : r1)) s[c][e] = NEG_INF;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[c][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int c = 0; c < NTB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(s[c][e] - m[i]);
        sum[i] += p;
        pw[(g + 8 * i) * LP + c * 8 + 2 * t4 + (e & 1)] = from_f<T>(p);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int c = 0; c < NTD; ++c) {
      acc[c][0] *= alpha[0];
      acc[c][1] *= alpha[0];
      acc[c][2] *= alpha[1];
      acc[c][3] *= alpha[1];
    }
    __syncwarp();
    mma_kn<NTD>(acc, pw, LP, vs, LD, BLK);
    __syncwarp();
  }

  T* og = reinterpret_cast<T*>(a.o) + base;
  float* lg = a.lse + (long long)bh * a.T;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    // a row with no present block: o = 0, lse = NEG_INF (the masked-dense
    // reference's zero output)
    const bool live = l[i] > 0.f;
    const float inv = live ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int c = 0; c < NTD; ++c) {
      T* op = og + (long long)row * D + c * 8 + 2 * t4;
      op[0] = from_f<T>(acc[c][2 * i] * inv);
      op[1] = from_f<T>(acc[c][2 * i + 1] * inv);
    }
    if (t4 == 0) lg[row] = live ? m[i] + logf(l[i]) : NEG_INF;
  }
}

// ---------------------------------------------------------------------- dq

template <typename T, int D, int BLK>
__global__ void __launch_bounds__(BLK * 2) bsa_dq_kernel(BsaArgs a) {
  using C = Tile<T, D, BLK>;
  constexpr int LD = C::LD, LP = C::LP, NTD = C::NTD, NTB = C::NTB, NTHR = C::NTHR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BLK][LD]
  T* dos = qs + BLK * LD;                   // [BLK][LD]
  T* ks = dos + BLK * LD;                   // [BLK][LD]
  T* vs = ks + BLK * LD;                    // [BLK][LD]
  T* pd = vs + BLK * LD;                    // [NW][16][LP] round(ds)

  const int qi = blockIdx.x, bh = blockIdx.y, h = bh % a.H, n = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int q0 = qi * BLK;
  const long long base = (long long)bh * a.T * D;
  const T* qg = reinterpret_cast<const T*>(a.q) + base;
  const T* kg = reinterpret_cast<const T*>(a.k) + base;
  const T* vg = reinterpret_cast<const T*>(a.v) + base;
  const T* dg = reinterpret_cast<const T*>(a.dout) + base;
  const T* og = reinterpret_cast<const T*>(a.o) + base;
  const int cnt = a.row_cnt[h * n + qi];
  const int* ids = a.rows + (long long)(h * n + qi) * a.max_row;

  load_tile<T, D, BLK, NTHR>(qs, LD, qg, D, q0, a.T);
  load_tile<T, D, BLK, NTHR>(dos, LD, dg, D, q0, a.T);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float dl_r[2];
  warp_row_delta<T, D>(dl_r, dg, D, og, D, nullptr, q0 + warp * 16, a.T);
  float* delg = a.delta + (long long)bh * a.T;
  if (t4 == 0) {
    delg[r0] = dl_r[0];
    delg[r1] = dl_r[1];
  }
  const float* lg = a.lse + (long long)bh * a.T;
  const float lse_r[2] = {lg[r0], lg[r1]};

  float dq[NTD][4];
#pragma unroll
  for (int c = 0; c < NTD; ++c) dq[c][0] = dq[c][1] = dq[c][2] = dq[c][3] = 0.f;
  T* pdw = pd + warp * 16 * LP;

  for (int jj = 0; jj < cnt; ++jj) {
    const int kb0 = ids[jj] * BLK;
    __syncthreads();
    load_tile<T, D, BLK, NTHR>(ks, LD, kg, D, kb0, a.T);
    load_tile<T, D, BLK, NTHR>(vs, LD, vg, D, kb0, a.T);
    __syncthreads();

    float s[NTB][4], dp[NTB][4];
#pragma unroll
    for (int c = 0; c < NTB; ++c)
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
    mma_nk<NTB>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    mma_nk<NTB>(dp, dos + warp * 16 * LD, LD, vs, LD, D);
#pragma unroll
    for (int c = 0; c < NTB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kl = c * 8 + 2 * t4 + (e & 1);
        const bool off = a.causal && kb0 + kl > (i ? r1 : r0);
        const float p = off ? 0.f : expf(s[c][e] - lse_r[i]);
        pdw[(g + 8 * i) * LP + kl] = from_f<T>(p * (dp[c][e] - dl_r[i]));
      }
    }
    __syncwarp();
    mma_kn<NTD>(dq, pdw, LP, ks, LD, BLK);
    __syncwarp();
  }

  T* dqg = reinterpret_cast<T*>(a.dq) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
#pragma unroll
    for (int c = 0; c < NTD; ++c) {
      T* qp = dqg + (long long)row * D + c * 8 + 2 * t4;
      qp[0] = from_f<T>(dq[c][2 * i]);
      qp[1] = from_f<T>(dq[c][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------- dk/dv

template <typename T, int D, int BLK>
__global__ void __launch_bounds__(BLK * 2) bsa_dkv_kernel(BsaArgs a) {
  using C = Tile<T, D, BLK>;
  constexpr int LD = C::LD, LP = C::LP, NTD = C::NTD, NTB = C::NTB, NTHR = C::NTHR;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BLK][LD]
  T* vs = ks + BLK * LD;                    // [BLK][LD]
  T* qs = vs + BLK * LD;                    // [BLK][LD]
  T* dos = qs + BLK * LD;                   // [BLK][LD]
  T* pp = dos + BLK * LD;                   // [NW][16][LP] round(p)^T, then round(ds)^T
  float* lse_s = reinterpret_cast<float*>(pp + C::NW * 16 * LP);  // [BLK]
  float* dl_s = lse_s + BLK;                                       // [BLK]

  const int ki = blockIdx.x, bh = blockIdx.y, h = bh % a.H, n = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int k0 = ki * BLK;
  const long long base = (long long)bh * a.T * D;
  const T* qg = reinterpret_cast<const T*>(a.q) + base;
  const T* kg = reinterpret_cast<const T*>(a.k) + base;
  const T* vg = reinterpret_cast<const T*>(a.v) + base;
  const T* dg = reinterpret_cast<const T*>(a.dout) + base;
  const float* lg = a.lse + (long long)bh * a.T;
  const float* delg = a.delta + (long long)bh * a.T;
  const int cnt = a.col_cnt[h * n + ki];
  const int* ids = a.cols + (long long)(h * n + ki) * a.max_col;

  load_tile<T, D, BLK, NTHR>(ks, LD, kg, D, k0, a.T);
  load_tile<T, D, BLK, NTHR>(vs, LD, vg, D, k0, a.T);
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int c = 0; c < NTD; ++c)
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;
  T* ppw = pp + warp * 16 * LP;

  for (int ii = 0; ii < cnt; ++ii) {
    const int qb0 = ids[ii] * BLK;
    __syncthreads();
    load_tile<T, D, BLK, NTHR>(qs, LD, qg, D, qb0, a.T);
    load_tile<T, D, BLK, NTHR>(dos, LD, dg, D, qb0, a.T);
    for (int r = threadIdx.x; r < BLK; r += NTHR) {
      lse_s[r] = lg[qb0 + r];
      dl_s[r] = delg[qb0 + r];
    }
    __syncthreads();

    float s[NTB][4], dp[NTB][4];
#pragma unroll
    for (int c = 0; c < NTB; ++c)
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
    mma_nk<NTB>(s, ks + warp * 16 * LD, LD, qs, LD, D);    // S^T [key][query]
    mma_nk<NTB>(dp, vs + warp * 16 * LD, LD, dos, LD, D);  // dP^T = V dO^T
#pragma unroll
    for (int c = 0; c < NTB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = c * 8 + 2 * t4 + (e & 1);
        const bool off = a.causal && ((e < 2) ? kr0 : kr1) > qb0 + ql;
        s[c][e] = off ? 0.f : expf(s[c][e] - lse_s[ql]);  // p
        ppw[(g + 8 * (e >> 1)) * LP + ql] = from_f<T>(s[c][e]);
      }
    }
    __syncwarp();
    mma_kn<NTD>(dv, ppw, LP, dos, LD, BLK);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < NTB; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = c * 8 + 2 * t4 + (e & 1);
        ppw[(g + 8 * (e >> 1)) * LP + ql] = from_f<T>(s[c][e] * (dp[c][e] - dl_s[ql]));
      }
    }
    __syncwarp();
    mma_kn<NTD>(dk, ppw, LP, qs, LD, BLK);
    __syncwarp();
  }

  T* dkg = reinterpret_cast<T*>(a.dk) + base;
  T* dvg = reinterpret_cast<T*>(a.dv) + base;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i ? kr1 : kr0;
#pragma unroll
    for (int c = 0; c < NTD; ++c) {
      const int col = c * 8 + 2 * t4;
      T* kp = dkg + (long long)key * D + col;
      T* vp = dvg + (long long)key * D + col;
      kp[0] = from_f<T>(dk[c][2 * i]);
      kp[1] = from_f<T>(dk[c][2 * i + 1]);
      vp[0] = from_f<T>(dv[c][2 * i]);
      vp[1] = from_f<T>(dv[c][2 * i + 1]);
    }
  }
}

// ----------------------------------------------------------------- launch

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
                   const BsaArgs& a) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// which: 0 = forward, 1 = dq, 2 = dk/dv. A (type, D, BLK) whose tiles do not
// fit a CTA's shared memory is refused (fp32 at D = BLK = 128).
template <typename T, int D, int BLK>
cudaError_t run(const BsaArgs& a, int which, cudaStream_t s) {
  using C = Tile<T, D, BLK>;
  const dim3 grid(a.T / BLK, a.BH);
  if (which == 0) {
    if constexpr (C::FWD <= MAX_SMEM) return launch(bsa_fwd_kernel<T, D, BLK>, grid, C::NTHR, C::FWD, s, a);
  } else if (which == 1) {
    if constexpr (C::BWD <= MAX_SMEM) return launch(bsa_dq_kernel<T, D, BLK>, grid, C::NTHR, C::BWD, s, a);
  } else if (which == 2) {
    if constexpr (C::BWD <= MAX_SMEM) return launch(bsa_dkv_kernel<T, D, BLK>, grid, C::NTHR, C::BWD, s, a);
  }
  return cudaErrorInvalidConfiguration;
}

template <typename T, int D>
cudaError_t run_by_block(const BsaArgs& a, int which, cudaStream_t s) {
  switch (a.block) {
    case 16: return run<T, D, 16>(a, which, s);
    case 32: return run<T, D, 32>(a, which, s);
    case 64: return run<T, D, 64>(a, which, s);
    case 128: return run<T, D, 128>(a, which, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run_by_d(const BsaArgs& a, int which, cudaStream_t s) {
  switch (a.D) {
    case 32: return run_by_block<T, 32>(a, which, s);
    case 64: return run_by_block<T, 64>(a, which, s);
    case 128: return run_by_block<T, 128>(a, which, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; which: 0 = forward, 1 = dq (writes
// delta), 2 = dk/dv (reads it). Returns a cudaError_t (0 = launched).
extern "C" int bsa_launch(const BsaArgs* a, int dtype, int which, void* stream) {
  if (a == nullptr || a->BH <= 0 || a->H <= 0 || a->T <= 0 || a->block <= 0 ||
      a->T % a->block != 0 || a->BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return run_by_d<bf16>(*a, which, s);
  if (dtype == 0) return run_by_d<float>(*a, which, s);
  return cudaErrorInvalidValue;
}
