// Flash attention forward and backward for the training path, CUDA C++ for sm_90a.
//
// Extern "C" launchers take a FlashArgs struct (mirrored by ctypes in
// ops/cuda/flash_attention.py) and return cudaGetLastError() (0 = launched).
// They never synchronize and never allocate: the wrapper allocates o, lse,
// the delta scratch and dq/dk/dv with torch.empty and passes raw pointers and
// the current stream.
//
// Layout: every (B, H, T, D) operand is addressed through its own element
// strides (b, h, t) with the head dim contiguous, so the model's (B, T, H, D)
// projections and the heads-major (B, H, T, D) API both reach the kernels
// without a copy. lse and delta are (B, H, T) fp32, contiguous.
// Element type: float or __nv_bfloat16 (template T). The softmax scale is
// folded into q by the wrapper (flash_attention.py:1570-1580), so the kernels
// run with scale 1.
//
// flash_fwd_kernel   replaces deepspeed_tpu/ops/pallas/flash_attention.py
//                    _fwd_kernel_t (via _fwd_t) and its twin _fwd_kernel
//                    (via _fwd): one contract, the T-minor layout is not
//                    ported.
//   One CTA (4 warps) per (64-query tile, b*h); each warp owns 16 query rows.
//   A loop over 64-key tiles replaces the TPU's in-kernel fori_loop; it stops
//   at the causal diagonal and starts at the window's first live tile
//   (flash_attention.py:388-394). Online softmax (m, l, acc) in fp32
//   registers; p is rounded to V's dtype before P.V, exactly as
//   p.astype(vb.dtype) (:420). Writes o in the input dtype and
//   lse = m + log(l) in fp32.
//   Bound: at T=1024, d=64 a causal head does 2*T^2*d flops against the
//   4*T*d bf16 elements it must move (q, k, v, o), ~256 flop/byte, just
//   under the H100's 295 flop/byte ridge, so bytes and tensor-core time
//   are close (chip_smoke.py computes which wins). The design keeps every
//   score and probability on chip and feeds the tensor cores (mma.sync
//   m16n8k16 bf16 -> fp32) from shared-memory tiles. Loads are synchronous
//   (no cp.async/TMA pipeline yet, no wgmma): later work.
//
// flash_block_fwd_kernel (flash_fwd_kernel with CARRY = true) replaces
//   _fwd_block_kernel (via flash_block_fwd, flash_attention.py:1033-1087,
//   :1106-1161): one chunk pair of a ring-attention schedule. The same CTA
//   shape and tile loop as the forward, but the online-softmax state is the
//   caller's: each CTA reads its 64 rows' running max m, running sum l
//   ((B*H, T) fp32) and unnormalized accumulator acc ((B*H, T, D) fp32),
//   walks the kv tiles, and writes m, l and acc back in place (each CTA
//   owns its rows, so nothing races); no o or lse. causal = 1 is the
//   diagonal pair (equal lengths, shared offset: only the diagonal tiles
//   mask); causal = 0 masks nothing but the keys past T. The wrapper folds
//   (B*H) into B with H = 1. Bound: as the forward, plus 2*(4*D + 8) bytes
//   a row of fp32 state read and written.
//
// flash_bwd (three launches, one contract) replaces _bwd_kernel_t (via
//   _bwd_t) and its twin _bwd_kernel (via _bwd). The TPU kernel walks key
//   blocks on a sequential grid and carries dq in an fp32 output across grid
//   steps (:813); GPU blocks run in parallel, so the deterministic
//   FlashAttention-2 split is used instead of atomics:
//   flash_delta_kernel   delta = rowsum(do * o) in fp32 (:781), one warp/row.
//   flash_dkdv_kernel    one CTA per 64-key tile, a loop over query tiles
//                        from the diagonal on; recomputes p = exp(s - lse),
//                        dv += round(p)^T do, ds = p (dp - delta),
//                        dk += round(ds)^T q, fp32 accumulators.
//   flash_dq_kernel      one CTA per 64-query tile, a loop over key tiles up
//                        to the diagonal; dq += round(ds) k in fp32.
//   Results are cast to the input dtype once at the end. Bound: operations
//   (about 2.5x the forward's flops); same mma.sync design.
//
// flash_bwd_qmajor_kernel (one launch) replaces _bwd_kernel_t_qmajor (via
//   _bwd_t_qmajor, flash_attention.py:828-916). The TPU kernel walks query
//   blocks on its sequential grid and keeps dk/dv for the whole sequence in
//   fp32 VMEM scratch (2*T*d*4 bytes a head: 512 KB at T=1024, d=64, over a
//   CTA's 227 KB of shared memory). Here one CTA per (b, h) walks the query
//   tiles itself and keeps its dk/dv accumulators in a global fp32 scratch
//   slice that no other CTA touches: per (query, key) tile pair S and dP are
//   formed once, dq is carried in registers and written once per query tile
//   in the input dtype, and dk/dv are read, updated and written back in fp32
//   and cast once at the end. No atomics: a run repeats bitwise, and since
//   it forms the same 64 x 64 tile products as flash_bwd and accumulates
//   each output in the same order, its results equal flash_bwd's bitwise
//   (chip_smoke.py checks both). Bound: the
//   same operations as flash_bwd with S and dP formed once (about 2x the
//   forward's flops); what holds it back is the scratch round trip (each
//   pair reads and writes 2*64*d*4 bytes of dk/dv) and B*H CTAs, one wave
//   at B*H = 384. A cluster that keeps dk/dv in distributed shared memory
//   is later work.
//
// Masks are the Pallas kernels' exactly: NEG_INF = -1e30 for masked scores
// in the forward, p = 0 for masked pairs in the backward, keys and queries
// beyond T masked (the ragged last tile), sliding window causal only.
//
// fp32 instances (the parity checks) run the same tiles with the products
// done by scalar FMAs in the mma fragment layout, so the softmax code is
// shared by both types.

#include "attention_tiles.cuh"

struct Strides {
  long long b, h, t;
};

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;            // forward output; backward input
  float* lse;         // (B, H, T): forward output; backward input
  const void* dout;   // backward: dL/do
  float* delta;       // backward: (B, H, T) scratch, rowsum(do * o) - dlse
  const float* dlse;  // backward: (B, H, T) cotangent of lse, or null
  void* dq;
  void* dk;
  void* dv;
  float* acc;         // query-major backward: (B*H, 2, Tp, D) fp32 dk/dv scratch;
                      // ring block forward: the (B*H, T, D) fp32 carry, strides sacc
  Strides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, T, D, causal, window;
  float* m;           // ring block forward: (B*H, T) running max, read and written
  float* l;           // ring block forward: (B*H, T) running sum, read and written
  long long sml;      // m and l stride per b*h (unit stride along T)
  Strides sacc;
};

namespace {

constexpr int BQ = 64;  // query rows per CTA
constexpr int BK = 64;  // key rows per tile
constexpr int NW = 4;   // warps per CTA, 16 rows each
constexpr int NT = NW * 32;

__device__ __forceinline__ bool pair_ok(int q, int k, int T_, int causal, int window) {
  bool ok = (k < T_) && (q < T_);
  if (causal) ok = ok && (k <= q);
  if (window > 0) ok = ok && (q - k < window);
  return ok;
}

// ------------------------------------------------------------------ forward

template <typename T, int D, bool CARRY>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(FlashArgs a) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  constexpr int NTD = D / 8, NTK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* ks = qs + BQ * LD;                     // [BK][LD]
  T* vs = ks + BK * LD;                     // [BK][LD]
  T* ps = vs + BK * LD;                     // [NW][16][LP]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BQ;
  const T* qg = reinterpret_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = reinterpret_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vg = reinterpret_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;

  load_tile<T, D, 64, NT>(qs, LD, qg, a.sq.t, q0, a.T);
  const int k_hi = a.causal ? min(a.T, q0 + BQ) : a.T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float* cm = a.m + (long long)bh * a.sml;
  float* cl = a.l + (long long)bh * a.sml;
  float* ca = a.acc + b * a.sacc.b + h * a.sacc.h;
  if (CARRY) {  // the caller's running state for rows r0 and r1
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? r1 : r0;
      if (row >= a.T) continue;
      m[i] = cm[row];
      l[i] = cl[row];
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        const float* ap = ca + (long long)row * a.sacc.t + n * 8 + 2 * t4;
        acc[n][2 * i] = ap[0];
        acc[n][2 * i + 1] = ap[1];
      }
    }
  }
  T* pw = ps + warp * 16 * LP;

  for (int j = j_lo; j < j_hi; ++j) {
    const int kb0 = j * BK;
    __syncthreads();
    load_tile<T, D, 64, NT>(ks, LD, kg, a.sk.t, kb0, a.T);
    load_tile<T, D, 64, NT>(vs, LD, vg, a.sv.t, kb0, a.T);
    __syncthreads();

    float s[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_nk<NTK>(s, qs + warp * 16 * LD, LD, ks, LD, D);

    const bool full = (kb0 + BK <= a.T) && (!a.causal || kb0 + BK - 1 <= q0) &&
                      (a.window == 0 || q0 + BQ - 1 - kb0 < a.window);
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (!full) {
          const int col = kb0 + n * 8 + 2 * t4 + (e & 1);
          const int row = (e < 2) ? r0 : r1;
          bool ok = col < a.T;
          if (a.causal) ok = ok && (col <= row);
          if (a.window > 0) ok = ok && (row - col < a.window);
          if (!ok) s[n][e] = NEG_INF;
        }
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
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
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float p = expf(s[n][e] - m[i]);
        sum[i] += p;
        pw[(g + 8 * i) * LP + n * 8 + 2 * t4 + (e & 1)] = from_f<T>(p);
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
      l[i] = l[i] * alpha[i] + sum[i];
    }
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    __syncwarp();
    mma_kn<NTD>(acc, pw, LP, vs, LD, BK);
    __syncwarp();
  }

  if (CARRY) {  // the state goes back unnormalized; finalize divides
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = i ? r1 : r0;
      if (row >= a.T) continue;
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        float* ap = ca + (long long)row * a.sacc.t + n * 8 + 2 * t4;
        ap[0] = acc[n][2 * i];
        ap[1] = acc[n][2 * i + 1];
      }
      if (t4 == 0) {
        cm[row] = m[i];
        cl[row] = l[i];
      }
    }
    return;
  }
  T* og = reinterpret_cast<T*>(a.o) + b * a.so.b + h * a.so.h;
  float* lg = a.lse + (long long)bh * a.T;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= a.T) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      T* op = og + (long long)row * a.so.t + n * 8 + 2 * t4;
      op[0] = from_f<T>(acc[n][2 * i] * inv);
      op[1] = from_f<T>(acc[n][2 * i + 1] * inv);
    }
    if (t4 == 0) lg[row] = m[i] + logf(l[i]);
  }
}

// ----------------------------------------------------------------- backward

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_delta_kernel(FlashArgs a, long long rows) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * NW + warp;
  if (row >= rows) return;
  const int t = (int)(row % a.T);
  const long long bh = row / a.T;
  const int b = (int)(bh / a.H), h = (int)(bh % a.H);
  const T* dp = reinterpret_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h + t * a.sdo.t;
  const T* op = reinterpret_cast<const T*>(a.o) + b * a.so.b + h * a.so.h + t * a.so.t;
  float s = 0.f;
  for (int e = lane; e < D; e += 32) s += to_f<T>(dp[e]) * to_f<T>(op[e]);
  s = warp_sum(s);
  // a cotangent on lse shifts delta by -dlse (flash_attention.py:1251-1254)
  if (lane == 0) a.delta[row] = a.dlse ? s - a.dlse[row] : s;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dkdv_kernel(FlashArgs a) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LD = D + PAD;
  constexpr int LP = BQ + PAD;
  constexpr int NTD = D / 8, NTQ = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [BK][LD]
  T* vs = ks + BK * LD;                     // [BK][LD]
  T* qs = vs + BK * LD;                     // [BQ][LD]
  T* dos = qs + BQ * LD;                    // [BQ][LD]
  T* pp = dos + BQ * LD;                    // [NW][16][LP] round(p)^T
  T* pd = pp + NW * 16 * LP;                // [NW][16][LP] round(ds)^T
  float* lse_s = reinterpret_cast<float*>(pd + NW * 16 * LP);  // [BQ]
  float* dl_s = lse_s + BQ;                                    // [BQ]

  const int kt = blockIdx.x, bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int k0 = kt * BK;
  const T* qg = reinterpret_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = reinterpret_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vg = reinterpret_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dg = reinterpret_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const float* lg = a.lse + (long long)bh * a.T;
  const float* delg = a.delta + (long long)bh * a.T;

  load_tile<T, D, 64, NT>(ks, LD, kg, a.sk.t, k0, a.T);
  load_tile<T, D, 64, NT>(vs, LD, vg, a.sv.t, k0, a.T);
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.T, k0 + BK - 1 + a.window) : a.T;
  const int i_lo = q_lo / BQ, i_hi = (q_hi + BQ - 1) / BQ;

  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  float dk[NTD][4], dv[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n)
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;
  T* ppw = pp + warp * 16 * LP;
  T* pdw = pd + warp * 16 * LP;

  for (int i = i_lo; i < i_hi; ++i) {
    const int qb0 = i * BQ;
    __syncthreads();
    load_tile<T, D, 64, NT>(qs, LD, qg, a.sq.t, qb0, a.T);
    load_tile<T, D, 64, NT>(dos, LD, dg, a.sdo.t, qb0, a.T);
    for (int r = threadIdx.x; r < BQ; r += NT) {
      const bool in = qb0 + r < a.T;
      lse_s[r] = in ? lg[qb0 + r] : 0.f;
      dl_s[r] = in ? delg[qb0 + r] : 0.f;
    }
    __syncthreads();

    float s[NTQ][4], dp[NTQ][4];
#pragma unroll
    for (int n = 0; n < NTQ; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nk<NTQ>(s, ks + warp * 16 * LD, LD, qs, LD, D);    // S^T [key][query]
    mma_nk<NTQ>(dp, vs + warp * 16 * LD, LD, dos, LD, D);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < NTQ; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = n * 8 + 2 * t4 + (e & 1);
        const int key = (e < 2) ? kr0 : kr1;
        const float p =
            pair_ok(qb0 + ql, key, a.T, a.causal, a.window) ? expf(s[n][e] - lse_s[ql]) : 0.f;
        const float ds = p * (dp[n][e] - dl_s[ql]);
        const int at = (g + 8 * (e >> 1)) * LP + ql;
        ppw[at] = from_f<T>(p);
        pdw[at] = from_f<T>(ds);
      }
    }
    __syncwarp();
    mma_kn<NTD>(dv, ppw, LP, dos, LD, BQ);
    mma_kn<NTD>(dk, pdw, LP, qs, LD, BQ);
    __syncwarp();
  }

  T* dkg = reinterpret_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvg = reinterpret_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = i ? kr1 : kr0;
    if (key >= a.T) continue;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      const int c = n * 8 + 2 * t4;
      T* kp = dkg + (long long)key * a.sdk.t + c;
      T* vp = dvg + (long long)key * a.sdv.t + c;
      kp[0] = from_f<T>(dk[n][2 * i]);
      kp[1] = from_f<T>(dk[n][2 * i + 1]);
      vp[0] = from_f<T>(dv[n][2 * i]);
      vp[1] = from_f<T>(dv[n][2 * i + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_dq_kernel(FlashArgs a) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  constexpr int NTD = D / 8, NTK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dos = qs + BQ * LD;                    // [BQ][LD]
  T* ks = dos + BQ * LD;                    // [BK][LD]
  T* vs = ks + BK * LD;                     // [BK][LD]
  T* pd = vs + BK * LD;                     // [NW][16][LP] round(ds)

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BQ;
  const T* qg = reinterpret_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = reinterpret_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vg = reinterpret_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dg = reinterpret_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;

  load_tile<T, D, 64, NT>(qs, LD, qg, a.sq.t, q0, a.T);
  load_tile<T, D, 64, NT>(dos, LD, dg, a.sdo.t, q0, a.T);
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    lse_r[i] = row < a.T ? a.lse[(long long)bh * a.T + row] : 0.f;
    dl_r[i] = row < a.T ? a.delta[(long long)bh * a.T + row] : 0.f;
  }
  const int k_hi = a.causal ? min(a.T, q0 + BQ) : a.T;
  const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

  float dq[NTD][4];
#pragma unroll
  for (int n = 0; n < NTD; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
  T* pdw = pd + warp * 16 * LP;

  for (int j = j_lo; j < j_hi; ++j) {
    const int kb0 = j * BK;
    __syncthreads();
    load_tile<T, D, 64, NT>(ks, LD, kg, a.sk.t, kb0, a.T);
    load_tile<T, D, 64, NT>(vs, LD, vg, a.sv.t, kb0, a.T);
    __syncthreads();

    float s[NTK][4], dp[NTK][4];
#pragma unroll
    for (int n = 0; n < NTK; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    mma_nk<NTK>(s, qs + warp * 16 * LD, LD, ks, LD, D);
    mma_nk<NTK>(dp, dos + warp * 16 * LD, LD, vs, LD, D);
#pragma unroll
    for (int n = 0; n < NTK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kl = n * 8 + 2 * t4 + (e & 1);
        const int row = i ? r1 : r0;
        const float p =
            pair_ok(row, kb0 + kl, a.T, a.causal, a.window) ? expf(s[n][e] - lse_r[i]) : 0.f;
        pdw[(g + 8 * i) * LP + kl] = from_f<T>(p * (dp[n][e] - dl_r[i]));
      }
    }
    __syncwarp();
    mma_kn<NTD>(dq, pdw, LP, ks, LD, BK);
    __syncwarp();
  }

  T* dqg = reinterpret_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = i ? r1 : r0;
    if (row >= a.T) continue;
#pragma unroll
    for (int n = 0; n < NTD; ++n) {
      T* qp = dqg + (long long)row * a.sdq.t + n * 8 + 2 * t4;
      qp[0] = from_f<T>(dq[n][2 * i]);
      qp[1] = from_f<T>(dq[n][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------ query-major backward

// The mma fragment of a 16 x 8*NTD fp32 tile at p (row stride ld) in the
// accumulator layout: c[n][0..1] at (row g, cols 8n + 2t + {0,1}), c[n][2..3]
// at row g + 8. Each thread touches only its own elements.
template <int NTD>
__device__ __forceinline__ void frag_load(float (&c)[NTD][4], const float* p, int ld, bool zero) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (!zero) {
      lo = *reinterpret_cast<const float2*>(p + g * ld + n * 8 + 2 * t4);
      hi = *reinterpret_cast<const float2*>(p + (g + 8) * ld + n * 8 + 2 * t4);
    }
    c[n][0] = lo.x;
    c[n][1] = lo.y;
    c[n][2] = hi.x;
    c[n][3] = hi.y;
  }
}

template <int NTD>
__device__ __forceinline__ void frag_store(const float (&c)[NTD][4], float* p, int ld) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int n = 0; n < NTD; ++n) {
    *reinterpret_cast<float2*>(p + g * ld + n * 8 + 2 * t4) = make_float2(c[n][0], c[n][1]);
    *reinterpret_cast<float2*>(p + (g + 8) * ld + n * 8 + 2 * t4) = make_float2(c[n][2], c[n][3]);
  }
}

// One CTA per (b, h) walks the query tiles in order, as the TPU kernel's
// sequential grid does. Per query tile: delta once (warp_row_delta), then
// per key tile between the forward's bounds S and dP once, p, ds, and
// dq += round(ds) k in registers (written once per query tile); dv += round(p)^T do
// and dk += round(ds)^T q go to this CTA's own fp32 slice of a.acc, which
// carries them across the whole walk (a key tile's first visit starts it
// at zero: the diagonal tile when causal, query tile 0 otherwise). During
// the walk each thread reads and writes only its own fragment elements of
// a.acc; the epilogue casts the slice after one barrier.
template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_bwd_qmajor_kernel(FlashArgs a) {
  constexpr int PAD = 16 / sizeof(T);
  constexpr int LD = D + PAD;
  constexpr int LP = BK + PAD;
  constexpr int NTD = D / 8, NTK = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [BQ][LD]
  T* dos = qs + BQ * LD;                    // [BQ][LD]
  T* ks = dos + BQ * LD;                    // [BK][LD]
  T* vs = ks + BK * LD;                     // [BK][LD]
  T* pt = vs + BK * LD;                     // [BK][LP] round(p)^T, every warp's queries
  T* dst = pt + BK * LP;                    // [BK][LP] round(ds)^T
  T* dsq = dst + BK * LP;                   // [NW][16][LP] round(ds), this warp's queries

  const int bh = blockIdx.x, b = bh / a.H, h = bh - b * a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int nq = (a.T + BQ - 1) / BQ;
  const long long tp = (long long)nq * BQ;
  const T* qg = reinterpret_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kg = reinterpret_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vg = reinterpret_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* dg = reinterpret_cast<const T*>(a.dout) + b * a.sdo.b + h * a.sdo.h;
  const T* og = reinterpret_cast<const T*>(a.o) + b * a.so.b + h * a.so.h;
  T* dqg = reinterpret_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  const float* lg = a.lse + (long long)bh * a.T;
  const float* dlg = a.dlse ? a.dlse + (long long)bh * a.T : nullptr;
  float* dk_acc = a.acc + (long long)bh * 2 * tp * D;
  float* dv_acc = dk_acc + tp * D;
  T* dsw = dsq + warp * 16 * LP;

  for (int i = 0; i < nq; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<T, D, 64, NT>(qs, LD, qg, a.sq.t, q0, a.T);
    load_tile<T, D, 64, NT>(dos, LD, dg, a.sdo.t, q0, a.T);
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    float dl_r[2];
    warp_row_delta<T, D>(dl_r, dg, a.sdo.t, og, a.so.t, dlg, q0 + warp * 16, a.T);
    const float lse_r[2] = {r0 < a.T ? lg[r0] : 0.f, r1 < a.T ? lg[r1] : 0.f};
    const int k_hi = a.causal ? min(a.T, q0 + BQ) : a.T;
    const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
    const int j_lo = k_lo / BK, j_hi = (k_hi + BK - 1) / BK;

    float dq[NTD][4];
#pragma unroll
    for (int n = 0; n < NTD; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

    for (int j = j_lo; j < j_hi; ++j) {
      const int kb0 = j * BK;
      __syncthreads();
      load_tile<T, D, 64, NT>(ks, LD, kg, a.sk.t, kb0, a.T);
      load_tile<T, D, 64, NT>(vs, LD, vg, a.sv.t, kb0, a.T);
      __syncthreads();

      float s[NTK][4], dp[NTK][4];
#pragma unroll
      for (int n = 0; n < NTK; ++n)
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      mma_nk<NTK>(s, qs + warp * 16 * LD, LD, ks, LD, D);    // S = Q K^T, once
      mma_nk<NTK>(dp, dos + warp * 16 * LD, LD, vs, LD, D);  // dP = dO V^T, once
#pragma unroll
      for (int n = 0; n < NTK; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i2 = e >> 1;
          const int kl = n * 8 + 2 * t4 + (e & 1);
          const int ql = warp * 16 + g + 8 * i2;
          const int row = i2 ? r1 : r0;
          const float p =
              pair_ok(row, kb0 + kl, a.T, a.causal, a.window) ? expf(s[n][e] - lse_r[i2]) : 0.f;
          const T dsb = from_f<T>(p * (dp[n][e] - dl_r[i2]));
          pt[kl * LP + ql] = from_f<T>(p);
          dst[kl * LP + ql] = dsb;
          dsw[(g + 8 * i2) * LP + kl] = dsb;
        }
      }
      __syncthreads();
      mma_kn<NTD>(dq, dsw, LP, ks, LD, BK);

      const bool first = a.causal ? (j == i) : (i == 0);
      const long long key0 = kb0 + warp * 16;
      float acc[NTD][4];
      frag_load<NTD>(acc, dv_acc + key0 * D, D, first);
      mma_kn<NTD>(acc, pt + warp * 16 * LP, LP, dos, LD, BQ);
      frag_store<NTD>(acc, dv_acc + key0 * D, D);
      frag_load<NTD>(acc, dk_acc + key0 * D, D, first);
      mma_kn<NTD>(acc, dst + warp * 16 * LP, LP, qs, LD, BQ);
      frag_store<NTD>(acc, dk_acc + key0 * D, D);
    }

#pragma unroll
    for (int i2 = 0; i2 < 2; ++i2) {
      const int row = i2 ? r1 : r0;
      if (row >= a.T) continue;
#pragma unroll
      for (int n = 0; n < NTD; ++n) {
        T* qp = dqg + (long long)row * a.sdq.t + n * 8 + 2 * t4;
        qp[0] = from_f<T>(dq[n][2 * i2]);
        qp[1] = from_f<T>(dq[n][2 * i2 + 1]);
      }
    }
  }

  // epilogue: every key's dk/dv, cast once from the fp32 slice
  __syncthreads();
  T* dkg = reinterpret_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvg = reinterpret_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
  for (int idx = threadIdx.x; idx < a.T * (D / 2); idx += NT) {
    const int key = idx / (D / 2), c = (idx - key * (D / 2)) * 2;
    const float2 k2 = *reinterpret_cast<const float2*>(dk_acc + (long long)key * D + c);
    const float2 v2 = *reinterpret_cast<const float2*>(dv_acc + (long long)key * D + c);
    T* kp = dkg + (long long)key * a.sdk.t + c;
    T* vp = dvg + (long long)key * a.sdv.t + c;
    kp[0] = from_f<T>(k2.x);
    kp[1] = from_f<T>(k2.y);
    vp[0] = from_f<T>(v2.x);
    vp[1] = from_f<T>(v2.y);
  }
}

// ----------------------------------------------------------------- launch

template <typename K>
cudaError_t launch(K kernel, dim3 grid, size_t smem, cudaStream_t s, const FlashArgs& a) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, NT, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool CARRY>
cudaError_t fwd(const FlashArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = sizeof(T) * ((size_t)(BQ + 2 * BK) * (D + PAD) + (size_t)NW * 16 * (BK + PAD));
  const dim3 grid((a.T + BQ - 1) / BQ, a.B * a.H);
  return launch(flash_fwd_kernel<T, D, CARRY>, grid, smem, s, a);
}

template <typename T, int D>
cudaError_t bwd(const FlashArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  const long long rows = (long long)a.B * a.H * a.T;
  flash_delta_kernel<T, D><<<(unsigned)((rows + NW - 1) / NW), NT, 0, s>>>(a, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem_kv = sizeof(T) * ((size_t)(2 * BK + 2 * BQ) * (D + PAD) +
                                      (size_t)2 * NW * 16 * (BQ + PAD)) +
                         sizeof(float) * 2 * BQ;
  err = launch(flash_dkdv_kernel<T, D>, dim3((a.T + BK - 1) / BK, a.B * a.H), smem_kv, s, a);
  if (err != cudaSuccess) return err;
  const size_t smem_q =
      sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) + (size_t)NW * 16 * (BK + PAD));
  return launch(flash_dq_kernel<T, D>, dim3((a.T + BQ - 1) / BQ, a.B * a.H), smem_q, s, a);
}

template <typename T, int D>
cudaError_t bwd_qmajor(const FlashArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  const size_t smem = sizeof(T) * ((size_t)(2 * BQ + 2 * BK) * (D + PAD) +
                                   (size_t)(2 * BK + NW * 16) * (BK + PAD));
  return launch(flash_bwd_qmajor_kernel<T, D>, dim3(a.B * a.H), smem, s, a);
}

template <typename T, bool CARRY>
cudaError_t fwd_by_d(const FlashArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return fwd<T, 32, CARRY>(a, s);
    case 64: return fwd<T, 64, CARRY>(a, s);
    case 128: return fwd<T, 128, CARRY>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_by_d(const FlashArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return bwd<T, 32>(a, s);
    case 64: return bwd<T, 64>(a, s);
    case 128: return bwd<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_qmajor_by_d(const FlashArgs& a, cudaStream_t s) {
  switch (a.D) {
    case 32: return bwd_qmajor<T, 32>(a, s);
    case 64: return bwd_qmajor<T, 64>(a, s);
    case 128: return bwd_qmajor<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_args(const FlashArgs* a) {
  return a == nullptr || a->B <= 0 || a->H <= 0 || a->T <= 0 || a->window < 0 ||
         (a->window > 0 && !a->causal) || (long long)a->B * a->H > 65535;  // gridDim.y
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int flash_fwd_launch(const FlashArgs* a, int dtype, void* stream) {
  if (bad_args(a)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return fwd_by_d<bf16, false>(*a, s);
  if (dtype == 0) return fwd_by_d<float, false>(*a, s);
  return cudaErrorInvalidValue;
}

// One ring chunk pair: a->m, a->l and a->acc carry the online-softmax state
// in and out (updated in place); o and lse are not touched.
extern "C" int flash_block_fwd_launch(const FlashArgs* a, int dtype, void* stream) {
  if (bad_args(a) || a->window != 0 || a->m == nullptr || a->l == nullptr ||
      a->acc == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return fwd_by_d<bf16, true>(*a, s);
  if (dtype == 0) return fwd_by_d<float, true>(*a, s);
  return cudaErrorInvalidValue;
}

// Three launches on one stream: delta, dk/dv, dq.
extern "C" int flash_bwd_launch(const FlashArgs* a, int dtype, void* stream) {
  if (bad_args(a)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return bwd_by_d<bf16>(*a, s);
  if (dtype == 0) return bwd_by_d<float>(*a, s);
  return cudaErrorInvalidValue;
}

// One launch: the query-major backward; a->acc is its (B*H, 2, Tp, D) fp32
// scratch, Tp = T rounded up to 64.
extern "C" int flash_bwd_qmajor_launch(const FlashArgs* a, int dtype, void* stream) {
  if (bad_args(a) || a->acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return bwd_qmajor_by_d<bf16>(*a, s);
  if (dtype == 0) return bwd_qmajor_by_d<float>(*a, s);
  return cudaErrorInvalidValue;
}
