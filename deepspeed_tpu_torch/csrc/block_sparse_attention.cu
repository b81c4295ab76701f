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
// synchronously.
//
// The forward has three designs (the wrapper's _bsa_fwd_design picks one
// per call, bsa_launch's design code): sm90 (bf16 at D = 64 or 128, block
// 64: bsa_fwd_sm90_kernel, K1's Hopper forward on TMA + wgmma driven by
// the union of two query blocks' lists, below), mma_sync (other bf16:
// bsa_fwd_kernel<bf16>) and fp32 (bsa_fwd_kernel<float>). The backward
// kernels have the last two.

#include "attention_tiles.cuh"
#include "sm90_attention.cuh"

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
  // the Hopper forward: the union walk of query-block pairs (n2 = ceil(n /
  // 2); ops/cuda/block_sparse_attention.py union_lists) and the work counter
  const int* urows;    // (H, n2, max_u) union of rows 2p and 2p + 1, ascending
  const int* ubits;    // (H, n2, max_u) bit 0: in row 2p's list; bit 1: in 2p + 1's
  const int* ucnt;     // (H, n2)
  const int* uorder;   // (H * n2,) the (h, p) entries, longest union first
  int* next_item;      // zero at the launch
  int max_u;
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

// ------------------------------------------------------- forward (Hopper)
//
// bsa_fwd_sm90_kernel<D> (bf16, D = 64 or 128, block 64): K1's Hopper
// forward (flash_attention.cu flash_fwd_sm90_kernel) with a list-driven
// producer, as K5 (paged_attention.cu paged_chunk_sm90_kernel) drives it
// from a block table. An item is (b*h, query blocks 2p and 2p + 1: 128
// rows); its key walk is the sorted union of the two blocks' lists (urows,
// with per-entry membership bits ubits: bit 0 the even block's list, bit 1
// the odd one's; ucnt entries), built once per layout on the host beside
// the lists (ops/cuda/block_sparse_attention.py union_lists). Warp 0 of the
// producer warpgroup holds 32 union entries at a time in its lanes'
// registers (a window paged along the walk) and lane 0 TMA-loads each
// entry's 64-key block of K and V into one half of a 128-key stage (4
// stages at D = 64, 3 at D = 128; an odd walk's last half repeats its last
// entry, masked). Two consumer warpgroups own one query block each: S = Q
// K^T by wgmma m64n128k16 (both K-major) while the previous stage's O += P
// V (P in registers, V MN-major) runs, then the online softmax on the fp32
// fragments. A half absent from the consumer's own list takes p = 0 (its
// scores masked to NEG_INF); only the causal diagonal block builds the
// per-element mask; a row with nothing live so far takes p = 0. The items
// run persistently from a counter in device memory, longest union first
// (uorder, computed with the lists), so the heaviest walks of every
// instance start first and the short ones fill the tail. Output: o / l
// rounded once, stored from
// the fragments (bf16 pairs), lse = m + log l; a row with no live key (l =
// 0: its list is empty) writes o = 0 and lse = NEG_INF, as bsa_fwd_kernel.
// Every output element has one writer: calls repeat bitwise.
// Bound: operations, 4 * 64 * 64 * d flops a present block pair; the union
// walk adds the blocks one block's list lacks (counted on the host:
// chip_smoke.py phase 22 logs the share).

constexpr int B90_TILE = 128;               // query rows an item, keys a stage
constexpr int B90_HALF = B90_TILE * 128;    // one 64-d half of a 128-row tile: 16 KB
constexpr float B90_LOG2E = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int b90_stages() {
  return D == 64 ? 4 : 3;
}

template <int D>
constexpr int b90_smem() {
  // q, the K/V ring, barriers, the item slot
  return 1024 + (D / 64) * B90_HALF * (1 + 2 * b90_stages<D>()) + (2 * b90_stages<D>() + 2) * 8 +
         16;
}

// Item w of BH x n2: its union entry (head h, pair p) from the order, its
// instance bh of that head, the union's count and its lists.
struct B90Item {
  int bh, h, p, cnt;
  const int* ids;
  const int* bits;
};

__device__ __forceinline__ B90Item b90_item(const BsaArgs& a, int w, int n2) {
  const int reps = a.BH / a.H;  // instances of each head
  const int hp = a.uorder[w / reps];
  B90Item it;
  it.h = hp / n2;
  it.p = hp - it.h * n2;
  it.bh = (w - (w / reps) * reps) * a.H + it.h;
  it.cnt = a.ucnt[hp];
  it.ids = a.urows + (long long)hp * a.max_u;
  it.bits = a.ubits + (long long)hp * a.max_u;
  return it;
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    bsa_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv, BsaArgs a) {
  constexpr int HALVES = D / 64;
  constexpr int STAGES = b90_stages<D>();
  constexpr bool PINGPONG = D == 64;
  constexpr int TILE_BYTES = HALVES * B90_HALF;  // a 128-row q, k or v tile
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* ks = qs + TILE_BYTES;           // [STAGES][TILE_BYTES]
  unsigned char* vs = ks + STAGES * TILE_BYTES;  // [STAGES][TILE_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;
  volatile int* item_slot = reinterpret_cast<volatile int*>(qempty + 1);

  const int n2 = (a.T / 64 + 1) / 2;
  const int items = a.BH * n2;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_init(qempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < 32) {
      // warp 0: its lanes hold 32 union entries at a time; lane 0 takes the
      // items from the counter and issues the TMA loads
      const int lane = tid;
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (;;) {
        int w = 0;
        if (lane == 0) {
          w = atomicAdd(a.next_item, 1);
          sm90::mbar_wait(qempty, qphase ^ 1);  // the last item's S products are done
          *item_slot = w;
        }
        w = __shfl_sync(0xffffffffu, w, 0);
        if (w >= items) {
          if (lane == 0) sm90::mbar_arrive(qfull);
          break;
        }
        const B90Item it = b90_item(a, w, n2);
        if (lane == 0) {
          if (it.cnt > 0) {
            sm90::mbar_expect_tx(qfull, TILE_BYTES);
#pragma unroll
            for (int hh = 0; hh < HALVES; ++hh)
              sm90::tma_load(qs + hh * B90_HALF, &mq, qfull, 4, 64 * hh, it.p * B90_TILE, 0,
                             it.bh);
          } else {
            sm90::mbar_arrive(qfull);  // nothing to load: the rows are written as zeros
          }
        }
        qphase ^= 1;
        int win = -1 << 30, ent = 0;
        for (int t = 0; t < (it.cnt + 1) / 2; ++t) {
          int blk[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int j = min(2 * t + b, it.cnt - 1);  // an odd walk repeats its last entry
            if (j - win >= 32 || j < win) {            // warp-uniform: move the window
              win = j;
              ent = it.ids[min(win + lane, a.max_u - 1)];
            }
            blk[b] = __shfl_sync(0xffffffffu, ent, j - win);
          }
          if (lane == 0) {
            sm90::mbar_wait(&empty[stage], phase ^ 1);
            sm90::mbar_expect_tx(&full[stage], 2 * TILE_BYTES);
#pragma unroll
            for (int b = 0; b < 2; ++b)
#pragma unroll
              for (int hh = 0; hh < HALVES; ++hh) {
                const int off = stage * TILE_BYTES + hh * B90_HALF + b * 64 * 128;
                sm90::tma_load(ks + off, &mk, &full[stage], 4, 64 * hh, blk[b] * 64, 0, it.bh);
                sm90::tma_load(vs + off, &mv, &full[stage], 4, 64 * hh, blk[b] * 64, 0, it.bh);
              }
          }
          __syncwarp();
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1, lane = tid & 31;
    const unsigned char* qa = qs + cw * (B90_HALF / 2);  // this consumer's 64 rows of each half
    float o[D / 2];
    float s[64];      // S of the tile in hand
    uint32_t pa[32];  // p in bf16 pairs: PV's A fragments, 16-key slice kk in pa[4 kk .. 4 kk + 3]
    float m0, m1, l0, l1;  // l: this thread's partial sums
    int qb, r0, r1;

    auto issue_s = [&](int stg) {
      const unsigned char* kt = ks + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * B90_HALF + (kk & 3) * 32;
        sm90::wgmma_m64n128k16_ss(s, sm90::smem_desc(qa + off, 16, 1024),
                                  sm90::smem_desc(kt + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
    };
    auto issue_pv = [&](int stg, const uint32_t (&p)[32]) {
      const unsigned char* vt = vs + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < B90_TILE / 16; ++kk) {
        const uint32_t f[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        sm90::wgmma_pv<D>(o, f, sm90::smem_desc(vt + kk * 2048, B90_HALF, 1024));
      }
      sm90::wgmma_commit();
    };
    // the online softmax of stage tile t (union entries 2t, 2t + 1 of
    // ``it``): a half that is not in this consumer's list is masked whole,
    // the causal diagonal block element by element; new running maxima; p
    // into ``p`` (bf16 pairs, p.astype(v.dtype)); the old state's rescale
    // factors and p's row sums out
    auto softmax = [&](const B90Item& it, int t, uint32_t (&p)[32], float& alpha0,
                       float& alpha1, float& sum0, float& sum1) {
      int kb[2];
      bool cut[2], mem[2];
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int j = 2 * t + b;
        mem[b] = j < it.cnt && ((__ldg(it.bits + j) >> cw) & 1);
        kb[b] = j < it.cnt ? __ldg(it.ids + j) : -1;
        cut[b] = !mem[b] || (a.causal && kb[b] == qb);
      }
      if (cut[0] || cut[1]) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          const int b = n >> 3;
          if (!cut[b]) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb[b] * 64 + sm90::frag_col(tid, n & 7, e);
            if (!mem[b] || key > (e < 2 ? r0 : r1)) s[4 * n + e] = NEG_INF;
          }
        }
      }
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      alpha0 = sm90::ex2((m0 - n0) * B90_LOG2E);
      alpha1 = sm90::ex2((m1 - n1) * B90_LOG2E);
      m0 = n0;
      m1 = n1;
      const float ms0 = m0 == NEG_INF ? 0.f : m0 * B90_LOG2E;
      const float ms1 = m1 == NEG_INF ? 0.f : m1 * B90_LOG2E;
      sum0 = sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float p0 = sm90::ex2(fmaf(s[4 * n], B90_LOG2E, -ms0));
        const float p1 = sm90::ex2(fmaf(s[4 * n + 1], B90_LOG2E, -ms0));
        const float p2 = sm90::ex2(fmaf(s[4 * n + 2], B90_LOG2E, -ms1));
        const float p3 = sm90::ex2(fmaf(s[4 * n + 3], B90_LOG2E, -ms1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[2 * n] = sm90::pack_bf16(p0, p1);
        p[2 * n + 1] = sm90::pack_bf16(p2, p3);
      }
    };

    // at d = 64 the two consumers issue their wgmma in turns (K1's ping-pong)
    auto my_turn = [&]() {
      if constexpr (PINGPONG) asm volatile("bar.sync %0, 256;\n" ::"r"(3 + cw) : "memory");
    };
    auto your_turn = [&]() {
      if constexpr (PINGPONG) asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - cw) : "memory");
    };
    if (cw == 1) your_turn();  // consumer 0 goes first
    int stage = 0;
    uint32_t phase = 0, qphase = 0;
    for (;;) {
      sm90::mbar_wait(qfull, qphase);
      qphase ^= 1;
      const int w = *item_slot;
      if (w >= items) break;
      const B90Item it = b90_item(a, w, n2);
      qb = 2 * it.p + cw;
      r0 = qb * 64 + sm90::frag_row(tid, 0);
      r1 = r0 + 8;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      const int nt = (it.cnt + 1) / 2;
      if (nt == 0) {
        if (lane == 0) sm90::mbar_arrive(qempty);  // no q was loaded
      } else {
        float alpha0, alpha1, sum0, sum1;
        sm90::mbar_wait(&full[stage], phase);
        my_turn();
        sm90::wgmma_fence();
        issue_s(stage);
        your_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        if (nt == 1 && lane == 0) sm90::mbar_arrive(qempty);  // q read for the last time
        softmax(it, 0, pa, alpha0, alpha1, sum0, sum1);
        l0 = sum0;
        l1 = sum1;
        for (int t = 1; t < nt; ++t) {
          int next = stage + 1;
          uint32_t next_phase = phase;
          if (next == STAGES) {
            next = 0;
            next_phase ^= 1;
          }
          sm90::mbar_wait(&full[next], next_phase);
          my_turn();
          sm90::wgmma_fence();
          issue_s(next);
          issue_pv(stage, pa);
          your_turn();
          sm90::wgmma_wait<1>();  // S (committed first) has landed
          sm90::fence_regs(s);
          if (t + 1 == nt && lane == 0) sm90::mbar_arrive(qempty);
          uint32_t pn[32];
          softmax(it, t, pn, alpha0, alpha1, sum0, sum1);
          sm90::wgmma_wait<0>();  // PV has read pa and written o
          sm90::fence_regs(o);
          sm90::keep_regs(pa);
          if (lane == 0) sm90::mbar_arrive(&empty[stage]);
          l0 = l0 * alpha0 + sum0;
          l1 = l1 * alpha1 + sum1;
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            o[4 * n] *= alpha0;
            o[4 * n + 1] *= alpha0;
            o[4 * n + 2] *= alpha1;
            o[4 * n + 3] *= alpha1;
          }
#pragma unroll
          for (int i = 0; i < 32; ++i) pa[i] = pn[i];
          stage = next;
          phase = next_phase;
        }
        my_turn();
        sm90::wgmma_fence();
        issue_pv(stage, pa);
        your_turn();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(o);
        sm90::keep_regs(pa);
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }

      // the row sums over the four threads of each row, then o / l rounded
      // once and stored from the fragments (bf16 pairs); a row with no live
      // key (l = 0) writes o = 0 and lse = NEG_INF
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      bf16* og = reinterpret_cast<bf16*>(a.o) + (long long)it.bh * a.T * D;
      float* lg = a.lse + (long long)it.bh * a.T;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = i ? r1 : r0;
        if (row >= a.T) continue;
        const float l = i ? l1 : l0;
        const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(og + (long long)row * D + sm90::frag_col(tid, n, 0)) =
              sm90::pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
        if ((tid & 3) == 0) lg[row] = l > 0.f ? (i ? m1 : m0) + logf(l) : NEG_INF;
      }
    }
    if (cw == 0) my_turn();  // consumer 1's last turn handed back
  }
}

// The Hopper forward: maps over the folded (BH, T, D) operands as (D, T, 1,
// BH) (sm90_attention.cuh make_bhtd_map), q with 128-row boxes, K and V
// with one block's 64; a persistent grid of at most one CTA an SM over the
// BH * ceil(n / 2) items, its work counter a.next_item (zero at the launch).
template <int D>
cudaError_t launch_fwd_sm90(const BsaArgs& a, cudaStream_t s) {
  CUtensorMap mq, mk, mv;
  const long long st = (long long)a.T * D;
  cudaError_t err = sm90::make_bhtd_map(&mq, a.q, a.BH, 1, a.T, D, st, st, D, B90_TILE);
  if (err == cudaSuccess) err = sm90::make_bhtd_map(&mk, a.k, a.BH, 1, a.T, D, st, st, D, 64);
  if (err == cudaSuccess) err = sm90::make_bhtd_map(&mv, a.v, a.BH, 1, a.T, D, st, st, D, 64);
  if (err != cudaSuccess) return err;
  auto kernel = bsa_fwd_sm90_kernel<D>;
  constexpr int smem = b90_smem<D>();
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long items = (long long)a.BH * ((a.T / 64 + 1) / 2);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<sm90::persistent_grid((int)items), 384, smem, s>>>(mq, mk, mv, a);
  return cudaGetLastError();
}

// bf16 q, k, v (BH, T, D) contiguous with 16-byte aligned bases, D = 64 or
// 128, block 64, BH a multiple of H, the union lists and the work counter
// set.
cudaError_t fwd_sm90(const BsaArgs& a, cudaStream_t s) {
  if (a.block != 64 || a.BH % a.H != 0 || a.urows == nullptr || a.ubits == nullptr ||
      a.ucnt == nullptr || a.uorder == nullptr || a.next_item == nullptr || a.max_u <= 0 ||
      (uintptr_t)a.q % 16 || (uintptr_t)a.k % 16 || (uintptr_t)a.v % 16 || (uintptr_t)a.o % 4)
    return cudaErrorInvalidValue;
  if (a.D == 64) return launch_fwd_sm90<64>(a, s);
  if (a.D == 128) return launch_fwd_sm90<128>(a, s);
  return cudaErrorInvalidValue;
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

// design: 0 = fp32 (the float instances), 1 = mma_sync (the bf16
// instances), 2 = sm90 (the forward only: bsa_fwd_sm90_kernel, see
// fwd_sm90); any other code, or 2 with a backward pass, is refused. which: 0
// = forward, 1 = dq (writes delta), 2 = dk/dv (reads it). Returns a
// cudaError_t (0 = launched).
extern "C" int bsa_launch(const BsaArgs* a, int design, int which, void* stream) {
  if (a == nullptr || a->BH <= 0 || a->H <= 0 || a->T <= 0 || a->block <= 0 ||
      a->T % a->block != 0 || a->BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 2) return which == 0 ? fwd_sm90(*a, s) : cudaErrorInvalidValue;
  if (design == 1) return run_by_d<bf16>(*a, which, s);
  if (design == 0) return run_by_d<float>(*a, which, s);
  return cudaErrorInvalidValue;
}
