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
// b*h) for the forward and dq, and per (k-block, b*h) for dk/dv (the
// mma_sync and fp32 designs):
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
// pair 4*BLK^2*d flops forward, 6 dq and 8 dk/dv) at BLK = 64; these
// designs keep scores on chip and feed mma.sync from shared tiles loaded
// synchronously.
//
// Each pass has three designs (the wrapper's _bsa_fwd_design /
// _bsa_bwd_design picks one per call, bsa_launch's design code): sm90
// (bf16 at D = 64 or 128, block 64, on TMA + wgmma, below:
// bsa_fwd_sm90_kernel walks the union of two query blocks' lists;
// bsa_dq_sm90_kernel and bsa_dkv_sm90_kernel walk one block's list split
// between two consumer warpgroups, entry by entry, and merge their fp32
// partials in fixed order), mma_sync (other bf16: the kernels above in
// bf16) and fp32 (their float instances). The split walk forms no block
// pair twice: its only idle work is the missing half of an odd list's last
// stage (its idle half-steps: (a) 2.7 % of the dq and of the dk/dv
// half-steps, (b) 13.4 % / 7.3 %), where the union walk of adjacent
// blocks would form 88.9 % extra column pairs at (a) (a global column of
// up to 125 entries beside neighbours of 2-4).

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
  // the Hopper backward's item orders: the (h, block) entries h * n + i,
  // row lists (dq) / column lists (dk/dv) longest first
  const int* rorder;   // (H * n,)
  const int* corder;   // (H * n,)
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

// ------------------------------------------------------ backward (Hopper)
//
// bsa_dkv_sm90_kernel<D> and bsa_dq_sm90_kernel<D> (bf16, D = 64 or 128,
// block 64): one skeleton, bsa_bwd_sm90<D, DQ>, on K2's Hopper backward
// (flash_attention.cu flash_dkdv_sm90_kernel / flash_dq_sm90_kernel) with
// a list-driven producer. An item is (b*h, one 64-row block: a key block
// for dk/dv, a query block for dq) and its list (cols[h, j] / rows[h, i]);
// items run persistently from a counter in device memory in the order
// corder / rorder (the lists longest first, each head's BH / H instances
// side by side; lists_on builds them with the lists), so the long global
// columns of a Fixed layout start first. Warp 0 of the producer warpgroup
// TMA-loads the item's resident pair once (dk/dv: K and V; dq: q and do),
// pages the list through its lanes' registers 32 entries at a time and
// streams two entries a stage through an mbarrier ring (dk/dv: each
// entry's q and do boxes plus its 64 rows of lse and delta by two 256-byte
// bulk copies, so the producer never waits on a load; dq: each entry's K
// and V).
// The split walk: consumer warpgroup c takes entry c of every stage (list
// entries c, c + 2, ...), so no block pair is formed twice and the only
// idle work is the missing half of an odd list's last stage (skipped: the
// consumer waits for the stage and releases it). Per entry a consumer
// forms S^T = K Q^T, dP^T = V dO^T (dk/dv) or S = Q K^T, dP = dO V^T (dq)
// by SS wgmma m64n64k16 (both K-major), p and ds by sm90::bwd_p_ds (only
// the causal diagonal entry builds the element mask), rounds them to bf16
// in pairs straight into the A fragments of dV += P^T dO, dK += dS^T Q
// (dk/dv) or dQ += dS K (dq) by RS wgmma with B MN-major. Each consumer
// keeps a 64 x D fp32 partial of each output; at the item's end consumer 1
// hands its partials through one fp32 buffer in shared memory (dK, then
// dV), consumer 0 adds them to its own in that fixed order, rounds once
// and TMA-stores the block from the same buffer as the bf16 staging. No
// atomics: a run repeats bitwise. An empty list writes zeros. dq's
// prologue also forms delta = rowsum(do * o) in fp32 for its 64 rows (do
// from the resident tile, o by 16-byte loads; four threads a row) and
// writes it to a.delta for the dk/dv launch that follows on the stream.
// Shared memory: the resident pair, the ring (4 stages at D = 64, 2 at D =
// 128: 64 KB a stage there), the 64 x D fp32 merge buffer, the stats:
// 193 KB at D = 128, 165 KB at D = 64.
// Bound: operations, 6 (dq: S, dP, dQ) and 8 (dk/dv: S, dP, dV, dK)
// 64 * 64 * d flops a present block pair (chip_smoke.py bsa_bounds).

template <int D>
struct B90Bwd {
  static constexpr int HALVES = D / 64;
  static constexpr int TILE = HALVES * sm90::BOX_BYTES;  // one operand's 64-row block
  static constexpr int ENTRY = 2 * TILE;                 // a list entry's two blocks
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int STAGE = 2 * ENTRY;                // two entries a stage
  static constexpr int ACC = D / 2;                      // a consumer's partial, per thread
  // per stage and entry: lse and delta of its 64 queries (dk/dv);
  // dq uses the first 128 floats for its delta, by item parity
  static constexpr int STATS = STAGES * 2 * 128;
  // the resident pair, the ring, the merge buffer (64 x D fp32 = the bf16
  // staging of two 64 x D blocks), the stats, barriers, the item slot
  static constexpr int SMEM =
      1024 + 2 * TILE + STAGES * STAGE + 64 * D * 4 + STATS * 4 + (2 * STAGES + 2) * 8 + 16;
};
static_assert(B90Bwd<64>::SMEM <= 232448 && B90Bwd<128>::SMEM <= 232448, "bsa backward smem");

// Item w of BH x n: its (head, block) entry from the order, its instance bh
// of that head, and the block's list.
struct B90Walk {
  int bh, h, blk, cnt;
  const int* ids;
};

__device__ __forceinline__ B90Walk b90_walk(const BsaArgs& a, int w, int n, const int* order,
                                            const int* counts, const int* lists, int max_len) {
  const int reps = a.BH / a.H;
  const int hb = order[w / reps];
  B90Walk it;
  it.h = hb / n;
  it.blk = hb - it.h * n;
  it.bh = (w - (w / reps) * reps) * a.H + it.h;
  it.cnt = counts[hb];
  it.ids = lists + (long long)hb * max_len;
  return it;
}

// Named barriers of the consumers: A (consumer 0 -> 1: the merge buffer
// may be written), B (consumer 1 -> 0: a partial is in it), consumer 0's
// own, and dq's delta (both consumers).
constexpr int B90_BAR_A = 1, B90_BAR_B = 2, B90_BAR_C0 = 3, B90_BAR_DELTA = 4;

__device__ __forceinline__ void bar_sync256(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive256(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// One bulk copy of ``bytes`` (a multiple of 16, both addresses 16-byte
// aligned) from global to shared memory, completing on ``bar``.
__device__ __forceinline__ void b90_bulk_load(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          sm90::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(sm90::smem_u32(bar))
      : "memory");
}

template <int D, bool DQ>
__device__ __forceinline__ void bsa_bwd_sm90(const CUtensorMap& mq, const CUtensorMap& mk,
                                             const CUtensorMap& mv, const CUtensorMap& mdo,
                                             const CUtensorMap& mo0, const CUtensorMap& mo1,
                                             const BsaArgs& a) {
  using L = B90Bwd<D>;
  constexpr int HALVES = L::HALVES, TILE = L::TILE, ENTRY = L::ENTRY, STAGES = L::STAGES;
  constexpr int ACC = L::ACC, BOX = sm90::BOX_BYTES;
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* res = base;                  // [2][TILE]: K, V (dk/dv); q, do (dq)
  unsigned char* ring = res + 2 * TILE;       // [STAGES][2 entries][2][TILE]: q, do / K, V
  unsigned char* mbuf = ring + STAGES * L::STAGE;  // 64 x D fp32; then the bf16 staging
  float* merge = reinterpret_cast<float*>(mbuf);
  float* stats = merge + 64 * D;              // [STAGES][2 entries][lse 64 | delta 64]
  uint64_t* full = reinterpret_cast<uint64_t*>(stats + L::STATS);
  uint64_t* empty = full + STAGES;
  uint64_t* rfull = empty + STAGES;
  uint64_t* rempty = rfull + 1;
  volatile int* item_slot = reinterpret_cast<volatile int*>(rempty + 1);

  const int n = a.T / 64;
  const int items = a.BH * n;
  const int* order = DQ ? a.rorder : a.corder;
  const int* counts = DQ ? a.row_cnt : a.col_cnt;
  const int* lists = DQ ? a.rows : a.cols;
  const int max_len = DQ ? a.max_row : a.max_col;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);          // one arrive per consumer warp
    }
    sm90::mbar_init(rfull, 1);
    sm90::mbar_init(rempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < 32) {
      const int lane = tid;
      const CUtensorMap* r0 = DQ ? &mq : &mk;  // the resident pair
      const CUtensorMap* r1 = DQ ? &mdo : &mv;
      const CUtensorMap* e0 = DQ ? &mk : &mq;  // each entry's pair
      const CUtensorMap* e1 = DQ ? &mv : &mdo;
      int stage = 0;
      uint32_t phase = 0, rphase = 0;
      for (;;) {
        int w = 0;
        if (lane == 0) w = atomicAdd(a.next_item, 1);
        w = __shfl_sync(0xffffffffu, w, 0);
        sm90::mbar_wait(rempty, rphase ^ 1);  // the last item's resident pair is read
        if (lane == 0) *item_slot = w;
        if (w >= items) {
          if (lane == 0) sm90::mbar_arrive(rfull);
          break;
        }
        const B90Walk it = b90_walk(a, w, n, order, counts, lists, max_len);
        if (lane == 0) {
          if (DQ || it.cnt > 0) {  // dq's prologue reads do even for an empty list
            sm90::mbar_expect_tx(rfull, 2 * TILE);
#pragma unroll
            for (int hh = 0; hh < HALVES; ++hh) {
              sm90::tma_load(res + hh * BOX, r0, rfull, 4, 64 * hh, it.blk * 64, 0, it.bh);
              sm90::tma_load(res + TILE + hh * BOX, r1, rfull, 4, 64 * hh, it.blk * 64, 0, it.bh);
            }
          } else {
            sm90::mbar_arrive(rfull);  // nothing to load: the block is written as zeros
          }
        }
        rphase ^= 1;
        int win = -1 << 30, ent = 0;
        for (int t = 0; t < (it.cnt + 1) / 2; ++t) {
          const int nb = min(2, it.cnt - 2 * t);  // an odd list's last stage holds one entry
          int blk[2];
#pragma unroll
          for (int b = 0; b < 2; ++b) {
            const int j = min(2 * t + b, it.cnt - 1);
            if (j - win >= 32 || j < win) {  // warp-uniform: move the window
              win = j;
              ent = it.ids[min(win + lane, max_len - 1)];
            }
            blk[b] = __shfl_sync(0xffffffffu, ent, j - win);
          }
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * L::STAGE;
          if (lane == 0) {
            // dk/dv: each entry's lse and delta rows ride in the stage too
            sm90::mbar_expect_tx(&full[stage], nb * (DQ ? ENTRY : ENTRY + 512));
#pragma unroll
            for (int b = 0; b < 2; ++b) {
              if (b >= nb) break;
#pragma unroll
              for (int hh = 0; hh < HALVES; ++hh) {
                sm90::tma_load(st + b * ENTRY + hh * BOX, e0, &full[stage], 4, 64 * hh, blk[b] * 64,
                               0, it.bh);
                sm90::tma_load(st + b * ENTRY + TILE + hh * BOX, e1, &full[stage], 4, 64 * hh,
                               blk[b] * 64, 0, it.bh);
              }
              if constexpr (!DQ) {
                const long long row = (long long)it.bh * a.T + blk[b] * 64;
                float* ss = stats + stage * 256 + b * 128;
                b90_bulk_load(ss, a.lse + row, 256, &full[stage]);
                b90_bulk_load(ss + 64, a.delta + row, 256, &full[stage]);
              }
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
    float acc0[ACC];              // dQ (dq) / dK (dk/dv)
    float acc1[DQ ? 1 : ACC];     // dV (dk/dv)
    float lse2[2], dl[2];         // dq: its two rows' lse log2(e) and delta
    int stage = 0;
    uint32_t phase = 0, rphase = 0, parity = 0;
    for (;;) {
      sm90::mbar_wait(rfull, rphase);
      rphase ^= 1;
      const int w = *item_slot;
      if (w >= items) break;
      const B90Walk it = b90_walk(a, w, n, order, counts, lists, max_len);
      const int row0 = it.blk * 64;  // the item's first query (dq) / key (dk/dv)
#pragma unroll
      for (int x = 0; x < ACC; ++x) acc0[x] = 0.f;
      if constexpr (!DQ) {
#pragma unroll
        for (int x = 0; x < ACC; ++x) acc1[x] = 0.f;
      } else {
        // delta = rowsum(do * o) in fp32: four threads a row, each D / 4
        // columns (do from the resident tile's swizzled boxes, o by 16-byte
        // loads), summed over the four lanes; written for the dk/dv pass
        float* dls = stats + parity * 64;
        parity ^= 1;
        const int t = threadIdx.x - 128, row = t >> 2, part = t & 3;
        const long long grow = (long long)it.bh * a.T + row0 + row;
        const bf16* og = reinterpret_cast<const bf16*>(a.o) + grow * D;
        const unsigned char* dos = res + TILE;
        float sum = 0.f;
#pragma unroll
        for (int x = 0; x < D / 32; ++x) {
          const int c = part * (D / 32) + x;  // the row's 16-byte chunk
          const uint4 ov = *reinterpret_cast<const uint4*>(og + c * 8);
          const uint4 dv =
              *reinterpret_cast<const uint4*>(dos + (c >> 3) * BOX + row * 128 + (((c & 7) ^ (row & 7)) << 4));
          const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
            sum = fmaf(df.x, of.x, sum);
            sum = fmaf(df.y, of.y, sum);
          }
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (part == 0) {
          dls[row] = sum;
          a.delta[grow] = sum;
        }
        bar_sync256(B90_BAR_DELTA);
        const int r = sm90::frag_row(tid, 0);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          lse2[i] = a.lse[(long long)it.bh * a.T + row0 + r + 8 * i] * B90_LOG2E;
          dl[i] = dls[r + 8 * i];
        }
      }
      const unsigned char* ra = res;         // K (dk/dv) / q (dq)
      const unsigned char* rb = res + TILE;  // V / do
      for (int t = 0; t < (it.cnt + 1) / 2; ++t) {
        const int e = 2 * t + cw;
        sm90::mbar_wait(&full[stage], phase);
        if (e < it.cnt) {
          const int other = __ldg(it.ids + e);  // the entry's block
          const unsigned char* ea = ring + stage * L::STAGE + cw * ENTRY;  // q / K
          const unsigned char* eb = ea + TILE;                              // do / V
          float s[32], dp[32];
          sm90::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K Q^T / S = Q K^T
            const int off = (kk >> 2) * BOX + (kk & 3) * 32;
            sm90::wgmma_nt<64>(s, sm90::smem_desc(ra + off, 16, 1024),
                               sm90::smem_desc(ea + off, 16, 1024), kk > 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V dO^T / dP = dO V^T
            const int off = (kk >> 2) * BOX + (kk & 3) * 32;
            sm90::wgmma_nt<64>(dp, sm90::smem_desc(rb + off, 16, 1024),
                               sm90::smem_desc(eb + off, 16, 1024), kk > 0);
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          if (e + 2 >= it.cnt && lane == 0) sm90::mbar_arrive(rempty);  // resident pair read
          // only the causal diagonal entry masks: key > query there
          const bool diag = a.causal && other == it.blk;
          uint32_t pa[DQ ? 1 : 16], da[16];  // round(p) (dk/dv), round(ds): RS A fragments
          if constexpr (DQ) {
            // rows: queries; columns: keys
#pragma unroll
            for (int nn = 0; nn < 8; ++nn)
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const bool ok = !diag || sm90::frag_col(tid, nn, x) <= sm90::frag_row(tid, x);
                sm90::bwd_p_ds(s[4 * nn + x], dp[4 * nn + x], lse2[x >> 1], dl[x >> 1], ok);
              }
          } else {
            // rows: keys; columns: queries, whose lse and delta rows came
            // with the stage
            const float* ls = stats + stage * 256 + cw * 128;
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
              const int c = sm90::frag_col(tid, nn, 0);
              const float2 l2 = make_float2(ls[c] * B90_LOG2E, ls[c + 1] * B90_LOG2E);
              const float2 d2 = make_float2(ls[64 + c], ls[65 + c]);
#pragma unroll
              for (int x = 0; x < 4; ++x) {
                const bool ok = !diag || sm90::frag_row(tid, x) <= c + (x & 1);
                sm90::bwd_p_ds(s[4 * nn + x], dp[4 * nn + x], x & 1 ? l2.y : l2.x,
                               x & 1 ? d2.y : d2.x, ok);
              }
            }
            sm90::pack_frag<64>(s, pa);
          }
          sm90::pack_frag<64>(dp, da);
          sm90::fence_regs(acc0);
          if constexpr (!DQ) sm90::fence_regs(acc1);
          sm90::wgmma_fence();
          if constexpr (!DQ) {
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {  // dV += P^T dO
              const uint32_t f[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
              sm90::wgmma_pv<D>(acc1, f, sm90::smem_desc(eb + kk * 2048, BOX, 1024));
            }
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // dK += dS^T Q / dQ += dS K
            const uint32_t f[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
            sm90::wgmma_pv<D>(acc0, f, sm90::smem_desc(ea + kk * 2048, BOX, 1024));
          }
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(acc0);
          if constexpr (!DQ) {
            sm90::fence_regs(acc1);
            sm90::keep_regs(pa);
          }
          sm90::keep_regs(da);
        }
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (cw >= it.cnt && lane == 0) sm90::mbar_arrive(rempty);  // no entry of its own

      // consumer 1's partials into consumer 0's (own + consumer 1's, dK then
      // dV), one rounding, one TMA store of the block from the staging
      const bool two = it.cnt >= 2;
      if (cw == 1) {
        if (two) {
          bar_sync256(B90_BAR_A);
#pragma unroll
          for (int x = 0; x < ACC; ++x) merge[x * 128 + tid] = acc0[x];
          bar_arrive256(B90_BAR_B);
          if constexpr (!DQ) {
            bar_sync256(B90_BAR_A);
#pragma unroll
            for (int x = 0; x < ACC; ++x) merge[x * 128 + tid] = acc1[x];
            bar_arrive256(B90_BAR_B);
          }
        }
      } else {
        if (tid == 0) sm90::tma_store_wait_read();  // the last item's store has read the staging
        if (two) {
          bar_arrive256(B90_BAR_A);
          bar_sync256(B90_BAR_B);
#pragma unroll
          for (int x = 0; x < ACC; ++x) acc0[x] += merge[x * 128 + tid];
          if constexpr (!DQ) {
            bar_arrive256(B90_BAR_A);
            bar_sync256(B90_BAR_B);
#pragma unroll
            for (int x = 0; x < ACC; ++x) acc1[x] += merge[x * 128 + tid];
          }
        }
        sm90::named_sync(B90_BAR_C0);  // the buffer is read (and the last store done with it)
        sm90::stage_bf16<D>(acc0, mbuf, tid);
        if constexpr (!DQ) sm90::stage_bf16<D>(acc1, mbuf + TILE, tid);
        sm90::fence_proxy_async();
        sm90::named_sync(B90_BAR_C0);
        if (tid == 0) {
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh) {
            sm90::tma_store_4d(&mo0, mbuf + hh * BOX, 64 * hh, row0, 0, it.bh);
            if constexpr (!DQ) sm90::tma_store_4d(&mo1, mbuf + TILE + hh * BOX, 64 * hh, row0, 0, it.bh);
          }
          sm90::tma_store_commit();
        }
      }
    }
    if (cw == 0 && tid == 0) sm90::tma_store_wait_all();
  }
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    bsa_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo,
                       const __grid_constant__ CUtensorMap mdq,
                       const __grid_constant__ CUtensorMap unused, BsaArgs a) {
  bsa_bwd_sm90<D, true>(mq, mk, mv, mdo, mdq, unused, a);
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    bsa_dkv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo,
                        const __grid_constant__ CUtensorMap mdk,
                        const __grid_constant__ CUtensorMap mdv, BsaArgs a) {
  bsa_bwd_sm90<D, false>(mq, mk, mv, mdo, mdk, mdv, a);
}

// The Hopper backward pass ``which`` (1 = dq, 2 = dk/dv): maps over the
// folded (BH, T, D) operands as (D, T, 1, BH) with one block's 64-row
// boxes; a persistent grid of at most one CTA an SM over the BH * n items,
// its work counter a.next_item (zero at the launch).
template <int D, bool DQ>
cudaError_t launch_bwd_sm90(const BsaArgs& a, cudaStream_t s) {
  const long long st = (long long)a.T * D;
  auto map = [&](CUtensorMap* m, const void* p) {
    return sm90::make_bhtd_map(m, p, a.BH, 1, a.T, D, st, st, D, 64);
  };
  CUtensorMap mq, mk, mv, mdo, mo0, mo1;
  cudaError_t err = map(&mq, a.q);
  if (err == cudaSuccess) err = map(&mk, a.k);
  if (err == cudaSuccess) err = map(&mv, a.v);
  if (err == cudaSuccess) err = map(&mdo, a.dout);
  if (err == cudaSuccess) err = map(&mo0, DQ ? a.dq : a.dk);
  if (err == cudaSuccess) err = map(&mo1, DQ ? a.dq : a.dv);
  if (err != cudaSuccess) return err;
  auto kernel = DQ ? bsa_dq_sm90_kernel<D> : bsa_dkv_sm90_kernel<D>;
  constexpr int smem = B90Bwd<D>::SMEM;
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const long long items = (long long)a.BH * (a.T / 64);
  if (items > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<sm90::persistent_grid((int)items), 384, smem, s>>>(mq, mk, mv, mdo, mo0, mo1, a);
  return cudaGetLastError();
}

// bf16 q, k, v, do and the pass's outputs (BH, T, D) contiguous with
// 16-byte aligned bases (dq also o: its 16-byte loads; dk/dv also lse and
// delta: their bulk copies), D = 64 or 128, block 64, BH a multiple of H,
// the pass's order and the work counter set.
cudaError_t bwd_sm90(const BsaArgs& a, int which, cudaStream_t s) {
  const bool dq = which == 1;
  const void* out0 = dq ? a.dq : a.dk;
  const void* out1 = dq ? a.o : a.dv;
  if (which < 1 || which > 2 || a.block != 64 || a.BH % a.H != 0 ||
      (dq ? a.rorder : a.corder) == nullptr || a.next_item == nullptr || a.lse == nullptr ||
      a.delta == nullptr || out0 == nullptr || out1 == nullptr || (uintptr_t)a.lse % 16 ||
      (uintptr_t)a.delta % 16 || (uintptr_t)a.q % 16 ||
      (uintptr_t)a.k % 16 || (uintptr_t)a.v % 16 || (uintptr_t)a.dout % 16 ||
      (uintptr_t)out0 % 16 || (uintptr_t)out1 % 16)
    return cudaErrorInvalidValue;
  if (a.D == 64) return dq ? launch_bwd_sm90<64, true>(a, s) : launch_bwd_sm90<64, false>(a, s);
  if (a.D == 128) return dq ? launch_bwd_sm90<128, true>(a, s) : launch_bwd_sm90<128, false>(a, s);
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
// instances), 2 = sm90 (bsa_fwd_sm90_kernel, see fwd_sm90;
// bsa_dq_sm90_kernel / bsa_dkv_sm90_kernel, see bwd_sm90); any other code
// is refused, and sm90 without its walk, order or work counter. which: 0 =
// forward, 1 = dq (writes delta), 2 = dk/dv (reads it). Returns a
// cudaError_t (0 = launched).
extern "C" int bsa_launch(const BsaArgs* a, int design, int which, void* stream) {
  if (a == nullptr || a->BH <= 0 || a->H <= 0 || a->T <= 0 || a->block <= 0 ||
      a->T % a->block != 0 || a->BH > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 2) return which == 0 ? fwd_sm90(*a, s) : bwd_sm90(*a, which, s);
  if (design == 1) return run_by_d<bf16>(*a, which, s);
  if (design == 0) return run_by_d<float>(*a, which, s);
  return cudaErrorInvalidValue;
}
