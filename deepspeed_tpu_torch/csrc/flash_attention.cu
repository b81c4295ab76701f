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
// flash_fwd_sm90_kernel / flash_fwd_kernel replace
//   deepspeed_tpu/ops/pallas/flash_attention.py _fwd_kernel_t (via _fwd_t)
//   and its twin _fwd_kernel (via _fwd): one contract, the T-minor layout is
//   not ported. bf16 with D = 64 or 128 takes the Hopper design
//   (flash_fwd_sm90_kernel, below); D = 32 and fp32 the mma.sync /
//   scalar-FMA flash_fwd_kernel (the wrapper's _fwd_design picks one per
//   call).
// flash_fwd_kernel:
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
//   m16n8k16 bf16 -> fp32) from shared-memory tiles with synchronous loads.
//
// flash_fwd_sm90_kernel (bf16, D = 64 or 128): persistent, one CTA of
//   three warpgroups per SM. The work items are the (b*h, 128-query tile)
//   pairs, heads in order and each head's last (longest causal) query
//   tiles first, so a head's K/V is read from L2 by its tiles side by side
//   and the causal imbalance leaves no tail; the producer takes the next
//   item from a counter in device memory. One producer thread issues TMA
//   loads (sm90_attention.cuh's maps over the (b, h, t) strides) of an
//   item's q tile, then of its 128-key K/V tiles into a 3-stage mbarrier
//   ring (2 at D = 128); the next item's q loads as soon as the last S
//   product has read this one's. Two consumer warpgroups own 64 query rows
//   each; at D = 64 they issue their products in turns (named barriers),
//   so one's softmax overlaps the other's wgmma. Per key tile a consumer
//   forms S = Q K^T by wgmma from shared memory (m64n128k16, both
//   K-major) while the previous tile's O += P V (m64nDk16, P in
//   registers, V MN-major by the transpose bit) runs, then
//   the online softmax on the fp32 accumulator fragments (row max and sum
//   over the four threads of a row, exp by ex2 of log2(e)-scaled scores),
//   rounding p to bf16 exactly as p.astype(vb.dtype) (:420) into the next
//   P V's register operand. Only the tiles the causal diagonal or the
//   window cuts (and the ragged last one) are masked; the loop stops at
//   the diagonal and starts at the window's first live tile, as
//   flash_fwd_kernel. The epilogue divides O by l, rounds once, stages it
//   in the TMA box layout and stores it by TMA through o's strides (rows
//   past T are not written; the store drains while the next item runs);
//   lse = m + log l in fp32. Bound: bytes at the GPT-2 350M shape (q, k,
//   v, o: 0.0606 ms) against 0.052 ms of causal tensor-core work; a
//   launch of one CTA per item spent about 3.4 us an item outside its
//   tiles (start-up, the q load, the epilogue), which the persistent walk
//   overlaps with the previous item.
//
// K10 replaces _fwd_block_kernel (via flash_block_fwd,
//   flash_attention.py:1033-1087, :1106-1161): one chunk pair of a
//   ring-attention schedule, the online-softmax state the caller's: each
//   query row's running max m, running sum l ((B*H, T) fp32) and
//   unnormalized accumulator acc ((B*H, T, D) fp32) are read at the start
//   and written back in place at the end (no o, no lse, no division by l).
//   causal = 1 is the diagonal pair (equal lengths, shared offset: only the
//   diagonal tiles mask); causal = 0 masks nothing but the keys past T. The
//   wrapper folds (B*H) into B with H = 1 and picks one of three designs
//   (_block_design), passed to flash_block_fwd_launch:
//   sm90 (bf16, D = 64 or 128, operands TMA can address):
//     flash_fwd_sm90_kernel<D, true>, the Hopper forward below with its
//     item walk, TMA ring and consumer loop unchanged; at an item's start
//     each consumer thread loads its rows' carried m (in place of NEG_INF),
//     l (into one of the row's four partial sums) and its own accumulator
//     elements in the wgmma fragment layout (in place of 0), rescales them
//     by the first tile's alpha, and at the end writes m, l and those
//     elements back. Every element is read and written by one thread, so
//     state tensors that are views of one buffer are safe. A carried m of
//     NEG_INF gives alpha = ex2(-1.4e30) = 0; both at NEG_INF give alpha =
//     1 and p = 0 (the masked-row rule of the forward), never inf or NaN.
//   mma_sync (bf16 at D = 32, or operands TMA cannot address) and fp32:
//     flash_fwd_kernel<T, D, true>, the forward's CTA shape and tile loop
//     with the state read into and written from its registers.
//   Bound: as the forward, plus 2*(4*D + 8) bytes a row of fp32 state read
//   and written; operations at the ring's (64, 2048, 64) pairs.
//
// flash_bwd (three launches, one contract) replaces _bwd_kernel_t (via
//   _bwd_t) and its twin _bwd_kernel (via _bwd). The TPU kernel walks key
//   blocks on a sequential grid and carries dq in an fp32 output across grid
//   steps (:813); GPU blocks run in parallel, so the deterministic
//   FlashAttention-2 split is used instead of atomics: dk/dv by key tiles,
//   dq by query tiles, each output summed by one CTA in a fixed order, so a
//   run repeats bitwise. The wrapper's _bwd_design picks one of three
//   designs, passed to flash_bwd_launch:
//   flash_delta_kernel   delta = rowsum(do * o) - dlse in fp32 (:781), one
//                        warp a row; every design launches it first.
//   sm90 (bf16, D = 64 or 128, q, k, v, do, dq, dk, dv TMA can address):
//     flash_dkdv_sm90_kernel<D>: persistent, one CTA of three warpgroups an
//       SM; an item is (b*h, 128-key tile), each head's first key tiles
//       (the longest causal walks) first, from a counter in device memory.
//       Warp 0 of the producer warpgroup loads the item's K and V by TMA,
//       then streams the walk's q and do tiles (128 queries at D = 64, 64
//       at D = 128) through an mbarrier ring (3 / 2 stages) with each
//       tile's lse log2(e) and delta rows. Two consumer warpgroups own 64
//       keys each: per query tile S^T = K Q^T and dP^T = V dO^T by SS wgmma
//       (both K-major), p = exp(s - lse) and ds = p (dp - delta) on the
//       accumulator fragments, rounded to bf16 in pairs straight into the A
//       fragments of dV += P^T dO and dK += dS^T Q (RS, do / q MN-major by
//       the transpose bit). The walk starts at the causal diagonal or ends
//       at the window's last live query, as flash_dkdv_kernel's; only
//       tiles the diagonal, the window or T cut are masked. dk, dv stay in
//       fp32 registers and are stored once by TMA.
//     flash_dq_sm90_kernel<D>: persistent over (b*h, 128-query tile), the
//       forward's item order; the producer loads q and do, then streams K
//       / V tiles (128 keys at D = 64, 64 at D = 128); per key tile S =
//       Q K^T and dP = dO V^T (SS), p and ds by the same instruction
//       sequence (bwd_p_ds), dQ += dS K (RS, K MN-major); dq stored once.
//     Registers (a consumer thread, setmaxnreg 232; the producer 40): at
//       D = 64 S^T and dP^T take 64 + 64 fp32 at 128 queries, dK and dV
//       32 + 32 (192); at D = 128 the 64-query tiles keep it at 32 + 32 +
//       64 + 64 (192, where 128-query tiles would need 256). dq: 64 + 64 +
//       32 at D = 64, 32 + 32 + 64 at D = 128. ptxas spills nothing
//       (chip_smoke.py phase 0b).
//     Bound: operations, 10 d flops a live (q, k) pair (S, dP, dV, dK, dQ;
//       the split forms S and dP twice, 14 d); at B=24, H=16, T=1024, d=64
//       causal 0.1304 ms against 0.1207 ms of bytes.
//   mma_sync (bf16 at D = 32, or operands TMA cannot address) and fp32:
//     flash_dkdv_kernel    one CTA per 64-key tile, a loop over query tiles
//                          from the diagonal on; recomputes p = exp(s - lse),
//                          dv += round(p)^T do, ds = p (dp - delta),
//                          dk += round(ds)^T q, fp32 accumulators.
//     flash_dq_kernel      one CTA per 64-query tile, a loop over key tiles
//                          up to the diagonal; dq += round(ds) k in fp32.
//     Results are cast to the input dtype once at the end; mma.sync
//     m16n8k16 from shared-memory tiles with synchronous loads.
//
// flash_bwd_qmajor replaces _bwd_kernel_t_qmajor (via _bwd_t_qmajor,
//   flash_attention.py:828-916). The TPU kernel walks query blocks on its
//   sequential grid and keeps dk/dv for the whole sequence in fp32 VMEM
//   scratch (2*T*d*4 bytes a head: 512 KB at T=1024, d=64, over a CTA's
//   227 KB of shared memory). Here one CTA per (b, h) walks the query tiles
//   itself and keeps its dk/dv accumulators in a global fp32 scratch slice
//   that no other CTA touches (no atomics: a run repeats bitwise); per
//   (query, key) tile pair S and dP are formed once, dq is carried in
//   registers and written once per query tile, dk/dv are read, updated
//   and written back in fp32 and cast once. Two designs
//   (flash_bwd_qmajor_launch, the same _bwd_design):
//   sm90: flash_delta_kernel, then flash_bwd_qmajor_sm90_kernel<D>: the
//     producer loads each 128-query tile's q and do by TMA and streams its
//     K / V tiles (128 keys at D = 64, 64 at D = 128) through a 2-stage
//     ring; the consumers form S, dP, p, ds and dQ with flash_dq_sm90_kernel's
//     code, store round(p)^T and round(ds)^T to swizzled shared memory as
//     K-major A tiles (keys x 128 queries), and then consumer 0 forms dV +=
//     P^T dO and consumer 1 dK += dS^T Q by SS wgmma (B MN-major) on the
//     scratch slice (Tp = T rounded up to 128), each thread reading and
//     writing only its own accumulator fragment elements (zero at a key
//     tile's first visit; at its last visit the thread writes dv or dk in
//     bf16 instead of the scratch, so no pass casts the slice).
//     Registers: dq's, plus a 64-key accumulator half (two at D = 64: 64
//     fp32; one at D = 128: 64).
//   mma_sync / fp32: flash_bwd_qmajor_kernel, 64 x 64 tiles on mma.sync
//     (delta formed in the kernel).
//   Bound: the same operations as flash_bwd with S and dP formed once (10
//   d flops a pair); what holds it back is the scratch round trip (each
//   tile pair but a key tile's first and last visits reads and writes
//   2 * keys * d * 4 bytes of dk/dv, most of it
//   past the 50 MB L2 at 132 concurrent heads of 512 KB) and B*H CTAs
//   (2.9 waves at B*H = 384). A cluster that keeps dk/dv in distributed
//   shared memory is later work.
//   Why K2-qmajor equals K2 bitwise, design for design (chip_smoke.py
//   phases 5 and 21 check it): both read delta from flash_delta_kernel;
//   p and ds come from one instruction sequence (bwd_p_ds: ex2 of
//   fma(s, log2 e, -lse log2 e), the masks of pair_ok, round to nearest
//   bf16) on the same S values (a bf16 product is exact in fp32, and a
//   wgmma / mma.sync slice sums its 16 products in an order fixed by k, so
//   S^T's and S's elements agree); and every output element accumulates
//   the same 16-deep slices in the same order from zero: dk and dv over
//   queries ascending from 0 (the fp32 scratch round trip is exact, a
//   slice left out by one walk adds exact zeros in the other), dq over
//   keys ascending. The RS and SS forms of one product give the same
//   bits (the card checks it in phase 21).
//
// Masks are the Pallas kernels' exactly: NEG_INF = -1e30 for masked scores
// in the forward, p = 0 for masked pairs in the backward, keys and queries
// beyond T masked (the ragged last tile), sliding window causal only.
//
// fp32 instances (the parity checks) run the same tiles with the products
// done by scalar FMAs in the mma fragment layout, so the softmax code is
// shared by both types.

#include "attention_tiles.cuh"
#include "sm90_attention.cuh"

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

// ------------------------------------------------------ forward (Hopper)

constexpr int SM90_TILE = 128;             // query rows per work item, keys per stage
constexpr int SM90_HALF = SM90_TILE * 128;  // one 64-d half of a 128-row tile: 16 KB
constexpr float LOG2E = 1.4426950408889634f;

// K/V stages: 3 at d = 64 (128 KB with q and the o staging), 2 at d = 128
// (192 KB; 3 would need 256)
template <int D>
__host__ __device__ constexpr int sm90_stages() {
  return D == 64 ? 3 : 2;
}

template <int D>
constexpr int sm90_fwd_smem() {
  // q, the K/V ring, the o staging (64 rows a consumer), barriers, the item slot
  return 1024 + (D / 64) * SM90_HALF * (2 + 2 * sm90_stages<D>()) +
         (2 * sm90_stages<D>() + 2) * 8 + 16;
}

// Work item w of (B*H) x nq: heads in order, each head's query tiles longest
// (last) first; q0 = its first row, [j_lo, j_hi) its key tiles.
__device__ __forceinline__ void sm90_item(int w, int nq, int T, int causal, int window, int& bh,
                                          int& q0, int& j_lo, int& j_hi) {
  bh = w / nq;
  q0 = (nq - 1 - (w - bh * nq)) * SM90_TILE;
  const int k_hi = causal ? min(T, q0 + SM90_TILE) : T;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  j_lo = k_lo / SM90_TILE;
  j_hi = (k_hi + SM90_TILE - 1) / SM90_TILE;
}

// K10's carried online-softmax state: m and l (B*H, T) fp32 at row stride
// ``sml``, acc (B*H, T, D) fp32 at strides (b, t) (d contiguous).
struct Carry {
  float* m;
  float* l;
  float* acc;
  long long sml, sacc_b, sacc_t;
};

template <int D, bool CARRY>
__global__ void __launch_bounds__(384, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                          const __grid_constant__ CUtensorMap mk,
                          const __grid_constant__ CUtensorMap mv,
                          const __grid_constant__ CUtensorMap mo, float* lse, int* next_item,
                          int items, int H, int T, int causal, int window, Carry carry) {
  constexpr int HALVES = D / 64;
  constexpr int STAGES = sm90_stages<D>();
  constexpr bool PINGPONG = D == 64;
  constexpr int TILE_BYTES = HALVES * SM90_HALF;  // a 128-row q, k or v tile
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* ks = qs + TILE_BYTES;           // [STAGES][TILE_BYTES]
  unsigned char* vs = ks + STAGES * TILE_BYTES;  // [STAGES][TILE_BYTES]
  unsigned char* os = vs + STAGES * TILE_BYTES;  // o staging, 64 rows a consumer
  uint64_t* full = reinterpret_cast<uint64_t*>(os + TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;
  volatile int* item_slot = reinterpret_cast<volatile int*>(qempty + 1);

  const int nq = (T + SM90_TILE - 1) / SM90_TILE;
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
    if (tid == 0) {
      // items come from a counter in device memory, in order (no CTA
      // waits on a short item while long ones are left); each item's
      // index goes to the consumers through the q buffer's barrier
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (;;) {
        const int w = atomicAdd(next_item, 1);
        sm90::mbar_wait(qempty, qphase ^ 1);  // the last item's S products are done
        *item_slot = w;
        if (w >= items) {
          sm90::mbar_arrive(qfull);
          break;
        }
        int bh, q0, j_lo, j_hi;
        sm90_item(w, nq, T, causal, window, bh, q0, j_lo, j_hi);
        const int b = bh / H, h = bh - b * H;
        sm90::mbar_expect_tx(qfull, TILE_BYTES);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          sm90::tma_load(qs + hh * SM90_HALF, &mq, qfull, 4, 64 * hh, q0, h, b);
        qphase ^= 1;
        for (int j = j_lo; j < j_hi; ++j) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], 2 * TILE_BYTES);
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh) {
            sm90::tma_load(ks + stage * TILE_BYTES + hh * SM90_HALF, &mk, &full[stage], 4,
                           64 * hh, j * SM90_TILE, h, b);
            sm90::tma_load(vs + stage * TILE_BYTES + hh * SM90_HALF, &mv, &full[stage], 4,
                           64 * hh, j * SM90_TILE, h, b);
          }
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
    const unsigned char* qa = qs + cw * (SM90_HALF / 2);  // this consumer's 64 rows of each half
    unsigned char* oa = os + cw * (SM90_HALF / 2);
    float o[D / 2];
    float s[64];      // S of the tile in hand
    uint32_t pa[32];  // p in bf16 pairs: PV's A fragments, 16-key slice kk in pa[4 kk .. 4 kk + 3]
    float m0, m1, l0, l1;  // l: this thread's partial sums
    int q0, r0, r1;

    // S = Q K^T of the tile in ``stg`` (issued and committed, not waited)
    auto issue_s = [&](int stg) {
      const unsigned char* kt = ks + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * SM90_HALF + (kk & 3) * 32;
        sm90::wgmma_m64n128k16_ss(s, sm90::smem_desc(qa + off, 16, 1024),
                                  sm90::smem_desc(kt + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
    };
    // O += P V of the tile in ``stg`` from ``p`` (issued and committed)
    auto issue_pv = [&](int stg, const uint32_t (&p)[32]) {
      const unsigned char* vt = vs + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < SM90_TILE / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        sm90::wgmma_pv<D>(o, a, sm90::smem_desc(vt + kk * 2048, SM90_HALF, 1024));
      }
      sm90::wgmma_commit();
    };
    // the online softmax of S for key tile kb0: masks the tiles the
    // diagonal, the window or T cut; new running maxima; p into ``p``
    // (bf16 pairs); the old state's rescale factors and p's row sums out
    auto softmax = [&](int kb0, uint32_t (&p)[32], float& alpha0, float& alpha1, float& sum0,
                       float& sum1) {
      const bool whole = (kb0 + SM90_TILE <= T) && (!causal || kb0 + SM90_TILE - 1 <= q0) &&
                         (window == 0 || q0 + SM90_TILE - 1 - kb0 < window);
      if (!whole) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kb0 + sm90::frag_col(tid, n, e), row = e < 2 ? r0 : r1;
            bool ok = col < T;
            if (causal) ok = ok && col <= row;
            if (window > 0) ok = ok && row - col < window;
            if (!ok) s[4 * n + e] = NEG_INF;
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
      alpha0 = sm90::ex2((m0 - n0) * LOG2E);
      alpha1 = sm90::ex2((m1 - n1) * LOG2E);
      m0 = n0;
      m1 = n1;
      // p = exp(s - m) as ex2(s log2(e) - m log2(e)) in one FMA; a row with
      // every key masked so far (m = NEG_INF) takes p = 0, not the rounding
      // residue of NEG_INF log2(e): its state is discarded (alpha = 0) at
      // its first live key, as the mma_sync kernel's is
      const float ms0 = m0 == NEG_INF ? 0.f : m0 * LOG2E;
      const float ms1 = m1 == NEG_INF ? 0.f : m1 * LOG2E;
      sum0 = sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float p0 = sm90::ex2(fmaf(s[4 * n], LOG2E, -ms0));
        const float p1 = sm90::ex2(fmaf(s[4 * n + 1], LOG2E, -ms0));
        const float p2 = sm90::ex2(fmaf(s[4 * n + 2], LOG2E, -ms1));
        const float p3 = sm90::ex2(fmaf(s[4 * n + 3], LOG2E, -ms1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[2 * n] = sm90::pack_bf16(p0, p1);
        p[2 * n + 1] = sm90::pack_bf16(p2, p3);
      }
    };

    // at d = 64 the two consumers issue their wgmma in turns (named
    // barriers 3 and 4), so one's softmax runs while the other's products
    // do (at d = 128, whose P V products are twice as long, the turns cost
    // more than they overlap)
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
      int bh, j_lo, j_hi;
      sm90_item(w, nq, T, causal, window, bh, q0, j_lo, j_hi);
      const int b = bh / H, h = bh - b * H;
      r0 = q0 + 64 * cw + sm90::frag_row(tid, 0);
      r1 = r0 + 8;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      if constexpr (CARRY) {
        // the caller's state of rows r0 and r1: m, l (held by one of the
        // row's four threads: l0 / l1 are partial sums), and this thread's
        // own accumulator elements
        const float* cm = carry.m + (long long)bh * carry.sml;
        const float* cl = carry.l + (long long)bh * carry.sml;
        const float* ca = carry.acc + (long long)bh * carry.sacc_b;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i ? r1 : r0;
          if (row >= T) continue;
          (i ? m1 : m0) = cm[row];
          if ((tid & 3) == 0) (i ? l1 : l0) = cl[row];
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            const float* ap = ca + (long long)row * carry.sacc_t + sm90::frag_col(tid, n, 0);
            o[4 * n + 2 * i] = ap[0];
            o[4 * n + 2 * i + 1] = ap[1];
          }
        }
      }
      float alpha0, alpha1, sum0, sum1;
      // the first tile: S, then its softmax (O is zero, or the carry)
      sm90::mbar_wait(&full[stage], phase);
      my_turn();
      sm90::wgmma_fence();
      issue_s(stage);
      your_turn();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      if (j_lo + 1 == j_hi && lane == 0) sm90::mbar_arrive(qempty);  // q read for the last time
      softmax(j_lo * SM90_TILE, pa, alpha0, alpha1, sum0, sum1);
      if constexpr (CARRY) {  // the carried state rescaled to the new max
        l0 = l0 * alpha0 + sum0;
        l1 = l1 * alpha1 + sum1;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          o[4 * n] *= alpha0;
          o[4 * n + 1] *= alpha0;
          o[4 * n + 2] *= alpha1;
          o[4 * n + 3] *= alpha1;
        }
      } else {
        l0 = sum0;
        l1 = sum1;
      }
      // each further tile: its S and the previous tile's PV in flight
      // together; the softmax of S runs while PV does
      for (int j = j_lo + 1; j < j_hi; ++j) {
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
        if (j + 1 == j_hi && lane == 0) sm90::mbar_arrive(qempty);
        uint32_t pn[32];
        softmax(j * SM90_TILE, pn, alpha0, alpha1, sum0, sum1);
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

      // the row sums over the four threads of each row, then o / l rounded
      // once into this consumer's staging rows in the TMA box layout
      // (16-byte chunk c of row r at c ^ (r % 8)), stored by TMA; the
      // previous item's store must have read the staging rows first
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if constexpr (CARRY) {  // the state goes back unnormalized, in place
        float* cm = carry.m + (long long)bh * carry.sml;
        float* cl = carry.l + (long long)bh * carry.sml;
        float* ca = carry.acc + (long long)bh * carry.sacc_b;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = i ? r1 : r0;
          if (row >= T) continue;
          if ((tid & 3) == 0) {
            cm[row] = i ? m1 : m0;
            cl[row] = i ? l1 : l0;
          }
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
            float* ap = ca + (long long)row * carry.sacc_t + sm90::frag_col(tid, n, 0);
            ap[0] = o[4 * n + 2 * i];
            ap[1] = o[4 * n + 2 * i + 1];
          }
        }
        continue;
      }
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_sync(1 + cw);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = sm90::frag_row(tid, 2 * i), c = sm90::frag_col(tid, n, 0) & 63;
          const float inv = i ? inv1 : inv0;
          unsigned char* dst = oa + (n >> 3) * SM90_HALF + r * 128 +
                               (((c >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
          *reinterpret_cast<uint32_t*>(dst) =
              sm90::pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
        }
      }
      sm90::fence_proxy_async();
      sm90::named_sync(1 + cw);
      if (tid == 0) {
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh)
          sm90::tma_store_4d(&mo, oa + hh * SM90_HALF, 64 * hh, q0 + 64 * cw, h, b);
        sm90::tma_store_commit();
      }
      if ((tid & 3) == 0) {
        float* lg = lse + (long long)bh * T;
        if (r0 < T) lg[r0] = m0 + logf(l0);
        if (r1 < T) lg[r1] = m1 + logf(l1);
      }
    }
    if (cw == 0) my_turn();  // consumer 1's last turn handed back
    if (!CARRY && tid == 0) sm90::tma_store_wait_all();
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

// ------------------------------------------------------ backward (Hopper)

constexpr int BWD_ROWS = 128;  // rows an item owns (keys, or queries): 64 a consumer
using sm90::BOX_BYTES;  // a 64-row, 64-d TMA box (one consumer's output half)

// rows of a streamed tile: the queries of a dK/dV step, the keys of a dQ
// step (64 at D = 128, so S, dP and the D-wide accumulators fit the
// consumers' registers)
template <int D>
__host__ __device__ constexpr int bwd_cols() {
  return D == 64 ? 128 : 64;
}
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D == 64 ? 3 : 2;
}
constexpr int DQ_STAGES = 3;
constexpr int QMAJOR_STAGES = 2;

template <int D>
constexpr int dkdv_smem() {
  // K and V (128 keys), the q / do ring, the dk / dv staging (64 rows a
  // consumer each), lse log2(e) and delta per stage, barriers, the item slot
  return 1024 + (D / 64) * 128 * (2 * BWD_ROWS + 2 * dkdv_stages<D>() * bwd_cols<D>() + 4 * 64) +
         2 * dkdv_stages<D>() * bwd_cols<D>() * 4 + (2 * dkdv_stages<D>() + 2) * 8 + 16;
}
template <int D>
constexpr int dq_smem() {
  // q and do (128 queries), the K / V ring, the dq staging, barriers, the slot
  return 1024 + (D / 64) * 128 * (2 * BWD_ROWS + 2 * DQ_STAGES * bwd_cols<D>() + 2 * 64) +
         (2 * DQ_STAGES + 2) * 8 + 16;
}
template <int D>
constexpr int qmajor_smem() {
  // q and do, the K / V ring, P^T and dS^T (keys x 128 queries), the dq
  // staging, barriers
  return 1024 + (D / 64) * 128 * (2 * BWD_ROWS + 2 * QMAJOR_STAGES * bwd_cols<D>() + 2 * 64) +
         2 * bwd_cols<D>() * 2 * 128 + (2 * QMAJOR_STAGES + 2) * 8;
}
static_assert(dkdv_smem<64>() <= 232448 && dkdv_smem<128>() <= 232448, "dk/dv smem");
static_assert(dq_smem<64>() <= 232448 && dq_smem<128>() <= 232448, "dq smem");
static_assert(qmajor_smem<64>() <= 232448 && qmajor_smem<128>() <= 232448, "qmajor smem");

// The query tiles [i_lo, i_hi) of ``bq`` rows that key rows [k0, k0 + 128)
// meet: from the causal diagonal, up to the window's last live query.
__device__ __forceinline__ void dkdv_walk(int k0, int T, int causal, int window, int bq, int& i_lo,
                                          int& i_hi) {
  const int q_lo = causal ? k0 : 0;
  const int q_hi = window > 0 ? min(T, k0 + BWD_ROWS - 1 + window) : T;
  i_lo = q_lo / bq;
  i_hi = (q_hi + bq - 1) / bq;
}

// The key tiles [j_lo, j_hi) of ``bk`` rows that query rows [q0, q0 + 128)
// meet: from the window's first live key, up to the causal diagonal.
__device__ __forceinline__ void dq_walk(int q0, int T, int causal, int window, int bk, int& j_lo,
                                        int& j_hi) {
  const int k_hi = causal ? min(T, q0 + BWD_ROWS) : T;
  const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  j_lo = k_lo / bk;
  j_hi = (k_hi + bk - 1) / bk;
}

// p and ds (sm90_attention.cuh): one instruction sequence for every
// backward kernel, so that the query-major and the k-major designs agree
// bitwise.
using sm90::bwd_p_ds;

// p, ds of a consumer's 64 x BQ S^T / dP^T fragments (rows: keys from kr;
// columns: queries from qb0), in place; lsq / dlq: the tile's lse log2(e)
// and delta by query, read once for each of a thread's column pairs
// (c, c + 1); MASK: the tile is cut by the diagonal, the window or T.
template <bool MASK, int BQ>
__device__ __forceinline__ void dkdv_p_ds(float (&s)[BQ / 2], float (&dp)[BQ / 2], const float* lsq,
                                          const float* dlq, int tid, int qb0, int kr, int T,
                                          int causal, int window) {
#pragma unroll
  for (int n = 0; n < BQ / 8; ++n) {
    const int c = sm90::frag_col(tid, n, 0);
    const float2 l2 = make_float2(lsq[c], lsq[c + 1]);
    const float2 d2 = make_float2(dlq[c], dlq[c + 1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok =
          !MASK || pair_ok(qb0 + c + (e & 1), kr + sm90::frag_row(tid, e), T, causal, window);
      bwd_p_ds(s[4 * n + e], dp[4 * n + e], e & 1 ? l2.y : l2.x, e & 1 ? d2.y : d2.x, ok);
    }
  }
}

using sm90::stage_bf16;

// The TMA store of a consumer's staged 64 rows from ``row0`` (rows past T
// are not written), committed in the calling thread's bulk group.
template <int D>
__device__ __forceinline__ void store_rows(const CUtensorMap* map, const unsigned char* st, int row0,
                                           int h, int b) {
#pragma unroll
  for (int hh = 0; hh < D / 64; ++hh) sm90::tma_store_4d(map, st + hh * BOX_BYTES, 64 * hh, row0, h, b);
}

using sm90::pack_frag;

// flash_dkdv_sm90_kernel: persistent; an item is (b*h, 128-key tile), heads
// in order and each head's first key tiles (the longest causal walks)
// first, taken from a counter in device memory. Warp 0 of the producer
// warpgroup loads the item's K and V by TMA, then streams the walk's q and
// do tiles (``bwd_cols`` queries) through an mbarrier ring, each with its
// rows' lse log2(e) and delta (plain loads into the stage, completed by the
// warp's arrivals on the stage's barrier). Each consumer warpgroup owns 64
// keys: per query tile S^T = K Q^T and dP^T = V dO^T (SS, both K-major),
// p and ds in registers (bwd_p_ds), rounded to bf16 in pairs straight into
// the A fragments of dV += P^T dO and dK += dS^T Q (RS, B MN-major); dk and
// dv in fp32 registers across the walk, stored once by TMA.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_dkdv_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                           const __grid_constant__ CUtensorMap mk,
                           const __grid_constant__ CUtensorMap mv,
                           const __grid_constant__ CUtensorMap mdo,
                           const __grid_constant__ CUtensorMap mdk,
                           const __grid_constant__ CUtensorMap mdv, const float* lse,
                           const float* delta, int* next_item, int items, int H, int T, int causal,
                           int window) {
  constexpr int HALVES = D / 64;
  constexpr int BQ = bwd_cols<D>();
  constexpr int STAGES = dkdv_stages<D>();
  constexpr int KV_HALF = BWD_ROWS * 128;  // one 64-d half of the K or V tile
  constexpr int Q_HALF = BQ * 128;         // one 64-d half of a q or do tile
  constexpr int Q_BYTES = HALVES * Q_HALF;
  constexpr int ST_BYTES = HALVES * BOX_BYTES;
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* ks = base;
  unsigned char* vs = ks + HALVES * KV_HALF;
  unsigned char* qs = vs + HALVES * KV_HALF;   // [STAGES][Q_BYTES]
  unsigned char* dos = qs + STAGES * Q_BYTES;  // [STAGES][Q_BYTES]
  unsigned char* outs = dos + STAGES * Q_BYTES;  // [consumer][dk, dv][ST_BYTES]
  float* ls = reinterpret_cast<float*>(outs + 4 * ST_BYTES);  // [STAGES][BQ] lse log2(e)
  float* dls = ls + STAGES * BQ;                               // [STAGES][BQ] delta
  uint64_t* full = reinterpret_cast<uint64_t*>(dls + STAGES * BQ);
  uint64_t* empty = full + STAGES;
  uint64_t* kvfull = empty + STAGES;
  uint64_t* kvempty = kvfull + 1;
  volatile int* item_slot = reinterpret_cast<volatile int*>(kvempty + 1);

  const int nk = (T + BWD_ROWS - 1) / BWD_ROWS;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 33);  // the producer warp's lanes and the expect_tx
      sm90::mbar_init(&empty[s], 8);  // one arrive per consumer warp
    }
    sm90::mbar_init(kvfull, 1);
    sm90::mbar_init(kvempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid < 32) {
      const int lane = tid;
      int stage = 0;
      uint32_t phase = 0, kvphase = 0;
      for (;;) {
        int w = 0;
        if (lane == 0) w = atomicAdd(next_item, 1);
        w = __shfl_sync(0xffffffffu, w, 0);
        sm90::mbar_wait(kvempty, kvphase ^ 1);  // the last item's S^T / dP^T are done
        if (lane == 0) *item_slot = w;
        if (w >= items) {
          if (lane == 0) sm90::mbar_arrive(kvfull);
          break;
        }
        const int bh = w / nk, k0 = (w - bh * nk) * BWD_ROWS;
        const int b = bh / H, h = bh - b * H;
        int i_lo, i_hi;
        dkdv_walk(k0, T, causal, window, BQ, i_lo, i_hi);
        if (lane == 0) {
          sm90::mbar_expect_tx(kvfull, 2 * HALVES * KV_HALF);
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh) {
            sm90::tma_load(ks + hh * KV_HALF, &mk, kvfull, 4, 64 * hh, k0, h, b);
            sm90::tma_load(vs + hh * KV_HALF, &mv, kvfull, 4, 64 * hh, k0, h, b);
          }
        }
        kvphase ^= 1;
        const float* lg = lse + (long long)bh * T;
        const float* dg = delta + (long long)bh * T;
        for (int i = i_lo; i < i_hi; ++i) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          if (lane == 0) {
            sm90::mbar_expect_tx(&full[stage], 2 * Q_BYTES);
#pragma unroll
            for (int hh = 0; hh < HALVES; ++hh) {
              sm90::tma_load(qs + stage * Q_BYTES + hh * Q_HALF, &mq, &full[stage], 4, 64 * hh,
                             i * BQ, h, b);
              sm90::tma_load(dos + stage * Q_BYTES + hh * Q_HALF, &mdo, &full[stage], 4, 64 * hh,
                             i * BQ, h, b);
            }
          }
          for (int r = lane; r < BQ; r += 32) {
            const int row = i * BQ + r;
            ls[stage * BQ + r] = row < T ? lg[row] * LOG2E : 0.f;
            dls[stage * BQ + r] = row < T ? dg[row] : 0.f;
          }
          sm90::mbar_arrive(&full[stage]);
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
    const unsigned char* ka = ks + cw * BOX_BYTES;  // this consumer's 64 keys of each half
    const unsigned char* va = vs + cw * BOX_BYTES;
    unsigned char* sk = outs + cw * 2 * ST_BYTES;
    unsigned char* sv = sk + ST_BYTES;
    float dk[D / 2], dv[D / 2];
    int stage = 0;
    uint32_t phase = 0, kvphase = 0;
    for (;;) {
      sm90::mbar_wait(kvfull, kvphase);
      kvphase ^= 1;
      const int w = *item_slot;
      if (w >= items) break;
      const int bh = w / nk, k0 = (w - bh * nk) * BWD_ROWS;
      const int b = bh / H, h = bh - b * H;
      int i_lo, i_hi;
      dkdv_walk(k0, T, causal, window, BQ, i_lo, i_hi);
      const int kr = k0 + 64 * cw;  // this consumer's first key
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dk[x] = dv[x] = 0.f;
      for (int i = i_lo; i < i_hi; ++i) {
        const int qb0 = i * BQ;
        const unsigned char* qt = qs + stage * Q_BYTES;
        const unsigned char* dt = dos + stage * Q_BYTES;
        float s[BQ / 2], dp[BQ / 2];
        sm90::mbar_wait(&full[stage], phase);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // S^T = K Q^T
          sm90::wgmma_nt<BQ>(s, sm90::smem_desc(ka + (kk >> 2) * KV_HALF + (kk & 3) * 32, 16, 1024),
                             sm90::smem_desc(qt + (kk >> 2) * Q_HALF + (kk & 3) * 32, 16, 1024),
                             kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {  // dP^T = V dO^T
          sm90::wgmma_nt<BQ>(dp, sm90::smem_desc(va + (kk >> 2) * KV_HALF + (kk & 3) * 32, 16, 1024),
                             sm90::smem_desc(dt + (kk >> 2) * Q_HALF + (kk & 3) * 32, 16, 1024),
                             kk > 0);
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (i + 1 == i_hi && lane == 0) sm90::mbar_arrive(kvempty);  // K, V read for the last time
        const bool whole = (kr + 64 <= T) && (qb0 + BQ <= T) && (!causal || kr + 63 <= qb0) &&
                           (window == 0 || qb0 + BQ - 1 - kr < window);
        if (whole)
          dkdv_p_ds<false, BQ>(s, dp, ls + stage * BQ, dls + stage * BQ, tid, qb0, kr, T, causal,
                               window);
        else
          dkdv_p_ds<true, BQ>(s, dp, ls + stage * BQ, dls + stage * BQ, tid, qb0, kr, T, causal,
                              window);
        uint32_t pa[BQ / 4], da[BQ / 4];
        pack_frag<BQ>(s, pa);
        pack_frag<BQ>(dp, da);
        sm90::fence_regs(dk);
        sm90::fence_regs(dv);
        sm90::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {  // dV += P^T dO
          const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
          sm90::wgmma_pv<D>(dv, a, sm90::smem_desc(dt + kk * 2048, Q_HALF, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {  // dK += dS^T Q
          const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
          sm90::wgmma_pv<D>(dk, a, sm90::smem_desc(qt + kk * 2048, Q_HALF, 1024));
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::keep_regs(pa);
        sm90::keep_regs(da);
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (i_lo >= i_hi && lane == 0) sm90::mbar_arrive(kvempty);
      // dk and dv rounded once into this consumer's staging rows and stored
      // by TMA; the previous item's store must have read them first
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_sync(1 + cw);
      stage_bf16<D>(dk, sk, tid);
      stage_bf16<D>(dv, sv, tid);
      sm90::fence_proxy_async();
      sm90::named_sync(1 + cw);
      if (tid == 0) {
        store_rows<D>(&mdk, sk, kr, h, b);
        store_rows<D>(&mdv, sv, kr, h, b);
        sm90::tma_store_commit();
      }
    }
    if (tid == 0) sm90::tma_store_wait_all();
  }
}

// p, ds of a consumer's 64 x BK S / dP fragments (rows: queries r0 and r0 + 8;
// columns: keys from kb0), in place; then ds in bf16 pairs into ``da``.
template <bool MASK, int BK>
__device__ __forceinline__ void dq_p_ds_tile(float (&s)[BK / 2], float (&dp)[BK / 2], int tid, int r0,
                                             int kb0, const float (&lse2)[2], const float (&dl)[2],
                                             int T, int causal, int window) {
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const bool ok =
          !MASK || pair_ok(r0 + 8 * i, kb0 + sm90::frag_col(tid, n, e), T, causal, window);
      bwd_p_ds(s[4 * n + e], dp[4 * n + e], lse2[i], dl[i], ok);
    }
  }
}

template <int BK>
__device__ __forceinline__ void dq_p_ds(float (&s)[BK / 2], float (&dp)[BK / 2], uint32_t (&da)[BK / 4],
                                        int tid, int r0, int kb0, bool whole, const float (&lse2)[2],
                                        const float (&dl)[2], int T, int causal, int window) {
  if (whole)
    dq_p_ds_tile<false, BK>(s, dp, tid, r0, kb0, lse2, dl, T, causal, window);
  else
    dq_p_ds_tile<true, BK>(s, dp, tid, r0, kb0, lse2, dl, T, causal, window);
  pack_frag<BK>(dp, da);
}

// S = Q K^T and dP = dO V^T of a consumer's 64 queries (qa, doa: its rows of
// the 128-query q and do tiles) against a BK-key K / V tile (issued,
// committed and waited).
template <int D, int BK>
__device__ __forceinline__ void dq_s_dp(float (&s)[BK / 2], float (&dp)[BK / 2], const unsigned char* qa,
                                        const unsigned char* doa, const unsigned char* kt,
                                        const unsigned char* vt) {
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_nt<BK>(s, sm90::smem_desc(qa + (kk >> 2) * (BWD_ROWS * 128) + (kk & 3) * 32, 16, 1024),
                       sm90::smem_desc(kt + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    sm90::wgmma_nt<BK>(dp, sm90::smem_desc(doa + (kk >> 2) * (BWD_ROWS * 128) + (kk & 3) * 32, 16, 1024),
                       sm90::smem_desc(vt + (kk >> 2) * (BK * 128) + (kk & 3) * 32, 16, 1024), kk > 0);
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
  sm90::fence_regs(s);
  sm90::fence_regs(dp);
}

// dQ += dS K over a BK-key tile: ds in bf16 pairs (RS), K MN-major (issued
// and committed, not waited).
template <int D, int BK>
__device__ __forceinline__ void dq_issue(float (&dq)[D / 2], const uint32_t (&da)[BK / 4],
                                         const unsigned char* kt) {
  sm90::fence_regs(dq);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {da[4 * kk], da[4 * kk + 1], da[4 * kk + 2], da[4 * kk + 3]};
    sm90::wgmma_pv<D>(dq, a, sm90::smem_desc(kt + kk * 2048, BK * 128, 1024));
  }
  sm90::wgmma_commit();
}

// lse log2(e) and delta of rows r0 and r0 + 8 (0 past T).
__device__ __forceinline__ void row_stats(float (&lse2)[2], float (&dl)[2], const float* lse,
                                          const float* delta, long long bh, int r0, int T) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    lse2[i] = row < T ? lse[bh * T + row] * LOG2E : 0.f;
    dl[i] = row < T ? delta[bh * T + row] : 0.f;
  }
}

// flash_dq_sm90_kernel: persistent, the forward's item walk (b*h, 128-query
// tile; each head's last, longest causal tiles first). The producer loads
// the item's q and do by TMA, then streams its K / V tiles (``bwd_cols``
// keys) through the ring. Each consumer owns 64 queries: per key tile
// S = Q K^T and dP = dO V^T (SS), p and ds (bwd_p_ds), dQ += dS K (RS, K
// MN-major); dq stored once by TMA.
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const __grid_constant__ CUtensorMap mdq, const float* lse,
                         const float* delta, int* next_item, int items, int H, int T, int causal,
                         int window) {
  constexpr int HALVES = D / 64;
  constexpr int BK = bwd_cols<D>();
  constexpr int STAGES = DQ_STAGES;
  constexpr int Q_HALF = BWD_ROWS * 128;
  constexpr int KV_HALF = BK * 128;
  constexpr int KV_BYTES = HALVES * KV_HALF;
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* dos = qs + HALVES * Q_HALF;
  unsigned char* ks = dos + HALVES * Q_HALF;   // [STAGES][KV_BYTES]
  unsigned char* vs = ks + STAGES * KV_BYTES;  // [STAGES][KV_BYTES]
  unsigned char* outs = vs + STAGES * KV_BYTES;  // [consumer][HALVES * BOX_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * HALVES * BOX_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;
  volatile int* item_slot = reinterpret_cast<volatile int*>(qempty + 1);

  const int nq = (T + BWD_ROWS - 1) / BWD_ROWS;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_init(qempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (;;) {
        const int w = atomicAdd(next_item, 1);
        sm90::mbar_wait(qempty, qphase ^ 1);
        *item_slot = w;
        if (w >= items) {
          sm90::mbar_arrive(qfull);
          break;
        }
        const int bh = w / nq, q0 = (nq - 1 - (w - bh * nq)) * BWD_ROWS;
        const int b = bh / H, h = bh - b * H;
        int j_lo, j_hi;
        dq_walk(q0, T, causal, window, BK, j_lo, j_hi);
        sm90::mbar_expect_tx(qfull, 2 * HALVES * Q_HALF);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          sm90::tma_load(qs + hh * Q_HALF, &mq, qfull, 4, 64 * hh, q0, h, b);
          sm90::tma_load(dos + hh * Q_HALF, &mdo, qfull, 4, 64 * hh, q0, h, b);
        }
        qphase ^= 1;
        for (int j = j_lo; j < j_hi; ++j) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], 2 * KV_BYTES);
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh) {
            sm90::tma_load(ks + stage * KV_BYTES + hh * KV_HALF, &mk, &full[stage], 4, 64 * hh,
                           j * BK, h, b);
            sm90::tma_load(vs + stage * KV_BYTES + hh * KV_HALF, &mv, &full[stage], 4, 64 * hh,
                           j * BK, h, b);
          }
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
    const unsigned char* qa = qs + cw * BOX_BYTES;  // this consumer's 64 queries of each half
    const unsigned char* doa = dos + cw * BOX_BYTES;
    unsigned char* sq = outs + cw * HALVES * BOX_BYTES;
    float dq[D / 2];
    int stage = 0;
    uint32_t phase = 0, qphase = 0;
    for (;;) {
      sm90::mbar_wait(qfull, qphase);
      qphase ^= 1;
      const int w = *item_slot;
      if (w >= items) break;
      const int bh = w / nq, q0 = (nq - 1 - (w - bh * nq)) * BWD_ROWS;
      const int b = bh / H, h = bh - b * H;
      int j_lo, j_hi;
      dq_walk(q0, T, causal, window, BK, j_lo, j_hi);
      const int qr = q0 + 64 * cw, r0 = qr + sm90::frag_row(tid, 0);
      float lse2[2], dl[2];
      row_stats(lse2, dl, lse, delta, bh, r0, T);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      for (int j = j_lo; j < j_hi; ++j) {
        const int kb0 = j * BK;
        const unsigned char* kt = ks + stage * KV_BYTES;
        float s[BK / 2], dp[BK / 2];
        uint32_t da[BK / 4];
        sm90::mbar_wait(&full[stage], phase);
        dq_s_dp<D, BK>(s, dp, qa, doa, kt, vs + stage * KV_BYTES);
        if (j + 1 == j_hi && lane == 0) sm90::mbar_arrive(qempty);  // q, do read for the last time
        const bool whole = (kb0 + BK <= T) && (qr + 64 <= T) && (!causal || kb0 + BK - 1 <= qr) &&
                           (window == 0 || qr + 63 - kb0 < window);
        dq_p_ds<BK>(s, dp, da, tid, r0, kb0, whole, lse2, dl, T, causal, window);
        dq_issue<D, BK>(dq, da, kt);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        sm90::keep_regs(da);
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (j_lo >= j_hi && lane == 0) sm90::mbar_arrive(qempty);
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_sync(1 + cw);
      stage_bf16<D>(dq, sq, tid);
      sm90::fence_proxy_async();
      sm90::named_sync(1 + cw);
      if (tid == 0) {
        store_rows<D>(&mdq, sq, qr, h, b);
        sm90::tma_store_commit();
      }
    }
    if (tid == 0) sm90::tma_store_wait_all();
  }
}

// flash_bwd_qmajor_sm90_kernel: one CTA per (b, h) walks its 128-query tiles
// in order and, inside each, the key tiles (``bwd_cols`` keys) between the
// forward's bounds; the producer loads each query tile's q and do by TMA and
// streams the K / V tiles through the ring. Per tile pair the consumers
// (64 queries each) form S and dP once and p, ds as flash_dq_sm90_kernel
// does (the same code), carry dq in registers (RS, written once per query
// tile by TMA), and store round(p)^T and round(ds)^T to shared memory as
// K-major A tiles (keys x 128 queries, consumer c's queries in half c).
// Then consumer 0 forms dV += P^T dO and consumer 1 dK += dS^T Q (SS, B
// MN-major) on the tile's keys, carried in this CTA's slice of the fp32
// scratch ``acc`` ((B*H, 2, Tp, D), Tp = T rounded up to 128): each thread
// reads and writes only its own fragment elements, starting from zero at a
// key tile's first visit; at its last visit it writes dv or dk in bf16
// instead (the scratch round trip is the kernel's bound: each other visit
// reads and writes 2 * keys * D * 4 bytes).
template <int D>
__global__ void __launch_bounds__(384, 1)
    flash_bwd_qmajor_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 const __grid_constant__ CUtensorMap mdo,
                                 const __grid_constant__ CUtensorMap mdq, const float* lse,
                                 const float* delta, float* acc, bf16* dkg, bf16* dvg, Strides sdk,
                                 Strides sdv, int H, int T, int causal, int window) {
  constexpr int HALVES = D / 64;
  constexpr int BK = bwd_cols<D>();
  constexpr int MH = BK / 64;  // 64-key row halves of a key tile
  constexpr int STAGES = QMAJOR_STAGES;
  constexpr int Q_HALF = BWD_ROWS * 128;
  constexpr int KV_HALF = BK * 128;
  constexpr int KV_BYTES = HALVES * KV_HALF;
  constexpr int PT_HALF = BK * 128;  // 64 queries of P^T / dS^T: BK key rows of 128 bytes
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* dos = qs + HALVES * Q_HALF;
  unsigned char* ks = dos + HALVES * Q_HALF;   // [STAGES][KV_BYTES]
  unsigned char* vs = ks + STAGES * KV_BYTES;  // [STAGES][KV_BYTES]
  unsigned char* pt = vs + STAGES * KV_BYTES;  // round(p)^T [2][PT_HALF]
  unsigned char* dst = pt + 2 * PT_HALF;       // round(ds)^T [2][PT_HALF]
  unsigned char* outs = dst + 2 * PT_HALF;     // [consumer][HALVES * BOX_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(outs + 2 * HALVES * BOX_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const int nq = (T + BWD_ROWS - 1) / BWD_ROWS;
  const long long tp = (long long)nq * BWD_ROWS;
  float* dk_acc = acc + (long long)bh * 2 * tp * D;
  float* dv_acc = dk_acc + tp * D;
  const int wg = threadIdx.x >> 7, tid = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_init(qempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      int stage = 0;
      uint32_t phase = 0, qphase = 0;
      for (int i = 0; i < nq; ++i) {
        const int q0 = i * BWD_ROWS;
        int j_lo, j_hi;
        dq_walk(q0, T, causal, window, BK, j_lo, j_hi);
        sm90::mbar_wait(qempty, qphase ^ 1);  // the last query tile's products are done
        sm90::mbar_expect_tx(qfull, 2 * HALVES * Q_HALF);
#pragma unroll
        for (int hh = 0; hh < HALVES; ++hh) {
          sm90::tma_load(qs + hh * Q_HALF, &mq, qfull, 4, 64 * hh, q0, h, b);
          sm90::tma_load(dos + hh * Q_HALF, &mdo, qfull, 4, 64 * hh, q0, h, b);
        }
        qphase ^= 1;
        for (int j = j_lo; j < j_hi; ++j) {
          sm90::mbar_wait(&empty[stage], phase ^ 1);
          sm90::mbar_expect_tx(&full[stage], 2 * KV_BYTES);
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh) {
            sm90::tma_load(ks + stage * KV_BYTES + hh * KV_HALF, &mk, &full[stage], 4, 64 * hh,
                           j * BK, h, b);
            sm90::tma_load(vs + stage * KV_BYTES + hh * KV_HALF, &mv, &full[stage], 4, 64 * hh,
                           j * BK, h, b);
          }
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
    const unsigned char* qa = qs + cw * BOX_BYTES;
    const unsigned char* doa = dos + cw * BOX_BYTES;
    unsigned char* sq = outs + cw * HALVES * BOX_BYTES;
    // consumer 0: dV += P^T dO; consumer 1: dK += dS^T Q
    const unsigned char* at = cw == 0 ? pt : dst;
    const unsigned char* bt = cw == 0 ? dos : qs;
    float* sc = cw == 0 ? dv_acc : dk_acc;
    bf16* out = cw == 0 ? dvg + b * sdv.b + h * sdv.h : dkg + b * sdk.b + h * sdk.h;
    const long long out_t = cw == 0 ? sdv.t : sdk.t;
    float dq[D / 2];
    int stage = 0;
    uint32_t phase = 0, qphase = 0;
    for (int i = 0; i < nq; ++i) {
      const int q0 = i * BWD_ROWS;
      int j_lo, j_hi, j_next = 0;
      dq_walk(q0, T, causal, window, BK, j_lo, j_hi);
      if (i + 1 < nq) {  // the next query tile's first key tile (the window's)
        int jh;
        dq_walk(q0 + BWD_ROWS, T, causal, window, BK, j_next, jh);
      }
      sm90::mbar_wait(qfull, qphase);
      qphase ^= 1;
      const int qr = q0 + 64 * cw, r0 = qr + sm90::frag_row(tid, 0);
      float lse2[2], dl[2];
      row_stats(lse2, dl, lse, delta, bh, r0, T);
#pragma unroll
      for (int x = 0; x < D / 2; ++x) dq[x] = 0.f;
      for (int j = j_lo; j < j_hi; ++j) {
        const int kb0 = j * BK;
        const unsigned char* kt = ks + stage * KV_BYTES;
        float s[BK / 2], dp[BK / 2];
        uint32_t da[BK / 4];
        sm90::mbar_wait(&full[stage], phase);
        dq_s_dp<D, BK>(s, dp, qa, doa, kt, vs + stage * KV_BYTES);
        const bool whole = (kb0 + BK <= T) && (qr + 64 <= T) && (!causal || kb0 + BK - 1 <= qr) &&
                           (window == 0 || qr + 63 - kb0 < window);
        dq_p_ds<BK>(s, dp, da, tid, r0, kb0, whole, lse2, dl, T, causal, window);
        // the last pair's dV / dK products have read P^T and dS^T
        asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
        for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = sm90::frag_col(tid, n, e), qq = sm90::frag_row(tid, e);
            const int off = cw * PT_HALF + key * 128 + ((((qq >> 3) ^ (key & 7)) << 4) | ((qq & 7) * 2));
            *reinterpret_cast<bf16*>(pt + off) = __float2bfloat16(s[4 * n + e]);
            *reinterpret_cast<bf16*>(dst + off) = __float2bfloat16(dp[4 * n + e]);
          }
        }
        sm90::fence_proxy_async();
        dq_issue<D, BK>(dq, da, kt);
        const bool first = causal ? (kb0 / BWD_ROWS == i) : (i == 0);
        float ac[MH][D / 2];
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const long long row = kb0 + 64 * mh + sm90::frag_row(tid, 2 * r);
              float2 x = make_float2(0.f, 0.f);
              if (!first) x = *reinterpret_cast<const float2*>(sc + row * D + sm90::frag_col(tid, n, 0));
              ac[mh][4 * n + 2 * r] = x.x;
              ac[mh][4 * n + 2 * r + 1] = x.y;
            }
          }
          sm90::fence_regs(ac[mh]);
        }
        asm volatile("bar.sync 3, 256;\n" ::: "memory");  // both halves of P^T, dS^T stored
        sm90::wgmma_fence();
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
#pragma unroll
          for (int kk = 0; kk < BWD_ROWS / 16; ++kk) {
            sm90::wgmma_pv_ss<D>(
                ac[mh], sm90::smem_desc(at + (kk >> 2) * PT_HALF + mh * BOX_BYTES + (kk & 3) * 32, 16, 1024),
                sm90::smem_desc(bt + kk * 2048, Q_HALF, 1024));
          }
        }
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();  // dQ's and this consumer's dV / dK products
        sm90::fence_regs(dq);
        sm90::keep_regs(da);
        // a key tile's last visit (no later query tile walks it) writes dv or
        // dk in the input dtype, every other one the fp32 scratch
        const bool last = i + 1 == nq || j < j_next;
#pragma unroll
        for (int mh = 0; mh < MH; ++mh) {
          sm90::fence_regs(ac[mh]);
#pragma unroll
          for (int n = 0; n < D / 8; ++n) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = kb0 + 64 * mh + sm90::frag_row(tid, 2 * r);
              const int col = sm90::frag_col(tid, n, 0);
              const float x = ac[mh][4 * n + 2 * r], y = ac[mh][4 * n + 2 * r + 1];
              if (!last)
                *reinterpret_cast<float2*>(sc + (long long)row * D + col) = make_float2(x, y);
              else if (row < T)
                *reinterpret_cast<__nv_bfloat162*>(out + row * out_t + col) =
                    __floats2bfloat162_rn(x, y);
            }
          }
        }
        if (lane == 0) sm90::mbar_arrive(&empty[stage]);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      if (lane == 0) sm90::mbar_arrive(qempty);  // q, do read for the last time
      if (tid == 0) sm90::tma_store_wait_read();
      sm90::named_sync(1 + cw);
      stage_bf16<D>(dq, sq, tid);
      sm90::fence_proxy_async();
      sm90::named_sync(1 + cw);
      if (tid == 0) {
        store_rows<D>(&mdq, sq, qr, h, b);
        sm90::tma_store_commit();
      }
    }
    if (tid == 0) sm90::tma_store_wait_all();
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

// q, k, v and o through their strides; lse (B, H, T) contiguous;
// next_item an int32 in device memory, 0 at the launch. CARRY (K10): o and
// lse are not touched; a.m, a.l and a.acc carry the state in and out.
template <int D, bool CARRY>
cudaError_t fwd_sm90(const FlashArgs& a, int* next_item, cudaStream_t s) {
  CUtensorMap mq, mk, mv, mo;
  cudaError_t err = sm90::make_bhtd_map(&mq, a.q, a.B, a.H, a.T, D, a.sq.b, a.sq.h, a.sq.t,
                                        SM90_TILE);
  if (err == cudaSuccess)
    err = sm90::make_bhtd_map(&mk, a.k, a.B, a.H, a.T, D, a.sk.b, a.sk.h, a.sk.t, SM90_TILE);
  if (err == cudaSuccess)
    err = sm90::make_bhtd_map(&mv, a.v, a.B, a.H, a.T, D, a.sv.b, a.sv.h, a.sv.t, SM90_TILE);
  if (CARRY)
    mo = mq;  // no o: the kernel never stores through it
  else if (err == cudaSuccess)  // each consumer stores its own 64 rows
    err = sm90::make_bhtd_map(&mo, a.o, a.B, a.H, a.T, D, a.so.b, a.so.h, a.so.t, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_fwd_sm90_kernel<D, CARRY>;
  constexpr int smem = sm90_fwd_smem<D>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long items = (long long)a.B * a.H * ((a.T + SM90_TILE - 1) / SM90_TILE);
  if (items > 0x7fffffffLL - 65536) return cudaErrorInvalidValue;
  const int grid = sm90::persistent_grid((int)items);
  const Carry carry{a.m, a.l, a.acc, a.sml, a.sacc.b, a.sacc.t};
  kernel<<<grid, 384, smem, s>>>(mq, mk, mv, mo, a.lse, next_item, (int)items, a.H, a.T,
                                 a.causal, a.window, carry);
  return cudaGetLastError();
}

// A bf16 operand TMA can address through its (b, h, t) strides: a 16-byte
// aligned base, the t stride and (b, h) strides of extent > 1 multiples of
// 8 elements.
bool tma_operand_ok(const void* p, const Strides& st, const FlashArgs* a) {
  return p != nullptr && (uintptr_t)p % 16 == 0 && (a->B == 1 || st.b % 8 == 0) &&
         (a->H == 1 || st.h % 8 == 0) && st.t % 8 == 0;
}

// The Hopper design's operand rules: D = 64 or 128; ``n`` operands (q, k,
// v[, o]) TMA can address.
bool sm90_args_ok(const FlashArgs* a, int n) {
  if (a->D != 64 && a->D != 128) return false;
  const void* ptrs[4] = {a->q, a->k, a->v, a->o};
  const Strides* strides[4] = {&a->sq, &a->sk, &a->sv, &a->so};
  for (int i = 0; i < n; ++i)
    if (!tma_operand_ok(ptrs[i], *strides[i], a)) return false;
  return true;
}

// The Hopper backward's operand rules: D = 64 or 128; q, k, v, do and the
// gradients dq, dk, dv TMA can address (o and lse are read by plain loads);
// the delta scratch given.
bool sm90_bwd_args_ok(const FlashArgs* a) {
  if ((a->D != 64 && a->D != 128) || a->delta == nullptr || a->lse == nullptr) return false;
  const void* ptrs[7] = {a->q, a->k, a->v, a->dout, a->dq, a->dk, a->dv};
  const Strides* strides[7] = {&a->sq, &a->sk, &a->sv, &a->sdo, &a->sdq, &a->sdk, &a->sdv};
  for (int i = 0; i < 7; ++i)
    if (!tma_operand_ok(ptrs[i], *strides[i], a)) return false;
  return true;
}

// delta = rowsum(do * o) - dlse into a.delta
template <typename T, int D>
cudaError_t delta_launch(const FlashArgs& a, cudaStream_t s) {
  const long long rows = (long long)a.B * a.H * a.T;
  flash_delta_kernel<T, D><<<(unsigned)((rows + NW - 1) / NW), NT, 0, s>>>(a, rows);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const FlashArgs& a, cudaStream_t s) {
  constexpr int PAD = 16 / sizeof(T);
  cudaError_t err = delta_launch<T, D>(a, s);
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

// A (B, H, T, D) bf16 operand's map through its strides, ``rows`` rows a box.
#define BHTD_MAP(map, ptr, st, rows)                                                       \
  if (err == cudaSuccess)                                                                  \
  err = sm90::make_bhtd_map(&map, ptr, a.B, a.H, a.T, D, st.b, st.h, st.t, rows)

// The Hopper backward: delta, then flash_dkdv_sm90_kernel and
// flash_dq_sm90_kernel, each persistent with its work counter
// (next_item[0], next_item[1]: int32 in device memory, 0 at the launch).
template <int D>
cudaError_t bwd_sm90(const FlashArgs& a, int* next_item, cudaStream_t s) {
  constexpr int BC = bwd_cols<D>();
  cudaError_t err = delta_launch<bf16, D>(a, s);
  CUtensorMap mq, mk, mv, mdo, mdk, mdv;
  BHTD_MAP(mq, a.q, a.sq, BC);
  BHTD_MAP(mdo, a.dout, a.sdo, BC);
  BHTD_MAP(mk, a.k, a.sk, BWD_ROWS);
  BHTD_MAP(mv, a.v, a.sv, BWD_ROWS);
  BHTD_MAP(mdk, a.dk, a.sdk, 64);
  BHTD_MAP(mdv, a.dv, a.sdv, 64);
  if (err != cudaSuccess) return err;
  const long long bh = (long long)a.B * a.H;
  const long long kv_items = bh * ((a.T + BWD_ROWS - 1) / BWD_ROWS);
  if (kv_items > 0x7fffffffLL - 65536) return cudaErrorInvalidValue;
  auto dkdv = flash_dkdv_sm90_kernel<D>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, dkdv_smem<D>());
  if (err != cudaSuccess) return err;
  dkdv<<<sm90::persistent_grid((int)kv_items), 384, dkdv_smem<D>(), s>>>(
      mq, mk, mv, mdo, mdk, mdv, a.lse, a.delta, next_item, (int)kv_items, a.H, a.T, a.causal,
      a.window);
  err = cudaGetLastError();
  // dq's maps: the 128-query q and do tiles, BC-key K / V tiles
  CUtensorMap mq2, mk2, mv2, mdo2, mdq;
  BHTD_MAP(mq2, a.q, a.sq, BWD_ROWS);
  BHTD_MAP(mdo2, a.dout, a.sdo, BWD_ROWS);
  BHTD_MAP(mk2, a.k, a.sk, BC);
  BHTD_MAP(mv2, a.v, a.sv, BC);
  BHTD_MAP(mdq, a.dq, a.sdq, 64);
  if (err != cudaSuccess) return err;
  auto dq = flash_dq_sm90_kernel<D>;
  err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());
  if (err != cudaSuccess) return err;
  dq<<<sm90::persistent_grid((int)kv_items), 384, dq_smem<D>(), s>>>(
      mq2, mk2, mv2, mdo2, mdq, a.lse, a.delta, next_item + 1, (int)kv_items, a.H, a.T, a.causal,
      a.window);
  return cudaGetLastError();
}

// The Hopper query-major backward: delta, then one CTA per (b, h).
template <int D>
cudaError_t bwd_qmajor_sm90(const FlashArgs& a, cudaStream_t s) {
  constexpr int BC = bwd_cols<D>();
  cudaError_t err = delta_launch<bf16, D>(a, s);
  CUtensorMap mq, mk, mv, mdo, mdq;
  BHTD_MAP(mq, a.q, a.sq, BWD_ROWS);
  BHTD_MAP(mdo, a.dout, a.sdo, BWD_ROWS);
  BHTD_MAP(mk, a.k, a.sk, BC);
  BHTD_MAP(mv, a.v, a.sv, BC);
  BHTD_MAP(mdq, a.dq, a.sdq, 64);
  if (err != cudaSuccess) return err;
  auto kernel = flash_bwd_qmajor_sm90_kernel<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, qmajor_smem<D>());
  if (err != cudaSuccess) return err;
  kernel<<<a.B * a.H, 384, qmajor_smem<D>(), s>>>(
      mq, mk, mv, mdo, mdq, a.lse, a.delta, a.acc, reinterpret_cast<bf16*>(a.dk),
      reinterpret_cast<bf16*>(a.dv), a.sdk, a.sdv, a.H, a.T, a.causal, a.window);
  return cudaGetLastError();
}

#undef BHTD_MAP

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

// The bf16 Hopper forward (flash_fwd_sm90_kernel): D = 64 or 128; q, k, v
// and o with 16-byte aligned bases, t strides and (b, h) strides of extent
// > 1 that are multiples of 8 elements; ``next_item`` one int32 of device memory set to
// 0 (the persistent CTAs' work counter). Returns a cudaError_t (0 =
// launched).
extern "C" int flash_fwd_sm90_launch(const FlashArgs* a, int* next_item, void* stream) {
  if (bad_args(a) || next_item == nullptr || !sm90_args_ok(a, 4)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return a->D == 64 ? fwd_sm90<64, false>(*a, next_item, s) : fwd_sm90<128, false>(*a, next_item, s);
}

// One ring chunk pair: a->m, a->l and a->acc carry the online-softmax state
// in and out (updated in place); o and lse are not touched. ``design`` is
// the wrapper's _block_design: 0 = fp32 (flash_fwd_kernel<float, D, true>),
// 1 = mma_sync (flash_fwd_kernel<bf16, D, true>), 2 = sm90
// (flash_fwd_sm90_kernel<D, true>, bf16 q, k, v that TMA can address, D =
// 64 or 128; ``next_item`` one int32 of device memory set to 0).
extern "C" int flash_block_fwd_launch(const FlashArgs* a, int design, int* next_item,
                                      void* stream) {
  if (bad_args(a) || a->window != 0 || a->m == nullptr || a->l == nullptr ||
      a->acc == nullptr)
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 2) {
    if (next_item == nullptr || !sm90_args_ok(a, 3)) return cudaErrorInvalidValue;
    return a->D == 64 ? fwd_sm90<64, true>(*a, next_item, s) : fwd_sm90<128, true>(*a, next_item, s);
  }
  if (design == 1) return fwd_by_d<bf16, true>(*a, s);
  if (design == 0) return fwd_by_d<float, true>(*a, s);
  return cudaErrorInvalidValue;
}

// Three launches on one stream: delta, dk/dv, dq. ``design`` is the
// wrapper's _bwd_design: 0 = fp32 (flash_dkdv_kernel / flash_dq_kernel
// <float, D>), 1 = mma_sync (the same kernels in bf16), 2 = sm90
// (flash_dkdv_sm90_kernel / flash_dq_sm90_kernel<D>: bf16, D = 64 or 128,
// q, k, v, do, dq, dk, dv TMA can address; ``next_item`` two int32 of
// device memory set to 0). a->delta is the (B, H, T) fp32 scratch.
extern "C" int flash_bwd_launch(const FlashArgs* a, int design, int* next_item, void* stream) {
  if (bad_args(a) || a->delta == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 2) {
    if (next_item == nullptr || !sm90_bwd_args_ok(a)) return cudaErrorInvalidValue;
    return a->D == 64 ? bwd_sm90<64>(*a, next_item, s) : bwd_sm90<128>(*a, next_item, s);
  }
  if (design == 1) return bwd_by_d<bf16>(*a, s);
  if (design == 0) return bwd_by_d<float>(*a, s);
  return cudaErrorInvalidValue;
}

// The query-major backward; ``design`` as flash_bwd_launch's. mma_sync and
// fp32: one launch (flash_bwd_qmajor_kernel, delta formed in the kernel),
// a->acc its (B*H, 2, Tp, D) fp32 scratch, Tp = T rounded up to 64. sm90:
// delta into a->delta, then flash_bwd_qmajor_sm90_kernel<D>, Tp = T rounded
// up to 128.
extern "C" int flash_bwd_qmajor_launch(const FlashArgs* a, int design, void* stream) {
  if (bad_args(a) || a->acc == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (design == 2) {
    if (!sm90_bwd_args_ok(a)) return cudaErrorInvalidValue;
    return a->D == 64 ? bwd_qmajor_sm90<64>(*a, s) : bwd_qmajor_sm90<128>(*a, s);
  }
  if (design == 1) return bwd_qmajor_by_d<bf16>(*a, s);
  if (design == 0) return bwd_qmajor_by_d<float>(*a, s);
  return cudaErrorInvalidValue;
}
