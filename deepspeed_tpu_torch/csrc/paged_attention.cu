// Paged (blocked-KV) attention for the v2 serving path, CUDA C++ for sm_90a.
//
// Extern "C" launchers return cudaGetLastError() (0 = launched). They never
// synchronize and never allocate: the Python wrapper
// (ops/cuda/paged_attention.py) allocates the output and the decode's split
// partials with torch.empty and passes raw pointers and the current stream.
//
// Layouts (the JAX package's, unchanged):
//   pools k/v  (NB, KVH, BS, D)  heads-major, contiguous
//   decode     q (B, H, D), tables (B, MB) i32, lengths (B,) i32 -> out (B, H, D)
//   chunk      q (C, H, D), table (MB,) i32, start/true_len ints -> out (C, H, D)
// Element type: float or __nv_bfloat16 (template T). Scores, softmax state
// and the output accumulator are fp32; p is rounded to T before the PV
// product, exactly as the Pallas kernels do (p.astype(v.dtype)), and l sums
// the unrounded p.
//
// paged_decode  replaces deepspeed_tpu/ops/pallas/paged_attention.py
//               _decode_kernel (via paged_decode_attention): split decode.
//   Bound: bytes. It must read K+V of every valid position once (sum_b
//   (L_b+1) * KVH * D * 2 * sizeof(T); min(L_b+1, window) positions with a
//   window) at 4*H*D flops per position: far below the card's 295
//   flop/byte ridge. So the design's one aim is to keep HBM busy:
//   - grid (S, KVH, B): each CTA (4 warps) takes one contiguous run of bps
//     table blocks of one slot and kv head (a split). S = ceil(MB / bps)
//     and bps come from the table's shape (the wrapper's decode_splits),
//     never from lengths: no host sync. The split's valid positions
//     [lo, hi) (pos <= L, pos > L - window, inside the table) are computed
//     in the CTA; a split with none writes an empty partial (m = -1e30,
//     l = 0, acc = 0) and exits;
//   - the valid positions stream in steps of 64 (16 keys a warp) through a
//     3-step ring of shared memory filled by 16-byte cp.async (each row is
//     one (block, kv head, position) row of the pool, found through the
//     split's table entries, staged once in shared memory), so two steps'
//     K and V are in flight while one is scored; rows past hi are zero;
//   - the G = H / KVH query heads of the kv head (up to 16 a CTA: the m16
//     rows of mma.sync m16n8k16, heads past G zero) share every K/V read;
//     bf16 keeps q's A fragments in registers, the scores' accumulator
//     becomes PV's A fragment (p rounded to bf16) and V's B fragments come
//     by ldmatrix.trans from rows padded by 16 bytes (no bank conflicts);
//     fp32 (the parity checks) runs scalar FMAs in the same fragment
//     layout (attention_tiles.cuh);
//   - the online softmax is the JAX kernel's with a step of 64 positions
//     in place of a block: the four warps exchange their rows' maxima
//     through shared memory once a step, so (m, l, acc) are the split's
//     own; at the end the warps' acc and l are summed in warp order and
//     written as the split's fp32 partial (acc (B, H, S, D), m and l
//     (B, H, S)).
//   paged_decode_merge_kernel folds a (slot, head)'s S partials in split
//   order: m* = max m_s, l = sum l_s e^(m_s - m*), acc likewise, out =
//   acc / max(l, 1e-30) rounded once to T. No atomics: calls repeat
//   bitwise. A table of one split (S = 1) skips the merge: its CTA writes
//   the output itself (the same arithmetic: e^0 = 1).
//
// paged_chunk   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//               _chunk_kernel (via paged_chunk_attention). Its math, not
//   its layout (the TPU (KVH, C*G, D) fold and 128-lane m/l scratch are not
//   ported): the C queries of one sequence at positions start .. start + C
//   - 1 attend over the keys the table names; a key is real below start +
//   true_len, causal at kpos <= qpos, inside the window at kpos > qpos -
//   window; s = (q.k) * scale in fp32, masked -1e30; p = exp(s - m), l
//   sums the unrounded p, PV takes p rounded to T; out = acc / max(l,
//   1e-30), rounded once. The wrapper's _chunk_design picks one of three
//   designs (paged_chunk_launch's design code):
//   sm90 (bf16, D = 64 or 128, BS = 64 or 128): paged_chunk_sm90_kernel<D>,
//     K1's Hopper forward (flash_attention.cu flash_fwd_sm90_kernel, on
//     sm90_attention.cuh) on a paged producer. An item is 128 rows of the
//     JAX fold of one kv head (row r = chunk token t0 + r / G, head kvh G +
//     r % G): q comes by TMA from a map over (C, H, D) as (D, H, C) with a
//     box of (64 d, G heads, 128 / G tokens), which lands the rows in the
//     fold's order with no copy; the output goes out from the fragments
//     (bf16 pairs; rows of tokens past C are not written). Warp 0 of
//     the producer walks the item's live table blocks, holding 32 entries
//     at a time in its lanes' registers, and lane 0 TMA-loads each block's
//     K and V from maps over the pools as (D, BS, KVH, NB) at (64 half, 0,
//     kvh, table[j]) into a 128-key stage (two blocks at BS = 64; two
//     64-wide halves at D = 128), 4 stages at D = 64, 3 at D = 128. The
//     walk visits the blocks from the one holding the item's first live
//     key (the window's start) to the one holding its last (the causal
//     diagonal or the limit); a block of the last tile past the walk reads
//     a valid entry whose keys are all masked. Two consumer warpgroups own
//     64 rows each: S = Q K^T by wgmma m64n128k16 (both K-major) while the
//     previous tile's O += P V (P in registers, V MN-major) runs, then the
//     online softmax on the fp32 fragments with the raw maxima and the
//     scale inside the exp's FMA (p = ex2(s sl2e - m sl2e), sl2e = scale
//     log2 e: q is never scaled in bf16); only tiles the diagonal, the
//     limit or the window cut build the per-element mask, and a row with
//     nothing live so far takes p = 0. Filling the card: a 256-token chunk
//     is KVH ceil(C G / 128) = 64 items (Llama-2-7B's MHA and Mixtral's G =
//     4 alike) on 132 SMs, persistent, longest walks first; where the
//     longest walk has at least 16 tiles (a chunk deep into a long prompt)
//     the wrapper (chunk_splits, from the shape and the host's start /
//     true_len) cuts each walk into S runs, each unit's fp32 (m, l, acc)
//     written unnormalized and paged_chunk_merge_kernel folding them in
//     split order: no atomics, calls repeat bitwise. At Llama-2-7B's
//     start-1000 chunk the split's partial round trip and second launch
//     cost more than the idle SMs (chip_smoke.py phase 2 times both).
//   simt (other bf16: D = 32, other block sizes) and fp32 (the parity
//     checks): paged_chunk_kernel<T, D, RT>, one CTA per (q tile of
//     block_c chunk tokens, kv head), rows in sub-tiles of RT (16 or 64)
//     walking the table's live blocks (live = k_lo < start + true_len and
//     k_lo <= q_hi, and k_hi > q_lo - window; a block fully before the
//     diagonal and the limit takes the mask-free path), K/V staged in
//     shared memory, both products SIMT micro-tiles on the CUDA cores.
//   Bound: max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) on an H100 SXM. Each
//   bf16 K/V position costs 4*D bytes per kv head and serves at most C*G
//   query rows at 4*D flops each, so a 256-token chunk is bound by bytes
//   under MHA (G=1: at most 256 flop/byte, below the 295 ridge) and by
//   flops under GQA (G=4, Mistral-7B: up to 1024).
//
// Masks are the Pallas kernels' exactly: NEG_INF = -1e30 for masked scores,
// and the output divides by max(l, 1e-30).

#include "attention_tiles.cuh"
#include "sm90_attention.cuh"

struct DecodeArgs {
  const void* q;        // (B, H, D)
  const void* k;        // (NB, KVH, BS, D) pools, 16-byte aligned
  const void* v;
  const int* tables;    // (B, MB)
  const int* lengths;   // (B,)
  void* out;            // (B, H, D) in q's dtype
  float* part;          // S > 1: acc (B, H, S, D), then m (B, H, S), then l (B, H, S)
  int B, H, KVH, BS, MB;
  int S, bps;           // splits, table blocks a split
  float scale;
  int window, alibi;
  float alibi_scale;
  int alibi_bf16;
  float alibi_cp;       // leading power of two of H (the bloom slopes)
};

namespace {

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ decode

constexpr int DEC_NT = 128;   // 4 warps
constexpr int DEC_STEP = 64;  // cache positions a pipeline step: 16 keys a warp
constexpr int DEC_NST = 3;    // ring depth in steps
constexpr int DEC_HG = 16;    // query heads a CTA: the m16 rows of the products

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                              uint32_t& r3, const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The CTA's 16 query rows (q, [16][ld] in shared memory, rows past G zero)
// and the scores of one warp's 16 keys ks [16][ld]: s[n][e] in the m16n8
// accumulator layout (keys 8n .. 8n + 7).
template <typename T, int D> struct QTile;

template <int D> struct QTile<bf16, D> {  // q's A fragments, held in registers
  uint32_t a[D / 16][4];
  __device__ __forceinline__ void load(const bf16* qs, int ld) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < D / 16; ++k) {
      a[k][0] = ld32(qs + g * ld + 16 * k + 2 * t);
      a[k][1] = ld32(qs + (g + 8) * ld + 16 * k + 2 * t);
      a[k][2] = ld32(qs + g * ld + 16 * k + 8 + 2 * t);
      a[k][3] = ld32(qs + (g + 8) * ld + 16 * k + 8 + 2 * t);
    }
  }
  __device__ __forceinline__ void scores(float (&s)[2][4], const bf16* ks, int ld) const {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < D / 16; ++k)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const bf16* bp = ks + (n * 8 + g) * ld + 16 * k + 2 * t;
        mma16816(s[n], a[k][0], a[k][1], a[k][2], a[k][3], ld32(bp), ld32(bp + 8));
      }
  }
};

template <int D> struct QTile<float, D> {  // fp32: scalar FMAs from shared q
  const float* qs;
  int ld;
  __device__ __forceinline__ void load(const float* q, int l) {
    qs = q;
    ld = l;
  }
  __device__ __forceinline__ void scores(float (&s)[2][4], const float* ks, int ldk) const {
    mma_nk<2>(s, qs, ld, ks, ldk, D);
  }
};

// o (16 rows x D) += p (16 rows x the warp's 16 keys) v (16 keys x D), vs
// [16][ld]; p in the scores' accumulator layout. bf16: p rounded to bf16
// (round to nearest even) as PV's A fragment, V's B fragments by
// ldmatrix.trans.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[2][4],
                                        const bf16* vs, int ld) {
  const int lane = threadIdx.x & 31;
  const uint32_t a0 = pack_bf16(p[0][0], p[0][1]), a1 = pack_bf16(p[0][2], p[0][3]);
  const uint32_t a2 = pack_bf16(p[1][0], p[1][1]), a3 = pack_bf16(p[1][2], p[1][3]);
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    uint32_t b0, b1, b2, b3;
    ldsm_x4_trans(b0, b1, b2, b3, vs + (lane & 15) * ld + n * 16 + (lane >> 4) * 8);
    mma16816(o[2 * n], a0, a1, a2, a3, b0, b1);
    mma16816(o[2 * n + 1], a0, a1, a2, a3, b2, b3);
  }
}

// fp32: each lane gathers its rows' 16 p values from its quad by shuffles.
template <int D>
__device__ __forceinline__ void pv_tile(float (&o)[D / 8][4], const float (&p)[2][4],
                                        const float* vs, int ld) {
  const int lane = threadIdx.x & 31, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < 16; ++kk) {
    const int src = (lane & ~3) | ((kk & 7) >> 1);
    const float lo = __shfl_sync(0xffffffffu, p[kk >> 3][kk & 1], src);
    const float hi = __shfl_sync(0xffffffffu, p[kk >> 3][2 + (kk & 1)], src);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float b0 = vs[kk * ld + n * 8 + 2 * t], b1 = vs[kk * ld + n * 8 + 2 * t + 1];
      o[n][0] = fmaf(lo, b0, o[n][0]);
      o[n][1] = fmaf(lo, b1, o[n][1]);
      o[n][2] = fmaf(hi, b0, o[n][2]);
      o[n][3] = fmaf(hi, b1, o[n][3]);
    }
  }
}

template <typename T, int D>
__host__ __device__ constexpr int dec_ld() {
  return D + 16 / (int)sizeof(T);  // row pitch: one 16-byte pad
}

template <typename T, int D>
__global__ void __launch_bounds__(DEC_NT) paged_decode_kernel(DecodeArgs a) {
  constexpr int LD = dec_ld<T, D>();
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CH = D / VEC;             // 16-byte chunks a row
  constexpr int RPI = DEC_NT / CH;        // rows a load pass
  constexpr int NP = DEC_STEP / RPI;      // load passes a step
  constexpr int SLOT = 2 * DEC_STEP * LD; // K then V of one step
  static_assert(DEC_NT % CH == 0 && DEC_STEP % RPI == 0, "load mapping");

  const int s = blockIdx.x, b = blockIdx.z;
  const int G = a.H / a.KVH, HC = (G + DEC_HG - 1) / DEC_HG;
  const int kvh = blockIdx.y / HC, g0 = (blockIdx.y - kvh * HC) * DEC_HG;
  const int ng = min(DEC_HG, G - g0), h0 = kvh * G + g0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long row0 = (long long)b * a.H + h0;  // (slot, head) row of query 0
  const long long BH = (long long)a.B * a.H;
  float* pm = a.part + BH * a.S * D;               // split design: (B, H, S) maxima
  float* pl = pm + BH * a.S;                       //                and sums
  T* out = reinterpret_cast<T*>(a.out);

  // the split's valid positions [lo, hi): pos <= L, pos > L - window, and
  // inside both the split's table blocks and the table
  const int L = a.lengths[b];
  const int p0 = s * a.bps * a.BS;
  const int hi = min(min(s * a.bps + a.bps, a.MB) * a.BS, L + 1);
  const int lo = a.window > 0 ? max(p0, L - a.window + 1) : p0;

  if (hi <= lo) {  // nothing live: an empty partial (S = 1: the output is 0)
    for (int i = tid; i < ng * D; i += DEC_NT) {
      const int gg = i / D, d = i - gg * D;
      const long long r = row0 + gg;
      if (a.S == 1) {
        out[r * D + d] = from_f<T>(0.f);
      } else {
        a.part[(r * a.S + s) * D + d] = 0.f;
        if (d == 0) {
          pm[r * a.S + s] = NEG_INF;
          pl[r * a.S + s] = 0.f;
        }
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);                   // [NST][K | V][STEP][LD]
  T* qs = ring + DEC_NST * SLOT;                              // [16][LD]
  float* red = reinterpret_cast<float*>(qs + DEC_HG * LD);   // [2][4 warps][16] step maxima
  int* tbl = reinterpret_cast<int*>(red + 2 * 4 * DEC_HG);  // [bps] the split's blocks

  const T* q = reinterpret_cast<const T*>(a.q);
  for (int i = tid; i < DEC_HG * D; i += DEC_NT) {
    const int gg = i / D, d = i - gg * D;
    qs[gg * LD + d] = gg < ng ? q[(row0 + gg) * D + d] : from_f<T>(0.f);
  }
  for (int i = tid; i < a.bps; i += DEC_NT) {
    const int j = s * a.bps + i;
    tbl[i] = j < a.MB ? a.tables[(long long)b * a.MB + j] : 0;
  }
  __syncthreads();

  // step st: positions lo + 64 st + r, r < 64; this thread stages chunk c16
  // of rows r0, r0 + RPI, ... of K and V (rows at or past hi are zero)
  const T* kc = reinterpret_cast<const T*>(a.k);
  const T* vc = reinterpret_cast<const T*>(a.v);
  const int c16 = tid % CH, r0 = tid / CH;
  auto load_step = [&](int slot, int st) {
    T* kd = ring + slot * SLOT + r0 * LD + c16 * VEC;
    T* vd = kd + DEC_STEP * LD;
    int pos = lo + st * DEC_STEP + r0;
    int jb = pos / a.BS, off = pos - jb * a.BS;
    jb -= s * a.bps;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (pos < hi) {
        const long long src =
            (((long long)tbl[jb] * a.KVH + kvh) * a.BS + off) * D + c16 * VEC;
        cp_async16(kd, kc + src);
        cp_async16(vd, vc + src);
      } else {
        *reinterpret_cast<uint4*>(kd) = make_uint4(0u, 0u, 0u, 0u);
        *reinterpret_cast<uint4*>(vd) = make_uint4(0u, 0u, 0u, 0u);
      }
      kd += RPI * LD;
      vd += RPI * LD;
      pos += RPI;
      for (off += RPI; off >= a.BS; off -= a.BS) ++jb;
    }
  };

  QTile<T, D> qt;
  qt.load(qs, LD);
  // ALiBi slopes of rows g and g + 8 (the bloom formula from the head
  // index, split at the leading power of two cp; paged_attention.py
  // _decode_kernel)
  float slope[2] = {0.f, 0.f};
  if (a.alibi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float hf = (float)(h0 + g + 8 * h), cp = a.alibi_cp;
      const float expo = hf < cp ? -(hf + 1.f) * (8.f / cp) : -(2.f * (hf - cp) + 1.f) * (4.f / cp);
      slope[h] = exp2f(expo);
    }
  }
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f};  // rows g, g + 8

  const int n_steps = (hi - lo + DEC_STEP - 1) / DEC_STEP;
#pragma unroll
  for (int st = 0; st < DEC_NST - 1; ++st) {
    if (st < n_steps) load_step(st, st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    cp_async_wait<DEC_NST - 2>();
    __syncthreads();  // step st landed; slot (st - 1) % NST is free
    {
      const int nxt = st + DEC_NST - 1;
      if (nxt < n_steps) load_step(nxt % DEC_NST, nxt);
      cp_async_commit();
    }
    const T* ks = ring + (st % DEC_NST) * SLOT + warp * 16 * LD;
    const T* vs = ks + DEC_STEP * LD;
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    qt.scores(sc, ks, LD);

    const int pb = lo + st * DEC_STEP + warp * 16 + 2 * t4;  // position of sc[0][0]
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pos = pb + 8 * n + (e & 1), h = e >> 1;
        float v = sc[n][e] * a.scale;
        if (a.alibi) {
          float ab = slope[h] * (float)pos;
          if (a.alibi_bf16) ab = __bfloat162float(__float2bfloat16(ab));
          if (a.alibi_scale != 1.f) ab *= a.alibi_scale;
          v += ab;
        }
        sc[n][e] = pos < hi ? v : NEG_INF;
        mx[h] = fmaxf(mx[h], sc[n][e]);
      }
    float* rb = red + (st & 1) * 4 * DEC_HG;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      if (t4 == 0) rb[warp * DEC_HG + g + 8 * h] = mx[h];
    }
    __syncthreads();  // every warp's row maxima of this step
    float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float m_new = m_run[h];
#pragma unroll
      for (int w = 0; w < 4; ++w) m_new = fmaxf(m_new, rb[w * DEC_HG + g + 8 * h]);
      alpha[h] = expf(m_run[h] - m_new);
      m_run[h] = m_new;
    }
    float p[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        p[n][e] = pb + 8 * n + (e & 1) < hi ? expf(sc[n][e] - m_run[h]) : 0.f;
        ps[h] += p[n][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + ps[h];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    pv_tile<D>(o, p, vs, LD);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the warps' partial acc and l, summed in warp order
  float* ored = reinterpret_cast<float*>(ring);  // [4 warps][16][D]
  float* lred = ored + 4 * DEC_HG * D;           // [4 warps][16]
  float* mrow = lred + 4 * DEC_HG;               // [16]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ored[(warp * DEC_HG + g + 8 * (e >> 1)) * D + 8 * n + 2 * t4 + (e & 1)] = o[n][e];
  if (t4 == 0) {
    lred[warp * DEC_HG + g] = l_run[0];
    lred[warp * DEC_HG + g + 8] = l_run[1];
    if (warp == 0) {
      mrow[g] = m_run[0];
      mrow[g + 8] = m_run[1];
    }
  }
  __syncthreads();
  for (int i = tid; i < ng * D; i += DEC_NT) {
    const int gg = i / D, d = i - gg * D;
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      acc += ored[(w * DEC_HG + gg) * D + d];
      l += lred[w * DEC_HG + gg];
    }
    const long long r = row0 + gg;
    if (a.S == 1) {
      out[r * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
    } else {
      a.part[(r * a.S + s) * D + d] = acc;
      if (d == 0) {
        pm[r * a.S + s] = mrow[gg];
        pl[r * a.S + s] = l;
      }
    }
  }
}

// One (slot, head) row a CTA, one head-dim element a thread: the S
// partials folded in split order.
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_merge_kernel(DecodeArgs a) {
  const long long r = blockIdx.x, BH = (long long)a.B * a.H;
  const int d = threadIdx.x, S = a.S;
  const float* acc_s = a.part + r * S * D + d;
  const float* m_s = a.part + BH * S * D + r * S;
  const float* l_s = m_s + BH * S;
  float m = NEG_INF;
  for (int s = 0; s < S; ++s) m = fmaxf(m, m_s[s]);
  float l = 0.f, acc = 0.f;
  for (int s = 0; s < S; ++s) {
    const float w = expf(m_s[s] - m);
    l += l_s[s] * w;
    acc += acc_s[(long long)s * D] * w;
  }
  reinterpret_cast<T*>(a.out)[r * D + d] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

// ------------------------------------------------------------------- chunk

constexpr int CH_NT = 256;   // 16 x 16 thread grid for the micro-tiles
constexpr int CH_NW = CH_NT / 32;
constexpr int CH_KJ = 8;     // key micro-tile: BS <= 16 * CH_KJ = 128

template <typename T, int D, int RT>
__global__ void __launch_bounds__(CH_NT)
paged_chunk_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ table,
                   T* __restrict__ out, int C, int H, int KVH, int BS, int MB,
                   int start, int true_len, float scale, int window, int BC) {
  constexpr int RI = RT / 16;             // rows per thread
  constexpr int DJ = D / 16;              // head-dim columns per thread (PV)
  constexpr int PAD = 4 / sizeof(T);      // one 32-bit word of row padding
  constexpr int KP = D + PAD;             // padded row pitch of q/K tiles
  const int tile = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KVH;
  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int lane = tid & 31, warp = tid >> 5;
  const int limit = start + true_len;      // keys < limit are real
  const int PP = BS + 1;                   // padded pitch of the score tile
  const int nkj = BS >> 4;

  extern __shared__ float smem[];
  float* ps = smem;                        // [RT][PP] scores, then p
  float* m_s = ps + RT * PP;               // [RT]
  float* l_s = m_s + RT;                   // [RT]
  float* a_s = l_s + RT;                   // [RT]
  T* qs = reinterpret_cast<T*>(a_s + RT);  // [RT][KP]
  T* ks = qs + RT * KP;                    // [BS][KP]
  T* vs = ks + BS * KP;                    // [BS][D]

  const int rows = BC * G;                 // (token, head) rows of the tile
  for (int r0 = 0; r0 < rows; r0 += RT) {
    // this sub-tile's query positions (rows past the tile or past C are
    // computed as zero queries and never stored)
    const int tok_lo = tile * BC + r0 / G;
    const int tok_hi = tile * BC + (min(r0 + RT, rows) - 1) / G;
    const int q_lo = start + tok_lo, q_hi = start + tok_hi;

    for (int i = tid; i < RT * D; i += CH_NT) {
      const int r = i / D, dd = i - r * D;
      const int rr = r0 + r, tok = tile * BC + rr / G;
      T v = from_f<T>(0.f);
      if (rr < rows && tok < C) v = q[((size_t)tok * H + kvh * G + rr % G) * D + dd];
      qs[r * KP + dd] = v;
    }
    for (int r = tid; r < RT; r += CH_NT) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
    float oacc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int jd = 0; jd < DJ; ++jd) oacc[i][jd] = 0.f;
    __syncthreads();

    for (int j = 0; j < MB; ++j) {
      const int k_lo = j * BS, k_hi = k_lo + BS - 1;
      bool live = (k_lo < limit) && (k_lo <= q_hi);
      if (window > 0) live = live && (k_hi > q_lo - window);
      if (!live) continue;  // uniform across the CTA
      bool full = (k_hi <= q_lo) && (k_hi < limit);
      if (window > 0) full = full && (k_lo > q_hi - window);

      const int blk = table[j];
      const T* kb = kc + ((size_t)blk * KVH + kvh) * BS * D;
      const T* vb = vc + ((size_t)blk * KVH + kvh) * BS * D;
      for (int i = tid; i < BS * D; i += CH_NT) {
        const int t = i / D, dd = i - t * D;
        ks[t * KP + dd] = kb[i];
        vs[i] = vb[i];
      }
      __syncthreads();

      // S = Q K^T: rows tr + 16*i, keys tc + 16*j
      float sacc[RI][CH_KJ];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int kj = 0; kj < CH_KJ; ++kj) sacc[i][kj] = 0.f;
#pragma unroll 4
      for (int dd = 0; dd < D; ++dd) {
        float qv[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = to_f<T>(qs[(tr + 16 * i) * KP + dd]);
#pragma unroll
        for (int kj = 0; kj < CH_KJ; ++kj) {
          if (kj < nkj) {
            const float kv = to_f<T>(ks[(tc + 16 * kj) * KP + dd]);
#pragma unroll
            for (int i = 0; i < RI; ++i) sacc[i][kj] += qv[i] * kv;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = tr + 16 * i;
        const int qpos = start + tile * BC + (r0 + r) / G;
#pragma unroll
        for (int kj = 0; kj < CH_KJ; ++kj) {
          if (kj < nkj) {
            const int t = tc + 16 * kj;
            float s = sacc[i][kj] * scale;
            if (!full) {
              const int kpos = k_lo + t;
              bool ok = (kpos <= qpos) && (kpos < limit);
              if (window > 0) ok = ok && (kpos > qpos - window);
              if (!ok) s = NEG_INF;
            }
            ps[r * PP + t] = s;
          }
        }
      }
      __syncthreads();

      // online softmax: one warp per row
      for (int r = warp; r < RT; r += CH_NW) {
        float mx = NEG_INF;
        for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, ps[r * PP + t]);
        mx = warp_max(mx);
        const float m_prev = m_s[r];
        const float m_new = fmaxf(m_prev, mx);
        float sum = 0.f;
        for (int t = lane; t < BS; t += 32) {
          const float p = expf(ps[r * PP + t] - m_new);
          sum += p;
          ps[r * PP + t] = round_to<T>(p);
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float alpha = expf(m_prev - m_new);
          a_s[r] = alpha;
          l_s[r] = l_s[r] * alpha + sum;
          m_s[r] = m_new;
        }
      }
      __syncthreads();

      // O = O * alpha + P V: rows tr + 16*i, head-dim columns tc + 16*jd
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float a = a_s[tr + 16 * i];
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) oacc[i][jd] *= a;
      }
#pragma unroll 4
      for (int t = 0; t < BS; ++t) {
        float p[RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) p[i] = ps[(tr + 16 * i) * PP + t];
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) {
          const float v = to_f<T>(vs[t * D + tc + 16 * jd]);
#pragma unroll
          for (int i = 0; i < RI; ++i) oacc[i][jd] += p[i] * v;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = tr + 16 * i, rr = r0 + r;
      const int tok = tile * BC + rr / G;
      if (rr < rows && tok < C) {
        const float l = fmaxf(l_s[r], 1e-30f);
        T* o = out + ((size_t)tok * H + kvh * G + rr % G) * D;
#pragma unroll
        for (int jd = 0; jd < DJ; ++jd) o[tc + 16 * jd] = from_f<T>(oacc[i][jd] / l);
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ chunk (Hopper)

constexpr int C90_TILE = 128;               // folded query rows an item, keys a stage
constexpr int C90_HALF = C90_TILE * 128;    // one 64-d half of a 128-row tile: 16 KB
constexpr float C90_LOG2E = 1.4426950408889634f;

// K / V stages: 4 at d = 64, 3 at d = 128 (225 KB with q: the output goes
// out from registers, so no staging tile takes a stage's room)
template <int D>
__host__ __device__ constexpr int c90_stages() {
  return D == 64 ? 4 : 3;
}

template <int D>
constexpr int c90_smem() {
  // q, the K / V ring, barriers; up to 1 KB to align
  return 1024 + (D / 64) * C90_HALF * (1 + 2 * c90_stages<D>()) + (2 * c90_stages<D>() + 2) * 8;
}

struct ChunkArgs {
  const int* table;  // (MB,) int32
  bf16* out;         // (C, H, D)
  int C, H, G, MB, BS;
  int start;
  int kmax;          // keys below min(start + true_len, MB * BS) are real
  int window;
  int nq, items;     // 128-row items a kv head, items in all
  int S;             // key-walk splits an item (S > 1: fp32 partials in part)
  float* part;       // S > 1: acc (items * S, 128, D), then m and l (items * S, 128)
  float sl2e;        // scale * log2(e)
};

// Item w: kv head ``kvh`` and its first chunk token t0 (each head's last,
// longest, item first).
__device__ __forceinline__ void c90_head(const ChunkArgs& a, int w, int& kvh, int& t0) {
  kvh = w / a.nq;
  t0 = (a.nq - 1 - (w - kvh * a.nq)) * (C90_TILE / a.G);
}

// Work unit u = (item u / S, split u % S): the item's kv head, first chunk
// token and query positions [q_lo, q_hi]; its walk of 128 / BS table blocks
// a tile from block ``b_lo``, of which the split takes tiles [i0, i1). An
// item with no live key walks one tile with every score masked (its rows
// come out 0); a split may take no tile (an empty partial).
__device__ __forceinline__ void c90_unit(const ChunkArgs& a, int u, int& kvh, int& t0, int& q_lo,
                                         int& q_hi, int& b_lo, int& i0, int& i1) {
  const int w = u / a.S, z = u - w * a.S;
  const int tt = C90_TILE / a.G;  // chunk tokens an item
  c90_head(a, w, kvh, t0);
  q_lo = a.start + t0;
  q_hi = a.start + min(a.C, t0 + tt) - 1;
  const int k_hi = min(a.kmax, q_hi + 1);
  const int k_lo = a.window > 0 ? max(0, q_lo - a.window + 1) : 0;
  const int bpt = C90_TILE / a.BS;
  int nt = 1;
  b_lo = 0;
  if (k_hi > k_lo) {
    b_lo = k_lo / a.BS;
    nt = ((k_hi + a.BS - 1) / a.BS - b_lo + bpt - 1) / bpt;
  }
  i0 = z * nt / a.S;
  i1 = (z + 1) * nt / a.S;
}

template <int D>
__global__ void __launch_bounds__(384, 1)
    paged_chunk_sm90_kernel(const __grid_constant__ CUtensorMap mq,
                            const __grid_constant__ CUtensorMap mk,
                            const __grid_constant__ CUtensorMap mv, ChunkArgs a) {
  constexpr int HALVES = D / 64;
  constexpr int STAGES = c90_stages<D>();
  constexpr bool PINGPONG = D == 64;
  constexpr int TILE_BYTES = HALVES * C90_HALF;  // a 128-row q, k or v tile
  unsigned char* base = sm90::sm90_smem + ((1024 - (sm90::smem_u32(sm90::sm90_smem) & 1023)) & 1023);
  unsigned char* qs = base;
  unsigned char* ks = qs + TILE_BYTES;           // [STAGES][TILE_BYTES]
  unsigned char* vs = ks + STAGES * TILE_BYTES;  // [STAGES][TILE_BYTES]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + STAGES * TILE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qfull = empty + STAGES;
  uint64_t* qempty = qfull + 1;

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
      // warp 0: its lanes hold 32 table entries at a time (a register
      // window moved along the walk); lane 0 issues the TMA loads
      const int lane = tid, bpt = C90_TILE / a.BS;
      int stage = 0, win = -1 << 30, ent = 0;
      uint32_t phase = 0, qphase = 0;
      for (int u = blockIdx.x; u < a.items * a.S; u += gridDim.x) {
        int kvh, t0, q_lo, q_hi, b_lo, i0, i1;
        c90_unit(a, u, kvh, t0, q_lo, q_hi, b_lo, i0, i1);
        if (i0 == i1) continue;
        if (lane == 0) {
          sm90::mbar_wait(qempty, qphase ^ 1);  // the last item's S products are done
          sm90::mbar_expect_tx(qfull, TILE_BYTES);
#pragma unroll
          for (int hh = 0; hh < HALVES; ++hh)
            sm90::tma_load(qs + hh * C90_HALF, &mq, qfull, 3, 64 * hh, kvh * a.G, t0, 0);
        }
        qphase ^= 1;
        for (int i = i0; i < i1; ++i) {
          int blk[2] = {0, 0};
          for (int b = 0; b < bpt; ++b) {
            const int jb = b_lo + i * bpt + b;
            if (jb - win >= 32 || jb < win) {  // warp-uniform: move the window
              win = jb;
              ent = a.table[min(win + lane, a.MB - 1)];
            }
            // blocks past the table read its last entry: masked keys
            blk[b] = __shfl_sync(0xffffffffu, ent, jb - win);
          }
          if (lane == 0) {
            sm90::mbar_wait(&empty[stage], phase ^ 1);
            sm90::mbar_expect_tx(&full[stage], 2 * TILE_BYTES);
            for (int b = 0; b < bpt; ++b)
#pragma unroll
              for (int hh = 0; hh < HALVES; ++hh) {
                const int off = stage * TILE_BYTES + hh * C90_HALF + b * a.BS * 128;
                sm90::tma_load(ks + off, &mk, &full[stage], 4, 64 * hh, 0, kvh, blk[b]);
                sm90::tma_load(vs + off, &mv, &full[stage], 4, 64 * hh, 0, kvh, blk[b]);
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
    const unsigned char* qa = qs + cw * (C90_HALF / 2);  // this consumer's 64 rows of each half
    float o[D / 2];
    float s[64];      // raw S = q k of the tile in hand (the scale goes into the exp)
    uint32_t pa[32];  // p in bf16 pairs: PV's A fragments, 16-key slice kk in pa[4 kk .. 4 kk + 3]
    float m0, m1, l0, l1;  // m: raw running maxima; l: this thread's partial sums
    int q_lo, q_hi, qp0, qp1;

    auto issue_s = [&](int stg) {
      const unsigned char* kt = ks + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk >> 2) * C90_HALF + (kk & 3) * 32;
        sm90::wgmma_m64n128k16_ss(s, sm90::smem_desc(qa + off, 16, 1024),
                                  sm90::smem_desc(kt + off, 16, 1024), kk > 0);
      }
      sm90::wgmma_commit();
    };
    auto issue_pv = [&](int stg, const uint32_t (&p)[32]) {
      const unsigned char* vt = vs + stg * TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < C90_TILE / 16; ++kk) {
        const uint32_t f[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
        sm90::wgmma_pv<D>(o, f, sm90::smem_desc(vt + kk * 2048, C90_HALF, 1024));
      }
      sm90::wgmma_commit();
    };
    // the online softmax of the tile whose first key is kb0: the mask
    // (causal, the limit, the window) only where it cuts the tile; new raw
    // maxima; p = exp(scale (s - m)) as ex2(s sl2e - m sl2e) into ``p``
    // (bf16 pairs, p.astype(vb.dtype)); the rescale factors and p's
    // unrounded row sums out. A row with nothing live so far (m = NEG_INF)
    // takes p = 0.
    auto softmax = [&](int kb0, uint32_t (&p)[32], float& alpha0, float& alpha1, float& sum0,
                       float& sum1) {
      const bool whole = kb0 + C90_TILE <= a.kmax && kb0 + C90_TILE - 1 <= q_lo &&
                         (a.window == 0 || q_hi - kb0 < a.window);
      if (!whole) {
#pragma unroll
        for (int n = 0; n < 16; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = kb0 + sm90::frag_col(tid, n, e), qp = e < 2 ? qp0 : qp1;
            bool ok = col < a.kmax && col <= qp;
            if (a.window > 0) ok = ok && qp - col < a.window;
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
      alpha0 = sm90::ex2((m0 - n0) * a.sl2e);
      alpha1 = sm90::ex2((m1 - n1) * a.sl2e);
      m0 = n0;
      m1 = n1;
      const float ms0 = m0 == NEG_INF ? 0.f : m0 * a.sl2e;
      const float ms1 = m1 == NEG_INF ? 0.f : m1 * a.sl2e;
      sum0 = sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float p0 = sm90::ex2(fmaf(s[4 * n], a.sl2e, -ms0));
        const float p1 = sm90::ex2(fmaf(s[4 * n + 1], a.sl2e, -ms0));
        const float p2 = sm90::ex2(fmaf(s[4 * n + 2], a.sl2e, -ms1));
        const float p3 = sm90::ex2(fmaf(s[4 * n + 3], a.sl2e, -ms1));
        sum0 += p0 + p1;
        sum1 += p2 + p3;
        p[2 * n] = sm90::pack_bf16(p0, p1);
        p[2 * n + 1] = sm90::pack_bf16(p2, p3);
      }
    };

    // unit u's fp32 partial of this thread's rows r0, r0 + 8 (of the
    // item's 128): its own acc elements, and m, l (the row sums, from the
    // row's first thread)
    auto write_partial = [&](int u, int r0) {
      float* acc = a.part + ((long long)u * C90_TILE + r0) * D;
      float* pm = a.part + (long long)a.items * a.S * C90_TILE * D + (long long)u * C90_TILE;
      float* pl = pm + (long long)a.items * a.S * C90_TILE;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(acc + i * 8 * D + sm90::frag_col(tid, n, 0)) =
              make_float2(o[4 * n + 2 * i], o[4 * n + 2 * i + 1]);
      if ((tid & 3) == 0) {
        pm[r0] = m0;
        pm[r0 + 8] = m1;
        pl[r0] = l0;
        pl[r0 + 8] = l1;
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
    const int bpt = C90_TILE / a.BS;
    for (int u = blockIdx.x; u < a.items * a.S; u += gridDim.x) {
      int kvh, t0, b_lo, i0, i1;
      c90_unit(a, u, kvh, t0, q_lo, q_hi, b_lo, i0, i1);
      // the query positions of this thread's two rows (folded row r is
      // chunk token t0 + r / G)
      const int r0 = 64 * cw + sm90::frag_row(tid, 0);
      qp0 = q_lo + r0 / a.G;
      qp1 = q_lo + (r0 + 8) / a.G;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      if (i0 == i1) {  // a split with no tile: an empty partial
        write_partial(u, r0);
        continue;
      }
      sm90::mbar_wait(qfull, qphase);
      qphase ^= 1;
      float alpha0, alpha1, sum0, sum1;
      sm90::mbar_wait(&full[stage], phase);
      my_turn();
      sm90::wgmma_fence();
      issue_s(stage);
      your_turn();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      if (i0 + 1 == i1 && lane == 0) sm90::mbar_arrive(qempty);  // q read for the last time
      softmax((b_lo + i0 * bpt) * a.BS, pa, alpha0, alpha1, sum0, sum1);
      l0 = sum0;
      l1 = sum1;
      for (int i = i0 + 1; i < i1; ++i) {
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
        if (i + 1 == i1 && lane == 0) sm90::mbar_arrive(qempty);
        uint32_t pn[32];
        softmax((b_lo + i * bpt) * a.BS, pn, alpha0, alpha1, sum0, sum1);
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
        for (int j = 0; j < 32; ++j) pa[j] = pn[j];
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

      // the row sums over the four threads of each row, then acc / max(l,
      // 1e-30) rounded once and stored from the fragments: bf16 pairs, a
      // warp 8 rows x 16 bytes a store (rows of tokens past C not written)
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      if (a.S > 1) {  // the split's fp32 partial, unnormalized
        write_partial(u, r0);
        continue;
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 8 * i, tok = t0 + r / a.G;
        if (tok >= a.C) continue;
        bf16* orow = a.out + ((long long)tok * a.H + kvh * a.G + r % a.G) * D;
        const float inv = i ? inv1 : inv0;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + sm90::frag_col(tid, n, 0)) =
              sm90::pack_bf16(o[4 * n + 2 * i] * inv, o[4 * n + 2 * i + 1] * inv);
      }
    }
    if (cw == 0) my_turn();  // consumer 1's last turn handed back
  }
}

// The S fp32 partials of one folded row (block: item w's row r, one head-dim
// element a thread) folded in split order as paged_decode_merge_kernel folds
// the decode's (the maxima raw, the scale in the exp), rounded once into
// (C, H, D); rows past C are not written.
template <int D>
__global__ void __launch_bounds__(D) paged_chunk_merge_kernel(ChunkArgs a) {
  const int w = blockIdx.x / C90_TILE, r = blockIdx.x - w * C90_TILE, d = threadIdx.x;
  int kvh, t0;
  c90_head(a, w, kvh, t0);
  const int tok = t0 + r / a.G;
  if (tok >= a.C) return;
  const long long rows = (long long)a.items * a.S * C90_TILE;
  const float* acc_s = a.part + ((long long)w * a.S * C90_TILE + r) * D + d;
  const float* m_s = a.part + rows * D + (long long)w * a.S * C90_TILE + r;
  const float* l_s = m_s + rows;
  float m = NEG_INF;
  for (int z = 0; z < a.S; ++z) m = fmaxf(m, m_s[z * C90_TILE]);
  float l = 0.f, acc = 0.f;
  for (int z = 0; z < a.S; ++z) {
    const float wt = sm90::ex2((m_s[z * C90_TILE] - m) * a.sl2e);
    l += l_s[z * C90_TILE] * wt;
    acc += acc_s[(long long)z * C90_TILE * D] * wt;
  }
  a.out[((long long)tok * a.H + kvh * a.G + r % a.G) * D + d] =
      __float2bfloat16(acc / fmaxf(l, 1e-30f));
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int LD = dec_ld<T, D>();
  const size_t smem = sizeof(T) * ((size_t)DEC_NST * 2 * DEC_STEP * LD + (size_t)DEC_HG * LD) +
                      sizeof(float) * 2 * 4 * DEC_HG + sizeof(int) * (size_t)a.bps;
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int HC = (a.H / a.KVH + DEC_HG - 1) / DEC_HG;
  kern<<<dim3(a.S, a.KVH * HC, a.B), DEC_NT, smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  paged_decode_merge_kernel<T, D><<<a.B * a.H, D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, int RT>
cudaError_t launch_chunk(const void* q, const void* k, const void* v, const int* table,
                         void* out, int C, int H, int KVH, int BS, int MB, int start,
                         int true_len, float scale, int window, int BC,
                         cudaStream_t stream) {
  constexpr int PAD = 4 / sizeof(T);
  const size_t smem = sizeof(float) * ((size_t)RT * (BS + 1) + 3 * RT) +
                      sizeof(T) * ((size_t)(RT + BS) * (D + PAD) + (size_t)BS * D);
  auto kern = paged_chunk_kernel<T, D, RT>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  const int n_tiles = (C + BC - 1) / BC;
  kern<<<dim3(n_tiles, KVH), CH_NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, table, (T*)out, C, H, KVH, BS, MB, start,
      true_len, scale, window, BC);
  return cudaGetLastError();
}

// K5's Hopper design: a map over q (C, H, D) as (D, H, C) with a box of
// (64 d, G heads, 128 / G tokens), so a box's rows are the (token, head)
// rows of the JAX fold in its order, and maps over the pools as
// (D, BS, KVH, NB) with a box of one block's 64-wide half; a persistent
// grid of at most one CTA an SM walks the items.
template <int D>
cudaError_t launch_chunk_sm90(const void* q, const void* k, const void* v, const int* table,
                              void* out, int C, int H, int KVH, int BS, int NB, int MB, int start,
                              int true_len, float scale, int window, int splits, float* part,
                              cudaStream_t stream) {
  const int G = H / KVH;
  CUtensorMap mq, mk, mv;
  const long long qdims[3] = {D, H, C}, qstr[2] = {D, (long long)H * D};
  const int qbox[3] = {64, G, C90_TILE / G};
  const long long kdims[4] = {D, BS, KVH, NB};
  const long long kstr[3] = {D, (long long)BS * D, (long long)KVH * BS * D};
  const int kbox[4] = {64, BS, 1, 1};
  cudaError_t err = sm90::make_tiled_map(&mq, q, 3, qdims, qstr, qbox);
  if (err == cudaSuccess) err = sm90::make_tiled_map(&mk, k, 4, kdims, kstr, kbox);
  if (err == cudaSuccess) err = sm90::make_tiled_map(&mv, v, 4, kdims, kstr, kbox);
  if (err != cudaSuccess) return err;
  auto kernel = paged_chunk_sm90_kernel<D>;
  constexpr int smem = c90_smem<D>();
  static bool smem_set = false;  // once: later calls may be captured in a graph
  if (!smem_set) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  ChunkArgs a;
  a.table = table;
  a.out = (bf16*)out;
  a.C = C;
  a.H = H;
  a.G = G;
  a.MB = MB;
  a.BS = BS;
  a.start = start;
  const long long limit = (long long)start + true_len, keys = (long long)MB * BS;
  a.kmax = (int)(limit < keys ? limit : keys);
  a.window = window > 0 ? window : 0;
  a.nq = (C + C90_TILE / G - 1) / (C90_TILE / G);
  const long long items = (long long)KVH * a.nq;
  if (items * splits * C90_TILE > 0x7fffffffLL) return cudaErrorInvalidValue;
  a.items = (int)items;
  a.S = splits;
  a.part = part;
  a.sl2e = scale * C90_LOG2E;
  kernel<<<sm90::persistent_grid(a.items * splits), 384, smem, stream>>>(mq, mk, mv, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  paged_chunk_merge_kernel<D><<<a.items * C90_TILE, D, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t decode_by_d(int D, const DecodeArgs& a, cudaStream_t s) {
  switch (D) {
    case 32: return launch_decode<T, 32>(a, s);
    case 64: return launch_decode<T, 64>(a, s);
    case 128: return launch_decode<T, 128>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int D>
cudaError_t chunk_by_rt(int RT, const void* q, const void* k, const void* v,
                        const int* table, void* out, int C, int H, int KVH, int BS, int MB,
                        int start, int true_len, float scale, int window, int BC,
                        cudaStream_t s) {
  if (RT == 16) return launch_chunk<T, D, 16>(q, k, v, table, out, C, H, KVH, BS, MB, start, true_len, scale, window, BC, s);
  return launch_chunk<T, D, 64>(q, k, v, table, out, C, H, KVH, BS, MB, start, true_len, scale, window, BC, s);
}

template <typename T>
cudaError_t chunk_by_d(int D, int RT, const void* q, const void* k, const void* v,
                       const int* table, void* out, int C, int H, int KVH, int BS, int MB,
                       int start, int true_len, float scale, int window, int BC,
                       cudaStream_t s) {
  switch (D) {
    case 32: return chunk_by_rt<T, 32>(RT, q, k, v, table, out, C, H, KVH, BS, MB, start, true_len, scale, window, BC, s);
    case 64: return chunk_by_rt<T, 64>(RT, q, k, v, table, out, C, H, KVH, BS, MB, start, true_len, scale, window, BC, s);
    case 128: return chunk_by_rt<T, 128>(RT, q, k, v, table, out, C, H, KVH, BS, MB, start, true_len, scale, window, BC, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; D the head dim. S = ceil(MB / bps)
// splits; S > 1 needs a.part (the merge kernel then runs on the same
// stream). Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_launch(const DecodeArgs* a, int D, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (a == nullptr || a->B <= 0 || a->B > 65535 || a->KVH <= 0 || a->H % a->KVH != 0 ||
      a->BS <= 0 || a->MB <= 0 || a->bps <= 0 || a->S != (a->MB + a->bps - 1) / a->bps ||
      (a->S > 1 && a->part == nullptr) ||
      (long long)a->KVH * ((a->H / a->KVH + DEC_HG - 1) / DEC_HG) > 65535)
    return cudaErrorInvalidValue;
  if (dtype == 1) return decode_by_d<bf16>(D, *a, s);
  if (dtype == 0) return decode_by_d<float>(D, *a, s);
  return cudaErrorInvalidValue;
}

// design: 0 = fp32 (paged_chunk_kernel<float>), 1 = simt
// (paged_chunk_kernel<bf16>), 2 = sm90 (paged_chunk_sm90_kernel<D>: bf16,
// D = 64 or 128, BS = 64 or 128, G = H / KVH dividing 64, 16-byte aligned
// q, pools and out, scale > 0; ``splits`` key-walk splits an item, and
// splits > 1 needs ``part``, fp32 (KVH ceil(C G / 128) splits 128 (D + 2))
// for the partials that paged_chunk_merge_kernel folds); any other code is
// refused. NB: the pools' block count. rt: rows per sub-tile of the SIMT kernel (16 or 64), chosen
// by the wrapper from block_c * G (block_c and rt are the SIMT kernel's
// tiles; the sm90 design has its own). Returns a cudaError_t (0 =
// launched).
extern "C" int paged_chunk_launch(const void* q, const void* k, const void* v,
                                  const int* table, void* out, int C, int H, int KVH,
                                  int D, int BS, int NB, int MB, int start, int true_len,
                                  float scale, int window, int block_c, int rt, int design,
                                  int splits, float* part, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 0 || KVH <= 0 || H % KVH != 0 || BS <= 0 || NB <= 0 || MB <= 0 || start < 0 ||
      true_len < 0)
    return cudaErrorInvalidValue;
  if (design == 2) {
    const int G = H / KVH;
    if ((D != 64 && D != 128) || (BS != 64 && BS != 128) || 64 % G != 0 || !(scale > 0.f) ||
        (uintptr_t)q % 16 || (uintptr_t)k % 16 || (uintptr_t)v % 16 || (uintptr_t)out % 16 ||
        splits < 1 || (splits > 1 && (part == nullptr || (uintptr_t)part % 16)))
      return cudaErrorInvalidValue;
    return D == 64 ? launch_chunk_sm90<64>(q, k, v, table, out, C, H, KVH, BS, NB, MB, start,
                                           true_len, scale, window, splits, part, s)
                   : launch_chunk_sm90<128>(q, k, v, table, out, C, H, KVH, BS, NB, MB, start,
                                            true_len, scale, window, splits, part, s);
  }
  if (design != 0 && design != 1) return cudaErrorInvalidValue;
  if (BS % 16 != 0 || BS > 16 * CH_KJ || block_c <= 0 || (rt != 16 && rt != 64))
    return cudaErrorInvalidValue;
  if (design == 1)
    return chunk_by_d<__nv_bfloat16>(D, rt, q, k, v, table, out, C, H, KVH, BS, MB, start,
                                     true_len, scale, window, block_c, s);
  return chunk_by_d<float>(D, rt, q, k, v, table, out, C, H, KVH, BS, MB, start, true_len,
                           scale, window, block_c, s);
}
