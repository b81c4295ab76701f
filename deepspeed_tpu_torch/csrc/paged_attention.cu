// Paged (blocked-KV) attention for the v2 serving path, CUDA C++ for sm_90a.
//
// Two kernels, each with an extern "C" launcher that returns
// cudaGetLastError() (0 = launched). Launchers never synchronize and never
// allocate: the Python wrapper (ops/cuda/paged_attention.py) allocates the
// output with torch.empty and passes raw pointers and the current stream.
//
// Layouts (the JAX package's, unchanged):
//   pools k/v  (NB, KVH, BS, D)  heads-major, contiguous
//   decode     q (B, H, D), tables (B, MB) i32, lengths (B,) i32 -> out (B, H, D)
//   chunk      q (C, H, D), table (MB,) i32, start/true_len ints -> out (C, H, D)
// Element type: float or __nv_bfloat16 (template T). Scores, softmax state
// and the output accumulator are fp32; p is rounded to T before the PV
// product, exactly as the Pallas kernels do (p.astype(v.dtype)).
//
// paged_decode  replaces deepspeed_tpu/ops/pallas/paged_attention.py
//               _decode_kernel (via paged_decode_attention).
//   One CTA per (slot b, kv head). Its G = H/KVH query heads share every
//   K/V row read (GQA-native, no repeat). A loop inside the CTA walks the
//   table's live blocks (j*BS <= L, and with a window j*BS+BS > L-window+1)
//   and keeps the online-softmax state (m, l, acc) in shared memory: the
//   TPU grid's sequential j axis and its VMEM scratch become that loop.
//   Bound: bytes. It must read K+V = sum_b (L_b+1) * KVH * D * 2 *
//   sizeof(T) once (min(L_b+1, window) positions with a window) at about
//   4*H*D flops per position — far below the card's 295 flop/byte ridge,
//   so the design reads each K/V element once per CTA and nothing else.
//
// paged_chunk   replaces deepspeed_tpu/ops/pallas/paged_attention.py
//               _chunk_kernel (via paged_chunk_attention).
//   One CTA per (q tile of block_c chunk tokens, kv head): its rows are the
//   tile's block_c*G (token, head) pairs, read straight from the (C, H, D)
//   layout (the TPU (KVH, C*G, D) fold and 128-lane m/l scratch are not
//   ported). Rows are processed in sub-tiles of RT (16 or 64); each sub-tile
//   walks the table's live blocks: live = k_lo < start+true_len and
//   k_lo <= q_hi (and k_hi > q_lo - window); a block fully before the
//   diagonal and the limit takes the mask-free path. K/V blocks are staged
//   in shared memory and the two products are SIMT micro-tiles with fp32
//   accumulation.
//   Bound: max(flops / 989 TFLOP/s, bytes / 3.35 TB/s) on an H100 SXM. Each
//   bf16 K/V position costs 4*D bytes per kv head and serves at most C*G
//   query rows at 4*D flops each, so a 256-token chunk is bound by bytes
//   under MHA (G=1: at most 256 flop/byte, below the 295 ridge) and by
//   flops under GQA (G=4, Mistral-7B: up to 1024). This first
//   version runs on the CUDA cores (no wgmma/TMA yet), so it sits well
//   above that bound; tensor cores are later work.
//
// Masks are the Pallas kernels' exactly: NEG_INF = -1e30 for masked scores,
// and the output divides by max(l, 1e-30).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define NEG_INF (-1e30f)

namespace {

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype(bf16)
}

template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------ decode

constexpr int DEC_NT = 128;
constexpr int DEC_NW = DEC_NT / 32;

template <typename T, int D>
__global__ void __launch_bounds__(DEC_NT)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                    const T* __restrict__ vc, const int* __restrict__ tables,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    int H, int KVH, int BS, int MB, float scale, int window,
                    int alibi, float alibi_scale, int alibi_bf16, float alibi_cp) {
  constexpr int VEC = D / 32;  // head-dim elements per lane in the score dot
  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / KVH;
  const int h0 = kvh * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ float smem[];
  float* qs = smem;             // [G][D]
  float* acc = qs + G * D;      // [G][D]
  float* ps = acc + G * D;      // [G][BS] scores, then p
  float* m_s = ps + G * BS;     // [G]
  float* l_s = m_s + G;         // [G]
  float* a_s = l_s + G;         // [G] alpha of the current block

  const int L = lengths[b];
  for (int i = tid; i < G * D; i += DEC_NT) {
    qs[i] = to_f<T>(q[((size_t)b * H + h0) * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += DEC_NT) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  // live blocks: j*BS <= L; with a window also j*BS + BS > L - window + 1
  const int j_hi = min(MB - 1, L / BS);
  int j_lo = 0;
  if (window > 0) {
    const int thr = L - window + 1 - BS;  // live needs j*BS > thr
    j_lo = thr < 0 ? 0 : thr / BS + 1;
  }

  for (int j = j_lo; j <= j_hi; ++j) {
    const int blk = tables[(size_t)b * MB + j];
    const T* kb = kc + ((size_t)blk * KVH + kvh) * BS * D;
    const T* vb = vc + ((size_t)blk * KVH + kvh) * BS * D;

    // scores: one warp per key row, lanes split the head dim
    for (int t = warp; t < BS; t += DEC_NW) {
      float kr[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) kr[e] = to_f<T>(kb[t * D + lane * VEC + e]);
      const int pos = j * BS + t;
      bool ok = pos <= L;
      if (window > 0) ok = ok && (pos > L - window);
      for (int g = 0; g < G; ++g) {
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) s += qs[g * D + lane * VEC + e] * kr[e];
        s = warp_sum(s) * scale;
        if (lane == 0) {
          if (alibi) {
            // bloom slopes from the head index, split at the leading
            // power of two cp (paged_attention.py _decode_kernel)
            const float h = (float)(h0 + g);
            const float expo = h < alibi_cp ? -(h + 1.f) * (8.f / alibi_cp)
                                            : -(2.f * (h - alibi_cp) + 1.f) * (4.f / alibi_cp);
            float ab = exp2f(expo) * (float)pos;
            if (alibi_bf16) ab = __bfloat162float(__float2bfloat16(ab));
            if (alibi_scale != 1.f) ab *= alibi_scale;
            s += ab;
          }
          ps[g * BS + t] = ok ? s : NEG_INF;
        }
      }
    }
    __syncthreads();

    // online softmax: one warp per query head
    for (int g = warp; g < G; g += DEC_NW) {
      float mx = NEG_INF;
      for (int t = lane; t < BS; t += 32) mx = fmaxf(mx, ps[g * BS + t]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < BS; t += 32) {
        const float p = expf(ps[g * BS + t] - m_new);
        sum += p;
        ps[g * BS + t] = round_to<T>(p);
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: each thread owns (g, d) outputs; V rows read coalesced
    for (int i = tid; i < G * D; i += DEC_NT) {
      const int g = i / D, dd = i - g * D;
      float a = acc[i] * a_s[g];
      const float* p = ps + g * BS;
#pragma unroll 8
      for (int t = 0; t < BS; ++t) a += p[t] * to_f<T>(vb[t * D + dd]);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += DEC_NT) {
    const int g = i / D;
    const float l = fmaxf(l_s[g], 1e-30f);
    out[((size_t)b * H + h0) * D + i] = from_f<T>(acc[i] / l);
  }
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

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const int* tables,
                          const int* lengths, void* out, int B, int H, int KVH, int BS,
                          int MB, float scale, int window, int alibi, float alibi_scale,
                          int alibi_bf16, float alibi_cp, cudaStream_t stream) {
  const int G = H / KVH;
  const size_t smem = sizeof(float) * ((size_t)2 * G * D + (size_t)G * BS + 3 * G);
  auto kern = paged_decode_kernel<T, D>;
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(B, KVH), DEC_NT, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, tables, lengths, (T*)out, H, KVH, BS, MB,
      scale, window, alibi, alibi_scale, alibi_bf16, alibi_cp);
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

template <typename T>
cudaError_t decode_by_d(int D, const void* q, const void* k, const void* v,
                        const int* tables, const int* lengths, void* out, int B, int H,
                        int KVH, int BS, int MB, float scale, int window, int alibi,
                        float alibi_scale, int alibi_bf16, float alibi_cp,
                        cudaStream_t s) {
  switch (D) {
    case 32: return launch_decode<T, 32>(q, k, v, tables, lengths, out, B, H, KVH, BS, MB, scale, window, alibi, alibi_scale, alibi_bf16, alibi_cp, s);
    case 64: return launch_decode<T, 64>(q, k, v, tables, lengths, out, B, H, KVH, BS, MB, scale, window, alibi, alibi_scale, alibi_bf16, alibi_cp, s);
    case 128: return launch_decode<T, 128>(q, k, v, tables, lengths, out, B, H, KVH, BS, MB, scale, window, alibi, alibi_scale, alibi_bf16, alibi_cp, s);
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

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = launched).
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const int* tables, const int* lengths, void* out,
                                   int B, int H, int KVH, int D, int BS, int MB,
                                   float scale, int window, int alibi, float alibi_scale,
                                   int alibi_bf16, float alibi_cp, int dtype,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (B <= 0 || KVH <= 0 || H % KVH != 0 || BS <= 0 || MB <= 0) return cudaErrorInvalidValue;
  if (dtype == 1)
    return decode_by_d<__nv_bfloat16>(D, q, k, v, tables, lengths, out, B, H, KVH, BS, MB,
                                      scale, window, alibi, alibi_scale, alibi_bf16,
                                      alibi_cp, s);
  if (dtype == 0)
    return decode_by_d<float>(D, q, k, v, tables, lengths, out, B, H, KVH, BS, MB, scale,
                              window, alibi, alibi_scale, alibi_bf16, alibi_cp, s);
  return cudaErrorInvalidValue;
}

// rt: rows per sub-tile (16 or 64), chosen by the wrapper from block_c * G.
extern "C" int paged_chunk_launch(const void* q, const void* k, const void* v,
                                  const int* table, void* out, int C, int H, int KVH,
                                  int D, int BS, int MB, int start, int true_len,
                                  float scale, int window, int block_c, int rt, int dtype,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (C <= 0 || KVH <= 0 || H % KVH != 0 || BS <= 0 || BS % 16 != 0 ||
      BS > 16 * CH_KJ || MB <= 0 || block_c <= 0 || (rt != 16 && rt != 64))
    return cudaErrorInvalidValue;
  if (dtype == 1)
    return chunk_by_d<__nv_bfloat16>(D, rt, q, k, v, table, out, C, H, KVH, BS, MB, start,
                                     true_len, scale, window, block_c, s);
  if (dtype == 0)
    return chunk_by_d<float>(D, rt, q, k, v, table, out, C, H, KVH, BS, MB, start,
                             true_len, scale, window, block_c, s);
  return cudaErrorInvalidValue;
}
