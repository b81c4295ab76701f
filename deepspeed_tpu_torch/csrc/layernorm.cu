// One-pass LayerNorm forward and backward and the RMSNorm forward (K13),
// CUDA C++ for sm_90a.
//
// ln_fwd_kernel      replaces deepspeed_tpu/ops/pallas/layernorm.py
//                    _ln_fwd_kernel (via _run_fwd):
//   y = (x - mu) * rsqrt(var + eps) * s + b per row of x (N, D), fp32
//   statistics (mu, then the mean of the centred squares, as the TPU
//   kernel), y in x's dtype.
// ln_bwd_kernel +    replace _ln_bwd_kernel (via _run_bwd):
// ln_reduce_kernel     xhat = (x - mu) * rstd, g = dy * s,
//   dx = rstd * (g - mean(g) - xhat * mean(g * xhat)) in x's dtype;
//   dscale = sum over rows of dy * xhat, dbias = sum over rows of dy, fp32
//   sums written in the scale's dtype. The statistics are recomputed from
//   x, never saved.
// rms_fwd_kernel     replaces fused_rmsnorm's _rms_fwd_kernel (layernorm.py
//                    :225, the pallas_call at :245):
//   y = x * rsqrt(mean(x^2) + eps) * s per row, fp32 statistics, y in x's
//   dtype; forward only, as the TPU kernel. The LayerNorm forward's
//   scaffolding with one statistic: one warp a row, the row in registers for
//   D <= 1024 and read again above it.
//
// Design. One warp per row; lane l holds columns 128 c + 4 l .. +3 of
// chunk c, so every load and store is 8 (bf16) or 16 (fp32) contiguous
// bytes per lane and a warp covers 128 columns per instruction. For
// D <= 1024 (CH = D / 128 <= 8, the template argument) the row stays in
// registers between the passes; for larger D (CH = 0) each pass reads the
// row again (the repeat reads hit L1/L2, not device memory). Row sums are
// warp shuffles (xor butterfly: every lane gets the same sum, in a fixed
// order). The TPU kernel accumulates dscale/dbias in a VMEM block carried
// along its sequential grid; here CTAs run in no order, so each CTA of the
// backward sums its own 64 rows (per lane in registers, or per warp in
// shared memory when CH = 0; then across its warps in warp order) into one
// fp32 partial row of (dscale, dbias), and ln_reduce_kernel adds the
// partial rows in CTA order. No floating-point atomics: a run repeats
// bitwise.
//
// Bound: bytes. RMSNorm at the microbenchmark's (8, 1024, 1024) bf16 moves
// 33.6 MB (x in, y out: 0.010 ms at 3.35 TB/s) against ~4 flops an element.
// At the GPT-2 350M training shapes (N = 24 * 1024 rows,
// D = 1024, bf16) the forward moves 100.7 MB (x in, y out: 0.030 ms at
// 3.35 TB/s) and the backward 151 MB (x, dy in, dx out: 0.045 ms) against
// ~10 flops an element. The partial rows add 2 * 4 bytes * D per 64 rows
// (3 % of the backward's bytes at D = 1024).
//
// The extern "C" launchers return cudaGetLastError() (0 = launched); they
// never synchronize or allocate: the caller passes the (n_part, 2, D)
// fp32 partial buffer (ln_bwd_partial_rows gives n_part).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

struct LnArgs {
  const void* x;      // (N, D) contiguous, 16-byte aligned
  const void* scale;  // (D,)
  const void* bias;   // (D,) forward only
  const void* dy;     // (N, D) backward only
  void* out;          // y (forward) or dx (backward), (N, D)
  float* part;        // backward: (n_part, 2, D) fp32 partial rows
  int N, D;
  float eps;
  int s_bf16;         // scale / bias are bf16 (else fp32)
};

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;      // forward: rows in flight per CTA
constexpr int BWD_ROWS = 64;  // backward: rows per CTA (one partial row)
// backward warps per CTA: 8 with the row in registers (D <= 1024); 2 when
// the per-warp sums live in shared memory (2 fp32 a column and warp)
constexpr int BWD_WARPS_REG = 8, BWD_WARPS_SMEM = 2;

// 4 contiguous values <-> fp32: float4 for fp32, uint2 (4 bf16) for bf16
// (a bf16 is the top half of its fp32)
template <typename T> struct Raw4;
template <> struct Raw4<float> { typedef float4 type; };
template <> struct Raw4<bf16> { typedef uint2 type; };

__device__ __forceinline__ void unpack(const float4 t, float (&v)[4]) {
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void unpack(const uint2 t, float (&v)[4]) {
  v[0] = __uint_as_float(t.x << 16);
  v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16);
  v[3] = __uint_as_float(t.y & 0xffff0000u);
}
template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  unpack(*reinterpret_cast<const typename Raw4<T>::type*>(p), v);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}
// scale / bias: fp32 or bf16, independent of x's dtype
__device__ __forceinline__ void load_param(const void* p, int s_bf16, int col, float (&v)[4]) {
  if (s_bf16)
    load4(reinterpret_cast<const bf16*>(p) + col, v);
  else
    load4(reinterpret_cast<const float*>(p) + col, v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row values of chunk c: kept in registers in x's own type (CH > 0), or
// read again from memory (CH = 0).
template <typename T, int CH>
struct Row {
  typedef typename Raw4<T>::type R;
  R raw[CH > 0 ? CH : 1];
  const T* p;
  __device__ __forceinline__ void load(const T* row, int lane) {
    p = row + lane * 4;
    if constexpr (CH > 0) {
#pragma unroll
      for (int c = 0; c < CH; ++c) raw[c] = *reinterpret_cast<const R*>(p + c * 128);
    }
  }
  __device__ __forceinline__ void get(int c, float (&o)[4]) const {
    if constexpr (CH > 0)
      unpack(raw[c], o);
    else
      load4(p + c * 128, o);
  }
};

// mean and rstd of one row, as the TPU kernel: mu = sum(x) / D, then
// var = sum((x - mu)^2) / D
template <typename T, int CH>
__device__ __forceinline__ void row_stats(const Row<T, CH>& x, int chunks, float d, float eps,
                                          float& mu, float& rstd) {
  float s = 0.f;
#pragma unroll
  for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
    float v[4];
    x.get(c, v);
    s += (v[0] + v[1]) + (v[2] + v[3]);
  }
  mu = warp_sum(s) / d;
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
    float v[4];
    x.get(c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = v[e] - mu;
      q = fmaf(d, d, q);
    }
  }
  rstd = rsqrtf(warp_sum(q) / d + eps);
}


template <typename T, int CH>
__global__ void __launch_bounds__(WARPS * 32) ln_fwd_kernel(LnArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= a.N) return;
  const int chunks = a.D / 128;
  const float d = (float)a.D;
  Row<T, CH> x;
  x.load(reinterpret_cast<const T*>(a.x) + row * a.D, lane);
  float mu, rstd;
  row_stats(x, chunks, d, a.eps, mu, rstd);
  T* y = reinterpret_cast<T*>(a.out) + row * a.D + lane * 4;
#pragma unroll
  for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
    float v[4], s[4], b[4];
    x.get(c, v);
    const int col = c * 128 + lane * 4;
    load_param(a.scale, a.s_bf16, col, s);
    load_param(a.bias, a.s_bf16, col, b);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = (v[e] - mu) * rstd * s[e] + b[e];
    store4(y + c * 128, v);
  }
}

template <typename T, int CH>
__global__ void __launch_bounds__(WARPS * 32) rms_fwd_kernel(LnArgs a) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + warp;
  if (row >= a.N) return;
  const int chunks = a.D / 128;
  Row<T, CH> x;
  x.load(reinterpret_cast<const T*>(a.x) + row * a.D, lane);
  float q = 0.f;
#pragma unroll
  for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
    float v[4];
    x.get(c, v);
#pragma unroll
    for (int e = 0; e < 4; ++e) q = fmaf(v[e], v[e], q);
  }
  const float r = rsqrtf(warp_sum(q) / (float)a.D + a.eps);
  T* y = reinterpret_cast<T*>(a.out) + row * a.D + lane * 4;
#pragma unroll
  for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
    float v[4], s[4];
    x.get(c, v);
    load_param(a.scale, a.s_bf16, c * 128 + lane * 4, s);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = v[e] * r * s[e];
    store4(y + c * 128, v);
  }
}

// Each CTA: rows [blockIdx.x * BWD_ROWS, +BWD_ROWS), warp w taking rows
// w, w + W, ...; writes dx and the CTA's partial (dscale, dbias) row.
template <typename T, int CH, int W>
__global__ void __launch_bounds__(W * 32) ln_bwd_kernel(LnArgs a) {
  extern __shared__ float4 smem4[];  // [W][2][D] fp32: each warp's sums
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int D = a.D, chunks = D / 128;
  const float d = (float)D;
  constexpr int NC = CH > 0 ? CH : 1;
  float ds_acc[NC][4], db_acc[NC][4];  // CH > 0: this lane's sums
  float* wacc = smem + (size_t)warp * 2 * D;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) ds_acc[c][e] = db_acc[c][e] = 0.f;
  if constexpr (CH == 0) {
    for (int i = lane * 4; i < 2 * D; i += 128)
      *reinterpret_cast<float4*>(wacc + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const T* xb = reinterpret_cast<const T*>(a.x);
  const T* dyb = reinterpret_cast<const T*>(a.dy);
  T* dxb = reinterpret_cast<T*>(a.out);
  for (int r = 0; r < BWD_ROWS / W; ++r) {
    const long long row = (long long)blockIdx.x * BWD_ROWS + r * W + warp;
    if (row >= a.N) break;
    Row<T, CH> x, dy;
    x.load(xb + row * D, lane);
    dy.load(dyb + row * D, lane);
    float mu, rstd;
    row_stats(x, chunks, d, a.eps, mu, rstd);
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
      float xv[4], gv[4], s[4];
      x.get(c, xv);
      dy.get(c, gv);
      load_param(a.scale, a.s_bf16, c * 128 + lane * 4, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float g = gv[e] * s[e];
        sg += g;
        sgx = fmaf(g, (xv[e] - mu) * rstd, sgx);
      }
    }
    const float mg = warp_sum(sg) / d, mgx = warp_sum(sgx) / d;
    T* dx = dxb + row * D + lane * 4;
#pragma unroll
    for (int c = 0; c < (CH > 0 ? CH : chunks); ++c) {
      float xv[4], gv[4], s[4], o[4], xh[4];
      x.get(c, xv);
      dy.get(c, gv);
      const int col = c * 128 + lane * 4;
      load_param(a.scale, a.s_bf16, col, s);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[e] = (xv[e] - mu) * rstd;
        o[e] = rstd * (gv[e] * s[e] - mg - xh[e] * mgx);
      }
      store4(dx + c * 128, o);
      if constexpr (CH > 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ds_acc[c][e] = fmaf(gv[e], xh[e], ds_acc[c][e]);
          db_acc[c][e] += gv[e];
        }
      } else {  // 16-byte accesses: conflict-free across the warp
        float4* ps = reinterpret_cast<float4*>(wacc + col);
        float4* pb = reinterpret_cast<float4*>(wacc + D + col);
        float4 vs = *ps, vb = *pb;
        vs.x = fmaf(gv[0], xh[0], vs.x);
        vs.y = fmaf(gv[1], xh[1], vs.y);
        vs.z = fmaf(gv[2], xh[2], vs.z);
        vs.w = fmaf(gv[3], xh[3], vs.w);
        vb.x += gv[0];
        vb.y += gv[1];
        vb.z += gv[2];
        vb.w += gv[3];
        *ps = vs;
        *pb = vb;
      }
    }
  }
  if constexpr (CH > 0) {
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      const int col = c * 128 + lane * 4;
      *reinterpret_cast<float4*>(wacc + col) =
          make_float4(ds_acc[c][0], ds_acc[c][1], ds_acc[c][2], ds_acc[c][3]);
      *reinterpret_cast<float4*>(wacc + D + col) =
          make_float4(db_acc[c][0], db_acc[c][1], db_acc[c][2], db_acc[c][3]);
    }
  }
  __syncthreads();
  // the CTA's partial row: the warps' sums added in warp order
  float* part = a.part + (size_t)blockIdx.x * 2 * D;
  for (int i = threadIdx.x; i < 2 * D; i += W * 32) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) s += smem[(size_t)w * 2 * D + i];
    part[i] = s;
  }
}

// out_ds[i] / out_db[i] = sum over the partial rows, in row order. One
// warp per 32 columns of one of the two sums; the warps of a CTA each take
// every WARPS-th partial row, then add their sums in warp order.
__global__ void __launch_bounds__(WARPS * 32) ln_reduce_kernel(const float* part, int n_part,
                                                               int D, void* ds, void* db,
                                                               int s_bf16) {
  __shared__ float red[WARPS][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int which = blockIdx.y;  // 0 = dscale, 1 = dbias
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < D)
    for (int r = warp; r < n_part; r += WARPS) s += part[((size_t)r * 2 + which) * D + col];
  red[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || col >= D) return;
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) t += red[w][lane];
  void* out = which == 0 ? ds : db;
  if (s_bf16)
    reinterpret_cast<bf16*>(out)[col] = __float2bfloat16(t);
  else
    reinterpret_cast<float*>(out)[col] = t;
}

// RMS: the RMSNorm forward, else the LayerNorm forward
template <typename T, int CH, bool RMS>
cudaError_t fwd_ch(const LnArgs& a, cudaStream_t s) {
  const unsigned grid = (unsigned)((a.N + WARPS - 1) / WARPS);
  if constexpr (RMS)
    rms_fwd_kernel<T, CH><<<grid, WARPS * 32, 0, s>>>(a);
  else
    ln_fwd_kernel<T, CH><<<grid, WARPS * 32, 0, s>>>(a);
  return cudaGetLastError();
}

template <typename T, bool RMS>
cudaError_t fwd_t(const LnArgs& a, cudaStream_t s) {
  switch (a.D / 128) {
    case 1: return fwd_ch<T, 1, RMS>(a, s);
    case 2: return fwd_ch<T, 2, RMS>(a, s);
    case 3: return fwd_ch<T, 3, RMS>(a, s);
    case 4: return fwd_ch<T, 4, RMS>(a, s);
    case 5: return fwd_ch<T, 5, RMS>(a, s);
    case 6: return fwd_ch<T, 6, RMS>(a, s);
    case 7: return fwd_ch<T, 7, RMS>(a, s);
    case 8: return fwd_ch<T, 8, RMS>(a, s);
    default: return fwd_ch<T, 0, RMS>(a, s);
  }
}

template <typename T, int CH>
cudaError_t bwd_ch(const LnArgs& a, cudaStream_t s) {
  constexpr int W = CH > 0 ? BWD_WARPS_REG : BWD_WARPS_SMEM;
  const size_t smem = sizeof(float) * (size_t)W * 2 * a.D;
  auto kernel = ln_bwd_kernel<T, CH, W>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned grid = (unsigned)((a.N + BWD_ROWS - 1) / BWD_ROWS);
  kernel<<<grid, W * 32, smem, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_t(const LnArgs& a, cudaStream_t s) {
  switch (a.D / 128) {
    case 1: return bwd_ch<T, 1>(a, s);
    case 2: return bwd_ch<T, 2>(a, s);
    case 3: return bwd_ch<T, 3>(a, s);
    case 4: return bwd_ch<T, 4>(a, s);
    case 5: return bwd_ch<T, 5>(a, s);
    case 6: return bwd_ch<T, 6>(a, s);
    case 7: return bwd_ch<T, 7>(a, s);
    case 8: return bwd_ch<T, 8>(a, s);
    default: return bwd_ch<T, 0>(a, s);
  }
}

bool bad_args(const LnArgs* a) {
  return a == nullptr || a->N <= 0 || a->D <= 0 || a->D % 128 != 0;
}

}  // namespace

// Rows of the fp32 partial buffer the backward needs for N rows.
extern "C" int ln_bwd_partial_rows(int N) { return (N + BWD_ROWS - 1) / BWD_ROWS; }

// Largest D the backward takes: D > 1024 keeps 2 fp32 sums a column for
// each of its 2 warps in shared memory (227 KB).
extern "C" int ln_bwd_max_d() {
  return (int)(227 * 1024 / (sizeof(float) * BWD_WARPS_SMEM * 2)) / 128 * 128;
}

// dtype: 0 = float32, 1 = bfloat16 (x, y). Returns a cudaError_t.
extern "C" int ln_fwd_launch(const LnArgs* a, int dtype, void* stream) {
  if (bad_args(a)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return fwd_t<bf16, false>(*a, s);
  if (dtype == 0) return fwd_t<float, false>(*a, s);
  return cudaErrorInvalidValue;
}

// The RMSNorm forward (a->bias unused). dtype as ln_fwd_launch.
extern "C" int rms_fwd_launch(const LnArgs* a, int dtype, void* stream) {
  if (bad_args(a)) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return fwd_t<bf16, true>(*a, s);
  if (dtype == 0) return fwd_t<float, true>(*a, s);
  return cudaErrorInvalidValue;
}

// dx into a->out, the partial rows into a->part ((ln_bwd_partial_rows(N),
// 2, D) fp32), then dscale / dbias (D,) in the scale's dtype into ds / db.
extern "C" int ln_bwd_launch(const LnArgs* a, int dtype, void* ds, void* db, void* stream) {
  if (bad_args(a) || a->D > ln_bwd_max_d() || a->part == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 1)
    err = bwd_t<bf16>(*a, s);
  else if (dtype == 0)
    err = bwd_t<float>(*a, s);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  const dim3 grid((a->D + 31) / 32, 2);
  ln_reduce_kernel<<<grid, WARPS * 32, 0, s>>>(a->part, ln_bwd_partial_rows(a->N), a->D, ds, db,
                                               a->s_bf16);
  return cudaGetLastError();
}
