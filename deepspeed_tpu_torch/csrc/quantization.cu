// Blockwise symmetric int8 quantization (K12), CUDA C++ for sm_90a.
//
// quant_blockwise_kernel   replaces deepspeed_tpu/ops/pallas/quantization.py
//                          _quant_kernel (via quantize_blockwise, :60/:82).
// dequant_blockwise_kernel replaces _dequant_kernel (via
//                          dequantize_blockwise, :69/:123).
//
// Layout: the input is R rows of P elements (row stride `ld` elements, the
// elements of a row contiguous); each row is cut into nb = ceil(P / block)
// blocks of `block` elements, the last one padded with zeros, so block b of
// the output is (row b / nb, piece b % nb). R = 1 is the JAX flat layout;
// R > 1 quantizes each destination piece of a reduce-scatter on its own, as
// the JAX package's vmap over pieces does (quantization.py:300-325), in one
// launch. Codes are (R * nb, block) int8, scales (R * nb) fp32.
//
// Arithmetic, bitwise equal to the Pallas kernel and to the jnp path as XLA
// compiles them (quantization.py:60-73, :111-114):
//   absmax = max |x| over the block, x cast to fp32 first;
//   scale  = absmax > 0 ? absmax * (1/127) : 1   (XLA folds the division by
//            the constant 127 into a product with its fp32 reciprocal;
//            eager jnp divides, and differs from the compiled programs by
//            an ulp in some blocks)
//   q      = clamp(rint(x / scale), -127, 127)    (IEEE division, round half
//                                                   to even, like jnp.round)
//   dequant: (float)q * scale, cast to the output type (round to nearest
//   even); with `sum`, the R rows' dequantized values are added into one
//   row as acc = fma(q_r, scale_r, acc) from acc = 0, row by row: XLA fuses
//   the JAX reduce-scatter's dequantize into its sum over pieces
//   (quantization.py:321-325) and contracts each step into an fma.
// The builder passes no fast-math flag; __fdiv_rn / __fmul_rn pin the
// rounding; the max is exact in any order.
//
// quant: one CTA of 256 threads per block: each thread takes every 256th
//   element (coalesced), the CTA reduces |x| max by warp shuffles and shared
//   memory, then each thread reads its elements again (an L1/L2 hit) and
//   writes the codes. dequant: the same CTA per block, each thread writing
//   every 256th element of it (with `sum`: one CTA per block of one row,
//   each element a loop over the R rows — the reference's
//   dequantize-then-reduce, quant_reduce.cu, in one pass).
// Bound: bytes. Both read and write each element once (quant: 4 or 2 bytes
//   in, 1 byte + 4 bytes per block out; dequant: 1 byte in, 4 or 2 out), with
//   a handful of operations each, far below the card's ridge. Scalar loads;
//   vector loads and more blocks per CTA are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

template <typename T>
__global__ void __launch_bounds__(NT)
    quant_blockwise_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                           float* __restrict__ s, long long P, long long ld, int nb, int block) {
  __shared__ float red[NT / 32];
  const long long b = blockIdx.x;
  const long long row = b / nb;
  const long long e0 = (b - row * nb) * (long long)block;  // first element of the block in its row
  const T* xr = x + row * ld;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float amax = 0.f;
  for (int i = threadIdx.x; i < block; i += NT) {
    const long long e = e0 + i;
    if (e < P) amax = fmaxf(amax, fabsf(to_f<T>(xr[e])));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  amax = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) amax = fmaxf(amax, red[w]);
  const float scale = amax > 0.f ? __fmul_rn(amax, 1.f / 127.f) : 1.f;
  if (threadIdx.x == 0) s[b] = scale;

  int8_t* qb = q + b * (long long)block;
  for (int i = threadIdx.x; i < block; i += NT) {
    const long long e = e0 + i;
    const float v = e < P ? to_f<T>(xr[e]) : 0.f;
    const float r = fminf(fmaxf(rintf(__fdiv_rn(v, scale)), -127.f), 127.f);
    qb[i] = (int8_t)r;
  }
}

template <typename T, bool SUM>
__global__ void __launch_bounds__(NT)
    dequant_blockwise_kernel(const int8_t* __restrict__ q, const float* __restrict__ s,
                             T* __restrict__ out, long long R, long long P, int nb, int block) {
  const long long b = blockIdx.x;  // SUM: block j of the one output row
  const long long row = SUM ? 0 : b / nb;
  const long long e0 = (b - row * nb) * (long long)block;
  const int len = (int)min((long long)block, P - e0);
  T* orow = out + row * P + e0;
  if (SUM) {
    for (int i = threadIdx.x; i < len; i += NT) {
      float acc = 0.f;
      for (long long r = 0; r < R; ++r) {
        const long long br = r * nb + b;
        acc = __fmaf_rn((float)q[br * block + i], s[br], acc);
      }
      orow[i] = from_f<T>(acc);
    }
  } else {
    const float sc = s[b];
    const int8_t* qb = q + b * (long long)block;
    for (int i = threadIdx.x; i < len; i += NT) orow[i] = from_f<T>(__fmul_rn((float)qb[i], sc));
  }
}

template <typename T>
int quant(const void* x, void* q, float* s, long long R, long long P, long long ld, int block,
          cudaStream_t st) {
  const long long nb = (P + block - 1) / block;
  const long long blocks = R * nb;
  if (blocks == 0) return 0;
  if (blocks > 2147483647LL || nb > 2147483647LL) return (int)cudaErrorInvalidValue;
  quant_blockwise_kernel<T><<<(unsigned)blocks, NT, 0, st>>>(
      reinterpret_cast<const T*>(x), reinterpret_cast<int8_t*>(q), s, P, ld, (int)nb, block);
  return (int)cudaGetLastError();
}

template <typename T>
int dequant(const void* q, const float* s, void* out, long long R, long long P, int block,
            int sum, cudaStream_t st) {
  const long long nb = (P + block - 1) / block;
  const long long grid = sum ? nb : R * nb;
  if (sum && R == 0) return (int)cudaErrorInvalidValue;
  if (grid == 0) return 0;
  if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int8_t* qq = reinterpret_cast<const int8_t*>(q);
  if (sum)
    dequant_blockwise_kernel<T, true><<<(unsigned)grid, NT, 0, st>>>(
        qq, s, reinterpret_cast<T*>(out), R, P, (int)nb, block);
  else
    dequant_blockwise_kernel<T, false><<<(unsigned)grid, NT, 0, st>>>(
        qq, s, reinterpret_cast<T*>(out), R, P, (int)nb, block);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16. Returns a cudaError_t
// (0 = launched). x: R rows of P elements, row stride ld; q: (R * nb, block)
// int8; s: (R * nb) fp32.
extern "C" int quant_blockwise_launch(const void* x, void* q, float* s, long long R, long long P,
                                      long long ld, int block, int dtype, void* stream) {
  if (block <= 0 || R < 0 || P < 0 || ld < P) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return quant<float>(x, q, s, R, P, ld, block, st);
    case 1: return quant<__nv_bfloat16>(x, q, s, R, P, ld, block, st);
    case 2: return quant<__half>(x, q, s, R, P, ld, block, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: R rows of P elements, contiguous, of the type `dtype` names; with
// sum != 0, one row of P elements: the R rows' fma-accumulated sum.
extern "C" int dequant_blockwise_launch(const void* q, const float* s, void* out, long long R,
                                        long long P, int block, int sum, int dtype,
                                        void* stream) {
  if (block <= 0 || R < 0 || P < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return dequant<float>(q, s, out, R, P, block, sum, st);
    case 1: return dequant<__nv_bfloat16>(q, s, out, R, P, block, sum, st);
    case 2: return dequant<__half>(q, s, out, R, P, block, sum, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
