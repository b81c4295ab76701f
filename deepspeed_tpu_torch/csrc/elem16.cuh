// The 16-bit element type of the tensor-core paths, shared by
// attention_tiles.cuh and sm90_gemm.cuh: bf16, or fp16 in a library built
// with -DDS_ELEM_F16 (flash_attention.cu's fp16 build, K1 / K2 on fp16
// operands). The kernels call the type bf16 either way; the products' PTX
// operand type (DS_MMA_T), the conversions and the TMA maps' data type
// (DS_TMA_ELEM) follow it. Both types round to nearest even and overflow
// to inf: nothing saturates.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#ifdef DS_ELEM_F16
typedef __half elem16;
#define DS_MMA_T "f16"
#define DS_TMA_ELEM CU_TENSOR_MAP_DATA_TYPE_FLOAT16
__device__ __forceinline__ float elem16_to_f(elem16 x) { return __half2float(x); }
__device__ __forceinline__ elem16 f_to_elem16(float x) { return __float2half_rn(x); }
__device__ __forceinline__ uint32_t elem16_bits(elem16 x) { return __half_as_ushort(x); }
// Two fp32 values as an element pair (lo in the low half).
__device__ __forceinline__ uint32_t pack_elem16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
#else
typedef __nv_bfloat16 elem16;
#define DS_MMA_T "bf16"
#define DS_TMA_ELEM CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
__device__ __forceinline__ float elem16_to_f(elem16 x) { return __bfloat162float(x); }
__device__ __forceinline__ elem16 f_to_elem16(float x) { return __float2bfloat16(x); }
__device__ __forceinline__ uint32_t elem16_bits(elem16 x) { return __bfloat16_as_ushort(x); }
__device__ __forceinline__ uint32_t pack_elem16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
#endif
