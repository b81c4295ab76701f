// Weight-only quantized projection (K7), CUDA C++ for sm_90a: replaces
// deepspeed_tpu/ops/pallas/mlp_matmul.py _mm_wq_kernel (via _mm_wq and
// wq_matmul). out (M, N) = x (M, K) @ dequant(codes), where the codes are
// int8 (K, N) or int4 packed two per byte along k (K/2, N) and the (1, N)
// fp32 scale multiplies the fp32 accumulator in the epilogue. One GEMM
// over all B*T rows at every shape, decode's 8 rows included (the JAX
// wrapper falls back to its jnp _ref_proj_wq there, the same math). The
// kernel is wq_gemm.cuh's wq_kernel in its dense mode (one weight, E = 1);
// design and bound are noted there. The TPU kernel's x_t / out_t operand
// orientations are layouts, not contracts: the wrapper serves them through
// transposed views.

#include "wq_gemm.cuh"

// dtype: 0 = float32, 1 = bfloat16; bits: 8 or 4 (K even); block_m: 16 or
// 64; WqArgs.group_sizes must be null and E 1. Returns a cudaError_t (0 =
// launched); never synchronizes or allocates.
extern "C" int wq_matmul_launch(const WqArgs* a, int dtype, int bits, int block_m, void* stream) {
  if (a == nullptr || a->group_sizes != nullptr || a->E != 1) return cudaErrorInvalidValue;
  return wq_dispatch<false>(a, dtype, bits, block_m, stream);
}
