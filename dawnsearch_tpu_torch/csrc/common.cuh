// Device helpers shared by the encoder kernels (gemm.cuh, so layer.cu and
// layer_i8.cu, and attention.cu). Each includer gets its own copy (internal
// linkage); the GELU's erf is the reference's, rounded as its twin is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// erf by Abramowitz & Stegun 7.1.26 (|err| <= 1.5e-7), the reference
// kernels' polynomial (dawnsearch_tpu/ops/layer.py:53-59, ops/ffn.py:36-46),
// each operation rounded as the plain twin (ops/ffn.py::erf_poly) rounds
// it: nvcc may contract nothing into an FMA
__device__ __forceinline__ float erf_as(float x) {
  const float a1 = 0.254829592f, a2 = -0.284496736f, a3 = 1.421413741f;
  const float a4 = -1.453152027f, a5 = 1.061405429f, p = 0.3275911f;
  const float ax = fabsf(x);
  const float t = __fdiv_rn(1.0f, __fadd_rn(1.0f, __fmul_rn(p, ax)));
  float poly = __fadd_rn(__fmul_rn(a5, t), a4);
  poly = __fadd_rn(__fmul_rn(poly, t), a3);
  poly = __fadd_rn(__fmul_rn(poly, t), a2);
  poly = __fadd_rn(__fmul_rn(poly, t), a1);
  poly = __fmul_rn(poly, t);
  const float y = __fsub_rn(1.0f, __fmul_rn(poly, expf(-__fmul_rn(ax, ax))));
  return x > 0.0f ? y : (x < 0.0f ? -y : 0.0f);
}

// 0.5·h·(1 + erf(h/√2)), in the reference's order
__device__ __forceinline__ float gelu_as(float h) {
  const float e = erf_as(__fmul_rn(h, 0.70710678118654752f));
  return __fmul_rn(__fmul_rn(0.5f, h), __fadd_rn(1.0f, e));
}

}  // namespace
