// Shared helpers of the port's Hopper kernels (built by ops/_build.py with
// nvcc for sm_90a into one shared library with a plain C interface).
//
// Conventions every kernel follows:
// - element type T is float or __nv_bfloat16; all arithmetic and every
//   accumulation runs in f32, and a value is rounded through T exactly where
//   the JAX reference rounds it to the compute dtype (round_t);
// - one C entry point per kernel, extern "C", taking raw device pointers, the
//   dtype code and the stream, returning cudaGetLastError() after the launch;
// - the kernel allocates nothing: outputs come from the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// return the error of a launch (or of a helper that launches) if it failed
#define LC2_TRY(expr)                 \
  do {                                \
    const cudaError_t e_ = (expr);    \
    if (e_ != cudaSuccess) return e_; \
  } while (0)

namespace lc2 {

enum DType { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t v) { return static_cast<float>(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// f32 value rounded through T (identity for float)
template <typename T>
__device__ __forceinline__ float round_t(float v) { return to_f<T>(from_f<T>(v)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Int8 serving scheme of lc2is_tpu/ops/quant.py: a row's scale is
// max(max|h| / 127, 1e-12) and its codes are round-half-even(h / s), by a
// true division (not a multiply by 1/s); an s8 x s8 product summed exactly is
// dequantised as (acc · s_row) · s_col + bias, left to right, with no fused
// multiply-add, as the reference's f32 ops round.
__device__ __forceinline__ float quant_scale(float absmax) {
  return fmaxf(absmax / 127.0f, 1e-12f);
}

__device__ __forceinline__ int quant_code(float h, float s) { return __float2int_rn(h / s); }

__device__ __forceinline__ float dequant(float acc, float s_row, float s_col, float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(acc, s_row), s_col), bias);
}

// Raise the dynamic shared-memory cap of a kernel above the 48 KB default.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lc2
