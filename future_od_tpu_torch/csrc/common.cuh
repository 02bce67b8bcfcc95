// Shared helpers for the port's Hopper kernels: element conversion between the
// storage type (float or bf16) and the float32 every kernel computes in, and the
// error-string entry point each kernel library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fod {

// Storage-type codes, as ops/_kernels.py::DTYPE_CODES passes them.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_float(T x);

template <>
__device__ __forceinline__ float to_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// The value an intermediate has after a round trip through storage type T.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

}  // namespace fod

extern "C" const char* fod_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
