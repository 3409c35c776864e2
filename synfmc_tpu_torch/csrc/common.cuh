// Shared helpers for the port's kernels: element conversion and the C ABI.
#pragma once

#include <math.h>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SYNFMC_API extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round through T and back: the value a kernel sees after storing in T.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T> __host__ __device__ constexpr int vec_elems() { return 16 / sizeof(T); }

// Shared-memory row stride (elements) with an odd number of 32-bit words, so
// that rows read one per thread fall on distinct banks.
template <typename T> __host__ __device__ inline int row_stride(int D) {
  const int words = D * (int)sizeof(T) / 4;
  return (words % 2 == 1) ? D : D + 4 / (int)sizeof(T);
}
