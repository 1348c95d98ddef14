// Shared helpers of the clip_glass_torch CUDA kernels: dtype codes of the
// plain C interface, fp32 conversion of the storage types, packed vectors.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T in one aligned access (16 bytes at the widest).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// Blocks for a grid-stride loop over n items, capped so that a launch
// never exceeds the grid limit.
inline unsigned grid_blocks(int64_t n, int threads, int64_t cap = 1 << 20) {
  int64_t b = (n + threads - 1) / threads;
  if (b > cap) b = cap;
  if (b < 1) b = 1;
  return static_cast<unsigned>(b);
}

}  // namespace cg
