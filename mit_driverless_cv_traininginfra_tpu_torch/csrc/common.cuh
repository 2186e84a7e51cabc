// Shared helpers of the port's kernels: element types, NaN-propagating
// min/max (jnp.maximum/torch.maximum semantics, unlike fmaxf), block
// reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mdcv {

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round-to-nearest-even, as torch's .to(dtype) does
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a > b ? a : b);
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : (a < b ? a : b);
}

constexpr int kWarp = 32;

// Block-wide sum; every thread gets the result. `scratch` holds one float
// per warp; blockDim.x must be a multiple of 32 (all launches use 256).
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  for (int o = kWarp / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nwarps; ++w) r += scratch[w];
  return r;
}

__device__ __forceinline__ float block_max_nan(float v, float* scratch) {
  for (int o = kWarp / 2; o > 0; o >>= 1)
    v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = max_nan(r, scratch[w]);
  return r;
}

__device__ __forceinline__ unsigned long long block_max_u64(unsigned long long v,
                                                            unsigned long long* scratch) {
  for (int o = kWarp / 2; o > 0; o >>= 1) {
    unsigned long long other = __shfl_xor_sync(0xffffffffu, v, o);
    v = other > v ? other : v;
  }
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nwarps = blockDim.x / kWarp;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  unsigned long long r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = scratch[w] > r ? scratch[w] : r;
  return r;
}

}  // namespace mdcv
