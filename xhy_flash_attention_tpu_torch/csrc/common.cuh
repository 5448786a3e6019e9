// Helpers shared by the port's CUDA kernels.
//
// Every kernel source exposes a plain C entry point (no PyTorch headers) that
// launches on the caller's stream and returns cudaGetLastError(); the Python
// wrappers load the shared library with ctypes and raise on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define XFA_EXPORT extern "C" __attribute__((visibility("default")))

namespace xfa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float load_as_float(const void* p, int64_t i, int dt) {
  return dt == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_float(void* p, int64_t i, float v, int dt) {
  if (dt == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; every thread gets the total. `red` holds one
// float per warp. The leading barrier lets a block call this twice in a row.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

}  // namespace xfa
