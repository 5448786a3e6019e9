// Helpers shared by the port's CUDA kernels.
//
// Every kernel source exposes a plain C entry point (no PyTorch headers) that
// launches on the caller's stream and returns cudaGetLastError(); the Python
// wrappers load the shared library with ctypes and raise on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#define XFA_EXPORT extern "C" __attribute__((visibility("default")))

namespace xfa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES and, for KV
// caches, CACHE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

// The finite mask value of the TPU package (common.py DEFAULT_MASK_VALUE):
// the running max that split-KV partials report for a split that sees no key.
constexpr float kMaskValue = -0.7f * FLT_MAX;

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
// int8 and e4m3 cache payloads convert exactly (Hopper converts e4m3 natively,
// subnormals included)
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

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

// ---- mma.sync m16n8k16 (bf16 in, fp32 accumulate), shared by the attention
// kernels. Fragment layouts (PTX ISA, "mma.m16n8k16"), g = lane / 4,
// t = lane % 4:
//   A (16x16, row-major): a[r] holds row g + (r & 1) * 8, columns
//     (r >> 1) * 8 + 2t and 2t + 1;
//   B (16x8, "col"): b0 holds k = 2t, 2t + 1 of column n = g; b1 k + 8;
//   C (16x8, fp32): c[e] sits at row g + (e >> 1) * 8, column 2t + (e & 1).
// The C fragments of n-tiles 2kk and 2kk + 1 are, packed to bf16, the A
// fragment of k-step kk of a following product (see pack_a).

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two transposed 8x8 bf16 matrices: lanes 0-7 address the rows of the first,
// lanes 8-15 the rows of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The A fragment of k-step kk from fp32 C fragments c[2kk], c[2kk + 1],
// rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

}  // namespace xfa
