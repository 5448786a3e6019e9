// Fused residual add + RMSNorm / LayerNorm forward.
//
// Replaces the TPU kernel xhy_flash_attention_tpu/ops/layer_norm.py:48
// `_ln_fwd_kernel` (forward primal, dropout off):
//
//   resid_out = x0 + residual              (fp32)
//   out       = norm(resid_out) * gamma (+ beta)   in x0's dtype
//
// RMSNorm and LayerNorm come from one template flag; the row reduction runs
// in fp32. resid_out is written only when the caller asks for it (prenorm).
//
// Bound on the H100: bytes. Per row it reads x0 (2 B/elem in bf16), the fp32
// residual (4 B) and writes out (2 B) and the fp32 residual (4 B): about 1.5
// flops per byte, far under the card's ~295 flops/byte balance point.
// Design: one block per row; the row is read from device memory once into
// shared memory in fp32, so the second pass (normalise, scale, store) reads
// shared memory, not device memory. Loads are coalesced (thread i reads
// elements i, i + blockDim, ...). Vector loads and several rows per block
// are left to a later tuning pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool IS_RMS>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const void* __restrict__ x0, int x0_dt, const void* __restrict__ residual,
              int res_dt, const float* __restrict__ gamma, const float* __restrict__ beta,
              void* __restrict__ out, void* __restrict__ resout, int resout_dt, int hidden,
              float eps) {
  extern __shared__ float row[];
  __shared__ float red[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hidden;

  float acc = 0.f;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    float x = xfa::load_as_float(x0, base + i, x0_dt);
    if (residual != nullptr) x += xfa::load_as_float(residual, base + i, res_dt);
    if (resout != nullptr) xfa::store_from_float(resout, base + i, x, resout_dt);
    row[i] = x;
    acc += IS_RMS ? x * x : x;
  }
  const float total = xfa::block_sum(acc, red);
  float mean = 0.f, var;
  if (IS_RMS) {
    var = total / hidden;
  } else {
    mean = total / hidden;
    float sq = 0.f;
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      const float c = row[i] - mean;
      sq += c * c;
    }
    var = xfa::block_sum(sq, red) / hidden;
  }
  const float rstd = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    float y = (row[i] - mean) * rstd * gamma[i];
    if (beta != nullptr) y += beta[i];
    xfa::store_from_float(out, base + i, y, x0_dt);
  }
}

template <bool IS_RMS>
cudaError_t launch(const void* x0, int x0_dt, const void* residual, int res_dt,
                   const float* gamma, const float* beta, void* out, void* resout,
                   int resout_dt, int64_t rows, int hidden, float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(hidden) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ln_fwd_kernel<IS_RMS>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ln_fwd_kernel<IS_RMS><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      x0, x0_dt, residual, res_dt, gamma, beta, out, resout, resout_dt, hidden, eps);
  return cudaGetLastError();
}

}  // namespace

// residual, beta and resout may be null. gamma and beta are fp32.
XFA_EXPORT int xfa_ln_fwd(const void* x0, int x0_dt, const void* residual, int res_dt,
                          const void* gamma, const void* beta, void* out, void* resout,
                          int resout_dt, int64_t rows, int hidden, float eps, int is_rms,
                          void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_rms ? launch<true>(x0, x0_dt, residual, res_dt, g, b, out, resout,
                                          resout_dt, rows, hidden, eps, s)
                           : launch<false>(x0, x0_dt, residual, res_dt, g, b, out, resout,
                                           resout_dt, rows, hidden, eps, s);
  return static_cast<int>(err);
}
