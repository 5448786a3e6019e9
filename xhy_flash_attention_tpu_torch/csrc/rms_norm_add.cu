// Fused residual add + RMSNorm / LayerNorm, forward and backward.
//
// Forward: replaces the TPU kernel xhy_flash_attention_tpu/ops/layer_norm.py:48
// `_ln_fwd_kernel` (dropout off):
//
//   resid_out = x0 + residual              (fp32 or x0's dtype)
//   out       = norm(resid_out) * gamma (+ beta)   in x0's dtype
//   mu, rstd  = the row's mean (LayerNorm) and 1 / sqrt(var + eps), fp32
//
// RMSNorm and LayerNorm come from one template flag; the row reduction runs
// in fp32. resid_out, mu and rstd are written only when the caller asks for
// them (prenorm; training saves all three, as the TPU kernel's save_stats).
//
// Backward: replaces layer_norm.py:102 `_ln_bwd_kernel` (kernel #8):
//
//   xhat = (resid_out - mu) * rstd,  dy = dout * gamma
//   dres = (dy - xhat * mean(dy * xhat) - mean(dy)) * rstd  (+ dres_in)
//
// (RMSNorm: no mean terms), written as dx0 in x0's dtype and, where the
// forward had a residual, as dresidual in its dtype; dgamma = sum(dout * xhat)
// and dbeta = sum(dout) leave as fp32 partials, one row per block of rows,
// which the caller sums in a fixed order (as XLA sums the TPU kernel's
// partials, layer_norm.py:325-333): no atomics, so the result is
// deterministic.
//
// Bound on the H100: bytes. Forward per element: x0 (2 B in bf16), the fp32
// residual (4 B) in, out (2 B) and the fp32 residual (4 B) out; backward:
// dout (2 B), resid_out (4 B), dres_in (4 B) in, dx0 (2 B) and dres (4 B)
// out. About 1.5 flops per byte, far under the card's ~295 flops/byte
// balance point. Design: forward, one block per row, the row read once into
// shared memory in fp32; backward, one block per group of rows, xhat and dy
// kept in shared memory between the reduction and the write pass, and the
// block's dgamma/dbeta partials in shared memory, each column owned by one
// thread. Loads are coalesced (thread i reads elements i, i + blockDim, ...).
// Vector loads are left to a later tuning pass.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <bool IS_RMS>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const void* __restrict__ x0, int x0_dt, const void* __restrict__ residual,
              int res_dt, const float* __restrict__ gamma, const float* __restrict__ beta,
              void* __restrict__ out, void* __restrict__ resout, int resout_dt,
              float* __restrict__ mu_out, float* __restrict__ rstd_out, int hidden, float eps) {
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
  if (threadIdx.x == 0) {
    if (mu_out != nullptr) mu_out[blockIdx.x] = mean;
    if (rstd_out != nullptr) rstd_out[blockIdx.x] = rstd;
  }
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    float y = (row[i] - mean) * rstd * gamma[i];
    if (beta != nullptr) y += beta[i];
    xfa::store_from_float(out, base + i, y, x0_dt);
  }
}

template <bool IS_RMS>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const void* __restrict__ dout, int dout_dt, const void* __restrict__ dres_in,
              int dres_in_dt, const void* __restrict__ resout, int resout_dt,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const float* __restrict__ gamma, void* __restrict__ dx0, int dx0_dt,
              void* __restrict__ dres, int dres_dt, float* __restrict__ dgamma_part,
              float* __restrict__ dbeta_part, int64_t rows, int hidden, int rows_per_block) {
  // xhat, dy of the current row, then this block's dgamma and dbeta partials;
  // thread i owns columns i, i + kThreads, ... of all four
  extern __shared__ float smem[];
  float* xhat_s = smem;
  float* dy_s = xhat_s + hidden;
  float* dg_s = dy_s + hidden;
  float* db_s = dg_s + hidden;
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < hidden; i += kThreads) dg_s[i] = db_s[i] = 0.f;

  const int64_t r_begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t r_end = r_begin + rows_per_block < rows ? r_begin + rows_per_block : rows;
  for (int64_t r = r_begin; r < r_end; ++r) {
    const int64_t base = r * hidden;
    const float m = IS_RMS ? 0.f : mu[r];
    const float rs = rstd[r];
    float a_xy = 0.f, a_y = 0.f;
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      const float xh = (xfa::load_as_float(resout, base + i, resout_dt) - m) * rs;
      const float g_out = xfa::load_as_float(dout, base + i, dout_dt);
      const float dy = g_out * gamma[i];
      xhat_s[i] = xh;
      dy_s[i] = dy;
      dg_s[i] += g_out * xh;
      db_s[i] += g_out;
      a_xy += dy * xh;
      a_y += dy;
    }
    const float c1 = xfa::block_sum(a_xy, red) / hidden;
    const float c2 = IS_RMS ? 0.f : xfa::block_sum(a_y, red) / hidden;
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      float d = IS_RMS ? (dy_s[i] - xhat_s[i] * c1) * rs
                       : (dy_s[i] - xhat_s[i] * c1 - c2) * rs;
      if (dres_in != nullptr) d += xfa::load_as_float(dres_in, base + i, dres_in_dt);
      if (dres != nullptr) xfa::store_from_float(dres, base + i, d, dres_dt);
      xfa::store_from_float(dx0, base + i, d, dx0_dt);
    }
  }
  const int64_t part = static_cast<int64_t>(blockIdx.x) * hidden;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    dgamma_part[part + i] = dg_s[i];
    if (dbeta_part != nullptr) dbeta_part[part + i] = db_s[i];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool IS_RMS>
cudaError_t launch_fwd(const void* x0, int x0_dt, const void* residual, int res_dt,
                       const float* gamma, const float* beta, void* out, void* resout,
                       int resout_dt, float* mu, float* rstd, int64_t rows, int hidden,
                       float eps, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(hidden) * sizeof(float);
  cudaError_t err = allow_smem(ln_fwd_kernel<IS_RMS>, smem);
  if (err != cudaSuccess) return err;
  ln_fwd_kernel<IS_RMS><<<static_cast<unsigned>(rows), kThreads, smem, stream>>>(
      x0, x0_dt, residual, res_dt, gamma, beta, out, resout, resout_dt, mu, rstd, hidden, eps);
  return cudaGetLastError();
}

template <bool IS_RMS>
cudaError_t launch_bwd(const void* dout, int dout_dt, const void* dres_in, int dres_in_dt,
                       const void* resout, int resout_dt, const float* mu, const float* rstd,
                       const float* gamma, void* dx0, int dx0_dt, void* dres, int dres_dt,
                       float* dgamma_part, float* dbeta_part, int64_t rows, int hidden,
                       int rows_per_block, cudaStream_t stream) {
  const size_t smem = 4 * static_cast<size_t>(hidden) * sizeof(float);
  cudaError_t err = allow_smem(ln_bwd_kernel<IS_RMS>, smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  ln_bwd_kernel<IS_RMS><<<blocks, kThreads, smem, stream>>>(
      dout, dout_dt, dres_in, dres_in_dt, resout, resout_dt, mu, rstd, gamma, dx0, dx0_dt, dres,
      dres_dt, dgamma_part, dbeta_part, rows, hidden, rows_per_block);
  return cudaGetLastError();
}

}  // namespace

// residual, beta, resout, mu and rstd may be null (mu is null for RMSNorm).
// gamma and beta are fp32; mu and rstd are (rows,) fp32.
XFA_EXPORT int xfa_ln_fwd(const void* x0, int x0_dt, const void* residual, int res_dt,
                          const void* gamma, const void* beta, void* out, void* resout,
                          int resout_dt, void* mu, void* rstd, int64_t rows, int hidden,
                          float eps, int is_rms, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = is_rms ? launch_fwd<true>(x0, x0_dt, residual, res_dt, g, b, out, resout,
                                              resout_dt, m, r, rows, hidden, eps, s)
                           : launch_fwd<false>(x0, x0_dt, residual, res_dt, g, b, out, resout,
                                               resout_dt, m, r, rows, hidden, eps, s);
  return static_cast<int>(err);
}

// dres_in (prenorm), dres (the forward had a residual) and dbeta_part (the
// forward had a bias) may be null; mu is null for RMSNorm. dgamma_part and
// dbeta_part are (ceil(rows / rows_per_block), hidden) fp32.
XFA_EXPORT int xfa_ln_bwd(const void* dout, int dout_dt, const void* dres_in, int dres_in_dt,
                          const void* resout, int resout_dt, const void* mu, const void* rstd,
                          const void* gamma, void* dx0, int dx0_dt, void* dres, int dres_dt,
                          void* dgamma_part, void* dbeta_part, int64_t rows, int hidden,
                          int rows_per_block, int is_rms, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  const float* g = static_cast<const float*>(gamma);
  float* dg = static_cast<float*>(dgamma_part);
  float* db = static_cast<float*>(dbeta_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      is_rms ? launch_bwd<true>(dout, dout_dt, dres_in, dres_in_dt, resout, resout_dt, m, r, g,
                                dx0, dx0_dt, dres, dres_dt, dg, db, rows, hidden, rows_per_block, s)
             : launch_bwd<false>(dout, dout_dt, dres_in, dres_in_dt, resout, resout_dt, m, r, g,
                                 dx0, dx0_dt, dres, dres_dt, dg, db, rows, hidden, rows_per_block,
                                 s);
  return static_cast<int>(err);
}
