// Fused rowscale / colscale / dropout + residual add + RMSNorm / LayerNorm,
// forward and backward.
//
// Forward: replaces the TPU kernel xhy_flash_attention_tpu/ops/layer_norm.py:48
// `_ln_fwd_kernel` (kernel #7):
//
//   x         = x0 * rowscale[row] * colscale[col]      (each if given)
//   x         = keep(row, col) ? x * (1 / (1 - p)) : 0   (dropout, p > 0)
//   resid_out = x + residual               (fp32 or x0's dtype)
//   out       = norm(resid_out) * gamma (+ beta)   in x0's dtype
//   mu, rstd  = the row's mean (LayerNorm) and 1 / sqrt(var + eps), fp32
//
// in fp32, in the TPU kernel's order (rowscale before colscale, a multiply
// by 1 / (1 - p), not a divide; the scalings are `__fmul_rn`, so that the
// add that follows is not contracted into them). keep is common.cuh's
// `dropout_keep` of the global (row, col) of the flattened (rows, hidden)
// input with salt 0 (ops common.py `dropout_keep_mask(seed, 0, row, col,
// p)`), so the mask depends on no tiling. RMSNorm and LayerNorm come from one
// template flag, rowscale, colscale and dropout from three more; the
// instantiation with none of the three is the kernel without them. The row
// reduction runs in fp32. resid_out, mu and rstd are written only when the
// caller asks for them (prenorm; training saves all three, as the TPU
// kernel's save_stats).
//
// Backward: replaces layer_norm.py:102 `_ln_bwd_kernel` (kernel #8):
//
//   xhat = (resid_out - mu) * rstd,  dy = dout * gamma
//   dres = (dy - xhat * mean(dy * xhat) - mean(dy)) * rstd  (+ dres_in)
//   dx1  = keep(row, col) ? dres * (1 / (1 - p)) : 0   (the mask regenerated)
//   dcolscale = sum over rows of dx1 * x0 * rowscale
//   dx0  = dx1 * colscale * rowscale
//
// (RMSNorm: no mean terms), dres written in the residual's dtype where the
// forward had a residual, dx0 in x0's; rowscale gets no gradient, as in the
// TPU package. dgamma = sum(dout * xhat), dbeta = sum(dout) and dcolscale
// leave as fp32 partials, one row per block of rows, which the caller sums
// in a fixed order (as XLA sums the TPU kernel's partials, layer_norm.py:
// 325-333): no atomics, so the result is deterministic. x0 is read again
// only with a colscale; no mask is stored.
//
// Bound on the H100: bytes. Forward per element: x0 (2 B in bf16), the fp32
// residual (4 B) in, out (2 B) and the fp32 residual (4 B) out; backward:
// dout (2 B), resid_out (4 B), dres_in (4 B) in (and x0 with a colscale),
// dx0 (2 B) and dres (4 B) out. About 1.5 flops per byte, far under the
// card's ~295 flops/byte balance point; the hash adds about 11 integer
// instructions an element, under the bytes' time at 64 a clock an SM.
// Design: forward, one block per row, the row read once into shared memory
// in fp32; backward, one block per group of rows, xhat and dy kept in shared
// memory between the reduction and the write pass, and the block's
// dgamma/dbeta/dcolscale partials in shared memory, each column owned by one
// thread. Loads are coalesced (thread i reads elements i, i + blockDim, ...).
// Vector loads are left to a later tuning pass.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// The part of an element's dropout hash that its row shares: row * kDropRow
// + seed (salt 0); the column adds col * kDropCol (common.cuh dropout_keep).
__device__ __forceinline__ uint32_t row_mix(int64_t row, const xfa::DropoutParams& d) {
  return static_cast<uint32_t>(row) * xfa::kDropRow + d.seed;
}

__device__ __forceinline__ bool keep_at(uint32_t mix, int col, const xfa::DropoutParams& d) {
  return xfa::dropout_keep(mix + static_cast<uint32_t>(col) * xfa::kDropCol, d.threshold);
}

template <bool IS_RMS, bool ROWSCALE = false, bool COLSCALE = false, bool DROPOUT = false>
__global__ void __launch_bounds__(kThreads)
ln_fwd_kernel(const void* __restrict__ x0, int x0_dt, const void* __restrict__ residual,
              int res_dt, const float* __restrict__ gamma, const float* __restrict__ beta,
              void* __restrict__ out, void* __restrict__ resout, int resout_dt,
              float* __restrict__ mu_out, float* __restrict__ rstd_out, int hidden, float eps,
              const float* __restrict__ rowscale, const float* __restrict__ colscale,
              xfa::DropoutParams drop) {
  extern __shared__ float row[];
  __shared__ float red[kThreads / 32];
  const int64_t base = static_cast<int64_t>(blockIdx.x) * hidden;

  float rs = 1.f;
  if constexpr (ROWSCALE) rs = rowscale[blockIdx.x];
  uint32_t mix = 0;
  if constexpr (DROPOUT) mix = row_mix(blockIdx.x, drop);
  float acc = 0.f;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    float x = xfa::load_as_float(x0, base + i, x0_dt);
    if constexpr (ROWSCALE) x = __fmul_rn(x, rs);
    if constexpr (COLSCALE) x = __fmul_rn(x, colscale[i]);
    if constexpr (DROPOUT) x = keep_at(mix, i, drop) ? __fmul_rn(x, drop.scale) : 0.f;
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

template <bool IS_RMS, bool ROWSCALE = false, bool COLSCALE = false, bool DROPOUT = false>
__global__ void __launch_bounds__(kThreads)
ln_bwd_kernel(const void* __restrict__ dout, int dout_dt, const void* __restrict__ dres_in,
              int dres_in_dt, const void* __restrict__ resout, int resout_dt,
              const float* __restrict__ mu, const float* __restrict__ rstd,
              const float* __restrict__ gamma, void* __restrict__ dx0, int dx0_dt,
              void* __restrict__ dres, int dres_dt, float* __restrict__ dgamma_part,
              float* __restrict__ dbeta_part, int64_t rows, int hidden, int rows_per_block,
              const void* __restrict__ x0, int x0_dt, const float* __restrict__ rowscale,
              const float* __restrict__ colscale, float* __restrict__ dcolscale_part,
              xfa::DropoutParams drop) {
  // xhat, dy of the current row, then this block's dgamma, dbeta (and
  // dcolscale) partials; thread i owns columns i, i + kThreads, ... of all
  extern __shared__ float smem[];
  float* xhat_s = smem;
  float* dy_s = xhat_s + hidden;
  float* dg_s = dy_s + hidden;
  float* db_s = dg_s + hidden;
  float* dc_s = db_s + hidden;
  __shared__ float red[kThreads / 32];
  for (int i = threadIdx.x; i < hidden; i += kThreads) dg_s[i] = db_s[i] = 0.f;
  if constexpr (COLSCALE)
    for (int i = threadIdx.x; i < hidden; i += kThreads) dc_s[i] = 0.f;

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
    float row_s = 1.f;
    if constexpr (ROWSCALE) row_s = rowscale[r];
    uint32_t mix = 0;
    if constexpr (DROPOUT) mix = row_mix(r, drop);
    for (int i = threadIdx.x; i < hidden; i += kThreads) {
      float d = IS_RMS ? (dy_s[i] - xhat_s[i] * c1) * rs
                       : (dy_s[i] - xhat_s[i] * c1 - c2) * rs;
      if (dres_in != nullptr) d += xfa::load_as_float(dres_in, base + i, dres_in_dt);
      if (dres != nullptr) xfa::store_from_float(dres, base + i, d, dres_dt);
      if constexpr (DROPOUT) d = keep_at(mix, i, drop) ? __fmul_rn(d, drop.scale) : 0.f;
      if constexpr (COLSCALE) {
        float x = xfa::load_as_float(x0, base + i, x0_dt);
        if constexpr (ROWSCALE) x = __fmul_rn(x, row_s);
        dc_s[i] += __fmul_rn(d, x);
        d = __fmul_rn(d, colscale[i]);
      }
      if constexpr (ROWSCALE) d = __fmul_rn(d, row_s);
      xfa::store_from_float(dx0, base + i, d, dx0_dt);
    }
  }
  const int64_t part = static_cast<int64_t>(blockIdx.x) * hidden;
  for (int i = threadIdx.x; i < hidden; i += kThreads) {
    dgamma_part[part + i] = dg_s[i];
    if (dbeta_part != nullptr) dbeta_part[part + i] = db_s[i];
    if constexpr (COLSCALE) dcolscale_part[part + i] = dc_s[i];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// f(std::bool_constant<flags[0]>, ..., std::bool_constant<flags[3]>): the
// runtime flags as template arguments
template <int N = 0, typename F, typename... B>
cudaError_t with_flags(const bool (&flags)[4], F&& f, B... done) {
  if constexpr (N == 4) {
    return f(done...);
  } else {
    return flags[N] ? with_flags<N + 1>(flags, f, done..., std::true_type{})
                    : with_flags<N + 1>(flags, f, done..., std::false_type{});
  }
}

}  // namespace

// residual, beta, resout, mu, rstd, rowscale and colscale may be null (mu is
// null for RMSNorm); drop != 0 turns dropout on. gamma, beta, rowscale
// (rows,) and colscale (hidden,) are fp32; mu and rstd are (rows,) fp32.
XFA_EXPORT int xfa_ln_fwd(const void* x0, int x0_dt, const void* residual, int res_dt,
                          const void* gamma, const void* beta, void* out, void* resout,
                          int resout_dt, void* mu, void* rstd, int64_t rows, int hidden,
                          float eps, int is_rms, const void* rowscale, const void* colscale,
                          XFA_DROPOUT_ARGS, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* rsc = static_cast<const float*>(rowscale);
  const float* csc = static_cast<const float*>(colscale);
  float* m = static_cast<float*>(mu);
  float* r = static_cast<float*>(rstd);
  const xfa::DropoutParams dp = XFA_DROPOUT_VALUES;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(hidden) * sizeof(float);
  const bool flags[4] = {is_rms != 0, rsc != nullptr, csc != nullptr, drop != 0};
  return static_cast<int>(with_flags(flags, [&](auto rms, auto rs, auto cs, auto dr) {
    auto kernel = ln_fwd_kernel<decltype(rms)::value, decltype(rs)::value, decltype(cs)::value,
                                decltype(dr)::value>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(rows), kThreads, smem, s>>>(
        x0, x0_dt, residual, res_dt, g, b, out, resout, resout_dt, m, r, hidden, eps, rsc, csc,
        dp);
    return cudaGetLastError();
  }));
}

// dres_in (prenorm), dres (the forward had a residual) and dbeta_part (the
// forward had a bias) may be null; mu is null for RMSNorm. dgamma_part,
// dbeta_part and dcolscale_part are (ceil(rows / rows_per_block), hidden)
// fp32. rowscale and colscale may be null; with a colscale, x0 (x0_dt) and
// dcolscale_part are given. drop != 0 regenerates the forward's keep mask.
XFA_EXPORT int xfa_ln_bwd(const void* dout, int dout_dt, const void* dres_in, int dres_in_dt,
                          const void* resout, int resout_dt, const void* mu, const void* rstd,
                          const void* gamma, void* dx0, int dx0_dt, void* dres, int dres_dt,
                          void* dgamma_part, void* dbeta_part, int64_t rows, int hidden,
                          int rows_per_block, int is_rms, const void* x0, int x0_dt,
                          const void* rowscale, const void* colscale, void* dcolscale_part,
                          XFA_DROPOUT_ARGS, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const float* m = static_cast<const float*>(mu);
  const float* r = static_cast<const float*>(rstd);
  const float* g = static_cast<const float*>(gamma);
  const float* rsc = static_cast<const float*>(rowscale);
  const float* csc = static_cast<const float*>(colscale);
  float* dg = static_cast<float*>(dgamma_part);
  float* db = static_cast<float*>(dbeta_part);
  float* dc = static_cast<float*>(dcolscale_part);
  if (csc != nullptr && (x0 == nullptr || dc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const xfa::DropoutParams dp = XFA_DROPOUT_VALUES;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (csc != nullptr ? 5 : 4) * static_cast<size_t>(hidden) * sizeof(float);
  const unsigned blocks = static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block);
  const bool flags[4] = {is_rms != 0, rsc != nullptr, csc != nullptr, drop != 0};
  return static_cast<int>(with_flags(flags, [&](auto rms, auto rs, auto cs, auto dr) {
    auto kernel = ln_bwd_kernel<decltype(rms)::value, decltype(rs)::value, decltype(cs)::value,
                                decltype(dr)::value>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, smem, s>>>(dout, dout_dt, dres_in, dres_in_dt, resout, resout_dt,
                                          m, r, g, dx0, dx0_dt, dres, dres_dt, dg, db, rows,
                                          hidden, rows_per_block, x0, x0_dt, rsc, csc, dc, dp);
    return cudaGetLastError();
  }));
}
