// Few-query decode attention against a dense (b, hk, S, d) KV cache.
//
// Replaces the TPU kernel
// xhy_flash_attention_tpu/ops/flash_attention/decode_kernel.py:47
// `_decode_kernel` for a bf16 or fp32 cache (the int8/fp8 branch comes with
// the quantized cache). What it computes, as the TPU kernel does:
//   * PackGQA: the g = h / hk query heads of one KV head and the sq new
//     tokens fold into sq * g rows (row r = si * g + gi);
//   * only the first lengths[b] cache positions are read;
//   * row r sees cache position j when j <= length - sq + r / g and, with a
//     window, j >= length - sq + r / g - window_left;
//   * s = (q . k) * sm_scale in fp32, optional softcap tanh(s / c) * c,
//     online softmax in fp32, output divided by the row sum (0 when a row
//     sees nothing).
// P stays in fp32 for P.V here (the TPU kernel rounds it to the cache dtype
// for its matrix unit); the plain version (ops/decode.py
// `_decode_attention_xla`) also keeps fp32.
//
// Bound on the H100: bytes. Each step reads 2 * length * d cache elements
// per (b, kv head) and does ~4 * sq * g flops per element read.
// Design: one block of eight warps per (batch, kv head). Keys go in tiles of
// 64: each warp takes 8 keys, reads each key row with one coalesced warp
// load (lanes split d) and reduces the sq * g dot products with shuffles;
// one warp per row runs the online-softmax update; then every thread owns
// one d column of a few rows and streams V rows with coalesced loads.
// Known limit: one block per (b, hk) puts only b * hk blocks on the card's
// 132 SMs (16 at b = 2, hk = 8), so decode reaches a small share of the
// memory bandwidth. Splitting the cache across blocks (split-KV, as
// inference/combine.py does on the TPU) is the first thing to fix.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // keys per tile
constexpr int kMaxRows = 16;  // sq * g

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ lengths, T* __restrict__ out, int sq, int h, int hk,
                    int S, float sm_scale, float softcap, int window_left) {
  constexpr int kPerLane = D / 32;         // q/k elements per lane in the score phase
  constexpr int kRowGroups = kThreads / D;  // rows sharing one d column in the P.V phase
  constexpr int kRowsPerThread = kMaxRows / kRowGroups;
  __shared__ float p_s[kMaxRows][kTile];
  __shared__ float alpha_s[kMaxRows];
  __shared__ float l_s[kMaxRows];

  const int kh = blockIdx.x, b = blockIdx.y;
  const int g = h / hk;
  const int rows = sq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int length = min(lengths[b], S);

  const T* kbase = kc + (static_cast<int64_t>(b) * hk + kh) * S * D;
  const T* vbase = vc + (static_cast<int64_t>(b) * hk + kh) * S * D;

  // this lane's slice of every query row
  float qr[kMaxRows][kPerLane];
#pragma unroll
  for (int r = 0; r < kMaxRows; ++r) {
#pragma unroll
    for (int e = 0; e < kPerLane; ++e) {
      float x = 0.f;
      if (r < rows) {
        const int si = r / g, gi = r % g;
        const int64_t off = ((static_cast<int64_t>(b) * sq + si) * h + kh * g + gi) * D;
        x = xfa::to_float(q[off + lane * kPerLane + e]);
      }
      qr[r][e] = x;
    }
  }

  // softmax state of the rows this warp owns (rows warp and warp + 8)
  float m_row[kMaxRows / kWarps], l_row[kMaxRows / kWarps];
#pragma unroll
  for (int i = 0; i < kMaxRows / kWarps; ++i) {
    m_row[i] = -INFINITY;
    l_row[i] = 0.f;
  }
  // P.V accumulators: column dcol of rows rg, rg + kRowGroups, ...
  const int dcol = threadIdx.x % D, rg = threadIdx.x / D;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;

  // the first key any row can see
  int start = 0;
  if (window_left >= 0) start = max(0, length - sq - window_left);
  start = (start / kTile) * kTile;

  for (int n0 = start; n0 < length; n0 += kTile) {
    // scores: warp w takes keys w, w + 8, ... of the tile
    for (int j = warp; j < kTile; j += kWarps) {
      const int key = n0 + j;
      float part[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) part[r] = 0.f;
      if (key < length) {
        float kv[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e)
          kv[e] = xfa::to_float(kbase[static_cast<int64_t>(key) * D + lane * kPerLane + e]);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
#pragma unroll
            for (int e = 0; e < kPerLane; ++e) part[r] += qr[r][e] * kv[e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float dot = xfa::warp_sum(part[r]);
          if (lane == 0) {
            float s = dot * sm_scale;
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            const int pos = length - sq + r / g;
            bool visible = key < length && key <= pos;
            if (window_left >= 0) visible = visible && key >= pos - window_left;
            p_s[r][j] = visible ? s : -INFINITY;
          }
        }
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows w and w + 8
#pragma unroll
    for (int i = 0; i < kMaxRows / kWarps; ++i) {
      const int r = warp + i * kWarps;
      if (r < rows) {
        const float x0 = p_s[r][lane], x1 = p_s[r][lane + 32];
        const float m_new = fmaxf(m_row[i], xfa::warp_max(fmaxf(x0, x1)));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float alpha = expf(m_row[i] - m_use);
        const float p0 = expf(x0 - m_use), p1 = expf(x1 - m_use);
        l_row[i] = l_row[i] * alpha + xfa::warp_sum(p0 + p1);
        m_row[i] = m_new;
        p_s[r][lane] = p0;
        p_s[r][lane + 32] = p1;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    const int n_keys = min(kTile, length - n0);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + i * kRowGroups;
      if (r < rows) acc[i] *= alpha_s[r];
    }
    for (int j = 0; j < n_keys; ++j) {
      const float vv = xfa::to_float(vbase[static_cast<int64_t>(n0 + j) * D + dcol]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rg + i * kRowGroups;
        if (r < rows) acc[i] += p_s[r][j] * vv;
      }
    }
    __syncthreads();  // p_s and alpha_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kMaxRows / kWarps; ++i) {
    const int r = warp + i * kWarps;
    if (r < rows && lane == 0) l_s[r] = l_row[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + i * kRowGroups;
    if (r < rows) {
      const float l = l_s[r];
      const int si = r / g, gi = r % g;
      const int64_t off = ((static_cast<int64_t>(b) * sq + si) * h + kh * g + gi) * D + dcol;
      out[off] = xfa::from_float<T>(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths, void* out,
                   int b, int sq, int h, int hk, int S, int d, float sm_scale, float softcap,
                   int window_left, cudaStream_t stream) {
  const dim3 grid(hk, b);
  const T* qq = static_cast<const T*>(q);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  T* oo = static_cast<T*>(out);
  if (d == 64) {
    flash_decode_kernel<T, 64><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, lengths, oo, sq, h, hk, S, sm_scale, softcap, window_left);
  } else if (d == 128) {
    flash_decode_kernel<T, 128><<<grid, kThreads, 0, stream>>>(
        qq, kk, vv, lengths, oo, sq, h, hk, S, sm_scale, softcap, window_left);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, out: (b, sq, h, d) contiguous; k, v: (b, hk, S, d) contiguous; lengths:
// (b,) int32 on the device, counting the sq new tokens. dtype: 0 fp32, 1 bf16.
XFA_EXPORT int xfa_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                                void* out, int b, int sq, int h, int hk, int S, int d, int dtype,
                                float sm_scale, float softcap, int window_left, void* stream) {
  if (sq * (h / hk) > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  const int* lens = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == xfa::kBF16
          ? launch<__nv_bfloat16>(q, k, v, lens, out, b, sq, h, hk, S, d, sm_scale, softcap,
                                  window_left, s)
          : launch<float>(q, k, v, lens, out, b, sq, h, hk, S, d, sm_scale, softcap,
                          window_left, s);
  return static_cast<int>(err);
}
