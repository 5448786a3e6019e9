// Few-query decode attention against a dense (b, hk, S, d) KV cache, whole
// or split across blocks.
//
// Replaces two TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/decode_kernel.py:47
//     `_decode_kernel` (entry xfa_flash_decode with num_splits = 1): the
//     normalised output;
//   * xhy_flash_attention_tpu/inference/combine.py:75 `_splitkv_kernel`
//     (num_splits > 1): per split of the cache, the normalised partial
//     output out_i and its running max m_i and sum l_i, which
//     merge_attention_partials (plain PyTorch) combines.
// What it computes, as the TPU kernels do:
//   * PackGQA: the g = h / hk query heads of one KV head and the sq new
//     tokens fold into sq * g rows (row r = si * g + gi);
//   * the sequence occupies cache columns [lp, lp + length) (lp = leftpad_k,
//     0 without it); row r sees cache position j when lp <= j <= pos with
//     pos = lp + length - sq + r / g and, with a window, j >= pos - window_left;
//   * kv_batch_idx remaps query batch row b to cache batch row kv_batch_idx[b];
//   * the cache is bf16 or fp32 (the query's dtype), or an int8 / e4m3
//     payload with per-token fp32 scales: s = (q . k) * k_scale[j] * sm_scale
//     and P.V takes p * v_scale[j]. Hopper converts e4m3 natively, so the TPU
//     kernels' rebias folded into the scales (common.py:44) is not needed;
//   * s in fp32, optional softcap tanh(s / c) * c, online softmax in fp32,
//     output divided by the row sum (0 when a row sees nothing).
// P stays in fp32 for P.V here (the TPU kernels round it to the query dtype
// for the matrix unit); the plain versions keep fp32 too.
//
// Bound on the H100: bytes. Each step reads 2 * length * d cache elements
// per (b, kv head) and does ~4 * sq * g flops per element read. Caches are
// read in place through element strides for their batch, head and sequence
// axes, so flash_attn_with_kvcache's (b, S, hk, d) caches cost no copy.
// Design: one block of eight warps per (kv head, batch, split). Keys go in
// tiles of 64: each warp takes 8 keys, reads each key row with one coalesced
// warp load (lanes split d) and reduces the sq * g dot products with
// shuffles; one warp per row runs the online-softmax update; then every
// thread owns one d column of a few rows and streams V rows with coalesced
// loads. Known limit: with one split the grid holds only b * hk blocks (16 at
// b = 2, hk = 8) on the card's 132 SMs, and decode reaches a small share of
// the memory rate; num_splits multiplies the blocks, at the cost of a merge.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;     // keys per tile
constexpr int kMaxRows = 16;  // sq * g

struct DecodeParams {
  const void* q;        // (b, sq, h, d) contiguous
  const void* k;        // cache, strides below (elements), head dim contiguous
  const void* v;
  const float* k_scale;  // (cache b, hk, S) contiguous, or null
  const float* v_scale;
  const int* lengths;       // (b,)
  const int* kv_batch_idx;  // (b,) or null
  const int* leftpad;       // (b,) or null
  void* out;                // (b, sq, h, d) without partials
  float* part_out;          // (b, hk, splits, rows, d), or null
  float* part_m;            // (b, hk, splits, rows)
  float* part_l;
  int64_t k_sb, k_sh, v_sb, v_sh;
  int k_ss, v_ss;  // sequence strides: offsets inside one (batch, head) fit in 32 bits
  int sq, h, hk, S;
  int split_len;  // keys per split
  float sm_scale, softcap;
  int window_left;
};

// kPerLane consecutive cache elements, one aligned vector load
template <typename C, int N>
struct alignas(N * sizeof(C)) Vec {
  C v[N];
};

template <typename T, typename C, int D, bool kPartial>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(const DecodeParams p) {
  constexpr int kPerLane = D / 32;         // q/k elements per lane in the score phase
  constexpr int kRowGroups = kThreads / D;  // rows sharing one d column in the P.V phase
  constexpr int kRowsPerThread = kMaxRows / kRowGroups;
  constexpr bool kQuant = !std::is_same<C, T>::value;  // int8 / e4m3 payload with scales
  __shared__ float p_s[kMaxRows][kTile];
  __shared__ float vsc_s[kTile];
  __shared__ float alpha_s[kMaxRows];
  __shared__ float l_s[kMaxRows];
  __shared__ float m_s[kMaxRows];

  const int kh = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int sq = p.sq, h = p.h, hk = p.hk;
  const int g = h / hk;
  const int rows = sq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cb = p.kv_batch_idx != nullptr ? p.kv_batch_idx[b] : b;
  const int lp = p.leftpad != nullptr ? p.leftpad[b] : 0;
  const int end_pos = lp + p.lengths[b];  // one past the sequence's last column

  const C* kbase = static_cast<const C*>(p.k) + cb * p.k_sb + kh * p.k_sh;
  const C* vbase = static_cast<const C*>(p.v) + cb * p.v_sb + kh * p.v_sh;
  const int64_t sc_off = (static_cast<int64_t>(cb) * hk + kh) * p.S;
  const T* q = static_cast<const T*>(p.q);

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

  // the keys any row can see, cut to this split
  int start = lp;
  if (p.window_left >= 0) start = max(start, end_pos - sq - p.window_left);
  int stop = min(end_pos, p.S);
  if (kPartial) {
    start = max(start, split * p.split_len);
    stop = min(stop, (split + 1) * p.split_len);
  }
  start = max(0, start);
  const int first = kPartial ? split * p.split_len : 0;
  start = first + ((start - first) / kTile) * kTile;

  for (int n0 = start; n0 < stop; n0 += kTile) {
    if (kQuant && threadIdx.x < kTile) {
      const int key = n0 + threadIdx.x;
      vsc_s[threadIdx.x] = key < stop ? p.v_scale[sc_off + key] : 0.f;
    }
    // scores: warp w takes keys w, w + 8, ... of the tile
    for (int j = warp; j < kTile; j += kWarps) {
      const int key = n0 + j;
      float part[kMaxRows];
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) part[r] = 0.f;
      if (key < stop) {
        const Vec<C, kPerLane> kvec =
            *reinterpret_cast<const Vec<C, kPerLane>*>(kbase + key * p.k_ss + lane * kPerLane);
        float kv[kPerLane];
#pragma unroll
        for (int e = 0; e < kPerLane; ++e) kv[e] = xfa::to_float(kvec.v[e]);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
#pragma unroll
            for (int e = 0; e < kPerLane; ++e) part[r] += qr[r][e] * kv[e];
          }
        }
      }
      const float ksc = kQuant && key < stop ? p.k_scale[sc_off + key] : 1.f;
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        if (r < rows) {
          const float dot = xfa::warp_sum(part[r]);
          if (lane == 0) {
            float s = dot;
            if (kQuant) s *= ksc;
            s *= p.sm_scale;
            if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
            const int pos = end_pos - sq + r / g;
            bool visible = key < stop && key >= lp && key <= pos;
            if (p.window_left >= 0) visible = visible && key >= pos - p.window_left;
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
        // P.V takes p * v_scale: folded in here, after the row sum
        p_s[r][lane] = kQuant ? p0 * vsc_s[lane] : p0;
        p_s[r][lane + 32] = kQuant ? p1 * vsc_s[lane + 32] : p1;
        if (lane == 0) alpha_s[r] = alpha;
      }
    }
    __syncthreads();

    // O = O * alpha + P V
    const int n_keys = min(kTile, stop - n0);
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = rg + i * kRowGroups;
      if (r < rows) acc[i] *= alpha_s[r];
    }
    for (int j = 0; j < n_keys; ++j) {
      const float vv = xfa::to_float(vbase[(n0 + j) * p.v_ss + dcol]);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = rg + i * kRowGroups;
        if (r < rows) acc[i] += p_s[r][j] * vv;
      }
    }
    __syncthreads();  // p_s, vsc_s and alpha_s are rewritten by the next tile
  }

#pragma unroll
  for (int i = 0; i < kMaxRows / kWarps; ++i) {
    const int r = warp + i * kWarps;
    if (r < rows && lane == 0) {
      l_s[r] = l_row[i];
      m_s[r] = m_row[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + i * kRowGroups;
    if (r < rows) {
      const float l = l_s[r];
      const float o = l > 0.f ? acc[i] / l : 0.f;
      if (kPartial) {
        const int64_t cell = ((static_cast<int64_t>(b) * hk + kh) * gridDim.z + split) * rows + r;
        p.part_out[cell * D + dcol] = o;
        if (dcol == 0) {
          p.part_m[cell] = l > 0.f ? m_s[r] : xfa::kMaskValue;
          p.part_l[cell] = l;
        }
      } else {
        const int si = r / g, gi = r % g;
        const int64_t off = ((static_cast<int64_t>(b) * sq + si) * h + kh * g + gi) * D + dcol;
        static_cast<T*>(p.out)[off] = xfa::from_float<T>(o);
      }
    }
  }
}

template <typename T, typename C, bool kPartial>
cudaError_t launch_d(const DecodeParams& p, dim3 grid, int d, cudaStream_t stream) {
  if (d == 64) {
    flash_decode_kernel<T, C, 64, kPartial><<<grid, kThreads, 0, stream>>>(p);
  } else if (d == 128) {
    flash_decode_kernel<T, C, 128, kPartial><<<grid, kThreads, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, bool kPartial>
cudaError_t launch_c(const DecodeParams& p, dim3 grid, int d, int cache_dtype,
                     cudaStream_t stream) {
  switch (cache_dtype) {
    case xfa::kI8:
      return launch_d<T, int8_t, kPartial>(p, grid, d, stream);
    case xfa::kE4M3:
      return launch_d<T, __nv_fp8_e4m3, kPartial>(p, grid, d, stream);
    default:
      return launch_d<T, T, kPartial>(p, grid, d, stream);
  }
}

}  // namespace

// q: (b, sq, h, d) contiguous, dtype 0 fp32 / 1 bf16. k, v: caches of dtype
// cache_dtype (the query's, or 2 int8 / 3 e4m3 with k_scale, v_scale: (cache
// b, hk, S) fp32 contiguous), element strides for batch, head and sequence
// (the sequence stride and the head dim aligned to d / 32 elements).
// lengths: (b,) int32 counting the sq new tokens; kv_batch_idx and leftpad:
// (b,) int32 or null. Without part_out it writes out (b, sq, h, d) (and
// num_splits must be 1); with it the partials part_out (b, hk, splits,
// sq * g, d) fp32 and part_m, part_l (b, hk, splits, sq * g) over splits of
// split_len keys.
XFA_EXPORT int xfa_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* lengths,
                                const void* kv_batch_idx, const void* leftpad, void* out,
                                void* part_out, void* part_m, void* part_l, int64_t k_sb,
                                int64_t k_sh, int k_ss, int64_t v_sb, int64_t v_sh, int v_ss,
                                int b, int sq, int h, int hk, int S, int d,
                                int dtype, int cache_dtype, int num_splits, int split_len,
                                float sm_scale, float softcap, int window_left, void* stream) {
  if (sq * (h / hk) > kMaxRows || num_splits < 1 || (part_out == nullptr && num_splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cache_dtype == xfa::kI8 || cache_dtype == xfa::kE4M3) != (k_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.kv_batch_idx = static_cast<const int*>(kv_batch_idx);
  p.leftpad = static_cast<const int*>(leftpad);
  p.out = out;
  p.part_out = static_cast<float*>(part_out);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.sq = sq; p.h = h; p.hk = hk; p.S = S;
  p.split_len = split_len;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window_left = window_left;
  const dim3 grid(hk, b, num_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (part_out != nullptr) {
    err = dtype == xfa::kBF16 ? launch_c<__nv_bfloat16, true>(p, grid, d, cache_dtype, s)
                              : launch_c<float, true>(p, grid, d, cache_dtype, s);
  } else {
    err = dtype == xfa::kBF16 ? launch_c<__nv_bfloat16, false>(p, grid, d, cache_dtype, s)
                              : launch_c<float, false>(p, grid, d, cache_dtype, s);
  }
  return static_cast<int>(err);
}
