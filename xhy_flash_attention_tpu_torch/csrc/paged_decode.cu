// Decode and chunked-prefill attention against a paged KV cache.
//
// Replaces two TPU kernels, one kernel here behind two entries of
// inference/paged.py (separate launch counts, as flash_fwd.cu serves two):
//   * xhy_flash_attention_tpu/inference/paged.py:149 `_paged_decode_kernel`
//     (the "page" entry: head dims other than 128, or one page per sequence);
//   * xhy_flash_attention_tpu/inference/paged.py:219
//     `_paged_decode_chunked_kernel` (the "chunked" entry: every engine
//     decode, chunked-prefill and speculative step at d = 128).
// The TPU split into two kernels follows the cost of its DMA descriptors;
// here a block gathers its key rows through the page table itself, so one
// kernel serves both.
//
// What it computes, as the TPU kernels do: pages (P, hk, 2, ps, d) hold K
// (index 0) and V (index 1) rows; key j of sequence b lives in page
// page_table[b, j / ps] at row j % ps. Rows are PackGQA, sq * g per KV head
// (row r = si * g + gi), and row r sees keys j <= pos = length - sq + r / g
// (with a window also j >= pos - window_left); a sequence of length 0 gives
// zeros. s = (q . k) * sm_scale in fp32, with int8 / e4m3 pages
// s = (q . k) * k_scale[j] * sm_scale over the linear per-sequence scales
// kv_scales (b, hk, 2, npp * ps); optional softcap; online softmax in fp32;
// P (times v_scale[j] for quantized pages) rounded to bf16 for P.V, as the
// TPU kernels round it to the query dtype; output divided by the fp32 row
// sum. int8 and e4m3 payloads convert to bf16 exactly, natively on Hopper:
// the TPU kernels' exponent rebias folded into the scales is not needed.
//
// Bound on the H100: bytes at decode (sq = 1: each key row is read once for
// the g rows of its KV head), operations at a chunked-prefill step (sq * g
// rows up to 2048 per KV head).
// Design: one block of four warps owns 64 query rows of one (batch, kv
// head); each warp keeps 16 rows of Q and the O accumulator in registers and
// runs mma.sync m16n8k16 bf16 tiles, as flash_fwd.cu does. Tiles of 64 keys
// are gathered row by row through the page table with 16-byte loads (8-byte
// for 1-byte pages, converted to bf16 on the way) into padded shared memory,
// with their per-token scales. Key tiles past the last row's causal position
// or before the first row's window are never loaded. Not yet used: cp.async
// or TMA double buffering, a split of long sequences across blocks.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 128;

struct PagedParams {
  const bf16* q;         // (b, sq, h, d) contiguous
  const void* pages;     // (num_pages, hk, 2, ps, d) contiguous
  const float* scales;   // (b, hk, 2, npp * ps) contiguous, or null
  const int* table;      // (b, npp)
  const int* lengths;    // (b,)
  bf16* out;             // (b, sq, h, d)
  int sq, h, hk, ps, npp, num_pages;
  float sm_scale, softcap;
  int window_left;
};

using xfa::ldmatrix_x2_trans;
using xfa::mma_16816;
using xfa::pack_a;
using xfa::pack_bf16;

// Eight consecutive cache elements as eight bf16 (one 16-byte shared store).
__device__ __forceinline__ uint4 load8(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}
template <typename C>
__device__ __forceinline__ uint4 load8(const C* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const C* e = reinterpret_cast<const C*>(&raw);
  uint4 r;
  r.x = pack_bf16(xfa::to_float(e[0]), xfa::to_float(e[1]));
  r.y = pack_bf16(xfa::to_float(e[2]), xfa::to_float(e[3]));
  r.z = pack_bf16(xfa::to_float(e[4]), xfa::to_float(e[5]));
  r.w = pack_bf16(xfa::to_float(e[6]), xfa::to_float(e[7]));
  return r;
}

template <typename C, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int kChunks = D / 8;  // 8-element chunks per row
  __shared__ __align__(16) bf16 ks[kBlockN * kStride];
  __shared__ __align__(16) bf16 vs[kBlockN * kStride];
  __shared__ float ksc[kBlockN];
  __shared__ float vsc[kBlockN];

  const int m_block = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.hk;
  const int rows = p.sq * g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int row0 = m_block * kBlockM + warp * 16;
  const int length = p.lengths[b];
  const int cap = p.npp * p.ps;
  const bool quant = p.scales != nullptr;
  const C* pages = static_cast<const C*>(p.pages);
  const int* table = p.table + static_cast<int64_t>(b) * p.npp;
  const float* kscale =
      quant ? p.scales + (static_cast<int64_t>(b) * p.hk + kh) * 2 * cap : nullptr;
  const float* vscale = quant ? kscale + cap : nullptr;

  // Q fragments (A operand), the query as it is (the scale comes after QK^T)
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + gq + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * t;
      uint32_t val = 0;
      if (row < rows) {
        const int si = row / g, gi = row % g;
        const bf16* qrow = p.q + ((static_cast<int64_t>(b) * p.sq + si) * p.h + kh * g + gi) * D;
        val = *reinterpret_cast<const uint32_t*>(qrow + col);
      }
      qf[kk][r] = val;
    }
  }

  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  // keys this block's rows can see
  const int r_first = m_block * kBlockM;
  const int r_last = min(r_first + kBlockM, rows) - 1;
  const int k_end = min(min(length, length - p.sq + r_last / g + 1), cap);
  int k_start = 0;
  if (p.window_left >= 0) k_start = max(0, length - p.sq + r_first / g - p.window_left);
  k_start = (k_start / kBlockN) * kBlockN;

  for (int n0 = k_start; n0 < k_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const int key = n0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < k_end) {
        const int page = min(max(table[key / p.ps], 0), p.num_pages - 1);
        const C* krow = pages + ((static_cast<int64_t>(page) * p.hk + kh) * 2 * p.ps + key % p.ps) * D;
        kv = load8(krow + c);
        vv = load8(krow + static_cast<int64_t>(p.ps) * D + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * kStride + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * kStride + c]) = vv;
    }
    if (threadIdx.x < kBlockN) {
      const int key = n0 + threadIdx.x;
      const bool in = quant && key < k_end;
      ksc[threadIdx.x] = in ? kscale[key] : 1.f;
      vsc[threadIdx.x] = in ? vscale[key] : 1.f;
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const bf16* kr = &ks[(j * 8 + gq) * kStride + kk * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    // scales, softcap and mask; fragment element e sits at row gq + (e >= 2)
    // * 8, column 2t + (e & 1) of n-tile j
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + gq + (e >> 1) * 8;
        const int jc = j * 8 + 2 * t + (e & 1);
        const int col = n0 + jc;
        float x = s[j][e];
        if (quant) x *= ksc[jc];
        x *= p.sm_scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const int pos = length - p.sq + row / g;
        bool visible = col < k_end && col <= pos;
        if (p.window_left >= 0) visible = visible && col >= pos - p.window_left;
        x = visible ? x : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      // a row with nothing visible yet keeps a zero shift so exp() gives 0
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m_i[i] - m_use[i]);
      m_i[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_use[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }
    if (quant) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const float v0 = vsc[j * 8 + 2 * t], v1 = vsc[j * 8 + 2 * t + 1];
        s[j][0] *= v0;
        s[j][1] *= v1;
        s[j][2] *= v0;
        s[j][3] *= v1;
      }
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s, kk);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[(kk * 16 + (lane & 15)) * kStride + j * 8]);
        mma_16816(o_acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + gq + i * 8;
    if (row >= rows) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
    const int si = row / g, gi = row % g;
    bf16* orow = p.out + ((static_cast<int64_t>(b) * p.sq + si) * p.h + kh * g + gi) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o_acc[j][2 * i] * inv, o_acc[j][2 * i + 1] * inv);
    }
  }
}

template <typename C>
cudaError_t launch(const PagedParams& p, dim3 grid, int d, cudaStream_t stream) {
  if (d == 64) {
    paged_decode_kernel<C, 64><<<grid, kThreads, 0, stream>>>(p);
  } else if (d == 128) {
    paged_decode_kernel<C, 128><<<grid, kThreads, 0, stream>>>(p);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// q, out: (b, sq, h, d) bf16 contiguous; pages: (num_pages, hk, 2, ps, d)
// contiguous of page_dtype (1 bf16, 2 int8 with scales, 3 e4m3 with
// scales); scales: (b, hk, 2, npp * ps) fp32 contiguous or null; table:
// (b, npp) int32; lengths: (b,) int32 counting the sq new tokens.
XFA_EXPORT int xfa_paged_decode(const void* q, const void* pages, const void* scales,
                                const void* table, const void* lengths, void* out, int b, int sq,
                                int h, int hk, int ps, int npp, int num_pages, int d,
                                int page_dtype, float sm_scale, float softcap,
                                int window_left, void* stream) {
  const bool quant = page_dtype == xfa::kI8 || page_dtype == xfa::kE4M3;
  if (quant != (scales != nullptr) || (!quant && page_dtype != xfa::kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  PagedParams p;
  p.q = static_cast<const bf16*>(q);
  p.pages = pages;
  p.scales = static_cast<const float*>(scales);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<bf16*>(out);
  p.sq = sq; p.h = h; p.hk = hk; p.ps = ps; p.npp = npp; p.num_pages = num_pages;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window_left = window_left;
  const int rows = sq * (h / hk);
  const dim3 grid((rows + kBlockM - 1) / kBlockM, hk, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (page_dtype) {
    case xfa::kI8:
      err = launch<int8_t>(p, grid, d, s);
      break;
    case xfa::kE4M3:
      err = launch<__nv_fp8_e4m3>(p, grid, d, s);
      break;
    default:
      err = launch<bf16>(p, grid, d, s);
  }
  return static_cast<int>(err);
}
