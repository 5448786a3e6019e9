// The parts of the attention backward (#2, #3, #6) that its two sources
// share: flash_bwd.cu (the pre-pass and dK/dV, with their entries) and
// flash_bwd_dq.cu (dQ and its entry), which ops/_cuda.py compiles side by
// side, one nvcc each. The tile constants, BwdParams, the products, P / dS
// of one element (p_ds), the accumulators' packing and stores, the grid
// size and the entries' C arguments (XFA_BWD_ARGS / XFA_BWD_PARAMS). The
// design is described at the top of flash_bwd.cu.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::pack_bf16;
namespace sm90 = xfa::sm90;
using sm90::ex2;
using sm90::issue_ss;
using sm90::kLog2e;

// ------------------------------------------------------------ the kernels

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRow = 128;  // bytes of a swizzled row: 64 bf16
// dK/dV: keys per block (64 per consumer) and query rows per streamed tile
// (bwd.py BWD_DKV_TILE_N / BWD_DKV_TILE_M)
constexpr int kDkvKeys = 128;
constexpr int kDkvRows = 64;
// A tile's LSE or delta arrives by 1-D TMA as kStatBox floats from the
// 16-byte aligned element at or before its first row (TMA reads a box from
// an aligned start): the tile's rows sit `(first row) % 4` floats in.
constexpr int kStatBox = kDkvRows + 4;
// dQ: query rows per block (64 per consumer) and keys per streamed tile
// (bwd.py BWD_DQ_TILE_M / bwd_dq_tile_n)
constexpr int kDqRows = 128;
__host__ __device__ constexpr int dq_keys(int d) { return d == 64 ? 128 : 64; }

// The masked instantiations' tile word and flags: common.cuh (kEnd,
// kElem, kBand, kOnShift); dQ's row block is common.cuh kRowBlock.
using xfa::kBand;
using xfa::kElem;
using xfa::kEnd;
using xfa::kBlockInfoBytes;
using xfa::kInfo;
using xfa::kOnShift;
static_assert(kDqRows == xfa::kRowBlock, "the dQ block is the masked producer's row block");

struct BwdParams {
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
  // the masked instantiations: the flags (FlashMask stats per kernel
  // tile), the FlashMask bands (b, fm_heads, fm_skp) as [lo1, hi1, lo2,
  // hi2) or null, and three counters: the dynamic scheduler's next item,
  // the tiles the producers emit and those of them with the elementwise test
  xfa::MaskParams mask;
  const int4* bands;
  int* next;
  // the bias instantiations' bias (common.cuh BiasParams)
  xfa::BiasParams bias;
  // the dropout instantiations' seed, threshold and scale
  xfa::DropoutParams drop;
};

// ---- products and the elementwise work

// C(64 x D) += A B over k = K (issued, not committed): A's bf16 pairs in
// registers (4 a k-step), B (K rows x D) MN-major, 16 rows of 128 B a
// k-step, its 64-column halves b_half bytes apart.
template <int D, int K>
__device__ __forceinline__ void issue_rs(float (&c)[D / 2], const uint32_t (&a)[K / 4], uint32_t b,
                                         uint32_t b_half) {
  const uint64_t db = sm90::desc_b128(b, b_half);
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    if constexpr (D == 64) {
      sm90::wgmma_rs_n64(c, &a[4 * kk], db + kk * (16 * kRow >> 4));
    } else {
      sm90::wgmma_rs_n128(c, &a[4 * kk], db + kk * (16 * kRow >> 4));
    }
  }
}

// P and dS of one element: the score x (fp32, before softcap), dp its dP,
// lse2 = LSE log2(e), delta; visible false gives 0 for both; with BIAS the
// element's bias added after softcap, as the forward adds it; with DROP
// the forward's keep bit `keep`: dP dropped or scaled by `dscale` = 1 / (1
// - p) before dS = P (dP - delta) (the undropped P), and P dropped for dV
// after it (its scale joins dV's epilogue), as the TPU kernels
// (bwd.py:158-172). SOFTCAP, BIAS and DROP are template flags so that the
// unrolled loops carry no test per element.
template <bool SOFTCAP, bool BIAS = false, bool DROP = false>
__device__ __forceinline__ void p_ds(float x, float dp, float lse2, float delta, bool visible,
                                     float softcap, float& pr, float& ds, float bias = 0.f,
                                     bool keep = true, float dscale = 1.f) {
  float fac = 1.f;
  if (SOFTCAP) {
    const float th = tanhf(x / softcap);
    x = th * softcap;
    fac = 1.f - th * th;
  }
  if constexpr (BIAS) x += bias;
  pr = visible ? ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
  if constexpr (DROP) dp = keep ? dp * dscale : 0.f;
  ds = pr * (dp - delta) * fac;
  if constexpr (DROP) pr = keep ? pr : 0.f;
}

// An fp32 accumulator as bf16 pairs: a[4kk .. 4kk + 3] is the A fragment of
// k-step kk of a following RS product
template <int N>
__device__ __forceinline__ void pack_pairs(const float (&x)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(x[2 * i], x[2 * i + 1]);
}

// Store this thread's share of a (64 x D) fp32 accumulator, scaled, as bf16
// rows row0 and row0 + 8 of `dst` (row stride ss); rows at or past `limit`
// are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, int64_t ss, const float (&c)[D / 2],
                                           int row0, int limit, float scale, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + row * ss + 8 * j + 2 * t) =
          pack_bf16(c[4 * j + 2 * rr] * scale, c[4 * j + 2 * rr + 1] * scale);
  }
}

// ---- launches

// One persistent CTA per SM (shared memory allows no second), or one per
// pair of blocks (per block under the masked kernels' dynamic scheduler)
// when there are fewer.
inline cudaError_t grid_size(int n_blocks, int heads, const BwdParams& p, bool masked, int& grid) {
  int sms = 0;
  const cudaError_t err = sm90::sm_count(sms);
  const int units = masked ? n_blocks * heads * p.b : xfa::block_pairs(n_blocks, heads, p.b);
  grid = units < sms ? units : sms;
  return err;
}

}  // namespace

// The 21 strides, in elements, are (batch, head, seq) of q, k, v, dout, dq,
// dk and dv in that order; the head-dim axis of every tensor is contiguous;
// `q` is q_s, the pre-pass's bf16(q * sm_scale), and q_s, k, v and dout are
// read through TMA tensor maps: pointers and strides multiples of 16 bytes.
// lse and delta are (b, h, sq) fp32 contiguous. The mask arguments
// (XFA_MASK_ARGS, common.cuh) carry FlashMask stats per key tile of the
// kernel launched: 128 keys for dK/dV, dq_keys(d) (128 at d 64, 64 at
// d 128) for dQ; with a FlashMask, `fm_bands` is (b, fm_heads, fm_skp, 4)
// int32 contiguous, each column's two bands [lo1, hi1) and [lo2, hi2); with
// segment ids or positions, their stats per query tile (64 rows for dK/dV,
// 128 for dQ) and key tile of the kernel launched, and the tile range per
// block (dK/dV: per 128-key block over query tiles; dQ: per 128-row block
// over key tiles). With a mask, `counters` is three int32 in device memory,
// cleared here on
// the stream: the dynamic scheduler's next block, then the tiles the
// kernel visits and those of them with the elementwise test (bwd.py
// bwd_masked_dkv_tile_plan / bwd_masked_dq_tile_plan count the same).
// dk/dv are written by xfa_flash_bwd_dkv, dq by xfa_flash_bwd_dq; each
// launch overwrites its outputs (no zero fill needed) for sq, sk > 0. The
// forward's bias (XFA_BIAS_ARGS), or a null pointer, selects the bias
// instantiations; the forward's dropout (XFA_DROPOUT_ARGS) with `drop` set
// the dropout instantiations, which take no bias.
#define XFA_BWD_ARGS                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, void *dq, void *dk, void *dv, int64_t q_sb, int64_t q_sh, int64_t q_ss, \
      int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,      \
      int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, \
      int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, \
      int b, int h, int hk, int sq, int sk, int d, float sm_scale, float softcap, int causal,    \
      XFA_MASK_ARGS, const void *fm_bands, void *counters, XFA_BIAS_ARGS, XFA_DROPOUT_ARGS,      \
      void *stream
#define XFA_BWD_PARAMS                                                                         \
  if (drop && bias != nullptr) return static_cast<int>(cudaErrorInvalidValue);                 \
  const xfa::MaskParams mask = XFA_MASK_VALUES;                                                \
  const bool masked = xfa::mask_active(mask);                                                  \
  const BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta),          \
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),    \
                    dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, b, h, hk,   \
                    sq, sk, sm_scale, softcap, causal, mask,                                   \
                    static_cast<const int4*>(fm_bands),                                        \
                    static_cast<int*>(counters), XFA_BIAS_VALUES, XFA_DROPOUT_VALUES};         \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                                          \
  if (masked) {                                                                                \
    if (counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);                   \
    const cudaError_t err = cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);                  \
    if (err != cudaSuccess) return static_cast<int>(err);                                      \
  }
