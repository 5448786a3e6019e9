// FlashAttention forward for bf16 q/k/v with fp32 accumulation.
//
// Replaces two TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78 `_fwd_kernel`
//     (kernel #1, driven by flash_attention_fwd, (b, h, s, d) layout), with
//     its FlashMask and block-mask flags (fwd.py:244-264), sliding window,
//     segment ids and q/kv positions (fwd.py:267-296, 353-390);
//   * xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:59
//     `_fwd_kernel` (kernel #5, the packed projection layout (b, s, h*d)).
// Both layouts reach one C entry with element strides for the batch, head
// and sequence axes of q, k, v and o (the head-dim stride is 1), so they are
// read and written in place with no copy.
//
// What it computes, as the TPU kernels do: q is scaled by sm_scale in fp32
// and rounded to bf16 before QK^T; scores accumulate in fp32; optional
// softcap tanh(s / c) * c; causal mask aligned to the bottom right (key j
// visible to query i when j <= i + sk - sq); GQA through
// kv_head = head / (h / hk); P is rounded to bf16 for P.V; the output is
// divided by the fp32 row sum; an optional fp32 LSE, (b, h, sq) contiguous
// (+inf on rows with no visible key, whose output is 0, whichever tiles
// come first).
//
// Softmax: the max-shifted online softmax. The TPU kernels use a zero shift,
// exp(min(s, 70)) (fwd.py:60-65, fused_heads.py:81). Both give the same
// P / l to fp32 rounding while scores stay under 70; the shifted form also
// stays finite above it. exp is taken as exp2 with log2(e) folded in.
//
// Bound on the H100: operations. Causal prefill at Llama-3-8B width
// (b2 h32 s2048 d128) does ~69 GFLOP (0.070 ms at 989 TFLOP/s) against
// ~50 MB of q/k/v/o traffic (0.015 ms at 3.35 TB/s), so only the tensor
// cores' rate matters, and on Hopper only wgmma reaches it. Under a sparse
// mask the work is that of the visible pairs, still operations-bound
// unless the mask leaves a few percent of them.
//
// One kernel, flash_fwd_kernel<D, MASKED, BIAS, FP8, DROPOUT>: persistent CTAs, one per SM, of
// three warpgroups; a CTA runs blocks of 128 query rows (kTileM) of one
// (batch, head).
//   - Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//     and issues TMA copies through 4-D tensor maps (d, s, h, b) built from
//     the strides: each block's Q (into the one of two buffers the
//     consumers have released), then its K and V tiles of 128 keys
//     (kTileN) into a ring of kStages stages (4 at d 64, 2 at d 128) that
//     runs on across blocks, each stage with K-full, V-full and empty
//     mbarriers. Rows or keys past sq / sk arrive as zeros and stop at the
//     batch row's end (no flattening).
//   - Warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg.inc).
//     They scale their Q rows in shared memory (fp32, rounded to bf16) and
//     fence them to the async proxy; then per key tile: S = Q K^T by
//     wgmma m64n128k16 from 128-byte-swizzled shared memory; the online
//     softmax in registers (hopper.cuh softmax_step); O += P V by wgmma
//     with P's bf16 fragment as the register A operand and V read MN-major
//     (the transpose bit on B).
//   - Dense at d 64, inside a consumer, tile i's softmax runs while tile
//     i - 1's P.V is on the tensor cores (QK^T(i) and PV(i - 1) are issued
//     together). At d 128, S, O and P in flight together are more than
//     ptxas keeps in flight (it serialises the wgmmas), and the tiles run
//     one by one; so do the masked route's at both head dims (the overlap
//     took 3-6% longer there).
//   - Epilogue: O is normalised, written to staging rows in shared memory
//     (swizzled) and stored by TMA, which drops rows past sq; the LSE by
//     one thread per row.
//
// * Dense (MASKED false): one thread of the producer issues every copy;
//   both roles walk the same blocks, taken in pairs that hold equal causal
//   work (the heavier block j from the end with block j from the start),
//   pairs dealt round-robin in head order so that the CTAs at work share
//   the K/V of a few heads in L2. The key tiles are visited from the last to
//   the first, so the tiles that need the elementwise mask (a causal
//   diagonal tile, the ragged last tile) come first and the interior ones
//   run with no mask test (fwd.py fwd_tile_plan mirrors the plan,
//   fwd_schedule the pairs; both from common.cuh key_tiles and pair_block,
//   shared with flash_bwd.cu). O is staged in a buffer of its own, and its
//   store overlaps the next block's loads.
//
// * Masked (MASKED true: FlashMask, block masks, sliding windows, segment
//   ids and positions). Which tiles a block
//   visits depends on the data, so the producer decides and the consumers
//   follow, as in the masked backward (flash_bwd.cu), with common.cuh's
//   producer code: warp 0 of the producer warpgroup evaluates the block's
//   candidate tiles (those of the dense plan) 32 at a time, a lane each, from
//   the FlashMask stats per 128-key tile and the block-mask entries per 64-row
//   x 64-key part (a 128-key tile straddles two entries at granularity 64:
//   row_block_tile_flags, the dQ kernel's decision at its 128-key tiles). Its
//   lane 0 loads each visited tile, with the tile's FlashMask bands [lo1,
//   hi1), [lo2, hi2) per key (ops common.py fm_bands, by a 2-D TMA box), and a
//   word in the stage: the first key and the flags (the elementwise test, the
//   band test, the segment / position test, each consumer's two 64-key
//   parts). The candidates are the key tiles of the row/key window
//   (common.cuh key_window: a window's tiles [lo, hi), not every tile of the
//   row; causal is right 0), cut to the block's tile range from the segment
//   and position stats, each decided from the stats per 128-row block and
//   128-key tile (token_flags). A tile with the segment / position test
//   arrives with its keys' (segment id, position) by a 2-D TMA box, and a
//   block with them its queries' with its Q; the consumers make their rows'
//   limits per tile (common.cuh row_limit): two compares per element for
//   the window and sk, three for segments and positions. A consumer with no part on a
//   tile passes it by and still arrives on the stage's empty barrier. Tiles
//   that need the elementwise test come first; it is branch-free (bitwise &/|
//   on the causal and sk limits, the part and the bands). Blocks come from a
//   dynamic scheduler (common.cuh next_block, the masked backward's: an
//   atomicAdd on a counter the entry clears with a memset on the stream, so a
//   CUDA graph replays it), the heaviest pair of every head first; each block
//   reaches the consumers in a slot of its Q buffer, kEnd after the last, and
//   a word kEnd ends its tiles. The producer decides one block ahead: while
//   the ring is full it takes the next block and decides its first 32
//   candidates, so that the scheduler's atomic and the mask reads (the four
//   block-mask entries of a candidate loaded together) do not stall the
//   consumers between blocks (scripts/ab_flash_fwd.py: 9-11% at BS, 3-4% at
//   FM-swg). A block with no visited tile still runs its epilogue (O = 0, LSE
//   +inf). The producer adds the tiles it emitted, and those with the
//   elementwise test, to two counters beside the scheduler's (fwd.py
//   fwd_masked_tile_plan counts the same). O is staged in the block's own Q
//   buffer (the room the bands take at d 128), which is released once the TMA
//   store has read it.
//
// * Attention bias (BIAS true, either instantiation; fwd.py:353-354 and
//   853-873 of the TPU package): a (bb, bh, sq, sk) fp32 or bf16 tensor,
//   broadcast by strides (common.cuh BiasParams), added to each score after
//   softcap and before the masks, in the scores' own units (softmax_step
//   folds log2(e) in after). Shared memory is full at d 128 (230 480 of 232
//   448 bytes), so each consumer thread reads its fragment's bias straight
//   from global memory (common.cuh load_bias_rows: a key pair per load),
//   issued after the tile's QK^T so that the loads run under the product.
//   Timed on the card (scripts/ab_trees.py --bias-only; PERF.md section
//   6): loads guarded per pair took 30-40% longer than unconditional loads
//   clamped into the tensor (every element they fetch past sq or sk is
//   masked or dropped); a bias shared by the batches is read by blocks
//   taken batch first (common.cuh pair_block_by), so that the CTAs at work
//   share one head's bias in L2 (T-long's (1, h, s, s): -25%). What is left
//   is L2 traffic: a tile's fp32 bias is 64 KB a CTA, as much as its K and
//   V at d 128, twice them at d 64, read again by every (batch, head) that
//   shares it.
//
// * Attention dropout (DROPOUT true, either instantiation, no bias and no
//   e4m3; fwd.py:312-327 of the TPU package): after each tile's online
//   softmax has taken the undropped P into the row sums, each consumer
//   thread hashes the global (row, key) of its accumulator registers
//   (common.cuh dropout_each: the fragment map of the mask code, a base
//   per row and a constant per register, then the finalizer) with the
//   (batch, head) key of the seed and salt, and zeroes the dropped
//   elements of P before it goes to P.V; 1 / (1 - p) joins the epilogue's
//   1 / l. The hash is integer work, about 11 instructions an element: at
//   d 64 it is as much as the tile's tensor-core time (PERF.md section 6).
//
// * e4m3 (FP8 true, with the dense schedule; flash_attn_fp8_func, the TPU
//   kernel's fp8 flag, fwd.py:111, 153-168, 334-344, 392, 639-652, 915): q,
//   k and v float8_e4m3fn with per-(batch, KV head) fp32 descales (q's
//   indexed by KV head, as FA3), bf16 out, the LSE of the descaled scores;
//   causal, sliding windows, softcap and GQA, no mask, bias or dropout, as
//   in the TPU package. Three changes to the dense route:
//   - QK^T on e4m3 wgmma (m64n128k32, Q and K K-major as TMA loads them:
//     a row is D bytes, one 128-byte swizzle row at d 128, a 64-byte
//     swizzled row at d 64), the fp32 scores then times sm_scale * qd * kd
//     (e4m3 products are exact in fp32, so this is at least as precise as
//     the TPU kernel's rounding of the scaled q to bf16);
//   - P.V in f16: FP8 wgmma takes only K-major B, and V (keys x d) is
//     MN-major for P.V, so the producer warpgroup's three idle warps turn
//     each e4m3 V tile (loaded unswizzled into a staging stage) into an
//     f16 tile in the bf16 V layout (exact: every e4m3 value is an f16
//     value), and the consumers run the RS f16 wgmma with P rounded to f16
//     (finer than the TPU kernel's bf16 P); v_descale joins the epilogue's
//     1 / l; the tiles run one after the other at both head dims;
//   - a window: each block visits the key tiles [lo, hi) of its rows'
//     window (common.cuh key_window, causal its right bound 0), the tiles
//     outside the free range [f_lo, f_hi) with the elementwise test.
//
// Shared memory: d 128: 2 x Q 32 KB + 2 x (K 32 + V 32) KB + O 32 KB
// (dense) or bands and keys' info 2 x (2 + 2) KB (masked); d 64: 2 x Q 16 KB
// + 4 x (K 16 + V 16) KB + O 16 KB (dense) or 4 x (2 + 2) KB (masked);
// e4m3: d 128: 2 x Q 16 KB + O 32 KB + 2 x (K 16 + V staging 16 + V f16
// 32) KB = 192 KB; d 64: 2 x Q 8 KB + O 16 KB + 4 x (8 + 8 + 16) KB = 160
// KB. Not yet used: ping-pong
// ordering of the two consumers, TMA multicast of K/V across a cluster.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::kBand;
using xfa::kElem;
using xfa::kEnd;
using xfa::kBlockInfoBytes;
using xfa::kInfo;
using xfa::kOnShift;
using xfa::pack_bf16;
namespace sm90 = xfa::sm90;
using sm90::issue_pv;
using sm90::issue_qk;

constexpr int kTileM = 128;  // query rows per block (fwd.py FWD_DENSE_TILE_M)
constexpr int kTileN = 128;  // keys per tile (fwd.py FWD_DENSE_TILE_N)
constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 8192;  // one 64-row x 128-byte swizzled box
constexpr int kBandBytes = kTileN * 16;  // a tile's FlashMask bands, int4 per key
static_assert(kTileN == sm90::kKeyTile && kBox == sm90::kBox64,
              "the tiles of hopper.cuh's issue_qk and issue_pv");
static_assert(kTileM == xfa::kRowBlock, "the masked producer's row block");

template <int D, bool MASKED, bool FP8 = false>
struct FwdSmem {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) tiles of a row
  // Q (two buffers) and O: [consumer 2][half][64 rows][128 B]; a K or V
  // stage: [half][128 keys][128 B]. FP8: Q and K rows of D e4m3 bytes, V
  // staged in e4m3 ([128 keys][D B], no swizzle) and converted to f16 in
  // the bf16 V layout
  static constexpr int kQWarpgroup = FP8 ? 64 * D : kHalves * kBox;
  static constexpr int kQBuffer = 2 * kQWarpgroup;
  static constexpr int kOWarpgroup = kHalves * kBox;
  static constexpr int kStage = kTileN * D * 2;
  static constexpr int kStage8 = FP8 ? kTileN * D : 0;  // an e4m3 K or staged V tile
  static constexpr int kQ = 0;
  // dense: O's staging buffer; masked: O is staged in its block's Q buffer
  static constexpr int kO = kQ + 2 * kQBuffer;
  static constexpr int kK = kO + (MASKED ? 0 : 2 * kOWarpgroup);
  static constexpr int kV = kK + kStages * (FP8 ? kStage8 : kStage);
  static constexpr int kV8 = kV + kStages * kStage;
  // masked: each stage's FlashMask bands, its keys' (segment, position)
  // info and word, each Q buffer's queries' info and block
  static constexpr int kBands = kV8 + kStages * kStage8;
  static constexpr int kKInfo = kBands + (MASKED ? kStages * kBandBytes : 0);
  static constexpr int kQInfo = kKInfo + (MASKED ? kStages * kBandBytes : 0);
  static constexpr int kWord = kQInfo + (MASKED ? 2 * kBlockInfoBytes : 0);
  static constexpr int kBlk = kWord + (MASKED ? kStages * 16 : 0);
  // barriers: Q full[2], Q empty[2], K full[], V full[], K/V empty[];
  // FP8: V staged[]
  static constexpr int kBar = kBlk + (MASKED ? 32 : 0);
  static constexpr int kBytes = kBar + 8 * (4 + (FP8 ? 4 : 3) * kStages) + 1024;  // + slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct FwdParams {
  float* lse;  // (b, h, sq) contiguous, or null
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
  // the masked instantiation: the flags (FlashMask stats per 128-key tile)
  // and three counters: the dynamic scheduler's next item, the tiles the
  // producers emit and those of them with the elementwise test
  xfa::MaskParams mask;
  int* next;
  // the bias instantiations' bias (common.cuh BiasParams)
  xfa::BiasParams bias;
  // the e4m3 instantiation's (b, hk) descales, each null for ones; its
  // window is mask.left / mask.right (causal: right 0)
  const float *qd, *kd, *vd;
  // the dropout instantiations' seed, threshold and scale
  xfa::DropoutParams drop;
};

// The online softmax of one tile's scores s (columns n0 .. n0 + kTileN - 1;
// this thread's rows row0 and row0 + 8), in place: softcap, with BIAS the
// tile's bias `bv` (common.cuh load_bias_rows; added in the scores' own
// units, before softmax_step folds log2(e) into the exponent), with MASK
// the elementwise causal / sk test, then hopper.cuh's softmax_step (the
// paged prefill shares it): the running max m_i, s = P in fp32, this
// thread's share of the row sums l_i (the quad is summed at the end) and
// alpha, the factor that takes the running O to the new max.
template <bool MASK, bool BIAS = false>
__device__ __forceinline__ void online_softmax(float (&s)[kTileN / 2], float (&m_i)[2],
                                               float (&l_i)[2], float (&alpha)[2], int n0,
                                               int row0, const FwdParams& p, int t,
                                               const float* bv = nullptr) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) s[i] = tanhf(s[i] / p.softcap) * p.softcap;
  }
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) s[i] += bv[i];
  }
  if (MASK) {
    const int last = p.causal ? row0 + p.sk - p.sq : p.sk;  // row0's last visible key
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) {
      const int col = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
      const int lim = last + ((i >> 1) & 1) * 8;
      if (col >= p.sk || col > lim) s[i] = -INFINITY;
    }
  }
  sm90::softmax_step(s, m_i, l_i, alpha);
}

// The masked instantiation's online softmax of one tile: softcap and, with
// ELEM, the elementwise test, all bitwise: the key below sk, the row/key
// window (causal is its right bound 0), the consumer's part of the tile's
// keys (`parts`: bit 0 keys [0, 64), bit 1 [64, 128)), with NB > 0 each
// column's first NB FlashMask bands (`bands`, in the stage) and with INFO
// each key's segment id and position (`kinfo`, in the stage) against the
// row's (`qinfo`: row0's, staged with Q; row0 + 8's 8 further), with
// BIAS the bias `bv` added before the test; then softmax_step.
template <bool ELEM, int NB, bool INFO, bool BIAS = false>
__device__ __forceinline__ void masked_softmax(float (&s)[kTileN / 2], float (&m_i)[2],
                                               float (&l_i)[2], float (&alpha)[2], int n0,
                                               int row0, int parts, const int4* bands,
                                               const int4* kinfo, const int4* qinfo,
                                               const FwdParams& p, int t,
                                               const float* bv = nullptr) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) s[i] = tanhf(s[i] / p.softcap) * p.softcap;
  }
  if constexpr (BIAS) {
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) s[i] += bv[i];
  }
  if (ELEM) {
    int lo[2], hi[2];
    int4 qt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      xfa::row_limit(p.mask, row0 + 8 * r, p.sq, p.sk, lo[r], hi[r]);
      if (INFO) qt[r] = xfa::query_tokens(p.mask, xfa::token_at(qinfo, 8 * r));
    }
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1), col = n0 + c;
      const int r = (i >> 1) & 1, row = row0 + r * 8;
      bool visible = (col <= hi[r]) & (col >= lo[r]) &
                     (((parts >> (i >= kTileN / 4 ? 1 : 0)) & 1) != 0);
      if (NB > 0) visible = visible & !xfa::banned<NB>(bands[c], row);  // the load unconditional
      if (INFO) visible = visible & xfa::tokens_meet(qt[r], xfa::token_at(kinfo, c));
      s[i] = visible ? s[i] : -INFINITY;
    }
  }
  sm90::softmax_step(s, m_i, l_i, alpha);
}

// P in bf16 pairs: pa[4kk .. 4kk + 3] is the A fragment of k-step kk
__device__ __forceinline__ void pack_p(const float (&s)[kTileN / 2], uint32_t (&pa)[kTileN / 4]) {
#pragma unroll
  for (int i = 0; i < kTileN / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// A consumer's Q rows * sm_scale in fp32, rounded to bf16, in place (every
// element alike, so the swizzle does not matter), fenced to the async
// proxy for wgmma.
template <int BYTES>
__device__ __forceinline__ void scale_q(uint8_t* q_wg, int wt, float sm_scale) {
  uint4* qv = reinterpret_cast<uint4*>(q_wg);
  for (int c = wt; c < BYTES / 16; c += 128) {
    uint4 x = qv[c];
    uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
      w[j] = pack_bf16(f.x * sm_scale, f.y * sm_scale);
    }
    qv[c] = x;
  }
  sm90::fence_proxy_async();  // the writes above, before wgmma reads them
}

// O * inv (per row) as bf16 into a consumer's staging rows, in the swizzled
// layout the TMA store reads.
template <int D>
__device__ __forceinline__ void stage_o(uint8_t* o_wg, const float (&o)[D / 2],
                                        const float (&inv)[2], int warp, int g, int t) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = warp * 16 + g + 8 * rr;
      const int off = (j >> 3) * kBox + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4;
      *reinterpret_cast<uint32_t*>(o_wg + off) =
          pack_bf16(o[4 * j + 2 * rr] * inv[rr], o[4 * j + 2 * rr + 1] * inv[rr]);
    }
  }
}

// The quad's row sums into l_i and their inverses (0 for a row with none).
__device__ __forceinline__ void row_sums(float (&l_i)[2], float (&inv)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
    inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
  }
}

// The LSE of this thread's rows row0 and row0 + 8 (+inf on a row with no
// visible key), by one thread of the quad.
__device__ __forceinline__ void store_lse(const FwdParams& p, int batch, int head, int row0,
                                          const float (&m_i)[2], const float (&l_i)[2], int t) {
  if (p.lse == nullptr || t != 0) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row < p.sq)
      p.lse[(static_cast<int64_t>(batch) * p.h + head) * p.sq + row] =
          l_i[rr] > 0.f ? m_i[rr] + logf(l_i[rr]) : INFINITY;
  }
}

constexpr int kConverters = 96;  // the producer warpgroup's warps 1-3

// Two e4m3 pairs (a 32-bit word) as two f16 pairs.
__device__ __forceinline__ void e4m3x4_to_f16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const __half2_raw a =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w & 0xFFFF), __NV_E4M3);
  const __half2_raw b =
      __nv_cvt_fp8x2_to_halfraw2(static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3);
  lo = static_cast<uint32_t>(a.x) | (static_cast<uint32_t>(a.y) << 16);
  hi = static_cast<uint32_t>(b.x) | (static_cast<uint32_t>(b.y) << 16);
}

// P in f16 pairs: pa[4kk .. 4kk + 3] is the A fragment of k-step kk
__device__ __forceinline__ void pack_p_f16(const float (&s)[kTileN / 2],
                                           uint32_t (&pa)[kTileN / 4]) {
#pragma unroll
  for (int i = 0; i < kTileN / 4; ++i) {
    __half2 v = __floats2half2_rn(s[2 * i], s[2 * i + 1]);
    pa[i] = *reinterpret_cast<uint32_t*>(&v);
  }
}

// The e4m3 instantiation's key tiles of the block at q0: [lo, hi) under
// the window, the free ones [f_lo, f_hi) (common.cuh key_window).
__device__ __forceinline__ void fp8_tiles(const FwdParams& p, int q0, int& lo, int& hi, int& f_lo,
                                          int& f_hi) {
  xfa::key_window<kTileM, kTileN>(p.mask, 0, q0, p.sq, p.sk, lo, hi, f_lo, f_hi);
}

// The e4m3 instantiation's online softmax of one tile: the scores times
// sm_scale * q_descale * k_descale, softcap, with ELEM the elementwise
// window / sk test (the tiles outside the free range), then softmax_step.
__device__ __forceinline__ void fp8_softmax(float (&s)[kTileN / 2], float (&m_i)[2],
                                            float (&l_i)[2], float (&alpha)[2], int n0,
                                            int row0, bool elem, float qk_scale,
                                            const FwdParams& p, int t) {
#pragma unroll
  for (int j = 0; j < kTileN / 2; ++j) s[j] *= qk_scale;
  if (p.softcap > 0.f) {
#pragma unroll
    for (int j = 0; j < kTileN / 2; ++j) s[j] = tanhf(s[j] / p.softcap) * p.softcap;
  }
  if (elem) {
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) xfa::row_limit(p.mask, row0 + 8 * r, p.sq, p.sk, lo[r], hi[r]);
#pragma unroll
    for (int j = 0; j < kTileN / 2; ++j) {
      const int col = n0 + (j >> 2) * 8 + 2 * t + (j & 1), r = (j >> 1) & 1;
      s[j] = (col >= lo[r]) & (col <= hi[r]) ? s[j] : -INFINITY;
    }
  }
  sm90::softmax_step(s, m_i, l_i, alpha);
}

template <int D, bool MASKED, bool BIAS, bool FP8, bool DROPOUT = false>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const __grid_constant__ CUtensorMap tbands,
                     const __grid_constant__ CUtensorMap tkinfo,
                     const __grid_constant__ CUtensorMap tqinfo, const FwdParams p) {
  static_assert(!FP8 || !(MASKED || BIAS), "the e4m3 instantiation is dense, with no bias");
  static_assert(!DROPOUT || !(FP8 || BIAS), "dropout takes no e4m3 and no bias");
  using S = FwdSmem<D, MASKED, FP8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 16;  // [2] each
  const uint32_t bar_k = bar_qe + 16, bar_v = bar_k + 8 * S::kStages, bar_e = bar_v + 8 * S::kStages;
  const uint32_t bar_v8 = bar_e + 8 * S::kStages;  // FP8: V staged in e4m3
  const int n_mb = (p.sq + kTileM - 1) / kTileM;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);
  // a bias shared by every batch: blocks batch first (common.cuh pair_block_by)
  const bool batch_fast = BIAS && p.bias.sb == 0 && p.b > 1;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(bar_q + 8 * qb, 1);
      // dense: the eight consumer warps after the block's last QK^T; masked:
      // one thread of each consumer once O's store has read the buffer
      sm90::mbar_init(bar_qe + 8 * qb, MASKED ? 2 : 8);
    }
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_k + 8 * st, 1);
      // FP8: V full once the converting warps have written its f16 copy
      sm90::mbar_init(bar_v + 8 * st, FP8 ? kConverters : 1);
      sm90::mbar_init(bar_e + 8 * st, 8);
      if constexpr (FP8) sm90::mbar_init(bar_v8 + 8 * st, 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup index, warp-uniform for the compiler: the two roles are
  // one if-else that never reconverges, so each keeps its own register
  // budget. Dense, both roles walk the same blocks and count the same K/V
  // tiles (it, the ring position) and Q loads (qk, a ring of two buffers),
  // so stages and parities agree without any other exchange. Masked, the
  // consumers take each block from its Q buffer's slot (every block takes
  // a buffer, loaded or not) and each tile from its stage's word.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    // ---- producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    int it = 0, qk = 0;
    // Q of the block at q0 into buffer qb; the second consumer's rows may
    // lie wholly past sq: not loaded (it computes on stale rows that the
    // store drops)
    auto load_q = [&](int qb, int q0, int head, int batch, uint32_t extra = 0) {
      const int wgs = q0 + 64 < p.sq ? 2 : 1;
      sm90::mbar_expect_tx(bar_q + 8 * qb, wgs * S::kQWarpgroup + extra);
      for (int w = 0; w < wgs; ++w) {
        if constexpr (FP8) {  // a row of D e4m3 bytes: one box
          sm90::tma_load_4d(base + S::kQ + qb * S::kQBuffer + w * S::kQWarpgroup, &tq,
                            bar_q + 8 * qb, 0, q0 + w * 64, head, batch);
        } else {
          for (int hf = 0; hf < S::kHalves; ++hf)
            sm90::tma_load_4d(base + S::kQ + qb * S::kQBuffer + w * S::kQWarpgroup + hf * kBox,
                              &tq, bar_q + 8 * qb, hf * 64, q0 + w * 64, head, batch);
        }
      }
    };
    // K and V of the tile at n0 into stage st (K-full also waits for `extra`
    // bytes: the masked tile's bands)
    auto load_kv = [&](int st, int n0, int kv_head, int batch, uint32_t extra) {
      if constexpr (FP8) {  // K, and V into its staging stage (the converters' barrier)
        sm90::mbar_expect_tx(bar_k + 8 * st, S::kStage8);
        sm90::tma_load_4d(base + S::kK + st * S::kStage8, &tk, bar_k + 8 * st, 0, n0, kv_head,
                          batch);
        sm90::mbar_expect_tx(bar_v8 + 8 * st, S::kStage8);
        sm90::tma_load_4d(base + S::kV8 + st * S::kStage8, &tv, bar_v8 + 8 * st, 0, n0, kv_head,
                          batch);
        return;
      }
      const uint32_t k_st = base + S::kK + st * S::kStage;
      const uint32_t v_st = base + S::kV + st * S::kStage;
      sm90::mbar_expect_tx(bar_k + 8 * st, S::kStage + extra);
      for (int hf = 0; hf < S::kHalves; ++hf)
        sm90::tma_load_4d(k_st + hf * kTileN * 128, &tk, bar_k + 8 * st, hf * 64, n0, kv_head,
                          batch);
      sm90::mbar_expect_tx(bar_v + 8 * st, S::kStage);
      for (int hf = 0; hf < S::kHalves; ++hf)
        sm90::tma_load_4d(v_st + hf * kTileN * 128, &tv, bar_v + 8 * st, hf * 64, n0, kv_head,
                          batch);
    };
    if constexpr (!MASKED) {
      // one thread keeps the TMA copies in flight
      if (threadIdx.x == 0) {
        for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            int m_block, head, batch, n_tiles, n_free;
            if (!xfa::pair_block_by(batch_fast, pair, half, n_mb, p.h, p.b, true, m_block, head,
                                    batch))
              continue;
            int hi = 0;  // FP8: the window's tiles [hi - n_tiles, hi)
            if constexpr (FP8) {
              int lo, f_lo, f_hi;
              fp8_tiles(p, m_block * kTileM, lo, hi, f_lo, f_hi);
              n_tiles = hi - lo;
            } else {
              xfa::key_tiles<kTileM, kTileN>(m_block * kTileM, p.sq, p.sk, p.causal, n_tiles,
                                             n_free);
            }
            if (n_tiles == 0) continue;
            const int qb = qk & 1;
            sm90::mbar_wait(bar_qe + 8 * qb, ((qk >> 1) & 1) ^ 1);  // the first pass is free
            load_q(qb, m_block * kTileM, head, batch);
            ++qk;
            const int kv_head = head / (p.h / p.hk);
            for (int i = 0; i < n_tiles; ++i, ++it) {
              const int st = it % S::kStages;
              // the first pass over the ring is free
              sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
              load_kv(st, ((FP8 ? hi : n_tiles) - 1 - i) * kTileN, kv_head, batch, 0);
            }
          }
        }
      } else if (FP8 && threadIdx.x >= 32) {
        // ---- FP8, warps 1-3: each staged e4m3 V tile (rows of D bytes, no
        // swizzle) into f16 in issue_pv's layout ([half][key][128 B],
        // 128-byte swizzled; exact, every e4m3 value is an f16 value), then
        // fenced to the async proxy
        const int ct = threadIdx.x - 32;
        for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            int m_block, head, batch, lo, hi, f_lo, f_hi;
            if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
            fp8_tiles(p, m_block * kTileM, lo, hi, f_lo, f_hi);
            for (int i = 0; i < hi - lo; ++i, ++it) {
              const int st = it % S::kStages;
              sm90::mbar_wait(bar_v8 + 8 * st, (it / S::kStages) & 1);
              const uint4* src = reinterpret_cast<const uint4*>(smem + S::kV8 + st * S::kStage8);
              uint8_t* dst = smem + S::kV + st * S::kStage;
              for (int c = ct; c < S::kStage8 / 16; c += kConverters) {
                const int r = c / (D / 16), col16 = c % (D / 16);  // 16 e4m3 values
                const uint4 x = src[c];
                uint4 a, b;
                e4m3x4_to_f16(x.x, a.x, a.y);
                e4m3x4_to_f16(x.y, a.z, a.w);
                e4m3x4_to_f16(x.z, b.x, b.y);
                e4m3x4_to_f16(x.w, b.z, b.w);
                uint8_t* row = dst + (col16 >> 2) * (kTileN * 128) + r * 128;
                const int j = 2 * (col16 & 3);  // 16-byte chunks j and j + 1 of the half
                *reinterpret_cast<uint4*>(row + ((j ^ (r & 7)) << 4)) = a;
                *reinterpret_cast<uint4*>(row + (((j + 1) ^ (r & 7)) << 4)) = b;
              }
              sm90::fence_proxy_async();
              sm90::mbar_arrive(bar_v + 8 * st);
            }
          }
        }
      }
    } else if (threadIdx.x < 32) {
      // ---- the masked producer: its whole warp decides, lane 0 issues (and
      // keeps the counts it and qk, and the tiles it emits and those of them
      // with the elementwise test). The warp decides one block ahead: it
      // takes the next block and decides its first 32 candidates (a lane
      // each) while the ring is full, so that the scheduler's atomic and the
      // mask reads do not stall the consumers between blocks.
      const xfa::MaskParams& m = p.mask;
      const int lane = threadIdx.x;
      const bool lead = lane == 0;
      int tiles = 0, elem = 0;
      struct Block {
        bool more;
        int m_block, head, batch;
        int lo, hi, f_lo, f_hi;  // the candidate key tiles [lo, hi), the free [f_lo, f_hi)
        int f;  // this lane's flags of candidate `lane` (-1: skipped or none)
        __device__ __forceinline__ int n_tiles() const { return hi - lo; }
      };
      auto flags_of = [&](const Block& k, int i) {
        const int tile = k.hi - 1 - i;
        return xfa::row_block_tile_flags<kTileN>(m, k.batch, k.head, p.h, p.sq, p.sk,
                                                 k.m_block * kTileM, tile * kTileN,
                                                 (tile < k.f_lo) | (tile >= k.f_hi));
      };
      auto take = [&](Block& k) {
        k.m_block = k.head = k.batch = k.lo = k.hi = k.f_lo = k.f_hi = 0;
        k.more =
            xfa::next_block_by(batch_fast, p.next, p.b, n_mb, p.h, true, k.m_block, k.head,
                               k.batch);
        if (k.more)
          xfa::key_window<kTileM, kTileN>(m, k.batch, k.m_block * kTileM, p.sq, p.sk, k.lo, k.hi,
                                          k.f_lo, k.f_hi);
      };
      auto decide = [&](Block& k) { k.f = lane < k.n_tiles() ? flags_of(k, lane) : -1; };
      Block cur, nxt;
      take(cur);
      bool decided = false;  // cur's first candidates decided ahead
      for (;;) {
        const int q0 = cur.m_block * kTileM, head = cur.head, batch = cur.batch;
        const int qb = qk & 1;
        if (lead) {
          sm90::mbar_wait(bar_qe + 8 * qb, ((qk >> 1) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kBlk + 16 * qb) =
              make_int4(cur.more ? cur.m_block : kEnd, head, batch, cur.n_tiles() > 0);
          if (cur.n_tiles() > 0) {
            // with segments or positions, the block's queries' info too
            const bool info = m.q_info != nullptr;
            load_q(qb, q0, head, batch, info ? kBlockInfoBytes : 0);
            if (info)
              sm90::tma_load_2d(base + S::kQInfo + qb * kBlockInfoBytes, &tqinfo, bar_q + 8 * qb,
                                0, batch * m.q_pad + q0);
          } else {
            sm90::mbar_arrive(bar_q + 8 * qb);
          }
        }
        ++qk;
        if (!cur.more) break;
        if (!decided) decide(cur);  // after the Q load is on its way
        const int kv_head = head / (p.h / p.hk);
        const int64_t band_row =
            m.fm_vecs != nullptr
                ? static_cast<int64_t>(batch * m.fm_heads + xfa::fm_head(m, head, p.h)) * m.fm_skp
                : 0;
        bool ahead = false;  // nxt taken and decided
        const int info_row = batch * m.k_pad;
        xfa::emit_tiles(
            cur.n_tiles(),
            [&](int i, int& n0) {
              n0 = (cur.hi - 1 - i) * kTileN;
              return i < 32 ? cur.f : flags_of(cur, i);  // i == lane below 32
            },
            [&](int n0, int flags) {
              const int st = it % S::kStages;
              sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
              *reinterpret_cast<int4*>(smem + S::kWord + 16 * st) = make_int4(n0, flags, 0, 0);
              const bool band = flags & kBand, info = flags & kInfo;
              load_kv(st, n0, kv_head, batch, (band ? kBandBytes : 0) + (info ? kBandBytes : 0));
              if (band)
                sm90::tma_load_2d(base + S::kBands + st * kBandBytes, &tbands, bar_k + 8 * st, 0,
                                  static_cast<int>(band_row + n0));
              if (info)
                sm90::tma_load_2d(base + S::kKInfo + st * kBandBytes, &tkinfo, bar_k + 8 * st, 0,
                                  info_row + n0);
              ++it;
              ++tiles;
              elem += flags & kElem;
            },
            [&]() {  // the whole warp, before each tile: decide ahead while the ring is full
              if (ahead) return;
              const int st = it % S::kStages;
              const bool full =
                  lead && !sm90::mbar_test(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
              if (__shfl_sync(0xffffffffu, static_cast<int>(full), 0)) {
                take(nxt);
                decide(nxt);
                ahead = true;
              }
            });
        if (lead) {  // the block's end: both full barriers complete their phase
          const int st = it % S::kStages;
          sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kWord + 16 * st) = make_int4(kEnd, 0, 0, 0);
          sm90::mbar_arrive(bar_k + 8 * st);
          sm90::mbar_arrive(bar_v + 8 * st);
        }
        ++it;
        if (!ahead) take(nxt);
        cur = nxt;
        decided = ahead;
      }
      if (lead) {
        atomicAdd(p.next + 1, tiles);
        atomicAdd(p.next + 2, elem);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    auto stage = [&](int i) { return i % S::kStages; };
    auto parity = [&](int i) { return static_cast<uint32_t>((i / S::kStages) & 1); };
    int it = 0, qk = 0;

    if constexpr (!MASKED) {
      const uint32_t o_wg = base + S::kO + cw * S::kOWarpgroup;
      uint8_t* o_wg_ptr = smem + S::kO + cw * S::kOWarpgroup;
      bool stored = false;  // this thread has a TMA store in flight

      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, n_tiles, n_free;
          if (!xfa::pair_block_by(batch_fast, pair, half, n_mb, p.h, p.b, true, m_block, head,
                                  batch))
            continue;
          // FP8: the window's tiles [lo, hi), the free ones [f_lo, f_hi), and
          // the descales of the block's KV head
          int lo = 0, hi = 0, f_lo = 0, f_hi = 0;
          float qk_scale = 1.f, v_scale = 1.f;
          if constexpr (FP8) {
            fp8_tiles(p, m_block * kTileM, lo, hi, f_lo, f_hi);
            n_tiles = hi - lo;
            n_free = 0;
            const int64_t dsc = static_cast<int64_t>(batch) * p.hk + head / (p.h / p.hk);
            qk_scale = p.sm_scale * (p.qd != nullptr ? p.qd[dsc] : 1.f) *
                       (p.kd != nullptr ? p.kd[dsc] : 1.f);
            v_scale = p.vd != nullptr ? p.vd[dsc] : 1.f;
          } else {
            xfa::key_tiles<kTileM, kTileN>(m_block * kTileM, p.sq, p.sk, p.causal, n_tiles,
                                           n_free);
          }
          const int q0 = m_block * kTileM;
          const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
          const int n_masked = n_tiles - n_free;           // the first tiles visited
          auto col0 = [&](int i) { return ((FP8 ? hi : n_tiles) - 1 - i) * kTileN; };
          // BIAS: the tile's bias, loaded under its QK^T
          const int64_t bias_base = batch * p.bias.sb + head * p.bias.sh;
          float bv[BIAS ? kTileN / 2 : 1];
          auto load_bias = [&](int n0) {
            if constexpr (BIAS)
              xfa::load_bias_rows<kTileN>(bv, p.bias, bias_base, row0, n0, p.sq, p.sk, t);
          };

          float o[D / 2];
#pragma unroll
          for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
          float m_i[2] = {-INFINITY, -INFINITY};
          float l_i[2] = {0.f, 0.f};

          const int qb = qk & 1;
          const uint32_t q_wg = base + S::kQ + qb * S::kQBuffer + cw * S::kQWarpgroup;
          uint8_t* q_wg_ptr = smem + S::kQ + qb * S::kQBuffer + cw * S::kQWarpgroup;
          if (n_tiles > 0) {
            sm90::mbar_wait(bar_q + 8 * qb, (qk >> 1) & 1);
            if constexpr (!FP8) {  // FP8: the scale goes onto the scores
              scale_q<S::kQWarpgroup>(q_wg_ptr, wt, p.sm_scale);
              sm90::named_barrier(1 + cw, 128);
            }
            ++qk;
          }
          // after the block's last QK^T: its Q buffer may be loaded again
          auto q_done = [&]() {
            if (lane == 0) sm90::mbar_arrive(bar_qe + 8 * qb);
          };

          float s[kTileN / 2];
          uint32_t pa[kTileN / 4];
          float alpha[2];
          // DROPOUT: P's dropped elements of the tile at n0 to 0, after the
          // row sums took them (1 / (1 - p) joins the epilogue)
          const uint32_t dkey = DROPOUT ? xfa::dropout_key(p.drop, batch, head, p.h) : 0u;
          auto drop_p = [&](int n0) {
            if constexpr (DROPOUT)
              xfa::dropout_each<kTileN / 2, false>(p.drop, dkey, row0, n0, t,
                                                   [&](int i, bool keep) {
                                                     if (!keep) s[i] = 0.f;
                                                   });
          };
          if constexpr (D == 64 && !FP8) {
            // Tile i's softmax runs while tile i - 1's P.V is on the tensor
            // cores: QK^T(i) and PV(i - 1) are issued together, QK^T(i) is
            // waited for (wgmma groups complete in order), then PV(i - 1);
            // then O is rescaled and P(i) packed into the registers PV(i - 1)
            // read.
            if (n_tiles > 0) {
              sm90::mbar_wait(bar_k + 8 * stage(it), parity(it));
              sm90::wgmma_fence();
              issue_qk<D>(s, q_wg, base + S::kK + stage(it) * S::kStage);
              load_bias(col0(0));
              sm90::wgmma_wait<0>();
              sm90::fence_regs(s);
              if (n_tiles == 1) q_done();
              if (n_masked > 0) {
                online_softmax<true, BIAS>(s, m_i, l_i, alpha, col0(0), row0, p, t, bv);
              } else {
                online_softmax<false, BIAS>(s, m_i, l_i, alpha, col0(0), row0, p, t, bv);
              }
              drop_p(col0(0));
              pack_p(s, pa);
            }
            for (int i = 1; i < n_tiles; ++i) {
              const int cur = it + i, st = stage(cur), prev = stage(cur - 1);
              sm90::mbar_wait(bar_k + 8 * st, parity(cur));
              sm90::mbar_wait(bar_v + 8 * prev, parity(cur - 1));
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              sm90::wgmma_fence();
              issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
              issue_pv<D>(o, pa, base + S::kV + prev * S::kStage);
              load_bias(col0(i));
              sm90::wgmma_wait<1>();
              sm90::fence_regs(s);
              if (i == n_tiles - 1) q_done();
              if (i < n_masked) {
                online_softmax<true, BIAS>(s, m_i, l_i, alpha, col0(i), row0, p, t, bv);
              } else {
                online_softmax<false, BIAS>(s, m_i, l_i, alpha, col0(i), row0, p, t, bv);
              }
              drop_p(col0(i));
              sm90::wgmma_wait<0>();
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              if (lane == 0) sm90::mbar_arrive(bar_e + 8 * prev);  // one arrival per consumer warp
#pragma unroll
              for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
              pack_p(s, pa);
            }
            if (n_tiles > 0) {
              const int last = stage(it + n_tiles - 1);
              sm90::mbar_wait(bar_v + 8 * last, parity(it + n_tiles - 1));
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              sm90::wgmma_fence();
              issue_pv<D>(o, pa, base + S::kV + last * S::kStage);
              sm90::wgmma_wait<0>();
              sm90::fence_regs(o);
              if (lane == 0) sm90::mbar_arrive(bar_e + 8 * last);
            }
          } else {
            // one tile after the other: QK^T, softmax, P.V (FP8: QK^T on
            // e4m3 wgmma, P in f16 against V's f16 copy)
            for (int i = 0; i < n_tiles; ++i) {
              const int st = stage(it + i);
              sm90::mbar_wait(bar_k + 8 * st, parity(it + i));
              sm90::wgmma_fence();
              if constexpr (FP8)
                sm90::issue_qk_e4m3<D>(s, q_wg, base + S::kK + st * S::kStage8);
              else
                issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
              load_bias(col0(i));
              sm90::wgmma_wait<0>();
              sm90::fence_regs(s);
              if (i == n_tiles - 1) q_done();
              if constexpr (FP8) {
                const int tile = hi - 1 - i;
                fp8_softmax(s, m_i, l_i, alpha, col0(i), row0, tile < f_lo || tile >= f_hi,
                            qk_scale, p, t);
                pack_p_f16(s, pa);
              } else {
                if (i < n_masked) {
                  online_softmax<true, BIAS>(s, m_i, l_i, alpha, col0(i), row0, p, t, bv);
                } else {
                  online_softmax<false, BIAS>(s, m_i, l_i, alpha, col0(i), row0, p, t, bv);
                }
                drop_p(col0(i));
                pack_p(s, pa);
              }
#pragma unroll
              for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
              sm90::mbar_wait(bar_v + 8 * st, parity(it + i));
              sm90::fence_regs(o);
              sm90::fence_regs(pa);
              sm90::wgmma_fence();
              if constexpr (FP8)
                sm90::issue_pv_f16<D>(o, pa, base + S::kV + st * S::kStage);
              else
                issue_pv<D>(o, pa, base + S::kV + st * S::kStage);
              sm90::wgmma_wait<0>();
              sm90::fence_regs(o);
              if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);  // one arrival per consumer warp
            }
          }
          it += n_tiles;

          float inv[2];
          row_sums(l_i, inv);
          if constexpr (FP8) {
            inv[0] *= v_scale;
            inv[1] *= v_scale;
          }
          if constexpr (DROPOUT) {
            inv[0] *= p.drop.scale;
            inv[1] *= p.drop.scale;
          }
          // O into this consumer's staging rows once the previous block's
          // store has read them
          if (stored) sm90::tma_store_wait_read();
          sm90::named_barrier(1 + cw, 128);
          stage_o<D>(o_wg_ptr, o, inv, warp, g, t);
          sm90::fence_proxy_async();
          sm90::named_barrier(1 + cw, 128);
          stored = wt == 0 && q0 + cw * 64 < p.sq;
          if (stored) {
            for (int hf = 0; hf < S::kHalves; ++hf)
              sm90::tma_store_4d(&to, o_wg + hf * kBox, hf * 64, q0 + cw * 64, head, batch);
            sm90::tma_store_commit();
          }
          store_lse(p, batch, head, row0, m_i, l_i, t);
        }
      }
      if (stored) sm90::tma_store_wait_read();  // shared memory stays until read
    } else {
      // ---- masked: blocks from the Q buffers' slots, tiles from the words
      for (;;) {
        const int qb = qk & 1;
        sm90::mbar_wait(bar_q + 8 * qb, (qk >> 1) & 1);
        // the slot and the words are the same for every lane: broadcast
        // from lane 0, the compiler knows them warp-uniform (fewer
        // convergence checks around the shuffles and wgmma; 2-8% at
        // FM-swg, scripts/ab_flash_fwd.py per_lane_words)
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kBlk + 16 * qb);
        const int m_block = __shfl_sync(0xffffffffu, blk.x, 0);
        if (m_block == kEnd) break;
        ++qk;
        const int q0 = m_block * kTileM, head = __shfl_sync(0xffffffffu, blk.y, 0);
        const int batch = __shfl_sync(0xffffffffu, blk.z, 0);
        const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
        const uint32_t q_wg = base + S::kQ + qb * S::kQBuffer + cw * S::kQWarpgroup;
        uint8_t* q_wg_ptr = smem + S::kQ + qb * S::kQBuffer + cw * S::kQWarpgroup;
        if (__shfl_sync(0xffffffffu, blk.w, 0)) {  // Q was loaded
          scale_q<S::kQWarpgroup>(q_wg_ptr, wt, p.sm_scale);
          sm90::named_barrier(1 + cw, 128);
        }
        float o[D / 2];
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
        float m_i[2] = {-INFINITY, -INFINITY};
        float l_i[2] = {0.f, 0.f};
        float s[kTileN / 2];
        uint32_t pa[kTileN / 4];
        float alpha[2];
        const int64_t bias_base = batch * p.bias.sb + head * p.bias.sh;
        float bv[BIAS ? kTileN / 2 : 1];  // BIAS: the tile's bias, loaded under its QK^T
        const uint32_t dkey = DROPOUT ? xfa::dropout_key(p.drop, batch, head, p.h) : 0u;
        int4 w;  // the word of the tile at `it`
        // Wait for the next tile this consumer computes (at `it`), passing
        // by the tiles with none of its parts; false at the block's end (it
        // then past the kEnd word).
        auto next_tile = [&]() -> bool {
          for (;;) {
            const int st = stage(it);
            sm90::mbar_wait(bar_k + 8 * st, parity(it));
            w = *reinterpret_cast<const int4*>(smem + S::kWord + 16 * st);
            w.x = __shfl_sync(0xffffffffu, w.x, 0);
            w.y = __shfl_sync(0xffffffffu, w.y, 0);
            if (w.x != kEnd && ((w.y >> (kOnShift + 2 * cw)) & 3) != 0) return true;
            if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);
            ++it;
            if (w.x == kEnd) return false;
          }
        };
        auto softmax_tile = [&]() {
          const int parts = (w.y >> (kOnShift + 2 * cw)) & 3;
          const int4* bands = reinterpret_cast<const int4*>(smem + S::kBands +
                                                            stage(it) * kBandBytes);
          const int4* kinfo = reinterpret_cast<const int4*>(smem + S::kKInfo +
                                                            stage(it) * kBandBytes);
          const int4* qinfo = reinterpret_cast<const int4*>(smem + S::kQInfo +
                                                            qb * kBlockInfoBytes) +
                              (row0 - q0);
#define XFA_SOFTMAX(E, NB, I)                                                               \
  masked_softmax<E, NB, I, BIAS>(s, m_i, l_i, alpha, w.x, row0, parts, bands, kinfo, qinfo, p, \
                                 t, bv)
          const bool one_band = p.mask.fm_mode <= xfa::kFmCausal2;
          if (!(w.y & kElem)) {
            XFA_SOFTMAX(false, 0, false);
          } else if (!(w.y & kBand)) {
            if (w.y & kInfo) XFA_SOFTMAX(true, 0, true);
            else XFA_SOFTMAX(true, 0, false);
          } else if (!(w.y & kInfo)) {
            if (one_band) XFA_SOFTMAX(true, 1, false);
            else XFA_SOFTMAX(true, 2, false);
          } else {  // both tests, rare: the one-band modes' second band is empty
            XFA_SOFTMAX(true, 2, true);
          }
#undef XFA_SOFTMAX
        };
        // one tile after the other at both head dims (at d 64, tile i's
        // softmax under tile i - 1's P.V, as the dense route runs it, took
        // 3-6% longer here: scripts/ab_flash_fwd.py masked_pipelined)
        while (next_tile()) {
          const int st = stage(it);
          sm90::wgmma_fence();
          issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
          if constexpr (BIAS)
            xfa::load_bias_rows<kTileN>(bv, p.bias, bias_base, row0, w.x, p.sq, p.sk, t);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(s);
          softmax_tile();
          if constexpr (DROPOUT)  // P's dropped elements to 0, after the row sums
            xfa::dropout_each<kTileN / 2, false>(p.drop, dkey, row0, w.x, t,
                                                 [&](int i, bool keep) {
                                                   if (!keep) s[i] = 0.f;
                                                 });
          pack_p(s, pa);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
          sm90::mbar_wait(bar_v + 8 * st, parity(it));
          sm90::fence_regs(o);
          sm90::fence_regs(pa);
          sm90::wgmma_fence();
          issue_pv<D>(o, pa, base + S::kV + st * S::kStage);
          sm90::wgmma_wait<0>();
          sm90::fence_regs(o);
          if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);
          ++it;
        }

        float inv[2];
        row_sums(l_i, inv);
        if constexpr (DROPOUT) {
          inv[0] *= p.drop.scale;
          inv[1] *= p.drop.scale;
        }
        // O into this consumer's Q rows, once every warp's products have
        // read them; the buffer is released when the store has read it
        sm90::named_barrier(1 + cw, 128);
        stage_o<D>(q_wg_ptr, o, inv, warp, g, t);
        sm90::fence_proxy_async();
        sm90::named_barrier(1 + cw, 128);
        if (wt == 0) {
          if (q0 + cw * 64 < p.sq) {
            for (int hf = 0; hf < S::kHalves; ++hf)
              sm90::tma_store_4d(&to, q_wg + hf * kBox, hf * 64, q0 + cw * 64, head, batch);
            sm90::tma_store_commit();
            sm90::tma_store_wait_read();
          }
          sm90::mbar_arrive(bar_qe + 8 * qb);
        }
        store_lse(p, batch, head, row0, m_i, l_i, t);
      }
    }
  }
}

// One persistent CTA per SM (shared memory allows no second), or one per
// pair of query blocks (per block under the masked kernel's dynamic
// scheduler) when there are fewer.
template <int D, bool MASKED, bool BIAS, bool FP8 = false, bool DROPOUT = false>
cudaError_t launch_fwd(const CUtensorMap* maps, const FwdParams& p, cudaStream_t s) {
  using S = FwdSmem<D, MASKED, FP8>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      sm90::smem_limit_once(flash_fwd_kernel<D, MASKED, BIAS, FP8, DROPOUT>, S::kBytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  const int n_mb = (p.sq + kTileM - 1) / kTileM;
  const int units = MASKED ? n_mb * p.h * p.b : xfa::block_pairs(n_mb, p.h, p.b);
  flash_fwd_kernel<D, MASKED, BIAS, FP8, DROPOUT>
      <<<units < sms ? units : sms, kThreads, S::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], p);
  return cudaGetLastError();
}

}  // namespace

// q/k/v/o strides are in elements for the (batch, head, seq) axes; the
// head-dim axis is contiguous; pointers and strides are multiples of 16
// bytes (the tensor maps' rule). lse may be null. The mask arguments
// (XFA_MASK_ARGS, common.cuh) carry FlashMask stats per 128-key tile; with
// a FlashMask, `fm_bands` is (b, fm_heads, fm_skp, 4) int32 contiguous, each
// column's two bands [lo1, hi1) and [lo2, hi2); with segment ids or
// positions, their stats per 128-row block and 128-key tile and the key
// tile range of each 128-row block. With a mask, `counters` is
// three int32 in device memory, cleared here on the stream: the dynamic
// scheduler's next block, then the tiles the kernel visits and those of
// them with the elementwise test (fwd.py fwd_masked_tile_plan counts the
// same); with none given the dense instantiation runs. The bias
// (XFA_BIAS_ARGS, common.cuh BiasParams), or a null pointer, selects the
// bias instantiation of either; it takes no FlashMask or block mask.
// Dropout (XFA_DROPOUT_ARGS, common.cuh DropoutParams) with `drop` set
// selects the dropout instantiation of either; it takes no bias.
XFA_EXPORT int xfa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                             int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                             int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int b,
                             int h, int hk, int sq, int sk, int d, float sm_scale,
                             float softcap, int causal, XFA_MASK_ARGS, const void* fm_bands,
                             void* counters, XFA_BIAS_ARGS, XFA_DROPOUT_ARGS, void* stream) {
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (drop && bias != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const xfa::MaskParams mask = XFA_MASK_VALUES;
  const bool masked = xfa::mask_active(mask);
  CUtensorMap maps[7] = {};
  const int skm = sk > 0 ? sk : 1;  // no key tile is visited when sk == 0
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, 64) ||
      !sm90::encode_bhsd(&maps[1], k, b, hk, skm, d, k_sb, k_sh, k_ss, kTileN) ||
      !sm90::encode_bhsd(&maps[2], v, b, hk, skm, d, v_sb, v_sh, v_ss, kTileN) ||
      !sm90::encode_bhsd(&maps[3], o, b, h, sq, d, o_sb, o_sh, o_ss, 64) ||
      (masked && fm_bands != nullptr &&
       !sm90::encode_rows_i32x4(&maps[4], fm_bands, static_cast<int64_t>(b) * fm_heads * fm_skp,
                                kTileN)) ||
      (masked && k_info != nullptr &&
       (!sm90::encode_rows_i32x4(&maps[5], k_info, static_cast<int64_t>(b) * k_pad, kTileN) ||
        !sm90::encode_rows_i32x4(&maps[6], q_info, static_cast<int64_t>(b) * q_pad, kTileM))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (masked) {
    if (counters == nullptr || (mask.fm_vecs != nullptr && fm_bands == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  FwdParams p{static_cast<float*>(lse), b, h, hk, sq, sk, sm_scale, softcap, causal, mask,
              static_cast<int*>(counters), XFA_BIAS_VALUES};
  p.drop = XFA_DROPOUT_VALUES;
  cudaError_t err;
  if (drop) {
    if (d == 64)
      err = masked ? launch_fwd<64, true, false, false, true>(maps, p, s)
                   : launch_fwd<64, false, false, false, true>(maps, p, s);
    else
      err = masked ? launch_fwd<128, true, false, false, true>(maps, p, s)
                   : launch_fwd<128, false, false, false, true>(maps, p, s);
  } else if (bias != nullptr) {
    if (d == 64)
      err = masked ? launch_fwd<64, true, true>(maps, p, s)
                   : launch_fwd<64, false, true>(maps, p, s);
    else
      err = masked ? launch_fwd<128, true, true>(maps, p, s)
                   : launch_fwd<128, false, true>(maps, p, s);
  } else if (d == 64) {
    err = masked ? launch_fwd<64, true, false>(maps, p, s)
                 : launch_fwd<64, false, false>(maps, p, s);
  } else {
    err = masked ? launch_fwd<128, true, false>(maps, p, s)
                 : launch_fwd<128, false, false>(maps, p, s);
  }
  return static_cast<int>(err);
}

// The e4m3 instantiation: q/k/v float8_e4m3fn with element strides for the
// (batch, head, seq) axes (head dim contiguous; pointers and strides
// multiples of 16 bytes), o bf16 (multiples of 16 bytes), lse fp32 (b, h,
// sq) or null; q/k/v descales (b, hk) fp32 contiguous, or null for ones;
// the window (left, right), -1 no bound, causal as right 0.
XFA_EXPORT int xfa_flash_fwd_fp8(const void* q, const void* k, const void* v, void* o, void* lse,
                                 const void* q_descale, const void* k_descale,
                                 const void* v_descale, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                 int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                 int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                                 int64_t o_ss, int b, int h, int hk, int sq, int sk, int d,
                                 float sm_scale, float softcap, int win_left, int win_right,
                                 void* stream) {
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const CUtensorMapSwizzle sw = d == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap maps[7] = {};
  const int skm = sk > 0 ? sk : 1;  // no key tile is visited when sk == 0
  if (!sm90::encode_bhsd_e4m3(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, 64, sw) ||
      !sm90::encode_bhsd_e4m3(&maps[1], k, b, hk, skm, d, k_sb, k_sh, k_ss, kTileN, sw) ||
      !sm90::encode_bhsd_e4m3(&maps[2], v, b, hk, skm, d, v_sb, v_sh, v_ss, kTileN,
                              CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !sm90::encode_bhsd(&maps[3], o, b, h, sq, d, o_sb, o_sh, o_ss, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  FwdParams p{};
  p.lse = static_cast<float*>(lse);
  p.qd = static_cast<const float*>(q_descale);
  p.kd = static_cast<const float*>(k_descale);
  p.vd = static_cast<const float*>(v_descale);
  p.b = b;
  p.h = h;
  p.hk = hk;
  p.sq = sq;
  p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.mask.left = win_left;
  p.mask.right = win_right;
  p.mask.pleft = p.mask.pright = -1;
  const cudaError_t err = d == 64 ? launch_fwd<64, false, false, true>(maps, p, s)
                                  : launch_fwd<128, false, false, true>(maps, p, s);
  return static_cast<int>(err);
}
