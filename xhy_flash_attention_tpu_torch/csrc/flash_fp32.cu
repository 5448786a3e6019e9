// fp32 attention on the tensor cores: the forward, and the backward's dK/dV
// and dQ kernels, dense and under masks, and the reduced scores, every
// product as three TF32 products (wgmma .tf32), fed by TMA rings.
//
// Replaces, for float32 q/k/v, the TPU kernels
//   * xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78 `_fwd_kernel`
//     (#1; and through strides fused_heads.py:59 `_fwd_kernel`, #5)
//     -> flash_fwd_fp32_kernel; its PAGED instantiation reads K/V through a
//     page table and serves the prefill regime (sq * g > 16 rows per KV
//     head) of inference/paged.py:219 `_paged_decode_chunked_kernel` (#11)
//     and :149 `_paged_decode_kernel` (#10) on fp32 pages;
//   * bwd.py:180 `_bwd_dkv_kernel` (#2) -> flash_bwd_dkv_fp32_kernel;
//   * bwd.py:511 `_bwd_dq_kernel` (#3) -> flash_bwd_dq_fp32_kernel;
//     both also through strides for fused_heads.py:105 `_bwd_kernel` (#6);
//   * #1-#3 under FlashMask, block masks, segment ids and q/kv positions
//     (fwd.py:244-296, 353-390; bwd.py's as #1) -> the MASKED
//     instantiations of the three kernels;
//   * #1-#3 with an attention bias (fwd.py:353-354, bwd.py:131-132) -> the
//     BIAS instantiations of the three kernels, dense or MASKED, and the
//     dbias output of #2 (bwd.py:173, 411-481, 757-800, 1302-1312) ->
//     flash_bwd_dbias_fp32_kernel;
//   * reduced_scores.py:34 `_reduced_kernel` (#12) ->
//     reduced_scores_fp32_kernel.
// The backward's pre-pass (delta, q_s) is flash_bwd.cu's
// flash_bwd_prep_kernel<D, float>.
//
// What they compute, as the TPU kernels do in fp32: S = (q * sm_scale) K^T
// (q_s = q * sm_scale rounded to fp32, as the plain versions), optional
// softcap t = tanh(S / c), S = t c; a row/key window bottom-right aligned
// (key j visible to row r when r + off - left <= j <= r + off + right, off
// = sk - sq; causal is right 0; -1 no bound); online softmax in fp32; O =
// P V / rowsum; LSE = m + log(l), +inf (and O = 0) on rows that see no key.
// Backward: P = exp(S - LSE), dP = dO V^T, dS = P (dP - delta) (1 - t^2),
// dV = P^T dO, dK = dS^T q_s, dQ = dS K sm_scale; dK/dV summed over the
// g = h / hk heads of a KV head's group in a fixed order. No value is
// rounded to a narrower type (the TF32 parts, hi and lo, carry each operand
// to within 2^-21).
//
// Arithmetic. The JAX contract for fp32 (err <= 2 err_lp + 1e-4 against an
// fp64 reference, err_lp ~ 1e-6, tests/test_flash_attn.py:23-35) rules out
// a single TF32 product (10 mantissa bits, about three decimal digits).
//   * Every product A B is three TF32 products into fp32 accumulators,
//     A_lo B_hi + A_hi B_lo (into one) and A_hi B_hi (into another), lo·lo
//     dropped. The tensor cores ignore a .tf32 operand's low 13 bits
//     (truncation; scripts/tf32_probe.cu shows it on the H100), so the raw
//     fp32 value is its own hi part, x_hi = x & 0xffffe000 as they read it,
//     and x_lo = x - x_hi, exact in fp32 (hopper.cuh tf32_lo), of whose 13
//     significant bits they keep 11: x = hi + lo to within 2^-21 |x|, and
//     lo·lo is below 2^-20 of each product. Rounding with cvt.rna.tf32.f32
//     would halve the hi error but made the backward 1.23-1.25x slower
//     (scripts/ab_fp32_bwd.py rna; PERF.md §6). reference.py
//     split_tf32 / matmul_tf32x3 / attention_fwd_tf32x3 /
//     attention_bwd_tf32x3 emulate this on the CPU
//     (tests/test_torch_tf32x3.py).
//   * The tensor cores add a wgmma's products to its accumulator with
//     truncation too, so a sum kept on them for thousands of products
//     drifts toward zero (dV 1.9e-4 from float64 at sq 1100, GQA 4, against
//     5.7e-6 for the fp32 plain version, before this was done): the hi·hi
//     terms and the small terms of the long products sum in two
//     accumulators, and every sum over the tiles (the forward's O over the
//     keys, dK, dV and dQ) is taken a tile at a time on the tensor cores
//     and added to fp32 registers with rounding (product_a_smem,
//     issue_a_acc).
//
// Bound on the H100: operations, three TF32 products per product at the
// tensor cores' 495 TFLOP/s (`chip_smoke.py` states each row's bound so).
//
// Common design (from flash_fwd.cu's dense route and flash_bwd.cu):
// persistent CTAs, one per SM, blocks in equal-work pairs (common.cuh
// block_pairs / pair_block), 384 threads: warpgroup 0 is the producer
// (setmaxnreg.dec): its thread 0 issues every TMA load (4-D fp32 maps,
// hopper.cuh encode_bhsd_f32: boxes of 32 columns = one 128-byte swizzle
// row, so a row of d 64 is two boxes), and its warps 1-3 are the
// converters; warpgroups 1 and 2 are consumers of 64 rows or keys each
// (setmaxnreg.inc). What differs from bf16, and what the design does
// about it:
//   * No transpose bit: .tf32 wgmma takes B from shared memory K-major only.
//     Four products need B with the query or key index contiguous: O += P V
//     needs V^T, dV += P^T dO and dK += dS^T q_s need dO^T and q_s^T, dQ +=
//     dS K needs K^T. The converters make them in shared memory from the
//     TMA-landed tile.
//   * The split. A operands are split in registers k-step by k-step (lo =
//     x - x_hi, two instructions; hi is x itself): the resident tiles (q_s
//     in the forward and dQ, dO in dQ, K and V in dK/dV) are read from
//     shared memory as the m64k8 fragment (a[i]: row g + 8 (i % 2), column
//     t + 4 (i / 2)), P, P^T, dS^T and dS come from the accumulators. B
//     operands need both parts in shared memory: the TMA-landed tile is hi,
//     the converters write lo beside it (and both parts of the transposes),
//     16 bytes a load or store. Every product is then an RS wgmma issued
//     three times.
//   * P/dS from the accumulators: a thread holds columns 2t and 2t + 1 of
//     each 8, where the A fragment wants t and t + 4. The fragment takes
//     them as they are (a = {x[4kk], x[4kk + 2], x[4kk + 1], x[4kk + 3]}),
//     and the converters write the transposed B rows in the matching
//     permuted k order: query or key 8j + 2t + e at k position 8j + t + 4e
//     (convert_item, convert_vt). No shuffle.
//   * Shared memory (227 KB) binds: an fp32 tile is twice bf16's, and each
//     B operand is there twice (hi, lo), four of them also transposed.
//
// Forward design (flash_fwd_fp32_kernel<D, PAGED, SOFTCAP, MASKED, BIAS>):
// a block is 128 query rows of one (batch, head), consumer c owning rows
// [64c, 64c + 64);
// blocks in pairs heaviest last (the causal pairs hold equal work). q
// arrives by TMA into one resident buffer (128 rows: 32 KB at d 64, 64 KB
// at d 128), and each consumer scales its rows in place (q_s = q sm_scale,
// rounded as the plain version rounds it) before its first product. K and
// V come in a ring of 2 stages of L keys (64 at d 64, 32 at d 128); a stage
// holds K (landed: its hi), K lo, V (landed), V^T hi and V^T lo, 16 KB each
// (80 KB; 192 KB in all at d 64, 224 KB at d 128). The producer issues a
// block's first two tiles before its q (the ring runs on across blocks, so
// only q's latency is left between blocks). The key tiles are those of the
// block's rows under the window (fwd_block); a consumer whose rows see
// none of a tile passes it by, and only tiles that some row of the
// consumer does not see whole take the elementwise test. Per tile, each
// consumer runs S = q_s K^T (k-steps issued in chunks of 8, its two
// accumulators added at the end); the online softmax in registers (ex2 with
// log2(e) folded in, tanhf for softcap; fwd_softmax); then P V on the
// tensor cores with P's fragment from S and V^T from the stage, waited for
// and added to O in fp32 registers after O's rescale (the drift above).
// The two consumers interleave on the tensor cores. The epilogue divides O
// by the row sum as the plain version does and stores it with plain stores
// from the registers, which take any strides (#5's packed layout
// included); the LSE by one thread per row. Paged K/V (PAGED): the tiles'
// keys through the page table, clamped pages; by TMA through a 5-D map over
// the pages (hopper.cuh encode_pages, fp32) when the page size is a
// multiple of L (a tile inside one page), else by cp.async from the
// converters into the same swizzled layout; V's keys at or past the row's
// length are written to V^T as zeros (a page's other rows may hold
// anything, and 0 · NaN would reach O).
//
// Backward design: flash_bwd.cu's dense backward (persistent CTAs, one per
// SM, blocks in equal-work pairs, common.cuh pair_block) on .tf32 wgmma,
// with the common design above.
//   * Shared memory:
//     - dK/dV, d 64: a block is 128 keys, consumer c owning keys [64c, 64c
//       + 64); K and V raw (64 KB, one buffer: the next block's load waits
//       for this block's end); a ring of 2 stages of 32 query rows of one
//       head (q_s, dO, each raw (its hi), lo, hi^T and lo^T: 64 KB, and their LSE
//       and delta) that streams every head of the GQA group in a fixed
//       order; both consumers read every stage. 194 KB.
//     - dK/dV, d 128: a block is 64 keys (K, V 64 KB) and a stage 16 query
//       rows (64 KB; the transposes' rows are 64 bytes, 64-byte swizzled).
//       Both consumers compute S^T and dP^T of all 64 keys, and consumer c
//       dK's and dV's columns [64c, 64c + 64): the products of S^T and dP^T
//       are done twice (6 products for 4), which leaves each consumer 64
//       accumulator registers of dK and dV instead of 128 (taking the
//       stages in turn with all 128 columns each spilled). 194 KB.
//     - dQ: a block is 128 query rows of one (batch, head), q_s and dO raw
//       resident (one buffer: two, with 2 stages, ran 4% slower than one
//       with 3); a ring of K/V tiles (K, V and K^T as hi and lo): 3 stages
//       of 32 keys at d 64 (64 + 144 KB), 2 of 16 at d 128 (128 + 96 KB).
//   Per tile, each consumer runs S^T = K q_s^T and dP^T = V dO^T (dK/dV) or
//   S = q_s K^T and dP = dO V^T (dQ), committed and waited for in chunks of
//   k-steps (8 at d 64, 2 at d 128: the split A fragments of a chunk are
//   live until the wait); then P and dS in registers (P = 2^(S log2(e) -
//   LSE log2(e)) by ex2, tanhf for softcap; the window test only on tiles
//   that need it, against each row's or key's visible range); then the
//   tile's dV and dK, or dQ, from the accumulators, added to the fp32
//   registers. The two consumers interleave on the tensor cores. Every
//   output element is summed by one thread in a fixed order (tiles in
//   order, the group's heads in order), so two runs give the same bits,
//   with no atomics. Outputs leave by plain stores from the accumulators,
//   which take any strides (#6's packed layout included).
//
// Masked design (the MASKED instantiations of the three kernels: FlashMask
// in its four modes, block masks, segment ids, q/kv positions and their
// windows, and any of these with a row/key window; a window alone runs the
// dense instantiations). The mask semantics are common.cuh's, shared with
// the bf16 masked kernels of flash_fwd.cu and flash_bwd.cu, at this file's
// tiles (ops common.py kernel_tiles: the forward's key tiles of 64 / 32
// keys, dK/dV's query tiles of 32 / 16 rows against key blocks of 128 /
// 64, dQ's key tiles of 32 / 16 keys, at d 64 / 128; the forward's and
// dQ's blocks 128 rows), whose FlashMask stats, segment / position stats
// and tile ranges the wrapper makes once a call.
//   * Which tiles a block visits depends on the data, so warp 0 of the
//     producer warpgroup decides and the others follow: blocks from the
//     dynamic scheduler (common.cuh next_block, the heavier pairs of every
//     head first: masked work per block is uneven), candidates the tiles of
//     the row/key window cut to the block's tile range (key_window,
//     query_window), 32 decided at a time (row_block_tile_flags for the
//     forward and dQ, dkv_flags for dK/dV; fm_decide, bm_on, token_flags),
//     those with the elementwise test first (emit_tiles). Lane 0 puts each
//     visited tile's word (first key or row, head in the group, flags) in
//     its ring stage with the tile's loads, kEnd after a block's last tile
//     and kStop after the last block; a block reaches the consumers in a
//     slot beside its q (forward, dQ) or K/V (dK/dV), kEnd after the last.
//     The forward's and dQ's producer (row_block_producer) issues a block's
//     first tiles before its q, as the dense forward does, and takes and
//     decides the next block while the ring is full, as flash_fwd.cu's
//     masked producer does. The producer counts the tiles it emitted and
//     those with the elementwise test (fwd.py fwd_masked_tile_plan, bwd.py
//     bwd_masked_dkv_tile_plan / bwd_masked_dq_tile_plan with fp32).
//   * The converters follow the words (masked_converters): they convert a
//     tile's stage, pass a kEnd by and stop at kStop.
//   * The consumers compute a tile when one of their parts is on, and test
//     elementwise only the tiles flagged for it, branch-free
//     (rows_visible, keys_visible: a bit a register; the window and the
//     ragged edge by common.cuh row_limit / key_limit, the FlashMask bands
//     by banned, the tokens by tokens_meet). Shared memory is full at d 128
//     (the forward's rings leave 2 KB), so the bands and the tokens' (segment
//     id, position) are read from global memory through the read-only cache
//     (L1), not staged; only the words and the slot are. A row that sees no
//     key keeps m = -inf and l = 0 in the forward (O = 0, LSE = +inf); the
//     backward's P is a select, so exp2(S - (+inf)) gives 0 and no -inf -
//     (+inf) is formed.
//   * Registers: the masked producer needs 72 (at 56 or 64 it spilled), so
//     the masked consumers take 216; the d 64 dK/dV consumers then issue
//     their products 4 k-steps at a time, wait for dV's product before dK's,
//     and read the tile's word again after the products (each of the three
//     was needed for no spill).
//
// Bias design (the BIAS instantiations; never PAGED; not with a FlashMask
// or block mask, as in the TPU package): a (bb, bh, sq, sk) fp32 or bf16
// bias, broadcast by strides (common.cuh BiasParams), added in fp32 to each
// score after softcap and before the mask, as flash_fwd.cu's and
// flash_bwd.cu's bias instantiations add it. Each consumer thread reads its
// accumulator fragment's bias straight from global memory (common.cuh
// load_bias_rows: a key pair a load, the forward's and dQ's S at their
// 64- / 32- / 16-key tiles; load_bias_cols: an element a load, dK/dV's
// S^T at its 32- / 16-row tiles) after the tile's products, its lines
// prefetched into L1 before them (prefetch_bias, a line a lane): loads
// issued before the products held their registers across them and spilled
// in the masked kernels (whose registers are spent, the masked d 64 dK/dV
// and d 128 forward and dQ do not prefetch either). Shared memory is full,
// so the bias is not staged. A bias shared by the batches orders the dense
// blocks batch first (common.cuh pair_block_by), so that the blocks running
// together read the same rows. dS keeps the softcap derivative; dbias, the gradient
// before it summed over the bias's broadcast axes, is
// flash_bwd_dbias_fp32_kernel's (its section below).
//
// The reduced scores (reduced_scores_fp32_kernel, #12): the dK/dV kernel's
// S^T pipeline alone; see its section below.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = xfa::sm90;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
// Registers a thread of the backward kernels after setmaxnreg (the launch
// gives each 168): the dense producer's converters need 56 and the d 64
// dK/dV consumers 224; the masked producer decides the tiles besides
// (row_block_producer, dkv_flags) and spilled at 56, so the masked
// instantiations give it 72 and their consumers 216 (128 x (168 - 72) =
// 256 x (216 - 168): the consumers may take only what the producer gives
// up, or setmaxnreg.inc waits forever), the d 64 dK/dV consumers then
// issuing their products 4 k-steps at a time (kChunk).
template <bool MASKED>
constexpr int kProducerRegs = MASKED ? 72 : 56;
template <bool MASKED>
constexpr int kConsumerRegs = MASKED ? 216 : 224;
static_assert(128 * (168 - kProducerRegs<false>) >= 256 * (kConsumerRegs<false> - 168) &&
                  128 * (168 - kProducerRegs<true>) >= 256 * (kConsumerRegs<true> - 168),
              "the consumers take more registers than the producer gives up");
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kDqRows = 128;     // query rows of a dQ block (64 a consumer)
// k-steps issued before a wait (d 128's dK/dV accumulators leave fewer
// registers, and so do the masked d 64 dK/dV consumers' 216)
template <int D, bool MASKED = false>
constexpr int kChunk = D == 64 ? (MASKED ? 4 : 8) : 2;

// The masked instantiations' tile words and flags (common.cuh kEnd, kElem,
// kBand, kInfo, kOnShift); kStop, after the last block's kEnd, stops the
// converters.
using xfa::kBand;
using xfa::kElem;
using xfa::kEnd;
using xfa::kInfo;
using xfa::kOnShift;
constexpr int kStop = -2;

// Visible everywhere: the functor of the tiles with no elementwise test.
struct AllVisible {
  __device__ __forceinline__ bool operator()(int) const { return true; }
};

// A token's (segment id, position) of a (b, pad) info array in global
// memory, through the read-only cache.
__device__ __forceinline__ int2 token_ldg(const int4* info, int i) {
  return __ldg(reinterpret_cast<const int2*>(info + i));
}

// The masked instantiations' elementwise test of a row-major fragment
// (the forward's S, dQ's S and dP: register i at row row0 + 8 ((i / 2) %
// 2), key n0 + 8 (i / 4) + 2t + (i % 2)), bit i of the result: the key
// inside the row's window and below sk (common.cuh row_limit), with NB > 0
// outside the column's first NB FlashMask bands (`bands`, the mask head's
// (skp) row), with INFO the tokens' segment ids and positions met (`kinfo`,
// `qinfo`: the batch row's info). Bands and info are read from global
// memory through the read-only cache (L1): staged per stage, they did not
// fit beside the rings at d 128.
template <int L, int NB, bool INFO>
__device__ __forceinline__ uint32_t rows_visible(const xfa::MaskParams& m, int sq, int sk, int n0,
                                                 int row0, const int4* bands, const int4* kinfo,
                                                 const int4* qinfo, int t) {
  static_assert(L / 2 <= 32, "a bit per register");
  int lo[2], hi[2];
  int4 qt[2] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xfa::row_limit(m, row0 + 8 * r, sq, sk, lo[r], hi[r]);
    if (INFO) qt[r] = xfa::query_tokens(m, token_ldg(qinfo, row0 + 8 * r));
  }
  uint32_t vis = 0;
#pragma unroll
  for (int j = 0; j < L / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * j + 2 * t + e;
      const int4 b = NB > 0 ? __ldg(bands + col) : int4{};
      const int2 kt = INFO ? token_ldg(kinfo, col) : int2{};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool v = (col >= lo[r]) & (col <= hi[r]);
        if (NB > 0) v = v & !xfa::banned<NB>(b, row0 + 8 * r);
        if (INFO) v = v & xfa::tokens_meet(qt[r], kt);
        vis |= static_cast<uint32_t>(v) << (4 * j + 2 * r + e);
      }
    }
  }
  return vis;
}

// rows_visible for the tests a tile's flags `f` ask for (common.cuh kBand,
// kInfo; the full modes' two bands).
template <int L>
__device__ __forceinline__ uint32_t rows_visible_by(int f, const xfa::MaskParams& m, int sq, int sk,
                                                    int n0, int row0, const int4* bands,
                                                    const int4* kinfo, const int4* qinfo, int t) {
#define XFA_VIS(NB, I) rows_visible<L, NB, I>(m, sq, sk, n0, row0, bands, kinfo, qinfo, t)
  if (!(f & kBand)) return f & kInfo ? XFA_VIS(0, true) : XFA_VIS(0, false);
  if (!(f & kInfo)) return m.fm_mode > xfa::kFmCausal2 ? XFA_VIS(2, false) : XFA_VIS(1, false);
  return XFA_VIS(2, true);  // both tests, rare: the one-band modes' second band is empty
#undef XFA_VIS
}

// The same test of a transposed fragment (dK/dV's S^T and dP^T: register i
// at key key0 + 8 ((i / 2) % 2), query row m0 + 8 (i / 4) + 2t + (i % 2)):
// the row inside the key's rows (common.cuh key_limit, below sq), with NB
// > 0 outside the key's first NB bands, with INFO the tokens met.
template <int R, int NB, bool INFO>
__device__ __forceinline__ uint32_t keys_visible(const xfa::MaskParams& m, int sq, int sk, int key0,
                                                 int m0, const int4* bands, const int4* kinfo,
                                                 const int4* qinfo, int t) {
  static_assert(R / 2 <= 32, "a bit per register");
  int rmin[2], rmax[2];
  int4 kt[2] = {}, b[2] = {};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xfa::key_limit(m, key0 + 8 * r, sq, sk, rmin[r], rmax[r]);
    if (INFO) kt[r] = xfa::key_tokens(m, token_ldg(kinfo, key0 + 8 * r));
    if (NB > 0) b[r] = __ldg(bands + key0 + 8 * r);
  }
  uint32_t vis = 0;
#pragma unroll
  for (int j = 0; j < R / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * t + e;
      const int2 qt = INFO ? token_ldg(qinfo, row) : int2{};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        bool v = (row >= rmin[r]) & (row <= rmax[r]);
        if (NB > 0) v = v & !xfa::banned<NB>(b[r], row);
        if (INFO) v = v & xfa::tokens_meet(kt[r], qt);
        vis |= static_cast<uint32_t>(v) << (4 * j + 2 * r + e);
      }
    }
  }
  return vis;
}

template <int R>
__device__ __forceinline__ uint32_t keys_visible_by(int f, const xfa::MaskParams& m, int sq, int sk,
                                                    int key0, int m0, const int4* bands,
                                                    const int4* kinfo, const int4* qinfo, int t) {
#define XFA_VIS(NB, I) keys_visible<R, NB, I>(m, sq, sk, key0, m0, bands, kinfo, qinfo, t)
  if (!(f & kBand)) return f & kInfo ? XFA_VIS(0, true) : XFA_VIS(0, false);
  if (!(f & kInfo)) return m.fm_mode > xfa::kFmCausal2 ? XFA_VIS(2, false) : XFA_VIS(1, false);
  return XFA_VIS(2, true);
#undef XFA_VIS
}

// The masked producer of the forward and dQ kernels (warp 0 of the
// producer warpgroup; flash_fwd.cu's masked producer at the fp32 key
// tiles): blocks of kRowBlock query rows from the dynamic scheduler
// (common.cuh next_block, the heavier first), candidates the key tiles of
// L keys of the block's window cut to its tile range (key_window), each
// decided by row_block_tile_flags, 32 at a time, a lane each; lane 0 puts
// each visited tile's word (first key, flags) in its stage of the ring
// (`words`, 16 bytes a stage) with its loads (`load_kv(st, n0, head,
// batch)` on the stage's full barrier), kEnd after a block's last tile and
// kStop after the last block, and each block's slot (block, head, batch,
// loaded) after the words with its q (`load_q(q0, head, batch)` on bar_q)
// once the consumers released the previous q, after the block's first
// STAGES tiles (the ring runs on across blocks, so only q's latency is left
// between blocks). While the ring is full it takes and decides the next
// block. Adds the tiles it emitted, and those with the elementwise test, to
// next[1] and next[2].
template <int L, int STAGES, typename LoadQ, typename LoadKV>
__device__ __forceinline__ void row_block_producer(const xfa::MaskParams& mk, int* next, int b,
                                                   int h, int sq, int sk, uint8_t* words,
                                                   uint32_t bar_q, uint32_t bar_qe,
                                                   uint32_t bar_full, uint32_t bar_empty,
                                                   LoadQ load_q, LoadKV load_kv) {
  const int lane = threadIdx.x & 31;
  const bool lead = lane == 0;
  const int n_mb = (sq + xfa::kRowBlock - 1) / xfa::kRowBlock;
  int it = 0, qk = 0, tiles = 0, elem = 0;
  struct Block {
    bool more;
    int m_block, head, batch, lo, hi, f_lo, f_hi, f;
    __device__ __forceinline__ int n_tiles() const { return hi - lo; }
  };
  auto flags_of = [&](const Block& k, int i) {
    const int tile = k.hi - 1 - i;
    return xfa::row_block_tile_flags<L>(mk, k.batch, k.head, h, sq, sk,
                                        k.m_block * xfa::kRowBlock, tile * L,
                                        (tile < k.f_lo) | (tile >= k.f_hi));
  };
  auto take = [&](Block& k) {
    k.m_block = k.head = k.batch = k.lo = k.hi = k.f_lo = k.f_hi = 0;
    k.more = xfa::next_block(next, b, n_mb, h, true, k.m_block, k.head, k.batch);
    if (k.more)
      xfa::key_window<xfa::kRowBlock, L>(mk, k.batch, k.m_block * xfa::kRowBlock, sq, sk, k.lo,
                                         k.hi, k.f_lo, k.f_hi);
  };
  auto decide = [&](Block& k) { k.f = lane < k.n_tiles() ? flags_of(k, lane) : -1; };
  auto send_q = [&](const Block& k, bool load) {  // lane 0
    sm90::mbar_wait(bar_qe, (qk & 1) ^ 1);  // the first pass is free
    *reinterpret_cast<int4*>(words + 16 * STAGES) =
        make_int4(k.more ? k.m_block : kEnd, k.head, k.batch, load);
    if (load) {
      load_q(k.m_block * xfa::kRowBlock, k.head, k.batch);
    } else {
      sm90::mbar_arrive(bar_q);
    }
  };
  auto put = [&](int4 w, int head, int batch) {  // lane 0: w.x >= 0 a tile, else alone
    const int st = it % STAGES;
    sm90::mbar_wait(bar_empty + 8 * st, ((it / STAGES) & 1) ^ 1);
    *reinterpret_cast<int4*>(words + 16 * st) = w;
    if (w.x >= 0) {
      load_kv(st, w.x, head, batch);
    } else {
      sm90::mbar_arrive(bar_full + 8 * st);
    }
    ++it;
  };
  Block cur, nxt;
  take(cur);
  bool decided = false;  // cur's first candidates decided ahead
  while (cur.more) {
    if (!decided) decide(cur);
    int sent = 0;        // lane 0: the block's tiles put
    bool ahead = false;  // nxt taken and decided
    xfa::emit_tiles(
        cur.n_tiles(),
        [&](int i, int& n0) {
          n0 = (cur.hi - 1 - i) * L;
          return i < 32 ? cur.f : flags_of(cur, i);  // i == lane below 32
        },
        [&](int n0, int flags) {
          put(make_int4(n0, flags, 0, 0), cur.head, cur.batch);
          ++tiles;
          elem += flags & kElem;
          if (++sent == STAGES) send_q(cur, true);
        },
        [&]() {  // the whole warp, before each tile
          if (ahead) return;
          const int st = it % STAGES;
          const bool full = lead && !sm90::mbar_test(bar_empty + 8 * st, ((it / STAGES) & 1) ^ 1);
          if (__shfl_sync(0xffffffffu, static_cast<int>(full), 0)) {
            take(nxt);
            decide(nxt);
            ahead = true;
          }
        });
    if (lead) {
      if (sent < STAGES) send_q(cur, sent > 0);
      put(make_int4(kEnd, 0, 0, 0), 0, 0);
    }
    ++qk;
    if (!ahead) take(nxt);
    cur = nxt;
    decided = ahead;
  }
  if (lead) {
    send_q(cur, false);                    // the slot kEnd: the consumers stop
    put(make_int4(kStop, 0, 0, 0), 0, 0);  // and the converters
    atomicAdd(next + 1, tiles);
    atomicAdd(next + 2, elem);
  }
}

// The converters of a masked kernel (warps 1-3 of the producer warpgroup):
// the ring's stages in order, each converted (`convert(st, first)`) unless
// its word (`word_at(st)`) is kEnd, until kStop.
template <int STAGES, typename WordAt, typename Convert>
__device__ __forceinline__ void masked_converters(uint32_t bar_full, uint32_t bar_ready,
                                                  WordAt word_at, Convert convert) {
  for (int it = 0;; ++it) {
    const int st = it % STAGES;
    sm90::mbar_wait(bar_full + 8 * st, (it / STAGES) & 1);
    const int first = *word_at(st);
    if (first == kStop) break;
    if (first != kEnd) convert(st, first);
    sm90::fence_proxy_async();  // the writes before the consumers' wgmma
    sm90::mbar_arrive(bar_ready + 8 * st);
  }
}

// Byte offset of element (r, c) in a K-major tile of rows of RB bytes, as
// TMA and wgmma lay it: RB 128 (32 floats) 128-byte swizzled, the 16-byte
// chunk c / 4 of row r at chunk (c / 4) ^ (r % 8); RB 64 (16 floats)
// 64-byte swizzled, at (c / 4) ^ ((r / 2) % 4).
template <int RB>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  const int x = RB == 128 ? (r & 7) : ((r >> 1) & 3);
  return r * RB + ((((c >> 2) ^ x)) << 4) + ((c & 3) << 2);
}

// Converter item j of a TMA-landed natural tile of N rows x D (boxes of 32
// columns x N rows; its raw values are the hi parts as the tensor cores read
// them): the lo parts into `lo`, same layout; with TRANS also the tile
// transposed, raw into th and lo into tl: D rows of N floats (4N bytes),
// query or key 8j + 2t + e of the tile at k position 8j + t + 4e, the order
// in which an accumulator's columns serve as the A fragment (see the
// header). An item is 4 rows 8 j8 + 2u + e (u < 4) by the 4 columns 4 c4 ..
// 4 c4 + 3 (16-byte loads and stores), in the transposes 4 rows of the 4
// consecutive k positions 8 j8 + 4e + u. The 8 items of a quarter warp (a
// 16-byte access's unit) take two chunks c4 and four (j8, e): the
// transposed stores hit 8 distinct 16-byte bank groups at N 32, the
// natural loads and stores 4 (two ways each).
template <int D, int N, bool TRANS>
__device__ __forceinline__ void convert_item(const uint8_t* nat, uint8_t* lo, uint8_t* th,
                                             uint8_t* tl, int j) {
  constexpr int kQ = N / 16;  // groups of four (j8, e)
  const int rest = j >> 3;
  const int kq = (j & 3) + 4 * (rest % kQ);  // 2 j8 + e
  const int c4 = 2 * (rest / kQ) + ((j >> 2) & 1), e = kq & 1, j8 = kq >> 1;
  float4 x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint32_t o = (c4 >> 3) * (N * 128) + swz<128>(8 * j8 + 2 * u + e, (c4 & 7) * 4);
    x[u] = *reinterpret_cast<const float4*>(nat + o);
    *reinterpret_cast<float4*>(lo + o) = make_float4(
        sm90::tf32_lo(x[u].x), sm90::tf32_lo(x[u].y), sm90::tf32_lo(x[u].z),
        sm90::tf32_lo(x[u].w));
  }
  if constexpr (TRANS) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const uint32_t ot = swz<4 * N>(4 * c4 + v, 8 * j8 + 4 * e);
      const float4 col = make_float4(reinterpret_cast<const float*>(&x[0])[v],
                                     reinterpret_cast<const float*>(&x[1])[v],
                                     reinterpret_cast<const float*>(&x[2])[v],
                                     reinterpret_cast<const float*>(&x[3])[v]);
      *reinterpret_cast<float4*>(th + ot) = col;
      *reinterpret_cast<float4*>(tl + ot) =
          make_float4(sm90::tf32_lo(col.x), sm90::tf32_lo(col.y), sm90::tf32_lo(col.z),
                      sm90::tf32_lo(col.w));
    }
  }
}

// A stage's two tiles (a: natural, lo, transposes; b: the same, with its
// transposes when TRANS_B), items dealt over the converters in turn.
template <int D, int N, bool TRANS_B>
__device__ __forceinline__ void convert_stage(uint8_t* a, uint8_t* b, int kt, int ct) {
  constexpr int kItems = N * D / 16;
  for (int j = ct; j < 2 * kItems; j += kConverters) {
    if (j < kItems) {
      convert_item<D, N, true>(a, a + kt, a + 2 * kt, a + 3 * kt, j);
    } else {
      convert_item<D, N, TRANS_B>(b, b + kt, b + 2 * kt, b + 3 * kt, j - kItems);
    }
  }
}

// D(64 x N) += A B on wgmma .tf32, A's fragment in registers
template <int N>
__device__ __forceinline__ void mma_tf32(float (&c)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 16) {
    sm90::wgmma_rs_n16_tf32(c, a, db);
  } else if constexpr (N == 32) {
    sm90::wgmma_rs_n32_tf32(c, a, db);
  } else if constexpr (N == 64) {
    sm90::wgmma_rs_n64_tf32(c, a, db);
  } else {
    sm90::wgmma_rs_n128_tf32(c, a, db);
  }
}

// The tensor cores sum a wgmma's products into its accumulator with
// truncation, not rounding (the H100's fp32 accumulate), so an accumulator
// that grows over many products drifts toward zero by about half an ulp a
// product. Each fp32 product below keeps its large accumulators short: the
// small terms (lo·hi, hi·lo) and the large one (hi·hi) go to separate
// accumulators, and a long sum (the forward's O and dQ over every key, dK
// and dV over every query row of the group) is taken a tile at a time on
// the tensor cores and added to its fp32 registers with rounding.

// C(64 x N) = A B^T over k = D (C zero on entry), issued, committed and
// waited for in chunks of CHUNK k-steps: A the 64 rows from a_row0 of a
// resident raw tile of a_rows rows (boxes of 32 columns x a_rows rows), read
// as m64k8 fragments and split in registers; B N rows in the natural layout,
// hi at b_hi and lo at b_lo (boxes of 32 columns x N rows). A_hi B_hi sums
// into c, A_lo B_hi + A_hi B_lo into a second accumulator, added at the end.
template <int D, int N, int CHUNK = kChunk<D>>
__device__ __forceinline__ void product_a_smem(float (&c)[N / 2], const uint8_t* a_tile,
                                               int a_rows, int a_row0, uint32_t b_hi,
                                               uint32_t b_lo, int w, int g, int t) {
  const uint64_t dh = sm90::desc_b128(b_hi, 16), dl = sm90::desc_b128(b_lo, 16);
  const uint8_t* a_row = a_tile + (a_row0 + 16 * w + g) * 128 + 4 * t;  // row % 8 == g
  float small[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) small[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += CHUNK) {
    uint32_t ah[CHUNK][4], al[CHUNK][4];
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const int kk = k0 + s;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int chunk = 2 * (kk & 3) + (i >> 1);
        const float x = *reinterpret_cast<const float*>(
            a_row + (kk >> 2) * (a_rows * 128) + (i & 1) * 8 * 128 + ((chunk ^ g) << 4));
        sm90::split_tf32(x, ah[s][i], al[s][i]);
      }
      sm90::fence_regs(ah[s]);
      sm90::fence_regs(al[s]);
    }
    sm90::fence_regs(c);
    sm90::fence_regs(small);
    sm90::wgmma_fence();
#pragma unroll
    for (int s = 0; s < CHUNK; ++s) {
      const int kk = k0 + s;
      const uint32_t off = (kk >> 2) * (N * 128 >> 4) + (kk & 3) * 2;  // 16-byte units
      mma_tf32<N>(small, al[s], dh + off);
      mma_tf32<N>(small, ah[s], dl + off);
      mma_tf32<N>(c, ah[s], dh + off);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(c);
    sm90::fence_regs(small);
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] += small[i];
}

// C(64 x N) = X B over k = K into a zeroed accumulator c, issued (not
// committed): X (64 x K) an fp32 accumulator of this warpgroup, split
// k-step by k-step in registers, its columns 2t, 2t + 1 of each 8 as the
// fragment's t, t + 4; B K-major, N rows of K floats in that order
// (convert_item, convert_vt), hi at b_hi and lo at b_lo (K 16: rows of 64
// bytes, 64-byte swizzled; K 32: rows of 128 bytes, 128-byte swizzled; K
// 64: two such boxes of N rows, N * 128 bytes apart); three products a
// k-step, the small terms first. The caller waits and adds c to its fp32
// registers.
template <int N, int K>
__device__ __forceinline__ void issue_a_acc(float (&c)[N / 2], const float (&x)[K / 2],
                                            uint32_t b_hi, uint32_t b_lo) {
  uint32_t ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    sm90::split_tf32(x[4 * kk], ah[kk][0], al[kk][0]);
    sm90::split_tf32(x[4 * kk + 2], ah[kk][1], al[kk][1]);
    sm90::split_tf32(x[4 * kk + 1], ah[kk][2], al[kk][2]);
    sm90::split_tf32(x[4 * kk + 3], ah[kk][3], al[kk][3]);
    sm90::fence_regs(ah[kk]);
    sm90::fence_regs(al[kk]);
  }
  const uint64_t dh = K == 16 ? sm90::desc_b64(b_hi) : sm90::desc_b128(b_hi, 16);
  const uint64_t dl = K == 16 ? sm90::desc_b64(b_lo) : sm90::desc_b128(b_lo, 16);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
  sm90::fence_regs(c);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    const uint32_t off = (kk >> 2) * (N * 128 >> 4) + (kk & 3) * 2;  // 16-byte units
    mma_tf32<N>(c, al[kk], dh + off);
    mma_tf32<N>(c, ah[kk], dl + off);
    mma_tf32<N>(c, ah[kk], dh + off);
  }
}

// dst += part, after the wait for part's products
template <int N>
__device__ __forceinline__ void add_part(float (&dst)[N], float (&part)[N]) {
  sm90::fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] += part[i];
}

// ------------------------------------------------------------------ forward

constexpr int kFwdRows = 128;  // query rows of a forward block (64 a consumer)
// Registers a thread after setmaxnreg (the launch gives each 168): the
// paged producer and converters need 64 (at 56 they spilled), the masked
// producer 72 (row_block_producer spilled at 64), and the consumers may
// take only what the producer gives up, 128 x (168 - 72) >= 256 x (216 -
// 168) (more, and setmaxnreg.inc waits forever).
template <bool MASKED>
constexpr int kFwdProducerRegs = MASKED ? 72 : 64;
constexpr int kFwdConsumerRegs = 216;
static_assert(128 * (168 - kFwdProducerRegs<true>) >= 256 * (kFwdConsumerRegs - 168),
              "the consumers take more registers than the producer gives up");
constexpr int kFwdStages = 2;
constexpr int kFwdChunk = 8;  // S's k-steps issued before a wait

// keys a forward stage: a stage's five tiles of L x D floats are 16 KB each
template <int D>
constexpr int kFwdKeys = D == 64 ? 64 : 32;

struct Fp32Params {
  const float* pages;  // PAGED: (P, hk, 2, ps, d), read by the converters without TMA
  float* out;          // (b, h, sq, d) by strides
  float* lse_out;      // (b, h, sq) contiguous, or null
  int64_t o_sb, o_sh, o_ss;
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int left, right;  // the window, -1 no bound; causal is right 0
  // paged K/V (PAGED): key j of batch row b at row j % ps of page
  // table[b * npp + j / ps] (clamped); lengths[b] keys, of which the last
  // sq are the queries (off = lengths[b] - sq)
  const int* table;
  const int* lengths;
  int ps, npp, num_pages;
  int tma;  // PAGED: tiles by TMA (ps a multiple of the stage's keys), else cp.async
  // MASKED: the flags (FlashMask stats per key tile of L keys, segment /
  // position stats per 128-row block and L-key tile, tile ranges per
  // block), the FlashMask bands (b, fm_heads, fm_skp) as [lo1, hi1, lo2,
  // hi2), and three counters: the scheduler's next item, the tiles emitted
  // and those of them with the elementwise test
  xfa::MaskParams mask;
  const int4* bands;
  int* next;
  xfa::BiasParams bias;  // BIAS: the attention bias (common.cuh BiasParams)
};

template <int D, bool MASKED = false>
struct FwdSmem {
  static constexpr int kQ = kFwdRows * D * 4;     // the resident q block
  static constexpr int kT = kFwdKeys<D> * D * 4;  // a tile of a stage
  // a stage: K (landed raw: its hi), K lo, V (landed raw), V^T hi, V^T lo
  static constexpr int kStage = 5 * kT;
  // masked: each stage's word, then the block's slot (row_block_producer)
  static constexpr int kWords = kQ + kFwdStages * kStage;
  // barriers: Q full, Q empty, then per stage full, ready, empty
  static constexpr int kBar = kWords + (MASKED ? 16 * (kFwdStages + 1) : 0);
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kFwdStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

// A forward block: its first row, head and batch row, the batch row's keys
// and causal offset, and its key tiles [first, first + n).
struct FwdBlock {
  int q0, head, batch, sk, off, first, n;
};

// Block `half` of pair `pair` (query blocks of kFwdRows rows, the heavier
// last) and the key tiles of L keys that its rows below sq see under the
// window; false when the pair has no second block. Paged, a batch row's
// keys are min(length, capacity) and its rows the last sq of its length.
template <int L, bool PAGED, bool BIAS = false>
__device__ __forceinline__ bool fwd_block(const Fp32Params& p, int pair, int half, int n_mb,
                                          FwdBlock& fb) {
  int m_block;
  if constexpr (BIAS) {  // a bias shared by every batch: blocks batch first
    if (!xfa::pair_block_by(p.bias.sb == 0 && p.b > 1, pair, half, n_mb, p.h, p.b, true, m_block,
                            fb.head, fb.batch))
      return false;
  } else if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, fb.head, fb.batch)) {
    return false;
  }
  fb.q0 = m_block * kFwdRows;
  if constexpr (PAGED) {
    const int len = p.lengths[fb.batch];
    fb.sk = min(len, p.npp * p.ps);
    fb.off = len - p.sq;
  } else {
    fb.sk = p.sk;
    fb.off = p.sk - p.sq;
  }
  const int r1 = min(fb.q0 + kFwdRows, p.sq) - 1;
  const int kmax = p.right < 0 ? fb.sk - 1 : min(fb.sk - 1, r1 + fb.off + p.right);
  const int kmin = p.left < 0 ? 0 : max(0, fb.q0 + fb.off - p.left);
  fb.first = kmin / L;
  fb.n = kmax >= kmin ? kmax / L - fb.first + 1 : 0;
  return true;
}

// The keys [lo, hi] that row `row` of block fb sees (hi < lo for none).
__device__ __forceinline__ void fwd_row_keys(const Fp32Params& p, const FwdBlock& fb, int row,
                                             int& lo, int& hi) {
  lo = p.left < 0 ? 0 : max(0, row + fb.off - p.left);
  hi = row >= p.sq ? -1 : p.right < 0 ? fb.sk - 1 : min(fb.sk - 1, row + fb.off + p.right);
}

// Converter item j of a TMA-landed V tile of L keys x D (boxes of 32
// columns x L rows): V^T as P V's K-major B, raw (its hi) into th and lo
// into tl, D rows of L floats in boxes of 32 k positions (D * 128 bytes
// apart), key 8j + 2t + e at k position 8j + t + 4e (convert_item's order,
// in which S's accumulator serves as P's A fragment). Keys at or past
// n_valid are written as zeros. Items as convert_item's.
template <int D, int L>
__device__ __forceinline__ void convert_vt(const uint8_t* nat, uint8_t* th, uint8_t* tl, int j,
                                           int n_valid) {
  constexpr int kQ = L / 16;  // groups of four (j8, e)
  const int rest = j >> 3;
  const int kq = (j & 3) + 4 * (rest % kQ);  // 2 j8 + e
  const int c4 = 2 * (rest / kQ) + ((j >> 2) & 1), e = kq & 1, j8 = kq >> 1;
  float4 x[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int key = 8 * j8 + 2 * u + e;
    x[u] = *reinterpret_cast<const float4*>(nat + (c4 >> 3) * (L * 128) +
                                            swz<128>(key, (c4 & 7) * 4));
    if (key >= n_valid) x[u] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int kp = 8 * j8 + 4 * e;  // the first of the 4 k positions
  const uint32_t box = (kp >> 5) * (D * 128);
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    const uint32_t ot = box + swz<128>(4 * c4 + v, kp & 31);
    const float4 col = make_float4(reinterpret_cast<const float*>(&x[0])[v],
                                   reinterpret_cast<const float*>(&x[1])[v],
                                   reinterpret_cast<const float*>(&x[2])[v],
                                   reinterpret_cast<const float*>(&x[3])[v]);
    *reinterpret_cast<float4*>(th + ot) = col;
    *reinterpret_cast<float4*>(tl + ot) =
        make_float4(sm90::tf32_lo(col.x), sm90::tf32_lo(col.y), sm90::tf32_lo(col.z),
                    sm90::tf32_lo(col.w));
  }
}

// A forward stage's conversions (K lo; V^T hi and lo), items dealt over
// the converters in turn; V's keys at or past n_valid as zeros.
template <int D, int L>
__device__ __forceinline__ void convert_fwd_stage(uint8_t* sp, int n_valid, int ct) {
  constexpr int kT = L * D * 4, kItems = L * D / 16;
  for (int j = ct; j < 2 * kItems; j += kConverters) {
    if (j < kItems) {
      convert_item<D, L, false>(sp, sp + kT, nullptr, nullptr, j);
    } else {
      convert_vt<D, L>(sp + 2 * kT, sp + 3 * kT, sp + 4 * kT, j - kItems, n_valid);
    }
  }
}

// The keys [n0, n0 + L) of block fb through the page table into a stage's
// K and V in TMA's layout (boxes of 32 columns x L rows, 128-byte
// swizzled), by cp.async from the converters (16 bytes each); keys at or
// past the batch row's sk zero-filled.
template <int D, int L>
__device__ __forceinline__ void load_pages(const Fp32Params& p, const FwdBlock& fb, int kv_head,
                                           int n0, uint8_t* sp, int ct) {
  constexpr int kChunks = D / 4, kT = L * D * 4;
  const int* table = p.table + static_cast<int64_t>(fb.batch) * p.npp;
  for (int idx = ct; idx < L * kChunks; idx += kConverters) {
    const int j = idx / kChunks, c = idx % kChunks, key = n0 + j;
    const bool ok = key < fb.sk;
    const int kk = ok ? key : 0;
    const int page = min(max(table[kk / p.ps], 0), p.num_pages - 1);
    const float* src = p.pages + (static_cast<int64_t>(page) * p.hk + kv_head) * 2 * p.ps * D +
                       static_cast<int64_t>(kk % p.ps) * D + 4 * c;
    const uint32_t o = (c >> 3) * (L * 128) + swz<128>(j, (c & 7) * 4);
    xfa::cp_async16(sp + o, src, ok);
    xfa::cp_async16(sp + 2 * kT + o, src + static_cast<int64_t>(p.ps) * D, ok);
  }
}

// The online softmax of one tile's scores s (register i: row g + 8 ((i /
// 2) % 2), key n0 + 8 (i / 4) + 2t + (i % 2)), in place: softcap, with
// MASK the elementwise test (`vis(i)`: register i visible); then the
// running max m, s = P in fp32 (ex2 with the max and log2(e) folded in),
// this thread's share of the row sums l (the quad is summed at the end) and
// alpha, the factor that takes the running O to the new max.
template <int L, bool MASK, bool SOFTCAP, typename Vis = AllVisible>
__device__ __forceinline__ void fwd_softmax(float (&s)[L / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], float cap, Vis vis = {}) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i];
    if constexpr (SOFTCAP) x = tanhf(x / cap) * cap;
    if constexpr (MASK) x = vis(i) ? x : -INFINITY;
    s[i] = x;
    mx[r] = fmaxf(mx[r], x);
  }
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with nothing visible yet keeps a zero shift, so ex2 gives 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = sm90::ex2((m[r] - m_use) * sm90::kLog2e);
    shift[r] = m_use * sm90::kLog2e;
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = sm90::ex2(fmaf(s[i], sm90::kLog2e, -shift[r]));
    rs[r] += s[i];
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
}

// The forward's BIAS: softcap, then the bias `bv` of the same fragment
// (common.cuh load_bias_rows) added in fp32, in place on the scores s, as
// the TPU kernel adds it (fwd.py:353-354): before the mask and the softmax
// (fwd_softmax then runs without SOFTCAP).
template <int N, bool SOFTCAP>
__device__ __forceinline__ void cap_and_bias(float (&s)[N / 2], const float (&bv)[N / 2],
                                             float cap) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    float x = s[i];
    if constexpr (SOFTCAP) x = tanhf(x / cap) * cap;
    s[i] = x + bv[i];
  }
}

// The bias lines of a warp's tile, one 128-byte line a lane, prefetched into
// L1 before the tile's products, so that its fragment loads after them
// (common.cuh load_bias_rows / load_bias_cols) find them there: loads held
// in registers across the products spilled in the masked forward and dQ.
// A warp's fragment covers ROWS bias rows from r0 (clamped below sq, as the
// loads clamp) by KEYS keys from k0, ROWS * KEYS * 4 bytes at most 32
// lines.
template <int ROWS, int KEYS>
__device__ __forceinline__ void prefetch_bias(const xfa::BiasParams& bp, int64_t base, int r0,
                                              int k0, int sq, int sk, int lane) {
  static_assert(ROWS <= 32 && 32 % ROWS == 0, "a row per lane group");
  const int es = bp.dtype == xfa::kBF16 ? 2 : 4;
  const int key = k0 + (lane / ROWS) * (128 / es);  // the lane's line of its row
  if (key < k0 + KEYS) {
    const char* at = static_cast<const char*>(bp.ptr) +
                     (base + min(r0 + lane % ROWS, sq - 1) * bp.ss + min(key, sk - 1)) * es;
    asm volatile("prefetch.global.L1 [%0];" ::"l"(at));
  }
}

// A consumer's rows row0 and row0 + 8 of O / l, divided as the plain
// version divides (0 where a row saw nothing), and their LSE (+inf there).
template <int D>
__device__ __forceinline__ void fwd_store(const Fp32Params& p, int batch, int head, int row0,
                                          const float (&o)[D / 2], const float (&m)[2],
                                          const float (&l)[2], int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int row = row0 + 8 * r;
    if (row >= p.sq) continue;
    float* orow = p.out + batch * p.o_sb + head * p.o_sh + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float2 v = lr > 0.f ? make_float2(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr)
                                : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = v;
    }
    if (p.lse_out != nullptr && t == 0)
      p.lse_out[(static_cast<int64_t>(batch) * p.h + head) * p.sq + row] =
          lr > 0.f ? m[r] + logf(lr) : INFINITY;
  }
}

template <int D, bool PAGED, bool SOFTCAP, bool MASKED, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Fp32Params p) {
  static_assert(!(PAGED && MASKED), "the paged route takes no mask");
  static_assert(!(PAGED && BIAS), "the paged route takes no bias");
  using S = FwdSmem<D, MASKED>;
  constexpr int L = kFwdKeys<D>, kStages = kFwdStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 8;
  const uint32_t bar_full = bar_qe + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_mb = (p.sq + kFwdRows - 1) / kFwdRows;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);
  const int group = p.h / p.hk;
  // tiles by TMA: always on the dense route, paged when a tile lies in one page
  const bool tma_tiles = !PAGED || p.tma;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    sm90::mbar_init(bar_qe, 8);  // the eight consumer warps
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_ready + 8 * st, kConverters);
      sm90::mbar_init(bar_empty + 8 * st, 8);  // the eight consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Dense, every role walks the same blocks and counts the same q loads
  // (qk) and key tiles (it, the ring position), so stages and parities
  // agree; a block whose rows see no key loads nothing, its O is zeros, its
  // LSE +inf. Masked, the consumers take each block from its slot (every
  // block takes the q buffer, loaded or not) and the consumers and the
  // converters each tile from its stage's word (row_block_producer).
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kFwdProducerRegs<MASKED>>();
    if constexpr (MASKED) {
      if (threadIdx.x < 32) {
        row_block_producer<L, kStages>(
            p.mask, p.next, p.b, p.h, p.sq, p.sk, smem + S::kWords, bar_q, bar_qe, bar_full,
            bar_empty,
            [&](int q0, int head, int batch) {
              sm90::mbar_expect_tx(bar_q, S::kQ);
              for (int j = 0; j < D / 32; ++j)
                sm90::tma_load_4d(base + j * kFwdRows * 128, &tq, bar_q, 32 * j, q0, head, batch);
            },
            [&](int st, int n0, int head, int batch) {
              const uint32_t k_st = base + S::kQ + st * S::kStage, v_st = k_st + 2 * S::kT;
              sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT);
              for (int j = 0; j < D / 32; ++j) {
                sm90::tma_load_4d(k_st + j * L * 128, &tk, bar_full + 8 * st, 32 * j, n0,
                                  head / group, batch);
                sm90::tma_load_4d(v_st + j * L * 128, &tv, bar_full + 8 * st, 32 * j, n0,
                                  head / group, batch);
              }
            });
      } else {
        masked_converters<kStages>(
            bar_full, bar_ready,
            [&](int st) { return reinterpret_cast<const int*>(smem + S::kWords + 16 * st); },
            [&](int st, int n0) {
              convert_fwd_stage<D, L>(smem + S::kQ + st * S::kStage, p.sk - n0,
                                      threadIdx.x - 32);
            });
      }
    } else if (threadIdx.x == 0) {  // the loads: a block's first tiles, then its q
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          FwdBlock fb;
          if (!fwd_block<L, PAGED, BIAS>(p, pair, half, n_mb, fb) || fb.n == 0) continue;
          const int kv_head = fb.head / group;
          const int q_at = tma_tiles ? min(kStages, fb.n) : 0;
          for (int i = 0; i <= fb.n; ++i) {
            if (i == q_at) {
              sm90::mbar_wait(bar_qe, (qk & 1) ^ 1);  // the first pass is free
              sm90::mbar_expect_tx(bar_q, S::kQ);
              for (int j = 0; j < D / 32; ++j)
                sm90::tma_load_4d(base + j * kFwdRows * 128, &tq, bar_q, 32 * j, fb.q0, fb.head,
                                  fb.batch);
              ++qk;
              if (!tma_tiles) break;  // the converters load the tiles
            }
            if (i == fb.n) break;
            const int st = it % kStages, n0 = (fb.first + i) * L;
            const uint32_t k_st = base + S::kQ + st * S::kStage, v_st = k_st + 2 * S::kT;
            sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT);
            if constexpr (PAGED) {
              const int page = min(max(p.table[static_cast<int64_t>(fb.batch) * p.npp + n0 / p.ps],
                                       0),
                                   p.num_pages - 1);
              const int row = n0 % p.ps;
              for (int j = 0; j < D / 32; ++j) {
                sm90::tma_load_5d(k_st + j * L * 128, &tk, bar_full + 8 * st, 32 * j, row, 0,
                                  kv_head, page);
                sm90::tma_load_5d(v_st + j * L * 128, &tk, bar_full + 8 * st, 32 * j, row, 1,
                                  kv_head, page);
              }
            } else {
              for (int j = 0; j < D / 32; ++j) {
                sm90::tma_load_4d(k_st + j * L * 128, &tk, bar_full + 8 * st, 32 * j, n0, kv_head,
                                  fb.batch);
                sm90::tma_load_4d(v_st + j * L * 128, &tv, bar_full + 8 * st, 32 * j, n0, kv_head,
                                  fb.batch);
              }
            }
            ++it;
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters, stage by stage
      const int ct = threadIdx.x - 32;
      int it = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          FwdBlock fb;
          if (!fwd_block<L, PAGED, BIAS>(p, pair, half, n_mb, fb)) continue;
          for (int i = 0; i < fb.n; ++i, ++it) {
            const int st = it % kStages, n0 = (fb.first + i) * L;
            uint8_t* sp = smem + S::kQ + st * S::kStage;
            if (tma_tiles) {
              sm90::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
            } else {
              sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
              load_pages<D, L>(p, fb, fb.head / group, n0, sp, ct);
              xfa::cp_async_commit();
              xfa::cp_async_wait<0>();
              sm90::named_barrier(1, kConverters);  // every converter's rows have landed
            }
            convert_fwd_stage<D, L>(sp, fb.sk - n0, ct);
            sm90::fence_proxy_async();  // the writes before the consumers' wgmma
            sm90::mbar_arrive(bar_ready + 8 * st);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    sm90::setmaxnreg_inc<kFwdConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, qk = 0;
    float o[D / 2], m[2], l[2];
    // BIAS: the tile's bias, its lines prefetched before the product
    // (`fetch`), loaded after it (`bias_in`) and added after softcap;
    // fwd_softmax then without softcap. The masked consumers (216 registers)
    // issue S's k-steps 4 at a time, and at d 128 do not prefetch: with 8 a
    // wait they spilled 96-164 bytes, with the prefetch at d 128 8-24 (ptxas
    // hoists the bias loads into the product; PERF.md section 6)
    float bv[BIAS ? L / 2 : 1];
    constexpr int kChunkS = MASKED && BIAS ? 4 : kFwdChunk;
    constexpr bool kCap = SOFTCAP && !BIAS;
    auto fetch = [&](int batch, int head, int q0, int n0) {
      if constexpr (BIAS && !(MASKED && D == 128))
        prefetch_bias<16, L>(p.bias, batch * p.bias.sb + head * p.bias.sh, q0 + 64 * cw + 16 * w,
                             n0, p.sq, p.sk, lane);
    };
    auto load_bias = [&](int batch, int head, int row0, int n0) {
      if constexpr (BIAS)
        xfa::load_bias_rows<L>(bv, p.bias, batch * p.bias.sb + head * p.bias.sh, row0, n0, p.sq,
                               p.sk, t);
    };
    auto clear = [&]() {
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
    };
    // q_s = q * sm_scale in place over this consumer's rows
    auto scale_q = [&]() {
      float4* q4 = reinterpret_cast<float4*>(smem) + 64 * cw * 8;
      for (int j = 0; j < D / 32; ++j) {
        for (int i = wt; i < 64 * 8; i += 128) {
          float4& x = q4[j * kFwdRows * 8 + i];
          x = make_float4(x.x * p.sm_scale, x.y * p.sm_scale, x.z * p.sm_scale, x.w * p.sm_scale);
        }
      }
      sm90::fence_proxy_async();  // before the wgmma reads them and the next q's TMA
      sm90::named_barrier(2 + cw, 128);
    };
    // The key tile of stage st: S = q_s K^T, the online softmax
    // (`softmax(s, alpha)`), then O += P V, the tile's part on the tensor
    // cores, added in fp32 after O's rescale
    auto tile = [&](int st, auto bias_in, auto softmax) {
      const uint32_t stage = base + S::kQ + st * S::kStage;
      float s[L / 2];
#pragma unroll
      for (int j = 0; j < L / 2; ++j) s[j] = 0.f;
      product_a_smem<D, L, kChunkS>(s, smem, kFwdRows, 64 * cw, stage, stage + S::kT, w, g, t);
      if constexpr (BIAS) {
        bias_in();
        cap_and_bias<L, SOFTCAP>(s, bv, p.softcap);
      }
      float alpha[2];
      softmax(s, alpha);
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      float pv[D / 2];
      issue_a_acc<D, L>(pv, s, stage + 3 * S::kT, stage + 4 * S::kT);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      add_part(o, pv);
    };
    if constexpr (MASKED) {
      // blocks from the slot, tiles from the words; a consumer with no
      // part of a tile passes it by
      const xfa::MaskParams& mk = p.mask;
      for (;;) {
        sm90::mbar_wait(bar_q, qk & 1);
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kWords + 16 * kStages);
        const int m_block = __shfl_sync(0xffffffffu, blk.x, 0);
        if (m_block == kEnd) break;
        ++qk;
        const int head = __shfl_sync(0xffffffffu, blk.y, 0);
        const int batch = __shfl_sync(0xffffffffu, blk.z, 0);
        const int row0 = m_block * kFwdRows + 64 * cw + 16 * w + g;  // rows row0, row0 + 8
        if (__shfl_sync(0xffffffffu, blk.w, 0)) scale_q();
        clear();
        const int4* bands =
            p.bands == nullptr
                ? nullptr
                : p.bands + static_cast<int64_t>(batch * mk.fm_heads +
                                                 xfa::fm_head(mk, head, p.h)) * mk.fm_skp;
        const int4* kinfo =
            mk.k_info == nullptr ? nullptr : mk.k_info + static_cast<int64_t>(batch) * mk.k_pad;
        const int4* qinfo =
            mk.q_info == nullptr ? nullptr : mk.q_info + static_cast<int64_t>(batch) * mk.q_pad;
        for (;;) {
          const int st = it % kStages, use = it / kStages;
          sm90::mbar_wait(bar_full + 8 * st, use & 1);
          sm90::mbar_wait(bar_ready + 8 * st, use & 1);
          const int4 wd = *reinterpret_cast<const int4*>(smem + S::kWords + 16 * st);
          const int n0 = __shfl_sync(0xffffffffu, wd.x, 0);
          const int f = __shfl_sync(0xffffffffu, wd.y, 0);
          if (n0 != kEnd && ((f >> (kOnShift + 2 * cw)) & 3) != 0) {
            const uint32_t vis =
                f & kElem ? rows_visible_by<L>(f, mk, p.sq, p.sk, n0, row0, bands, kinfo, qinfo, t)
                          : 0u;
            if constexpr (BIAS) {
              fetch(batch, head, m_block * kFwdRows, n0);
              tile(
                  st, [&] { load_bias(batch, head, row0, n0); },
                  [&](float (&s)[L / 2], float (&alpha)[2]) {
                    if (f & kElem) {
                      fwd_softmax<L, true, false>(s, m, l, alpha, p.softcap,
                                                  [&](int i) { return ((vis >> i) & 1u) != 0; });
                    } else {
                      fwd_softmax<L, false, false>(s, m, l, alpha, p.softcap);
                    }
                  });
            } else {  // the lambdas capture only what the kernel without a bias did
              tile(st, [] {}, [&](float (&s)[L / 2], float (&alpha)[2]) {
                if (f & kElem) {
                  fwd_softmax<L, true, SOFTCAP>(s, m, l, alpha, p.softcap,
                                                [&](int i) { return ((vis >> i) & 1u) != 0; });
                } else {
                  fwd_softmax<L, false, SOFTCAP>(s, m, l, alpha, p.softcap);
                }
              });
            }
          }
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
          ++it;
          if (n0 == kEnd) break;
        }
        if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s
        fwd_store<D>(p, batch, head, row0, o, m, l, t);
      }
    } else {
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          FwdBlock fb;
          if (!fwd_block<L, PAGED, BIAS>(p, pair, half, n_mb, fb)) continue;
          const int rc0 = fb.q0 + 64 * cw;     // this consumer's first row
          const int row0 = rc0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
          int lo[2], hi[2];                   // the keys each of them sees
          fwd_row_keys(p, fb, row0, lo[0], hi[0]);
          fwd_row_keys(p, fb, row0 + 8, lo[1], hi[1]);
          // the keys of the consumer's first row and of its last row below sq
          int lo_a, hi_a, lo_b, hi_b;
          fwd_row_keys(p, fb, rc0, lo_a, hi_a);
          fwd_row_keys(p, fb, min(rc0 + 63, p.sq - 1), lo_b, hi_b);
          const bool has_rows = rc0 < p.sq;
          clear();
          if (fb.n > 0) {
            sm90::mbar_wait(bar_q, qk & 1);
            ++qk;
            scale_q();
            for (int i = 0; i < fb.n; ++i, ++it) {
              const int st = it % kStages, use = it / kStages;
              const int n0 = (fb.first + i) * L;
              if (tma_tiles) sm90::mbar_wait(bar_full + 8 * st, use & 1);
              sm90::mbar_wait(bar_ready + 8 * st, use & 1);
              if (has_rows && n0 <= hi_b && n0 + L - 1 >= lo_a) {
                const bool whole = rc0 + 64 <= p.sq && n0 >= lo_b && n0 + L - 1 <= hi_a;
                fetch(fb.batch, fb.head, fb.q0, n0);
                tile(
                    st, [&] { load_bias(fb.batch, fb.head, row0, n0); },
                    [&](float (&s)[L / 2], float (&alpha)[2]) {
                      if (whole) {
                        fwd_softmax<L, false, kCap>(s, m, l, alpha, p.softcap);
                      } else {
                        fwd_softmax<L, true, kCap>(s, m, l, alpha, p.softcap, [&](int i) {
                          const int key = n0 + (i >> 2) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
                          return (key >= lo[r]) & (key <= hi[r]);
                        });
                      }
                    });
              }
              if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
            }
            if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s
          }
          fwd_store<D>(p, fb.batch, fb.head, row0, o, m, l, t);
        }
      }
    }
  }
}

// ----------------------------------------------------------------- backward

// The tiles by head dim: dK/dV's keys a block, query rows a stage and
// stages, whether the two consumers split the block's keys (else both take
// all 64 keys and split dK's and dV's columns); dQ's keys a stage and
// stages.
template <int D>
struct BwdTiles;
template <>
struct BwdTiles<64> {
  static constexpr int kKeys = 128, kRows = 32, kDkvStages = 2, kDqKeys = 32, kDqStages = 3;
  static constexpr bool kKeySplit = true;
};
template <>
struct BwdTiles<128> {
  static constexpr int kKeys = 64, kRows = 16, kDkvStages = 2, kDqKeys = 16, kDqStages = 2;
  static constexpr bool kKeySplit = false;
};

struct Fp32BwdParams {
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  float* dq;
  float* dk;
  float* dv;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int left, right;  // the window, -1 no bound; causal is right 0
  // MASKED: the flags at the kernel's tiles, the FlashMask bands and the
  // three counters, as Fp32Params
  xfa::MaskParams mask;
  const int4* bands;
  int* next;
  xfa::BiasParams bias;  // BIAS: the forward's attention bias
};

// Block `half` of pair `pair` (common.cuh pair_block over `heads`); with
// BIAS and a bias shared by every batch, the batches of a head first, so
// that the blocks running together read the same bias rows.
template <bool BIAS>
__device__ __forceinline__ bool bwd_pair_block(const Fp32BwdParams& p, int pair, int half,
                                               int n_blocks, int heads, bool heavy_last,
                                               int& block, int& head, int& batch) {
  if constexpr (BIAS)
    return xfa::pair_block_by(p.bias.sb == 0 && p.b > 1, pair, half, n_blocks, heads, p.b,
                              heavy_last, block, head, batch);
  return xfa::pair_block(pair, half, n_blocks, heads, heavy_last, block, head, batch);
}

// P and dS of one element from its score x and dP, the row's LSE times
// log2(e) and delta: P = 2^(x log2(e) - lse2) on the SFU (ex2.approx, about
// 2^-22 of P; x log2(e) rounded once in the FMA), 0 where not visible (a
// row that saw nothing has LSE +inf: ex2(-inf) = 0, never NaN); with BIAS
// the element's bias added after softcap, as the forward adds it (dS keeps
// the softcap derivative; the bias enters after it).
template <bool SOFTCAP, bool BIAS = false>
__device__ __forceinline__ void p_ds(float x, float& dp, float lse2, float delta, bool vis,
                                     float cap, float& pr, float bias = 0.f) {
  float fac = 1.f;
  if constexpr (SOFTCAP) {
    const float th = tanhf(x / cap);
    x = th * cap;
    fac = 1.f - th * th;
  }
  if constexpr (BIAS) x += bias;
  pr = vis ? sm90::ex2(fmaf(x, sm90::kLog2e, -lse2)) : 0.f;
  dp = pr * (dp - delta) * fac;
}

// The rows [lo, hi] that key `key` is visible to under the window and the
// bounds (hi < lo for none).
__device__ __forceinline__ void key_rows(const Fp32BwdParams& p, int key, int& lo, int& hi) {
  const int off = p.sk - p.sq;
  lo = p.right < 0 ? 0 : max(0, key - off - p.right);
  hi = key >= p.sk ? -1 : p.left < 0 ? p.sq - 1 : min(p.sq - 1, key - off + p.left);
}

// The keys [lo, hi] that row `row` sees (hi < lo for none).
__device__ __forceinline__ void row_keys(const Fp32BwdParams& p, int row, int& lo, int& hi) {
  const int off = p.sk - p.sq;
  lo = p.left < 0 ? 0 : max(0, row + off - p.left);
  hi = row >= p.sq ? -1 : p.right < 0 ? p.sk - 1 : min(p.sk - 1, row + off + p.right);
}

// Whether every pair of rows [r0, r0 + nr) and keys [k0, k0 + nk) is
// visible (the elementwise test can be skipped).
__device__ __forceinline__ bool all_visible(const Fp32BwdParams& p, int r0, int nr, int k0,
                                            int nk) {
  const int off = p.sk - p.sq;
  return r0 + nr <= p.sq && k0 + nk <= p.sk &&
         (p.right < 0 || k0 + nk - 1 <= r0 + off + p.right) &&
         (p.left < 0 || k0 >= r0 + nr - 1 + off - p.left);
}

// dK/dV: P^T and dS^T of one query tile in place (s: S^T -> P^T, dp: dP^T
// -> dS^T); rows this thread's keys key0 and key0 + 8, columns the tile's
// rows m0 + c with their LSE and delta from the stage; with MASK the
// elementwise test (`vis(i)`: register i visible); with BIAS the tile's
// bias `bv` in the same layout (common.cuh load_bias_cols).
template <int R, bool MASK, bool SOFTCAP, bool BIAS = false, typename Vis = AllVisible>
__device__ __forceinline__ void dkv_p_ds(float (&s)[R / 2], float (&dp)[R / 2], const float* lse,
                                         const float* delta, float cap, int t, Vis vis = {},
                                         const float* bv = nullptr) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse[c] * sm90::kLog2e, delta[c], !MASK || vis(i), cap, s[i],
                        BIAS ? bv[i] : 0.f);
  }
}

// dQ: dS of one key tile in place (dp: dP -> dS) from S; rows this
// thread's rows row0 and row0 + 8 (LSE times log2(e) and delta per row),
// columns the tile's keys; with MASK the elementwise test (`vis(i)`); with
// BIAS the tile's bias `bv` (common.cuh load_bias_rows).
template <int L, bool MASK, bool SOFTCAP, bool BIAS = false, typename Vis = AllVisible>
__device__ __forceinline__ void dq_ds(const float (&s)[L / 2], float (&dp)[L / 2],
                                      const float (&lse2)[2], const float (&delta)[2], float cap,
                                      Vis vis = {}, const float* bv = nullptr) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int r = (i >> 1) & 1;
    float pr;
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse2[r], delta[r], !MASK || vis(i), cap, pr,
                        BIAS ? bv[i] : 0.f);
  }
}

// This thread's share of a (64 x D) accumulator, times `scale`, to rows
// row0 and row0 + 8 of `dst` (row stride ss); rows at or past `limit` are
// not written.
template <int D>
__device__ __forceinline__ void store_acc(float* dst, int64_t ss, const float (&c)[D / 2],
                                          int row0, int limit, float scale, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = row0 + 8 * rr;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(dst + row * ss + 8 * j + 2 * t) =
          make_float2(c[4 * j + 2 * rr] * scale, c[4 * j + 2 * rr + 1] * scale);
  }
}

// The query tiles of R rows that the keys [n0, n0 + nk) below sk see under
// the window: tiles [first, first + n).
template <int R>
__device__ __forceinline__ void query_tiles(const Fp32BwdParams& p, int n0, int nk, int& first,
                                            int& n) {
  const int off = p.sk - p.sq, n1 = min(n0 + nk, p.sk) - 1;
  const int rmin = p.right < 0 ? 0 : max(0, n0 - off - p.right);
  const int rmax = p.left < 0 ? p.sq - 1 : min(p.sq - 1, n1 - off + p.left);
  first = rmin / R;
  n = rmax >= rmin ? rmax / R - first + 1 : 0;
}

// The key tiles of L keys that rows [q0, q0 + nr) below sq see under the
// window: tiles [first, first + n).
template <int L>
__device__ __forceinline__ void key_tiles(const Fp32BwdParams& p, int q0, int nr, int& first,
                                          int& n) {
  const int off = p.sk - p.sq, r1 = min(q0 + nr, p.sq) - 1;
  const int kmax = p.right < 0 ? p.sk - 1 : min(p.sk - 1, r1 + off + p.right);
  const int kmin = p.left < 0 ? 0 : max(0, q0 + off - p.left);
  first = kmin / L;
  n = kmax >= kmin ? kmax / L - first + 1 : 0;
}

// ---- dK/dV

template <int D, bool MASKED = false>
struct DkvSmem {
  using T = BwdTiles<D>;
  static constexpr int kStages = T::kDkvStages;
  static constexpr int kKV = T::kKeys * D * 4;  // K or V of a block
  static constexpr int kT = T::kRows * D * 4;   // a tile of a stage
  // a stage: q_s (landed raw: its hi), q_s lo, q_s^T hi, q_s^T
  // lo, then the same four of dO, then the LSE box, the masked word (first
  // row, head in the group, flags; kEnd, kStop) and the delta box
  static constexpr int kStatBox = T::kRows + 4;
  static constexpr int kStats = 8 * kT;
  static constexpr int kWord = kStats + 256;
  static constexpr int kStage = 8 * kT + 1024;
  static constexpr int kRing = 2 * kKV;
  // barriers: K/V full, K/V empty, then per stage full, ready, empty; then
  // the masked block's slot
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBlk = kBar + 8 * (2 + 3 * kStages);
  static constexpr int kBytes = kBlk + (MASKED ? 16 : 0) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kStatBox * 4 <= 256, "the LSE box ends before the word");
};

// The flags of the dK/dV tile of rows [m0, m0 + R) against the key block
// of KEYS keys at n0 for query head `head`, or -1 when it is skipped
// (flash_bwd.cu dkv_tile_flags at the fp32 tiles): `st` the FlashMask
// stats of the block's keys (or null), `elem` the window / ragged test of
// the plan, the segment / position decision from the stats per R-row tile
// and KEYS-key block; on bits: at d 64 consumer c's 64 keys [64c, 64c +
// 64), at d 128 (KEYS 64) both consumers take the block's keys. A
// block-mask entry covers 64 or more rows and keys, so a tile never needs
// its test per element. Mirrored by bwd.py bwd_masked_dkv_tile_plan.
template <int R, int KEYS>
__device__ __forceinline__ int dkv_flags(const Fp32BwdParams& p, const int* st, int batch,
                                         int head, int n0, int m0, bool elem) {
  const xfa::MaskParams& m = p.mask;
  int flags = elem ? kElem : 0;
  if (st != nullptr) {
    bool skip, bypass;
    xfa::fm_decide(m.fm_mode, st, m0, min(m0 + R, p.sq), skip, bypass);
    if (skip) return -1;
    if (!bypass) flags |= kElem | kBand;
  }
  if (m.q_info != nullptr) {
    const int tf = xfa::token_flags(m, m.q_st[static_cast<int64_t>(batch) * m.n_qst + m0 / R],
                                    m.k_st[static_cast<int64_t>(batch) * m.n_kst + n0 / KEYS]);
    if (tf < 0) return -1;
    flags |= tf;
  }
  int on = 0;
#pragma unroll
  for (int c = 0; c < KEYS / 64; ++c) {
    const int key = n0 + 64 * c;
    if (key < p.sk && xfa::bm_on(m, batch, head, p.h, m0, key)) on |= 1 << c;
  }
  if (KEYS == 64) on |= on << 1;
  return on == 0 ? -1 : flags | on << kOnShift;
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tlse,
                              const __grid_constant__ CUtensorMap tdelta,
                              const Fp32BwdParams p) {
  using S = DkvSmem<D, MASKED>;
  using T = BwdTiles<D>;
  constexpr int R = T::kRows, kKeys = T::kKeys, kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_kv = base + S::kBar, bar_kve = bar_kv + 8;
  const uint32_t bar_full = bar_kve + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_nb = (p.sk + kKeys - 1) / kKeys;
  const int n_pairs = xfa::block_pairs(n_nb, p.hk, p.b);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_kv, 1);
    sm90::mbar_init(bar_kve, 8);  // the eight consumer warps
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_ready + 8 * st, kConverters);
      sm90::mbar_init(bar_empty + 8 * st, 8);  // the eight consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Dense, every role walks the same blocks and counts the same K/V loads
  // (kv) and query tiles (it, the ring position), so stages and parities
  // agree; a block whose keys no row sees loads nothing, its dK and dV are
  // zeros. Masked, the consumers take each block from its slot and the
  // consumers and converters each tile from its stage's word.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs<MASKED>>();
    // one thread's loads: a block's K and V, a query tile of `head` at m0
    auto load_kv = [&](int n0, int kv_head, int batch) {
      sm90::mbar_expect_tx(bar_kv, 2 * S::kKV);
      for (int j = 0; j < D / 32; ++j) {
        sm90::tma_load_4d(base + j * kKeys * 128, &tk, bar_kv, 32 * j, n0, kv_head, batch);
        sm90::tma_load_4d(base + S::kKV + j * kKeys * 128, &tv, bar_kv, 32 * j, n0, kv_head,
                          batch);
      }
    };
    auto load_tile = [&](int st, int m0, int head, int batch) {
      const uint32_t stage = base + S::kRing + st * S::kStage;
      sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT + 2 * S::kStatBox * 4);
      for (int j = 0; j < D / 32; ++j) {
        sm90::tma_load_4d(stage + j * R * 128, &tq, bar_full + 8 * st, 32 * j, m0, head, batch);
        sm90::tma_load_4d(stage + 4 * S::kT + j * R * 128, &tdo, bar_full + 8 * st, 32 * j, m0,
                          head, batch);
      }
      const int c0 = ((batch * p.h + head) * p.sq + m0) & ~3;  // a 1-D box starts 16-byte aligned
      sm90::tma_load_1d(stage + S::kStats, &tlse, bar_full + 8 * st, c0);
      sm90::tma_load_1d(stage + S::kStats + 512, &tdelta, bar_full + 8 * st, c0);
    };
    if constexpr (MASKED) {
      if (threadIdx.x < 32) {
        // ---- the masked producer (flash_bwd.cu's, at the fp32 tiles): its
        // whole warp decides, lane 0 loads and counts
        const xfa::MaskParams& mk = p.mask;
        const bool lead = threadIdx.x == 0;
        int it = 0, kv = 0, tiles = 0, elem = 0;
        auto word = [&](int st) {
          return reinterpret_cast<int4*>(smem + S::kRing + st * S::kStage + S::kWord);
        };
        auto put_alone = [&](int w) {  // lane 0: kEnd or kStop in the next stage
          const int st = it % kStages;
          sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
          *word(st) = make_int4(w, 0, 0, 0);
          sm90::mbar_arrive(bar_full + 8 * st);
          ++it;
        };
        for (;;) {
          int n_block = 0, kv_head = 0, batch = 0;
          const bool more =
              xfa::next_block(p.next, p.b, n_nb, p.hk, false, n_block, kv_head, batch);
          if (lead) {
            sm90::mbar_wait(bar_kve, (kv & 1) ^ 1);  // the first pass is free
            *reinterpret_cast<int4*>(smem + S::kBlk) =
                make_int4(more ? n_block : kEnd, kv_head, batch, 0);
            if (more) {
              load_kv(n_block * kKeys, kv_head, batch);
            } else {
              sm90::mbar_arrive(bar_kv);
            }
          }
          ++kv;
          if (!more) break;
          const int n0 = n_block * kKeys;
          const xfa::QueryTilePlan pl = xfa::query_window<R, kKeys>(mk, batch, n0, p.sq, p.sk);
          const int n_masked = pl.n_masked();
          for (int gi = 0; gi < group; ++gi) {
            const int head = kv_head * group + gi;
            const int* st_fm = mk.fm_vecs != nullptr
                                   ? xfa::fm_tile_stats(mk, batch, xfa::fm_head(mk, head, p.h),
                                                        n0, kKeys)
                                   : nullptr;
            xfa::emit_tiles(
                pl.n_tiles(),
                [&](int i, int& m0) {
                  m0 = pl.tile(i) * R;
                  return dkv_flags<R, kKeys>(p, st_fm, batch, head, n0, m0, i < n_masked);
                },
                [&](int m0, int flags) {
                  const int st = it % kStages;
                  sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
                  *word(st) = make_int4(m0, gi, flags, 0);
                  load_tile(st, m0, head, batch);
                  ++it;
                  ++tiles;
                  elem += flags & kElem;
                });
          }
          if (lead) put_alone(kEnd);
        }
        if (lead) {
          put_alone(kStop);
          atomicAdd(p.next + 1, tiles);
          atomicAdd(p.next + 2, elem);
        }
      } else {
        masked_converters<kStages>(
            bar_full, bar_ready,
            [&](int st) {
              return reinterpret_cast<const int*>(smem + S::kRing + st * S::kStage + S::kWord);
            },
            [&](int st, int) {
              uint8_t* sp = smem + S::kRing + st * S::kStage;
              convert_stage<D, R, true>(sp, sp + 4 * S::kT, S::kT, threadIdx.x - 32);
            });
      }
    } else if (threadIdx.x == 0) {  // the loads
      int it = 0, kv = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch, first, n_qt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_nb, p.hk, false, n_block, kv_head, batch))
            continue;
          const int n0 = n_block * kKeys;
          query_tiles<R>(p, n0, kKeys, first, n_qt);
          if (n_qt == 0) continue;
          sm90::mbar_wait(bar_kve, (kv & 1) ^ 1);  // the first pass is free
          load_kv(n0, kv_head, batch);
          ++kv;
          for (int gi = 0; gi < group; ++gi) {
            for (int i = 0; i < n_qt; ++i, ++it) {
              const int st = it % kStages;
              sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
              load_tile(st, (first + i) * R, kv_head * group + gi, batch);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters, stage by stage
      int n = 0;  // this CTA's query tiles
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch, first, n_qt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_nb, p.hk, false, n_block, kv_head, batch))
            continue;
          query_tiles<R>(p, n_block * kKeys, kKeys, first, n_qt);
          n += group * n_qt;
        }
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % kStages;
        uint8_t* sp = smem + S::kRing + st * S::kStage;
        sm90::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        convert_stage<D, R, true>(sp, sp + 4 * S::kT, S::kT, threadIdx.x - 32);
        sm90::fence_proxy_async();  // the writes before the consumers' wgmma
        sm90::mbar_arrive(bar_ready + 8 * st);
      }
    }
  } else {
    // ---- consumers: at d 64 consumer cw the block's keys [64 cw, 64 cw +
    // 64), at d 128 both the block's 64 keys (S^T and dP^T computed by both),
    // consumer cw dK's and dV's columns [64 cw, 64 cw + 64)
    sm90::setmaxnreg_inc<kConsumerRegs<MASKED>>();
    constexpr int kCols = T::kKeySplit ? D : 64;  // dK and dV columns a consumer owns
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    // the masked d 64 consumers (216 registers) wait for dV's product
    // before dK's: the split A fragments of both, live until the wait,
    // spilled beside the masked state
    constexpr bool kSerial = MASKED && D == 64;
    const int kc = T::kKeySplit ? 64 * cw : 0;    // this consumer's first key in the block
    const int col0 = T::kKeySplit ? 0 : 64 * cw;  // and its first column
    int it = 0, kv = 0;
    float dk[kCols / 2], dv[kCols / 2];
    // BIAS: the tile's bias in S^T's layout, its lines prefetched before
    // the products (`fetch`: a query row's 16 keys of a warp a lane), loaded
    // after them (common.cuh load_bias_cols, an element a load); the masked
    // d 64 consumers, whose registers are spent (kSerial), do not prefetch
    // (with it they spilled 8 bytes)
    float bv[BIAS ? R / 2 : 1];
    auto fetch = [&](int batch, int head, int key0, int m0) {
      if constexpr (BIAS && !(MASKED && D == 64))
        prefetch_bias<R, 16>(p.bias, batch * p.bias.sb + head * p.bias.sh, m0, key0 - g, p.sq,
                             p.sk, lane);
    };
    auto load_bias = [&](int batch, int head, int key0, int m0) {
      if constexpr (BIAS)
        xfa::load_bias_cols<R>(bv, p.bias, batch * p.bias.sb + head * p.bias.sh, key0, m0, p.sq,
                               p.sk, t);
    };
    // The query tile of stage st: S^T = K q_s^T and dP^T = V dO^T; then
    // its rows m0 and head (`at(m0, head)`, asked after the products, so
    // that nothing of the tile but its stage stays in registers across
    // them), P^T and dS^T (`pds(s, dp, lse, delta)`); then dV += P^T dO and
    // dK += dS^T q_s over this consumer's columns (the transposes' rows
    // col0 on), one wait for both, added in fp32
    auto tile = [&](int st, int batch, auto at, auto pds) {
      const uint32_t stage = base + S::kRing + st * S::kStage;
      const uint8_t* sp = smem + S::kRing + st * S::kStage;
      float s[R / 2], dp[R / 2];
#pragma unroll
      for (int j = 0; j < R / 2; ++j) s[j] = dp[j] = 0.f;
      product_a_smem<D, R, kChunk<D, MASKED>>(s, smem, kKeys, kc, stage, stage + S::kT, w, g, t);
      product_a_smem<D, R, kChunk<D, MASKED>>(dp, smem + S::kKV, kKeys, kc, stage + 4 * S::kT,
                                              stage + 5 * S::kT, w, g, t);
      int m0, head;
      at(m0, head);
      const int stat0 = (batch * p.h + head) * p.sq;
      const float* lse = reinterpret_cast<const float*>(sp + S::kStats) + ((stat0 + m0) & 3);
      pds(s, dp, lse, lse + 128);  // the delta box 512 bytes on
      const uint32_t cols = col0 * 4 * R;
      float pv[kCols / 2], pk[kCols / 2];
      issue_a_acc<kCols, R>(pv, s, stage + 6 * S::kT + cols, stage + 7 * S::kT + cols);
      if constexpr (kSerial) {  // dV's product waited for before dK's is issued
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        add_part(dv, pv);
      }
      issue_a_acc<kCols, R>(pk, dp, stage + 2 * S::kT + cols, stage + 3 * S::kT + cols);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      if constexpr (!kSerial) add_part(dv, pv);
      add_part(dk, pk);
    };
    auto clear = [&]() {
#pragma unroll
      for (int j = 0; j < kCols / 2; ++j) dk[j] = dv[j] = 0.f;
    };
    auto store = [&](int batch, int kv_head, int key0) {
      store_acc<kCols>(p.dk + batch * p.dk_sb + kv_head * p.dk_sh + col0, p.dk_ss, dk, key0, p.sk,
                       1.f, t);
      store_acc<kCols>(p.dv + batch * p.dv_sb + kv_head * p.dv_sh + col0, p.dv_ss, dv, key0, p.sk,
                       1.f, t);
    };
    if constexpr (MASKED) {
      const xfa::MaskParams& mk = p.mask;
      for (;;) {
        sm90::mbar_wait(bar_kv, kv & 1);
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kBlk);
        const int n_block = __shfl_sync(0xffffffffu, blk.x, 0);
        if (n_block == kEnd) break;
        const int kv_head = __shfl_sync(0xffffffffu, blk.y, 0);
        const int batch = __shfl_sync(0xffffffffu, blk.z, 0);
        const int key0 = n_block * kKeys + kc + 16 * w + g;  // this thread's keys: key0, key0 + 8
        clear();
        for (;;) {
          const int st = it % kStages, use = it / kStages;
          sm90::mbar_wait(bar_full + 8 * st, use & 1);  // the LSE and delta
          sm90::mbar_wait(bar_ready + 8 * st, use & 1);
          // the word, read again after the products (the d 64 consumers
          // spilled when it stayed in registers across them)
          const int4* word =
              reinterpret_cast<const int4*>(smem + S::kRing + st * S::kStage + S::kWord);
          const int m0 = __shfl_sync(0xffffffffu, word->x, 0);
          const int f = __shfl_sync(0xffffffffu, word->z, 0);
          if (m0 != kEnd && ((f >> (kOnShift + cw)) & 1) != 0) {
            fetch(batch, kv_head * group + word->y, key0, m0);
            tile(
                st, batch,
                [&](int& m0_, int& head) {
                  m0_ = word->x;
                  head = kv_head * group + word->y;
                },
                [&](float (&s)[R / 2], float (&dp)[R / 2], const float* lse,
                    const float* delta) {
                  const int4 wd = *word;
                  load_bias(batch, kv_head * group + wd.y, key0, wd.x);
                  if (wd.z & kElem) {
                    const int head = kv_head * group + wd.y;
                    const int4* bands =
                        p.bands == nullptr
                            ? nullptr
                            : p.bands + static_cast<int64_t>(batch * mk.fm_heads +
                                                             xfa::fm_head(mk, head, p.h)) *
                                            mk.fm_skp;
                    const int4* kinfo = mk.k_info == nullptr
                                            ? nullptr
                                            : mk.k_info + static_cast<int64_t>(batch) * mk.k_pad;
                    const int4* qinfo = mk.q_info == nullptr
                                            ? nullptr
                                            : mk.q_info + static_cast<int64_t>(batch) * mk.q_pad;
                    const uint32_t vis = keys_visible_by<R>(wd.z, mk, p.sq, p.sk, key0, wd.x,
                                                            bands, kinfo, qinfo, t);
                    dkv_p_ds<R, true, SOFTCAP, BIAS>(
                        s, dp, lse, delta, p.softcap, t,
                        [&](int i) { return ((vis >> i) & 1u) != 0; }, bv);
                  } else {
                    dkv_p_ds<R, false, SOFTCAP, BIAS>(s, dp, lse, delta, p.softcap, t,
                                                      AllVisible{}, bv);
                  }
                });
          }
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
          ++it;
          if (m0 == kEnd) break;
        }
        if (lane == 0) sm90::mbar_arrive(bar_kve);  // done with K and V
        ++kv;
        store(batch, kv_head, key0);
      }
    } else {
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch, first, n_qt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_nb, p.hk, false, n_block, kv_head, batch))
            continue;
          const int n0 = n_block * kKeys;
          query_tiles<R>(p, n0, kKeys, first, n_qt);
          const int key0 = n0 + kc + 16 * w + g;  // this thread's keys: key0, key0 + 8
          int lo[2], hi[2];  // the rows each of them is visible to
          key_rows(p, key0, lo[0], hi[0]);
          key_rows(p, key0 + 8, lo[1], hi[1]);
          clear();
          if (n_qt > 0) {
            sm90::mbar_wait(bar_kv, kv & 1);
            ++kv;
          }
          for (int idx = 0; idx < group * n_qt; ++idx, ++it) {
            const int st = it % kStages, use = it / kStages;
            const int gi = idx / n_qt, m0 = (first + idx - gi * n_qt) * R;
            sm90::mbar_wait(bar_full + 8 * st, use & 1);  // the LSE and delta
            sm90::mbar_wait(bar_ready + 8 * st, use & 1);
            const bool whole = all_visible(p, m0, R, n0 + kc, 64);
            fetch(batch, kv_head * group + gi, key0, m0);
            tile(st, batch,
                 [&](int& m0_, int& head) {
                   m0_ = m0;
                   head = kv_head * group + gi;
                 },
                 [&](float (&s)[R / 2], float (&dp)[R / 2], const float* lse, const float* delta) {
                   load_bias(batch, kv_head * group + gi, key0, m0);
                   if (whole) {
                     dkv_p_ds<R, false, SOFTCAP, BIAS>(s, dp, lse, delta, p.softcap, t,
                                                       AllVisible{}, bv);
                   } else {
                     dkv_p_ds<R, true, SOFTCAP, BIAS>(
                         s, dp, lse, delta, p.softcap, t,
                         [&](int i) {
                           const int row = m0 + (i >> 2) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
                           return (row >= lo[r]) & (row <= hi[r]);
                         },
                         bv);
                   }
                 });
            if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
          }
          store(batch, kv_head, key0);
          if (n_qt > 0 && lane == 0) sm90::mbar_arrive(bar_kve);
        }
      }
    }
  }
}

// ---- dQ

template <int D, bool MASKED = false>
struct DqSmem {
  using T = BwdTiles<D>;
  static constexpr int kStages = T::kDqStages;
  static constexpr int kQ = kDqRows * D * 4;      // q_s or dO of a block
  static constexpr int kT = T::kDqKeys * D * 4;   // a tile of a stage
  // a stage: K (landed raw: its hi), K lo, K^T hi, K^T lo, V (raw), V lo
  static constexpr int kStage = 6 * kT;
  static constexpr int kRing = 2 * kQ;
  // masked: each stage's word, then the block's slot (row_block_producer)
  static constexpr int kWords = kRing + kStages * kStage;
  // barriers: Q full, Q empty, then per stage full, ready, empty
  static constexpr int kBar = kWords + (MASKED ? 16 * (kStages + 1) : 0);
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Fp32BwdParams p) {
  using S = DqSmem<D, MASKED>;
  constexpr int L = BwdTiles<D>::kDqKeys, kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 8;
  const uint32_t bar_full = bar_qe + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_mb = (p.sq + kDqRows - 1) / kDqRows;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_q, 1);
    sm90::mbar_init(bar_qe, 8);
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_ready + 8 * st, kConverters);
      sm90::mbar_init(bar_empty + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // As dK/dV: dense, every role walks the same blocks, Q loads (qk) and key
  // tiles (it), a block whose rows see no key loads nothing and writes
  // zeros; masked, blocks from the slot and tiles from the words
  // (row_block_producer).
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs<MASKED>>();
    // one thread's loads: a block's q_s and dO, a K/V tile at n0
    auto load_q = [&](int q0, int head, int batch) {
      sm90::mbar_expect_tx(bar_q, 2 * S::kQ);
      for (int j = 0; j < D / 32; ++j) {
        sm90::tma_load_4d(base + j * kDqRows * 128, &tq, bar_q, 32 * j, q0, head, batch);
        sm90::tma_load_4d(base + S::kQ + j * kDqRows * 128, &tdo, bar_q, 32 * j, q0, head,
                          batch);
      }
    };
    auto load_kv = [&](int st, int n0, int head, int batch) {
      const uint32_t stage = base + S::kRing + st * S::kStage;
      sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT);
      for (int j = 0; j < D / 32; ++j) {
        sm90::tma_load_4d(stage + j * L * 128, &tk, bar_full + 8 * st, 32 * j, n0, head / group,
                          batch);
        sm90::tma_load_4d(stage + 4 * S::kT + j * L * 128, &tv, bar_full + 8 * st, 32 * j, n0,
                          head / group, batch);
      }
    };
    if constexpr (MASKED) {
      if (threadIdx.x < 32) {
        row_block_producer<L, kStages>(p.mask, p.next, p.b, p.h, p.sq, p.sk, smem + S::kWords,
                                       bar_q, bar_qe, bar_full, bar_empty, load_q, load_kv);
      } else {
        masked_converters<kStages>(
            bar_full, bar_ready,
            [&](int st) { return reinterpret_cast<const int*>(smem + S::kWords + 16 * st); },
            [&](int st, int) {
              uint8_t* sp = smem + S::kRing + st * S::kStage;
              convert_stage<D, L, false>(sp, sp + 4 * S::kT, S::kT, threadIdx.x - 32);
            });
      }
    } else if (threadIdx.x == 0) {  // the loads
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, first, n_kt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_mb, p.h, true, m_block, head, batch))
            continue;
          const int q0 = m_block * kDqRows;
          key_tiles<L>(p, q0, kDqRows, first, n_kt);
          if (n_kt == 0) continue;
          sm90::mbar_wait(bar_qe, (qk & 1) ^ 1);
          load_q(q0, head, batch);
          ++qk;
          for (int i = 0; i < n_kt; ++i, ++it) {
            const int st = it % kStages;
            sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
            load_kv(st, (first + i) * L, head, batch);
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters, stage by stage
      int n = 0;  // this CTA's key tiles
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, first, n_kt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_mb, p.h, true, m_block, head, batch))
            continue;
          key_tiles<L>(p, m_block * kDqRows, kDqRows, first, n_kt);
          n += n_kt;
        }
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % kStages;
        uint8_t* sp = smem + S::kRing + st * S::kStage;
        sm90::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        convert_stage<D, L, false>(sp, sp + 4 * S::kT, S::kT, threadIdx.x - 32);
        sm90::fence_proxy_async();
        sm90::mbar_arrive(bar_ready + 8 * st);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    sm90::setmaxnreg_inc<kConsumerRegs<MASKED>>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, qk = 0;
    float dq[D / 2];
    float lse2[2], delta[2];
    // BIAS: the tile's bias in S's layout, its lines prefetched before the
    // products (`fetch`), loaded after them (common.cuh load_bias_rows); the
    // masked consumers (216 registers) issue 4 k-steps a wait at d 64 (with
    // 8 they spilled 140 bytes: ptxas hoists the bias loads into the
    // products) and at d 128 do not prefetch, as the forward's
    float bv[BIAS ? L / 2 : 1];
    constexpr int kDqChunk = MASKED && BIAS && D == 64 ? 4 : kChunk<D>;
    auto fetch = [&](int batch, int head, int row0, int n0) {
      if constexpr (BIAS && !(MASKED && D == 128))
        prefetch_bias<16, L>(p.bias, batch * p.bias.sb + head * p.bias.sh, row0 - g, n0, p.sq,
                             p.sk, lane);
    };
    auto load_bias = [&](int batch, int head, int row0, int n0) {
      if constexpr (BIAS)
        xfa::load_bias_rows<L>(bv, p.bias, batch * p.bias.sb + head * p.bias.sh, row0, n0, p.sq,
                               p.sk, t);
    };
    // this thread's rows' LSE times log2(e) and delta (+inf and 0 past sq)
    auto row_stats = [&](int batch, int head, int row0) {
      const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse2[r] = row < p.sq ? p.lse[stat + row] * sm90::kLog2e : INFINITY;
        delta[r] = row < p.sq ? p.delta[stat + row] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
    };
    // The key tile of stage st: S = q_s K^T, dP = dO V^T, then dS (`ds(s,
    // dp)`), then dQ += dS K, added in fp32
    auto tile = [&](int st, auto ds) {
      const uint32_t stage = base + S::kRing + st * S::kStage;
      float s[L / 2], dp[L / 2];
#pragma unroll
      for (int j = 0; j < L / 2; ++j) s[j] = dp[j] = 0.f;
      product_a_smem<D, L, kDqChunk>(s, smem, kDqRows, 64 * cw, stage, stage + S::kT, w, g, t);
      product_a_smem<D, L, kDqChunk>(dp, smem + S::kQ, kDqRows, 64 * cw, stage + 4 * S::kT,
                                     stage + 5 * S::kT, w, g, t);
      ds(s, dp);
      float pq[D / 2];
      issue_a_acc<D, L>(pq, dp, stage + 2 * S::kT, stage + 3 * S::kT);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      add_part(dq, pq);
    };
    auto store = [&](int batch, int head, int row0) {
      store_acc<D>(p.dq + batch * p.dq_sb + head * p.dq_sh, p.dq_ss, dq, row0, p.sq, p.sm_scale,
                   t);
    };
    if constexpr (MASKED) {
      const xfa::MaskParams& mk = p.mask;
      for (;;) {
        sm90::mbar_wait(bar_q, qk & 1);
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kWords + 16 * kStages);
        const int m_block = __shfl_sync(0xffffffffu, blk.x, 0);
        if (m_block == kEnd) break;
        ++qk;
        const int head = __shfl_sync(0xffffffffu, blk.y, 0);
        const int batch = __shfl_sync(0xffffffffu, blk.z, 0);
        const int row0 = m_block * kDqRows + 64 * cw + 16 * w + g;  // rows row0, row0 + 8
        row_stats(batch, head, row0);
        const int4* bands =
            p.bands == nullptr
                ? nullptr
                : p.bands + static_cast<int64_t>(batch * mk.fm_heads +
                                                 xfa::fm_head(mk, head, p.h)) * mk.fm_skp;
        const int4* kinfo =
            mk.k_info == nullptr ? nullptr : mk.k_info + static_cast<int64_t>(batch) * mk.k_pad;
        const int4* qinfo =
            mk.q_info == nullptr ? nullptr : mk.q_info + static_cast<int64_t>(batch) * mk.q_pad;
        for (;;) {
          const int st = it % kStages, use = it / kStages;
          sm90::mbar_wait(bar_full + 8 * st, use & 1);
          sm90::mbar_wait(bar_ready + 8 * st, use & 1);
          const int4 wd = *reinterpret_cast<const int4*>(smem + S::kWords + 16 * st);
          const int n0 = __shfl_sync(0xffffffffu, wd.x, 0);
          const int f = __shfl_sync(0xffffffffu, wd.y, 0);
          if (n0 != kEnd && ((f >> (kOnShift + 2 * cw)) & 3) != 0) {
            const uint32_t vis =
                f & kElem ? rows_visible_by<L>(f, mk, p.sq, p.sk, n0, row0, bands, kinfo, qinfo, t)
                          : 0u;
            if constexpr (BIAS) {
              fetch(batch, head, row0, n0);
              tile(st, [&](float (&s)[L / 2], float (&dp)[L / 2]) {
                load_bias(batch, head, row0, n0);
                if (f & kElem) {
                  dq_ds<L, true, SOFTCAP, true>(
                      s, dp, lse2, delta, p.softcap,
                      [&](int i) { return ((vis >> i) & 1u) != 0; }, bv);
                } else {
                  dq_ds<L, false, SOFTCAP, true>(s, dp, lse2, delta, p.softcap, AllVisible{},
                                                 bv);
                }
              });
            } else {  // the lambdas capture only what the kernel without a bias did
              tile(st, [&](float (&s)[L / 2], float (&dp)[L / 2]) {
                if (f & kElem) {
                  dq_ds<L, true, SOFTCAP>(s, dp, lse2, delta, p.softcap,
                                          [&](int i) { return ((vis >> i) & 1u) != 0; });
                } else {
                  dq_ds<L, false, SOFTCAP>(s, dp, lse2, delta, p.softcap);
                }
              });
            }
          }
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);
          ++it;
          if (n0 == kEnd) break;
        }
        if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s and dO
        store(batch, head, row0);
      }
    } else {
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, first, n_kt;
          if (!bwd_pair_block<BIAS>(p, pair, half, n_mb, p.h, true, m_block, head, batch))
            continue;
          const int q0 = m_block * kDqRows;
          key_tiles<L>(p, q0, kDqRows, first, n_kt);
          const int r0 = q0 + 64 * cw;       // this consumer's first row
          const int row0 = r0 + 16 * w + g;  // this thread's rows: row0, row0 + 8
          row_stats(batch, head, row0);
          if (n_kt == 0) {
            store(batch, head, row0);
            continue;
          }
          int lo[2], hi[2];  // the keys each row sees
          row_keys(p, row0, lo[0], hi[0]);
          row_keys(p, row0 + 8, lo[1], hi[1]);
          sm90::mbar_wait(bar_q, qk & 1);
          ++qk;
          for (int i = 0; i < n_kt; ++i, ++it) {
            const int st = it % kStages, use = it / kStages;
            const int n0 = (first + i) * L;
            sm90::mbar_wait(bar_full + 8 * st, use & 1);
            sm90::mbar_wait(bar_ready + 8 * st, use & 1);
            const bool whole = all_visible(p, r0, 64, n0, L);
            fetch(batch, head, row0, n0);
            tile(st, [&](float (&s)[L / 2], float (&dp)[L / 2]) {
              load_bias(batch, head, row0, n0);
              if (whole) {
                dq_ds<L, false, SOFTCAP, BIAS>(s, dp, lse2, delta, p.softcap, AllVisible{}, bv);
              } else {
                dq_ds<L, true, SOFTCAP, BIAS>(
                    s, dp, lse2, delta, p.softcap,
                    [&](int i) {
                      const int key = n0 + (i >> 2) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
                      return (key >= lo[r]) & (key <= hi[r]);
                    },
                    bv);
              }
            });
            if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);
          }
          if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s and dO
          store(batch, head, row0);
        }
      }
    }
  }
}

// ---- dbias
//
// The bias gradient in fp32 (flash_bwd_dbias_fp32_kernel; bf16 q/k/v run
// flash_bwd_dbias.cu): dbias = P (dP - delta), the scores' gradient before
// the softcap derivative (the bias enters after softcap), summed over the
// (batch, head) pairs that share each element of a (bb, bh, sq, sk) bias,
// for fp32 q_s/k/v/dO and an fp32 or bf16 bias (dbias in its dtype). It
// replaces the dbias output of TPU kernel #2 (bwd.py:180 `_bwd_dkv_kernel`
// with has_bias: bwd.py:173, 411-481, 757-800, 1302-1312) by
// flash_bwd_dbias.cu's rules: every element summed by one thread over its
// pairs in a fixed order (batch, then head), in registers, and written once
// (no atomics, no (b, h, sq, sk) workspace: a second pass gives the same
// bits); units that the row/key window masks whole are skipped and keep
// the wrapper's zeros.
//
// A unit is a bias tile of 128 query rows x 64 keys, consumer c owning rows
// [64c, 64c + 64), its sums 32 registers a thread. For each pair that
// shares it, S = q_s K^T and dP = dO V^T, each as three TF32 products
// (product_a_smem: q_s and dO the A operands, read raw from shared memory
// and split in registers; K and V the B operands, their lo parts from the
// converters), as the dQ kernel forms them. bf16's stage plan (a stage of
// a pair's q_s, dO, K and V) would be one stage of 192 KB at d 128 with K's
// and V's lo parts, so the ring takes the head dim in boxes of 32 columns:
// a stage is one box of q_s (or dO) over the unit's 128 rows (16 KB) with
// the same box of K (or V) over its 64 keys and its lo (8 KB each), 32 KB,
// six stages. A pair runs D / 32 stages of (q_s, K) into S, then P in place
// (softcap, the bias, the elementwise test, exp2 against the LSE), then D /
// 32 stages of (dO, V) into dP, then acc += P (dP - delta). The hi·hi terms
// of a product sum on the tensor cores over the boxes, its small terms in
// fp32 registers a box at a time (product_a_smem), as the forward's S. The
// unit's bias is read once from global memory into shared memory, each
// thread's own 32 values (32 KB): in registers beside S, dP and the sums it
// left the products too few. Bound: the two products of every pair, 6 TF32
// products a pair element, and each pair's q_s, dO, K and V tiles (two 128 x
// 64 x D products for 384 x D x 4 bytes from L2, as bf16's for half the
// bytes).

constexpr int kDbRows = 128, kDbKeys = 64, kDbStages = 6;
constexpr int kDbChunk = 4;  // k-steps issued before a wait: one box

struct DbSmem {
  static constexpr int kA = kDbRows * 128;          // a box of q_s or dO (landed raw)
  static constexpr int kB = kDbKeys * 128;          // a box of K or V (landed raw: its hi)
  static constexpr int kStage = kA + 2 * kB;        // A, B, B lo
  static constexpr int kBias = kDbStages * kStage;  // the unit's bias: [32][256] floats
  static constexpr int kBar = kBias + (kDbKeys / 2) * 256 * 4;
  // barriers: per stage full, ready, empty
  static constexpr int kBytes = kBar + 8 * 3 * kDbStages + 1024;  // + alignment slack
  static_assert(kStage % 1024 == 0 && kA % 1024 == 0 && kB % 1024 == 0,
                "128-byte swizzled tiles start 1024-byte aligned");
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct DbFp32Params {
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  xfa::BiasParams bias;
  void* dbias;  // (bb, bh, sq, sk) in the bias's dtype, by the strides below
  int64_t db_sb, db_sh, db_ss;
  int b, h, hk, sq, sk, bb, bh;
  float softcap;
  int causal;
  xfa::MaskParams mask;  // MASKED: the row/key window, segment ids and positions
};

// Unit u: (bias batch bi, bias head hi, query block at q0, key tile at n0),
// key tile fastest; false when the row/key window masks every pair of it.
template <bool MASKED>
__device__ __forceinline__ bool db_unit(const DbFp32Params& p, int u, int n_mb, int n_nt, int& bi,
                                        int& hi, int& q0, int& n0) {
  n0 = (u % n_nt) * kDbKeys;
  u /= n_nt;
  q0 = (u % n_mb) * kDbRows;
  u /= n_mb;
  hi = u % p.bh;
  bi = u / p.bh;
  const int left = MASKED ? p.mask.left : -1;
  const int right = MASKED ? p.mask.right : (p.causal ? 0 : -1);
  const int off = p.sk - p.sq, q1 = min(q0 + kDbRows, p.sq) - 1, n1 = min(n0 + kDbKeys, p.sk) - 1;
  return !(right >= 0 && n0 > q1 + off + right) && !(left >= 0 && n1 < q0 + off - left);
}

// The (batch, head) of member mi of a unit: every batch for a
// batch-broadcast bias (else bi), every head for a head-broadcast one (else
// hi), batch first.
__device__ __forceinline__ void db_member(const DbFp32Params& p, int mi, int bi, int hi,
                                          int& batch, int& head) {
  const int heads = p.bh == 1 ? p.h : 1;
  batch = p.bb == 1 ? mi / heads : bi;
  head = p.bh == 1 ? mi % heads : hi;
}

template <int D, bool SOFTCAP, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dbias_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tdo,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const DbFp32Params p) {
  using S = DbSmem;
  constexpr int kBoxes = D / 32, kStages = kDbStages, N = kDbKeys;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_full = base + S::kBar, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_mb = (p.sq + kDbRows - 1) / kDbRows, n_nt = (p.sk + N - 1) / N;
  const int n_units = p.bb * p.bh * n_mb * n_nt;
  const int members = (p.bb == 1 ? p.b : 1) * (p.bh == 1 ? p.h : 1);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_ready + 8 * st, kConverters);
      sm90::mbar_init(bar_empty + 8 * st, 8);  // the eight consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Every role walks the same units, members and boxes and counts the same
  // stages (it), so stages and parities agree: per member, kBoxes stages of
  // (q_s, K), then kBoxes of (dO, V).
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs<false>>();
    if (threadIdx.x == 0) {  // the loads
      int it = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int bi, hi, q0, n0;
        if (!db_unit<MASKED>(p, u, n_mb, n_nt, bi, hi, q0, n0)) continue;
        for (int mi = 0; mi < members; ++mi) {
          int batch, head;
          db_member(p, mi, bi, hi, batch, head);
          for (int c = 0; c < 2 * kBoxes; ++c, ++it) {
            const int st = it % kStages, box = c % kBoxes;
            const bool second = c >= kBoxes;  // dO and V
            const uint32_t stage = base + st * S::kStage;
            // the first pass is free
            sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(bar_full + 8 * st, S::kA + S::kB);
            sm90::tma_load_4d(stage, second ? &tdo : &tq, bar_full + 8 * st, 32 * box, q0, head,
                              batch);
            sm90::tma_load_4d(stage + S::kA, second ? &tv : &tk, bar_full + 8 * st, 32 * box, n0,
                              head / group, batch);
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters: the lo of each stage's B
      int n = 0;                     // this CTA's stages
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int bi, hi, q0, n0;
        if (db_unit<MASKED>(p, u, n_mb, n_nt, bi, hi, q0, n0)) n += members * 2 * kBoxes;
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % kStages;
        uint8_t* sp = smem + st * S::kStage + S::kA;
        sm90::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        for (int j = threadIdx.x - 32; j < N * 32 / 16; j += kConverters)
          convert_item<32, N, false>(sp, sp + S::kB, nullptr, nullptr, j);
        sm90::fence_proxy_async();  // the writes before the consumers' wgmma
        sm90::mbar_arrive(bar_ready + 8 * st);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    sm90::setmaxnreg_inc<kConsumerRegs<false>>();
    const int cw = warpgroup - 1;
    const int ct = threadIdx.x - 128;
    const int w = (ct & 127) >> 5, lane = ct & 31, g = lane >> 2, t = lane & 3;
    const xfa::MaskParams& m = p.mask;
    const bool info = MASKED && m.q_info != nullptr;
    float* bias_slots = reinterpret_cast<float*>(smem + S::kBias) + ct;  // [i][256]
    int it = 0;
    // C += A B over the head dim, a stage a box (A the unit's rows, B the
    // tile's keys; `second`: dO and V), each stage released after its wait
    auto product = [&](float (&c)[N / 2]) {
      for (int box = 0; box < kBoxes; ++box, ++it) {
        const int st = it % kStages, use = it / kStages;
        const uint32_t stage = base + st * S::kStage;
        sm90::mbar_wait(bar_full + 8 * st, use & 1);
        sm90::mbar_wait(bar_ready + 8 * st, use & 1);
        product_a_smem<32, N, kDbChunk>(c, smem + st * S::kStage, kDbRows, 64 * cw,
                                        stage + S::kA, stage + S::kA + S::kB, w, g, t);
        if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
      }
    };
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      int bi, hi, q0, n0;
      if (!db_unit<MASKED>(p, u, n_mb, n_nt, bi, hi, q0, n0)) continue;
      const int row0 = q0 + 64 * cw + 16 * w + g;  // this thread's rows: row0, row0 + 8
      {
        float bv[N / 2];
        xfa::load_bias_rows<N>(bv, p.bias, bi * p.bias.sb + hi * p.bias.sh, row0, n0, p.sq, p.sk,
                               t);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) bias_slots[i * 256] = bv[i];
      }
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
      for (int mi = 0; mi < members; ++mi) {
        int batch, head;
        db_member(p, mi, bi, hi, batch, head);
        float s[N / 2], dp[N / 2];
#pragma unroll
        for (int i = 0; i < N / 2; ++i) s[i] = dp[i] = 0.f;
        product(s);  // S = q_s K^T
        // P in place: softcap, the bias, the elementwise test (causal and
        // sk; MASKED: each row's window [lo, hi] and, with segment ids or
        // positions, the tokens), exp2 against the row's LSE (+inf past sq)
        const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
        float lse2[2], delta[2];
        int lo[2] = {0, 0}, hi_[2] = {0, 0};
        int4 qt[2] = {};
        const int4* kinfo = info ? m.k_info + static_cast<int64_t>(batch) * m.k_pad : nullptr;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          lse2[r] = row < p.sq ? p.lse[stat + row] * sm90::kLog2e : INFINITY;
          delta[r] = row < p.sq ? p.delta[stat + row] : 0.f;
          if constexpr (MASKED) xfa::row_limit(m, row, p.sq, p.sk, lo[r], hi_[r]);
          if (info)
            qt[r] = xfa::query_tokens(
                m, row < p.sq ? token_ldg(m.q_info + static_cast<int64_t>(batch) * m.q_pad, row)
                              : make_int2(INT_MIN, 0));
        }
#pragma unroll
        for (int i = 0; i < N / 2; ++i) {
          const int r = (i >> 1) & 1, col = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
          bool visible;
          if constexpr (MASKED) {
            visible = (col >= lo[r]) & (col <= hi_[r]);
            if (info) {
              const int2 kt = col < p.sk ? token_ldg(kinfo, col) : make_int2(INT_MIN, 0);
              visible = visible & xfa::tokens_meet(qt[r], kt);
            }
          } else {
            visible = (col < p.sk) & (!p.causal | (col <= row0 + 8 * r + p.sk - p.sq));
          }
          float x = s[i];
          if constexpr (SOFTCAP) x = tanhf(x / p.softcap) * p.softcap;
          x += bias_slots[i * 256];
          s[i] = visible ? sm90::ex2(fmaf(x, sm90::kLog2e, -lse2[r])) : 0.f;
        }
        product(dp);  // dP = dO V^T
#pragma unroll
        for (int i = 0; i < N / 2; ++i) acc[i] += s[i] * (dp[i] - delta[(i >> 1) & 1]);
      }
      // the unit's dbias, once, in the bias's dtype
      const int64_t out = bi * p.db_sb + hi * p.db_sh;
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r, col = n0 + 8 * j + 2 * t;
          if (row >= p.sq || col >= p.sk) continue;
          const int64_t off = out + row * p.db_ss + col;
          const float x = acc[4 * j + 2 * r], y = acc[4 * j + 2 * r + 1];
          if (p.bias.dtype == xfa::kBF16) {
            *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.dbias) + off) =
                xfa::pack_bf16(x, y);
          } else {
            *reinterpret_cast<float2*>(static_cast<float*>(p.dbias) + off) = make_float2(x, y);
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------ reduced scores
//
// #12 in fp32 (reduced_scores_fp32_kernel): reduced[b, h, j] = sum_i
// 2^(S^T[j, i] sm_scale log2(e) - lse_i log2(e)) with S^T = K q^T on three
// TF32 products (q not pre-scaled: the TPU kernel scales the fp32 product),
// the causal superset, GQA; the dK/dV kernel's S^T pipeline alone.
// Persistent CTAs over equal-work pairs of 128-key blocks of one (batch,
// kv head) (common.cuh pair_block, heavy first), consumer c owning keys
// [64c, 64c + 64): K arrives raw by TMA into one resident buffer, the A
// operand split in registers; a ring of 4 stages of 32 query rows of one
// head (q raw: its B hi, and its LSE box by 1-D TMA), streaming every head
// of the group in a fixed order, the converters writing q lo beside q; per
// tile S^T (product_a_smem), P by ex2 with sm_scale log2(e) and LSE
// log2(e) folded into one FMA, each key's sums in registers; a head's sums
// over the quad in a fixed order at the end of its tiles. No atomics: the
// result is bitwise equal from launch to launch. The diagonal and ragged
// query tiles (common.cuh query_tiles) come first and take the elementwise
// test. Bound: the larger of three TF32 products of 2d a visible pair at
// 495 TFLOP/s and one exponent a pair on the SFU.

constexpr int kRedKeys = 128, kRedRows = 32, kRedStages = 4;

template <int D>
struct RedSmem {
  static constexpr int kK = kRedKeys * D * 4;  // K of a block
  static constexpr int kT = kRedRows * D * 4;  // q of a stage, then its lo
  static constexpr int kStatBox = kRedRows + 4;
  static constexpr int kStats = 2 * kT;  // the stage's LSE box
  static constexpr int kStage = 2 * kT + 1024;
  // barriers: K full, K empty, then per stage full, ready, empty
  static constexpr int kBar = kK + kRedStages * kStage;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kRedStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct RedParams {
  float* out;  // (b, h, sk) contiguous
  int b, h, hk, sq, sk;
  float scale2;  // sm_scale * log2(e)
  int causal;
};

// One tile's exponents added to this thread's two key sums: s = S^T (keys
// key0, key0 + 8 as rows, the tile's rows m0 + c as columns), the LSE per
// column from the stage; with MASK the elementwise causal / sq test.
template <bool MASK>
__device__ __forceinline__ void red_add(const float (&s)[kRedRows / 2], const float* lse, int key0,
                                        int m0, const RedParams& p, int t, float (&acc)[2]) {
#pragma unroll
  for (int i = 0; i < kRedRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);
    float x = sm90::ex2(fmaf(s[i], p.scale2, -lse[c] * sm90::kLog2e));
    if (MASK) {
      const int key = key0 + ((i >> 1) & 1) * 8, row = m0 + c;
      x = (row < p.sq) & ((p.causal == 0) | (key <= row + p.sk - p.sq)) ? x : 0.f;
    }
    acc[(i >> 1) & 1] += x;
  }
}

// This thread's key sums over the quad (a fixed order), written by its
// first thread for keys below sk; acc cleared for the next head.
__device__ __forceinline__ void red_store(float* out, float (&acc)[2], int key0, int sk, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 1);
    acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 2);
    if (t == 0 && key0 + 8 * r < sk) out[key0 + 8 * r] = acc[r];
    acc[r] = 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    reduced_scores_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tlse, const RedParams p) {
  using S = RedSmem<D>;
  constexpr int R = kRedRows, kStages = kRedStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_k = base + S::kBar, bar_ke = bar_k + 8;
  const uint32_t bar_full = bar_ke + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_nb = (p.sk + kRedKeys - 1) / kRedKeys;
  const int n_pairs = xfa::block_pairs(n_nb, p.hk, p.b);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    sm90::mbar_init(bar_k, 1);
    sm90::mbar_init(bar_ke, 8);  // the eight consumer warps
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_full + 8 * st, 1);
      sm90::mbar_init(bar_ready + 8 * st, kConverters);
      sm90::mbar_init(bar_empty + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Every role walks the same blocks and counts the same K loads (kv) and
  // query tiles (it), so stages and parities agree; a block whose keys no
  // row sees loads nothing, its sums are zeros.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs<false>>();
    if (threadIdx.x == 0) {  // the loads
      int it = 0, kv = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
          const int n0 = n_block * kRedKeys;
          const xfa::QueryTilePlan pl = xfa::query_tiles<R, kRedKeys>(n0, p.sq, p.sk, p.causal);
          if (pl.n_tiles() == 0) continue;
          sm90::mbar_wait(bar_ke, (kv & 1) ^ 1);  // the first pass is free
          sm90::mbar_expect_tx(bar_k, S::kK);
          for (int j = 0; j < D / 32; ++j)
            sm90::tma_load_4d(base + j * kRedKeys * 128, &tk, bar_k, 32 * j, n0, kv_head, batch);
          ++kv;
          for (int gi = 0; gi < group; ++gi) {
            const int head = kv_head * group + gi;
            const int stat0 = (batch * p.h + head) * p.sq;
            for (int i = 0; i < pl.n_tiles(); ++i, ++it) {
              const int st = it % kStages, m0 = pl.tile(i) * R;
              const uint32_t stage = base + S::kK + st * S::kStage;
              sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
              sm90::mbar_expect_tx(bar_full + 8 * st, S::kT + S::kStatBox * 4);
              for (int j = 0; j < D / 32; ++j)
                sm90::tma_load_4d(stage + j * R * 128, &tq, bar_full + 8 * st, 32 * j, m0, head,
                                  batch);
              sm90::tma_load_1d(stage + S::kStats, &tlse, bar_full + 8 * st, (stat0 + m0) & ~3);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters: q lo beside q
      int n = 0;  // this CTA's query tiles
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
          n += group *
               xfa::query_tiles<R, kRedKeys>(n_block * kRedKeys, p.sq, p.sk, p.causal).n_tiles();
        }
      }
      for (int it = 0; it < n; ++it) {
        const int st = it % kStages;
        uint8_t* sp = smem + S::kK + st * S::kStage;
        sm90::mbar_wait(bar_full + 8 * st, (it / kStages) & 1);
        for (int j = threadIdx.x - 32; j < R * D / 16; j += kConverters)
          convert_item<D, R, false>(sp, sp + S::kT, nullptr, nullptr, j);
        sm90::fence_proxy_async();  // the writes before the consumers' wgmma
        sm90::mbar_arrive(bar_ready + 8 * st);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    sm90::setmaxnreg_inc<kConsumerRegs<false>>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, kv = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int n_block, kv_head, batch;
        if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
        const int n0 = n_block * kRedKeys;
        const xfa::QueryTilePlan pl = xfa::query_tiles<R, kRedKeys>(n0, p.sq, p.sk, p.causal);
        const int n_tiles = pl.n_tiles(), n_masked = pl.n_masked();
        const int key0 = n0 + 64 * cw + 16 * w + g;  // this thread's keys: key0, key0 + 8
        float* out = p.out + static_cast<int64_t>(batch * p.h + kv_head * group) * p.sk;
        float acc[2] = {0.f, 0.f};
        if (n_tiles == 0) {  // no row sees these keys
          for (int gi = 0; gi < group; ++gi) red_store(out + gi * p.sk, acc, key0, p.sk, t);
          continue;
        }
        sm90::mbar_wait(bar_k, kv & 1);
        for (int gi = 0; gi < group; ++gi) {
          const int stat0 = (batch * p.h + kv_head * group + gi) * p.sq;
          for (int i = 0; i < n_tiles; ++i, ++it) {
            const int st = it % kStages, use = it / kStages, m0 = pl.tile(i) * R;
            const uint32_t stage = base + S::kK + st * S::kStage;
            sm90::mbar_wait(bar_full + 8 * st, use & 1);  // the LSE
            sm90::mbar_wait(bar_ready + 8 * st, use & 1);
            float s[R / 2];
#pragma unroll
            for (int j = 0; j < R / 2; ++j) s[j] = 0.f;
            product_a_smem<D, R>(s, smem, kRedKeys, 64 * cw, stage, stage + S::kT, w, g, t);
            const float* lse = reinterpret_cast<const float*>(smem + S::kK + st * S::kStage +
                                                              S::kStats) + ((stat0 + m0) & 3);
            if (i < n_masked) {
              red_add<true>(s, lse, key0, m0, p, t, acc);
            } else {
              red_add<false>(s, lse, key0, m0, p, t, acc);
            }
            if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
          }
          red_store(out + gi * p.sk, acc, key0, p.sk, t);
        }
        if (lane == 0) sm90::mbar_arrive(bar_ke);  // after the block's last product
        ++kv;
      }
    }
  }
}

// ------------------------------------------------------------ launches

// One persistent CTA per SM, or one per work unit (a pair of blocks; a
// block under a masked kernel's dynamic scheduler) when there are fewer.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int bytes, std::atomic<uint64_t>& done, int units,
                            int& grid) {
  int sms = 0;
  cudaError_t err = sm90::smem_limit_once(kernel, bytes, done);
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  grid = units < sms ? units : sms;
  return err;
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
cudaError_t launch_dkv(const CUtensorMap* maps, const Fp32BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const int n_nb = (p.sk + BwdTiles<D>::kKeys - 1) / BwdTiles<D>::kKeys;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      flash_bwd_dkv_fp32_kernel<D, SOFTCAP, MASKED, BIAS>, DkvSmem<D, MASKED>::kBytes, done,
      MASKED ? n_nb * p.hk * p.b : xfa::block_pairs(n_nb, p.hk, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fp32_kernel<D, SOFTCAP, MASKED, BIAS>
      <<<grid, kThreads, DkvSmem<D, MASKED>::kBytes, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                          maps[4], maps[5], p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
cudaError_t launch_dq(const CUtensorMap* maps, const Fp32BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const int n_mb = (p.sq + kDqRows - 1) / kDqRows;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      flash_bwd_dq_fp32_kernel<D, SOFTCAP, MASKED, BIAS>, DqSmem<D, MASKED>::kBytes, done,
      MASKED ? n_mb * p.h * p.b : xfa::block_pairs(n_mb, p.h, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fp32_kernel<D, SOFTCAP, MASKED, BIAS>
      <<<grid, kThreads, DqSmem<D, MASKED>::kBytes, s>>>(maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D, bool MASKED, bool BIAS>
cudaError_t launch_bwd(int which, const CUtensorMap* maps, const Fp32BwdParams& p,
                       cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  if (which == 0)
    return cap ? launch_dkv<D, true, MASKED, BIAS>(maps, p, s)
               : launch_dkv<D, false, MASKED, BIAS>(maps, p, s);
  return cap ? launch_dq<D, true, MASKED, BIAS>(maps, p, s)
             : launch_dq<D, false, MASKED, BIAS>(maps, p, s);
}

template <int D, bool PAGED, bool SOFTCAP, bool MASKED, bool BIAS>
cudaError_t launch_fwd(const CUtensorMap* maps, const Fp32Params& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const int n_mb = (p.sq + kFwdRows - 1) / kFwdRows;
  int grid = 0;
  const cudaError_t err = persistent_grid(
      flash_fwd_fp32_kernel<D, PAGED, SOFTCAP, MASKED, BIAS>, FwdSmem<D, MASKED>::kBytes, done,
      MASKED ? n_mb * p.h * p.b : xfa::block_pairs(n_mb, p.h, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_fwd_fp32_kernel<D, PAGED, SOFTCAP, MASKED, BIAS>
      <<<grid, kThreads, FwdSmem<D, MASKED>::kBytes, s>>>(maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <int D, bool BIAS>
cudaError_t launch_fwd_b(const CUtensorMap* maps, const Fp32Params& p, bool masked,
                         cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  if (masked)
    return cap ? launch_fwd<D, false, true, true, BIAS>(maps, p, s)
               : launch_fwd<D, false, false, true, BIAS>(maps, p, s);
  return cap ? launch_fwd<D, false, true, false, BIAS>(maps, p, s)
             : launch_fwd<D, false, false, false, BIAS>(maps, p, s);
}

template <int D>
cudaError_t launch_fwd_d(const CUtensorMap* maps, const Fp32Params& p, bool paged, bool masked,
                         cudaStream_t s) {
  if (paged)
    return p.softcap > 0.f ? launch_fwd<D, true, true, false, false>(maps, p, s)
                           : launch_fwd<D, true, false, false, false>(maps, p, s);
  return p.bias.ptr != nullptr ? launch_fwd_b<D, true>(maps, p, masked, s)
                               : launch_fwd_b<D, false>(maps, p, masked, s);
}

template <int D, bool SOFTCAP, bool MASKED>
cudaError_t launch_dbias(const CUtensorMap* maps, const DbFp32Params& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const int units = p.bb * p.bh * ((p.sq + kDbRows - 1) / kDbRows) *
                    ((p.sk + kDbKeys - 1) / kDbKeys);
  int grid = 0;
  const cudaError_t err = persistent_grid(flash_bwd_dbias_fp32_kernel<D, SOFTCAP, MASKED>,
                                          DbSmem::kBytes, done, units, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dbias_fp32_kernel<D, SOFTCAP, MASKED><<<grid, kThreads, DbSmem::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dbias_cap(const CUtensorMap* maps, const DbFp32Params& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch_dbias<D, true, MASKED>(maps, p, s)
                         : launch_dbias<D, false, MASKED>(maps, p, s);
}

template <int D>
cudaError_t launch_reduced(const CUtensorMap* maps, const RedParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  int grid = 0;
  const cudaError_t err =
      persistent_grid(reduced_scores_fp32_kernel<D>, RedSmem<D>::kBytes, done,
                      xfa::block_pairs((p.sk + kRedKeys - 1) / kRedKeys, p.hk, p.b), grid);
  if (err != cudaSuccess) return err;
  reduced_scores_fp32_kernel<D><<<grid, kThreads, RedSmem<D>::kBytes, s>>>(maps[0], maps[1],
                                                                           maps[2], p);
  return cudaGetLastError();
}

// The masked instantiations run with a FlashMask, a block mask, segment ids
// or positions (a window alone runs the dense ones); they need the
// counters, and the bands with a FlashMask. Clears the counters on the
// stream.
cudaError_t masked_setup(const xfa::MaskParams& m, const void* fm_bands, void* counters,
                         cudaStream_t s, bool& masked) {
  masked = m.fm_vecs != nullptr || m.bm != nullptr || m.q_info != nullptr;
  if (!masked) return cudaSuccess;
  if (counters == nullptr || (m.fm_vecs != nullptr && fm_bands == nullptr))
    return cudaErrorInvalidValue;
  return cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);
}

}  // namespace

// q, out: (b, h, sq, d) fp32 by element strides (batch, head, seq); k, v:
// (b, hk, sk, d) by strides, or, with `table`, both the pages (num_pages,
// hk, 2, ps, d) fp32 contiguous (the strides unused, sk = npp * ps) with
// `table` (b, npp) int32 and `lengths` (b,) int32 (key count per batch row,
// its last sq keys the queries'); every row's head dim contiguous, every
// pointer and stride a multiple of 4 elements (16 bytes; q, k and v are
// read through TMA tensor maps). lse: (b, h, sq) fp32 contiguous or null.
// window: left, right (-1 no bound; causal is right 0). The mask
// arguments (XFA_MASK_ARGS, common.cuh) carry the FlashMask stats per key
// tile of the forward (64 keys at d 64, 32 at d 128), the segment /
// position stats per 128-row block and key tile and the tile range of each
// 128-row block; with a FlashMask, a block mask, segment ids or positions
// the masked instantiation runs (not paged): `fm_bands` (b, fm_heads,
// fm_skp, 4) int32 with a FlashMask, and `counters`, three int32 in device
// memory cleared here on the stream: the dynamic scheduler's next block,
// then the tiles visited and those with the elementwise test (fwd.py
// fwd_masked_tile_plan counts the same). The bias (XFA_BIAS_ARGS,
// common.cuh BiasParams: fp32 or bf16, (bb, bh, sq, sk) by strides), or a
// null pointer, selects the BIAS instantiation of the dense or masked
// route; it takes no page table, FlashMask or block mask.
XFA_EXPORT int xfa_flash_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                  int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                  int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                                  int64_t o_ss, int b, int h, int hk, int sq, int sk, int d,
                                  float sm_scale, float softcap, int left, int right,
                                  const void* table, const void* lengths, int ps, int npp,
                                  int num_pages, XFA_MASK_ARGS, const void* fm_bands,
                                  void* counters, XFA_BIAS_ARGS, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (table != nullptr) != (lengths != nullptr) ||
      (d != 64 && d != 128) ||
      (bias != nullptr && (table != nullptr || fm_vecs != nullptr || bm != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool paged = table != nullptr;
  const int keys = d == 64 ? kFwdKeys<64> : kFwdKeys<128>;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Fp32Params p{};
  p.mask = XFA_MASK_VALUES;
  bool masked = false;
  const cudaError_t err = masked_setup(p.mask, fm_bands, counters, s, masked);
  if (err != cudaSuccess || (masked && paged))
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidValue);
  p.bands = static_cast<const int4*>(fm_bands);
  p.next = static_cast<int*>(counters);
  p.pages = static_cast<const float*>(k);
  p.out = static_cast<float*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.b = b; p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.left = left;
  p.right = right;
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.ps = ps; p.npp = npp; p.num_pages = num_pages;
  p.tma = paged && ps % keys == 0;
  p.bias = XFA_BIAS_VALUES;
  // maps: q (blocks of 128 rows); k and v (tiles of `keys` rows), or the
  // pages (K and V of one page, kv head and tile a box) when paged by TMA
  CUtensorMap maps[3] = {};
  bool ok = sm90::encode_bhsd_f32(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kFwdRows);
  if (!paged) {
    const int s_k = sk > 0 ? sk : 1;  // no key: no tile is loaded
    ok = ok && sm90::encode_bhsd_f32(&maps[1], k, b, hk, s_k, d, k_sb, k_sh, k_ss, keys) &&
         sm90::encode_bhsd_f32(&maps[2], v, b, hk, s_k, d, v_sb, v_sh, v_ss, keys);
  } else if (p.tma) {
    ok = ok && sm90::encode_pages(&maps[1], k, num_pages, hk, ps, d, keys, true);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(d == 64 ? launch_fwd_d<64>(maps, p, paged, masked, s)
                                  : launch_fwd_d<128>(maps, p, paged, masked, s));
}

// which: 0 dK/dV, 1 dQ. q is q_s = q * sm_scale (flash_bwd.cu's pre-pass,
// fp32), (b, h, sq, d) like dout and dq; k, v, dk, dv (b, hk, sk, d); the
// 21 element strides (batch, head, seq) of q, k, v, dout, dq, dk, dv; every
// row's head dim contiguous, pointers and strides multiples of 4 elements
// (q_s, k, v and dout are read through TMA tensor maps). lse, delta: (b, h,
// sq) fp32 contiguous. Each launch overwrites its outputs (zero where no
// pair is visible). The mask arguments as xfa_flash_fwd_fp32's, at the
// kernel's tiles (dK/dV: query tiles of 32 rows and key blocks of 128 keys
// at d 64, 16 and 64 at d 128, the tile ranges per key block; dQ: 128-row
// blocks and key tiles of 32 keys at d 64, 16 at d 128; bwd.py
// bwd_masked_dkv_tile_plan / bwd_masked_dq_tile_plan count the tiles).
// The forward's bias (XFA_BIAS_ARGS), or a null pointer, selects the BIAS
// instantiation (no FlashMask or block mask with it); dbias is
// xfa_flash_bwd_dbias_fp32's.
XFA_EXPORT int xfa_flash_bwd_fp32(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                  int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                  int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                  int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss,
                                  int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb,
                                  int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                                  int64_t dv_ss, int b, int h, int hk, int sq, int sk, int d,
                                  float sm_scale, float softcap, int left, int right, int which,
                                  XFA_MASK_ARGS, const void* fm_bands, void* counters,
                                  XFA_BIAS_ARGS, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (d != 64 && d != 128) || (which != 0 && which != 1) ||
      (bias != nullptr && (fm_vecs != nullptr || bm != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const xfa::MaskParams mask = XFA_MASK_VALUES;
  bool masked = false;
  const cudaError_t err = masked_setup(mask, fm_bands, counters, s, masked);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Fp32BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta),
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, b, h, hk,
                        sq, sk, sm_scale, softcap, left, right, mask,
                        static_cast<const int4*>(fm_bands), static_cast<int*>(counters),
                        XFA_BIAS_VALUES};
  // boxes: dK/dV's query tiles and key blocks, or dQ's row blocks and key tiles
  const int q_rows = which == 1 ? kDqRows : d == 64 ? BwdTiles<64>::kRows : BwdTiles<128>::kRows;
  const int k_rows = which == 0 ? (d == 64 ? BwdTiles<64>::kKeys : BwdTiles<128>::kKeys)
                                : (d == 64 ? BwdTiles<64>::kDqKeys : BwdTiles<128>::kDqKeys);
  const int64_t stats = static_cast<int64_t>(b) * h * sq;
  CUtensorMap maps[6] = {};
  if (!sm90::encode_bhsd_f32(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, q_rows) ||
      !sm90::encode_bhsd_f32(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, q_rows) ||
      !sm90::encode_bhsd_f32(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, k_rows) ||
      !sm90::encode_bhsd_f32(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, k_rows) ||
      (which == 0 && (!sm90::encode_flat_f32(&maps[4], lse, stats, q_rows + 4) ||
                      !sm90::encode_flat_f32(&maps[5], delta, stats, q_rows + 4))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e;
  if (bias != nullptr) {
    if (masked)
      e = d == 64 ? launch_bwd<64, true, true>(which, maps, p, s)
                  : launch_bwd<128, true, true>(which, maps, p, s);
    else
      e = d == 64 ? launch_bwd<64, false, true>(which, maps, p, s)
                  : launch_bwd<128, false, true>(which, maps, p, s);
  } else if (masked) {
    e = d == 64 ? launch_bwd<64, true, false>(which, maps, p, s)
                : launch_bwd<128, true, false>(which, maps, p, s);
  } else {
    e = d == 64 ? launch_bwd<64, false, false>(which, maps, p, s)
                : launch_bwd<128, false, false>(which, maps, p, s);
  }
  return static_cast<int>(e);
}

// dbias for fp32 q/k/v (flash_bwd_dbias_fp32_kernel), the arguments as
// xfa_flash_bwd_dbias's (flash_bwd_dbias.cu): q is q_s (the pre-pass's
// fp32 q * sm_scale); q, k, v and dout (b, h|hk, s, d) fp32 views with
// element strides (batch, head, seq) and a contiguous head dim, read
// through TMA tensor maps (pointers and strides multiples of 4 elements);
// lse and delta (b, h, sq) fp32 contiguous. The bias (XFA_BIAS_ARGS) is
// (bb, bh, sq, sk), bb in {1, b}, bh in {1, h}, fp32 or bf16; dbias, of
// the bias's dtype, by its strides db_* (even, as the bias's), is written
// on every tile that the row/key window leaves a pair in and must be zero
// elsewhere. The mask arguments carry the row/key window, segment ids and
// positions (no FlashMask or block mask).
XFA_EXPORT int xfa_flash_bwd_dbias_fp32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dbias, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                        int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                        int64_t v_sh, int64_t v_ss, int64_t do_sb, int64_t do_sh,
                                        int64_t do_ss, int64_t db_sb, int64_t db_sh,
                                        int64_t db_ss, int b, int h, int hk, int sq, int sk, int d,
                                        int bb, int bh, float softcap, int causal, XFA_MASK_ARGS,
                                        XFA_BIAS_ARGS, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if ((d != 64 && d != 128) || hk <= 0 || h % hk != 0 || bias == nullptr || dbias == nullptr ||
      (bb != 1 && bb != b) || (bh != 1 && bh != h) || fm_vecs != nullptr || bm != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const xfa::MaskParams mask = XFA_MASK_VALUES;
  const bool masked = xfa::mask_active(mask);
  const DbFp32Params p{static_cast<const float*>(lse), static_cast<const float*>(delta),
                       XFA_BIAS_VALUES, dbias, db_sb, db_sh, db_ss, b, h, hk, sq, sk, bb, bh,
                       softcap, causal, mask};
  CUtensorMap maps[4] = {};
  if (!sm90::encode_bhsd_f32(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kDbRows) ||
      !sm90::encode_bhsd_f32(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kDbRows) ||
      !sm90::encode_bhsd_f32(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, kDbKeys) ||
      !sm90::encode_bhsd_f32(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, kDbKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = masked ? launch_dbias_cap<64, true>(maps, p, s) : launch_dbias_cap<64, false>(maps, p, s);
  else
    err = masked ? launch_dbias_cap<128, true>(maps, p, s)
                 : launch_dbias_cap<128, false>(maps, p, s);
  return static_cast<int>(err);
}

// #12 in fp32: q (b, h, sq, d) and k (b, hk, sk, d) fp32 with element
// strides for the (batch, head, seq) axes, head dim contiguous, pointers
// and strides multiples of 4 elements (the tensor maps' rule); lse (b, h,
// sq) and out (b, h, sk) fp32 contiguous. Every output element is written.
XFA_EXPORT int xfa_reduced_scores_fp32(const void* q, const void* k, const void* lse, void* out,
                                       int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                       int64_t k_sh, int64_t k_ss, int b, int h, int hk, int sq,
                                       int sk, int d, float sm_scale, int causal, void* stream) {
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq <= 0)  // no row: every sum is 0
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(b) * h * sk * sizeof(float), s));
  CUtensorMap maps[3] = {};
  if (!sm90::encode_bhsd_f32(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kRedRows) ||
      !sm90::encode_bhsd_f32(&maps[1], k, b, hk, sk, d, k_sb, k_sh, k_ss, kRedKeys) ||
      !sm90::encode_flat_f32(&maps[2], lse, static_cast<int64_t>(b) * h * sq, kRedRows + 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const RedParams p{static_cast<float*>(out), b, h, hk, sq, sk, sm_scale * sm90::kLog2e, causal};
  return static_cast<int>(d == 64 ? launch_reduced<64>(maps, p, s) : launch_reduced<128>(maps, p, s));
}
