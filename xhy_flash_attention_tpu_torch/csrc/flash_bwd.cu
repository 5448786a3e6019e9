// FlashAttention-2 backward for bf16 q/k/v/dO with fp32 accumulation, as
// the deterministic split pair of the TPU package.
//
// Replaces three TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/bwd.py:180
//     `_bwd_dkv_kernel` (dK, dV; kernel #2) -> flash_bwd_dkv_kernel;
//   * bwd.py:511 `_bwd_dq_kernel` (dQ; kernel #3) -> flash_bwd_dq_kernel;
//   * fused_heads.py:105 `_bwd_kernel` (the packed projection layout; #6):
//     the same two kernels, reached through element strides, so dq/dk/dv are
//     written straight into the column ranges of one packed dqkv.
// and the `dot_do_o` preprocess that the TPU package leaves to XLA (bwd.py:737)
// -> flash_bwd_prep_kernel. The FlashMask and block-mask flags of the TPU
// kernels (bwd.py:332-350, 582-600), the sliding window, segment ids and
// q/kv positions are a template flag of the same two kernels (MASKED).
//
// What they compute, as the TPU kernels do (bwd.py:106-177): q is scaled by
// sm_scale in fp32 and rounded to bf16 (q_s); S = q_s K^T in fp32, optional
// softcap t = tanh(S / c), S = t c; the causal mask is aligned to the bottom
// right (key j visible to query i when j <= i + sk - sq); P = exp(S - LSE)
// from the forward's LSE (+inf on rows with no key gives P = 0);
// dP = dO V^T; dS = P (dP - delta) (1 - t^2), delta = rowsum(dO * O) in
// fp32; P and dS are rounded to bf16 for the products
//   dV = P^T dO,  dK = dS^T q_s,  dQ = (dS K) sm_scale.
// GQA: dK/dV sum over the query heads of the group inside one block.
//
// Why two kernels. JAX's merged mode (bwd.py:9-23) carries dQ across a
// sequential KV grid axis in VMEM. A Hopper grid has no sequential axis:
// without fp32 atomics (which would make dQ depend on block order) a merged
// kernel needs an fp32 dQ partials workspace of b*h*(s/64)*s*d*4 bytes, 4.3
// GB at b16 h16 s2048 d64. The split pair recomputes S and dP once more (7
// products per tile instead of 5) and is bitwise deterministic: every output
// element is summed by one thread in a fixed order (the GQA group's heads
// in one fixed order inside the CTA that owns the keys).
//
// Bound on the H100: operations (b16 h16 s2048 d64 causal: 3.8e11 FLOPs in
// the pair against ~0.3 GB of traffic; a sparse mask keeps the products of
// the visible pairs), and on Hopper only wgmma reaches the tensor cores'
// rate. The design:
//
// * Pre-pass (flash_bwd_prep_kernel): delta = rowsum(dO * O) in fp32 (each
//   product rounded, summed in a fixed order) in one read of dO and O, and
//   q_s = bf16(q * sm_scale) once into a contiguous (b, h, sq, d) buffer
//   that both kernels read through TMA (the plain version's bits; no kernel
//   scales Q in shared memory). Its fp32 instantiation
//   (flash_bwd_prep_kernel<D, float>: delta and q_s = q * sm_scale in fp32)
//   serves flash_fp32.cu's fp32 backward.
//
// * The kernels, the forward's design (flash_fwd.cu) turned to the
//   backward: persistent CTAs, one per SM, of three warpgroups; warpgroup 0
//   the producer (setmaxnreg.dec; TMA through 4-D tensor maps (d, s, h, b)
//   built from the strides, 128-byte swizzled), warpgroups 1 and 2
//   consumers of 64 rows each (setmaxnreg.inc). Blocks are dealt in
//   equal-work pairs (common.cuh pair_block; bwd.py bwd_schedule mirrors).
//   - dK/dV (flash_bwd_dkv_kernel): a block is 128 keys of one (batch, kv
//     head), each consumer owning 64 (wgmma's M). K and V arrive once by TMA
//     into one of two buffers (the next block's load overlaps this block);
//     a ring of query tiles of 64 rows (q_s, dO, and their LSE and delta by
//     1-D TMA from an aligned start) streams every head of the group in a
//     fixed order and every query tile that sees the block's keys. Per
//     tile: S^T = K q_s^T and dP^T = V dO^T by SS wgmma (m64n64k16, both B
//     operands K-major); P and dS from the accumulators with each column's
//     LSE and delta read from shared memory; dV += P^T dO and dK += dS^T q_s
//     by RS wgmma, the bf16 A fragment converted in registers from the
//     accumulator, B read MN-major (the transpose bit). The tiles that need
//     the elementwise test (causal diagonal tiles, the ragged last tile)
//     come first, the interior ones run with no test (bwd.py
//     bwd_dkv_tile_plan).
//   - dQ (flash_bwd_dq_kernel): a block is 128 query rows of one (batch,
//     head) with q_s and dO resident (two buffers); K/V tiles (128 keys at
//     d 64, 64 at d 128) stream through a ring, last to first, the masked
//     ones first (common.cuh key_tiles; bwd.py bwd_dq_tile_plan). Per tile:
//     S = q_s K^T and dP = dO V^T by SS wgmma, P and dS in registers with
//     the row's LSE and delta, dQ += dS K by RS wgmma with K MN-major;
//     sm_scale in the epilogue.
//   Each consumer runs its tiles one by one (products, then the elementwise
//   work, then products); the two consumers interleave on the tensor cores.
//   Softcap and the elementwise mask are template flags, so that the
//   unrolled elementwise loops test nothing per element. The outputs leave
//   by plain stores from the accumulators, which take any strides (the
//   packed layout of #6 included).
//   Shared memory: dK/dV d 128: 2 x (K 32 + V 32) KB + 2 x (q_s 16 + dO 16
//   + stats 1) KB; d 64: 2 x (16 + 16) KB + 4 x (8 + 8 + 1) KB. dQ d 128:
//   2 x (q_s 32 + dO 32) KB + 2 x (K 16 + V 16 [+ bands 2]) KB; d 64:
//   2 x (16 + 16) KB + 4 x (K 16 + V 16 [+ bands 3]) KB.
//   Tried and dropped (PERF.md §6): a tile's P and dS under the previous
//   tile's RS products inside a consumer; the two consumers taking turns
//   (ping-pong) to issue; K/V (dK/dV) or q_s/dO (dQ) held as register A
//   fragments across tiles (the fragments read back wrong after the first
//   tile, and reloading them per tile reads as many shared-memory bytes as
//   SS).
//
// * The masked instantiations (MASKED: FlashMask, block masks, sliding
//   windows, segment ids and positions). Which
//   tiles a block visits depends on the data, so the producer decides and
//   the consumers follow (the candidate evaluation, the tile word, the
//   candidates of the row/key window cut to the block's tile range from the
//   segment and position stats (common.cuh key_window, query_window), the
//   per-tile decision of a 128-row block and the dynamic scheduler are
//   common.cuh's, shared with the masked forward in flash_fwd.cu): warp 0
//   of the producer warpgroup evaluates 32 candidate tiles at a time (a
//   lane each, from the FlashMask stats per kernel tile and the
//   block-mask entries, and the segment / position stats per kernel tile:
//   common.cuh token_flags), and its lane 0 loads each
//   visited tile with a word in the tile's ring stage: its first row (dK/dV)
//   or key (dQ), its head in the group and its flags (the elementwise test,
//   the FlashMask band test, and per consumer the 64-key or 64-row parts
//   that it computes; a consumer with no part passes the tile by). A word
//   kEnd ends a block; the block itself reaches the consumers in a slot of
//   its K/V (dK/dV) or q_s/dO (dQ) buffer, from a dynamic scheduler (the
//   next block from an atomicAdd on a counter that the entry clears on the
//   same stream; under the static pairs the two kernels took 4-20% longer
//   at FM-doc, BS and FM-swg, PERF.md §6). Each producer also adds the
//   tiles it emitted to two counters beside it. Within a head the tiles
//   that need the elementwise test come first (causal diagonal and ragged
//   tiles, FlashMask band tiles, dQ tiles whose keys straddle two
//   block-mask entries); the others run the unmasked code. The FlashMask
//   band test reads each column's bands [lo1, hi1) and [lo2, hi2) (every mode
//   rewritten to two bands by ops common.py fm_bands): dK/dV from global
//   memory for the thread's two keys, dQ from the stage, where they arrive
//   by TMA with the key tile. Mirrored by bwd.py bwd_masked_dkv_tile_plan
//   and bwd_masked_dq_tile_plan. A block-mask entry covers 64 or more rows
//   and keys, so each consumer's 64 keys (dK/dV) or 64 rows (dQ) lie in one
//   entry: a dK/dV tile never needs the block-mask test per element, and a
//   dQ tile of 128 keys does only when its two 64-key parts differ. In
//   causal_1 (a causal document mask) the stats skip every query tile at or
//   past the block's largest LTStart, the end of the last document its keys
//   belong to: the work a packed batch saves. With segment ids or positions
//   a tile that needs their test arrives with its queries' (dK/dV) or keys'
//   (dQ) (segment id, position) by a 2-D TMA box, the other side's with the
//   block's K/V (dK/dV) or q_s (dQ); the consumers make their keys' or
//   rows' limits per tile (common.cuh key_limit, row_limit): two compares
//   per element for the window, three for segments and positions.
//
// * Attention bias (BIAS, both kernels and instantiations; bwd.py:131-132 of
//   the TPU package): each consumer reads its fragment's bias from global
//   memory under the tile's products, as the forward does (common.cuh
//   load_bias_rows; dK/dV's transposed fragment load_bias_cols, an element a
//   load), and adds it after softcap to rebuild P; blocks are taken batch
//   first for a bias shared by the batches (common.cuh pair_block_by). dS
//   stays the softcap-scaled gradient of the products; dbias, the gradient
//   before the softcap derivative summed over the bias's broadcast axes, is
//   flash_bwd_dbias.cu's.
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

// ------------------------------------------------------------- pre-pass

template <typename T>
struct PrepParams {
  const T* q;
  const T* dout;
  const T* out;
  T* qs;         // (b, h, sq, d) contiguous, or null
  float* delta;  // (b, h, sq) contiguous
  int64_t q_sb, q_sh, q_ss, do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  int64_t rows;  // b * h * sq
  int h, sq;
  float sm_scale;
};

constexpr int kPrepThreads = 256;

// 16 bytes of each tensor a thread (8 bf16 or 4 fp32 values), D / 8 or D / 4
// threads per (batch, head, row). T is bf16, or fp32 for flash_fp32.cu's
// backward (q_s = q * sm_scale then stays fp32).
template <int D, typename T>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(const PrepParams<T> p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kLanes = kF32 ? D / 4 : D / 8;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (kPrepThreads / kLanes) + threadIdx.x / kLanes;
  const int c = (threadIdx.x % kLanes) * (kF32 ? 4 : 8);
  float acc = 0.f;
  if (r < p.rows) {
    const int64_t bh = r / p.sq;
    const int64_t row = r - bh * p.sq;
    const int64_t batch = bh / p.h, head = bh - batch * p.h;
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + batch * p.do_sb + head * p.do_sh +
                                                     row * p.do_ss + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(p.out + batch * p.o_sb + head * p.o_sh +
                                                     row * p.o_ss + c);
    if constexpr (kF32) {
      const float* d4 = reinterpret_cast<const float*>(&dv);
      const float* o4 = reinterpret_cast<const float*>(&ov);
#pragma unroll
      for (int j = 0; j < 4; ++j) acc += __fmul_rn(d4[j], o4[j]);
    } else {
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 a = __bfloat1622float2(d2[j]), b = __bfloat1622float2(o2[j]);
        acc += __fmul_rn(a.x, b.x);
        acc += __fmul_rn(a.y, b.y);
      }
    }
    if (p.qs != nullptr) {
      uint4 qv = *reinterpret_cast<const uint4*>(p.q + batch * p.q_sb + head * p.q_sh +
                                                 row * p.q_ss + c);
      uint32_t* w = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kF32) {
          w[j] = __float_as_uint(__fmul_rn(__uint_as_float(w[j]), p.sm_scale));
        } else {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
          w[j] = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
        }
      }
      *reinterpret_cast<uint4*>(p.qs + r * D + c) = qv;
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (r < p.rows && threadIdx.x % kLanes == 0) p.delta[r] = acc;
}


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

template <int D, bool MASKED = false>
struct DkvSmem {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) tiles of a row
  // K or V of a block: [half][128 keys][128 B]; buffer kb holds K at
  // kK + 2 kb kKV and V after it
  static constexpr int kKV = kDkvKeys * D * 2;
  static constexpr int kK = 0;
  // a stage of the query ring: q_s and dO [half][64 rows][128 B], then the
  // tile's LSE and delta boxes (kStatBox floats each, kStatStride apart);
  // the masked instantiations' tile word after the LSE box, and the tile's
  // queries' (segment, position) info after the delta box
  static constexpr int kTile = kDkvRows * D * 2;
  static constexpr int kStatStride = 512;
  static constexpr int kWord = 2 * kTile + kStatBox * 4;
  static constexpr int kQInfo = 2 * kTile + 2 * kStatStride;
  static constexpr int kQInfoBytes = kDkvRows * 16;
  static constexpr int kStage = kQInfo + (MASKED ? 1024 : 0);
  static constexpr int kRing = kK + 4 * kKV;
  // masked: each K/V buffer's keys' (segment, position) info; barriers:
  // K/V full[2], K/V empty[2], tile full[], tile empty[]; then the block of
  // each K/V buffer (masked)
  static constexpr int kKInfo = kRing + kStages * kStage;
  static constexpr int kBar = kKInfo + (MASKED ? 2 * kBlockInfoBytes : 0);
  static constexpr int kBlk = kBar + 8 * (4 + 2 * kStages);
  static constexpr int kBytes = kBlk + 32 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <int D, bool MASKED>
struct DqSmem {
  static constexpr int kN = dq_keys(D);
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;
  // q_s or dO of a block: [half][128 rows][128 B]; buffer qb holds q_s at
  // kQ0 + 2 qb kQ and dO after it
  static constexpr int kQ = kDqRows * D * 2;
  static constexpr int kQ0 = 0;
  // a stage of the key ring: K then V, [half][kN keys][128 B]; masked: the
  // tile's FlashMask bands (kN x 16 B), its keys' (segment, position) info
  // (kN x 16 B) and its word
  static constexpr int kKV = kN * D * 2;
  static constexpr int kRing = kQ0 + 4 * kQ;
  static constexpr int kBands = 2 * kKV;
  static constexpr int kKInfo = kBands + kN * 16;
  static constexpr int kWord = kKInfo + kN * 16;
  static constexpr int kStage =
      2 * kKV + (MASKED ? (2 * kN * 16 + 16 + 1023) / 1024 * 1024 : 0);
  static_assert(!MASKED || kWord + 16 <= kStage, "the bands and the word fit the stage");
  // masked: each Q buffer's queries' (segment, position) info; barriers: Q
  // full[2], Q empty[2], K/V full[], K/V empty[]; then the block of each Q
  // buffer (masked)
  static constexpr int kQInfo = kRing + kStages * kStage;
  static constexpr int kBar = kQInfo + (MASKED ? 2 * kBlockInfoBytes : 0);
  static constexpr int kBlk = kBar + 8 * (4 + 2 * kStages);
  static constexpr int kBytes = kBlk + 32 + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

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
};

// The query tiles of a dK/dV block (common.cuh query_tiles; bwd.py
// bwd_dkv_tile_plan).
__device__ __forceinline__ xfa::QueryTilePlan dkv_plan(int n0, int sq, int sk, int causal) {
  return xfa::query_tiles<kDkvRows, kDkvKeys>(n0, sq, sk, causal);
}

// ---- the masked producer's decisions

// The flags of the dK/dV tile of rows [m0, m0 + 64) against the keys of the
// block at n0 for query head `head`, or -1 when it is skipped; `st` the
// FlashMask stats of the block's keys (or null), `elem` the window /
// ragged test of the plan; with segments or positions their decision from
// the stats per 64-row tile and 128-key block. Mirrored by bwd.py
// bwd_masked_dkv_tile_plan.
__device__ __forceinline__ int dkv_tile_flags(const BwdParams& p, const int* st, int batch,
                                              int head, int n0, int m0, bool elem) {
  int flags = elem ? kElem : 0;
  if (st != nullptr) {
    bool skip, bypass;
    xfa::fm_decide(p.mask.fm_mode, st, m0, min(m0 + kDkvRows, p.sq), skip, bypass);
    if (skip) return -1;
    if (!bypass) flags |= kElem | kBand;
  }
  const xfa::MaskParams& m = p.mask;
  if (m.q_info != nullptr) {
    const int tf = xfa::token_flags(m, m.q_st[static_cast<int64_t>(batch) * m.n_qst + m0 / kDkvRows],
                                    m.k_st[static_cast<int64_t>(batch) * m.n_kst + n0 / kDkvKeys]);
    if (tf < 0) return -1;
    flags |= tf;
  }
  int on = 0;
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int key = n0 + 64 * c;
    if (key < p.sk && xfa::bm_on(p.mask, batch, head, p.h, m0, key)) on |= 1 << c;
  }
  return on == 0 ? -1 : flags | on << kOnShift;
}

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
// element's bias added after softcap, as the forward adds it. SOFTCAP and
// BIAS are template flags so that the unrolled loops carry no test per
// element.
template <bool SOFTCAP, bool BIAS = false>
__device__ __forceinline__ void p_ds(float x, float dp, float lse2, float delta, bool visible,
                                     float softcap, float& pr, float& ds, float bias = 0.f) {
  float fac = 1.f;
  if (SOFTCAP) {
    const float th = tanhf(x / softcap);
    x = th * softcap;
    fac = 1.f - th * th;
  }
  if constexpr (BIAS) x += bias;
  pr = visible ? ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
  ds = pr * (dp - delta) * fac;
}

// dK/dV: P^T and dS^T of one query tile, in place in fp32 (s: S^T -> P^T,
// dp: dP^T -> dS^T), this thread's keys key0 and key0 + 8 as rows and the
// tile's rows m0 + c as columns; LSE and delta per column from shared
// memory; with MASK the elementwise causal / sq test, with NB > 0 also the
// first NB FlashMask bands of the two keys (b0, b1); with BIAS the tile's
// bias `bv` (common.cuh load_bias_cols).
template <bool MASK, bool SOFTCAP, int NB = 0, bool BIAS = false>
__device__ __forceinline__ void dkv_p_ds(float (&s)[kDkvRows / 2], float (&dp)[kDkvRows / 2],
                                         const float* lse, const float* delta, int key0, int m0,
                                         const BwdParams& p, int t, int4 b0 = int4{},
                                         int4 b1 = int4{}, const float* bv = nullptr) {
#pragma unroll
  for (int i = 0; i < kDkvRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);  // the query row in the tile
    bool visible = true;
    if (MASK) {
      const int key = key0 + ((i >> 1) & 1) * 8, row = m0 + c;
      visible = row < p.sq && (!p.causal || key <= row + p.sk - p.sq);
      if (NB > 0) visible = visible & !xfa::banned<NB>((i >> 1) & 1 ? b1 : b0, row);
    }
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse[c] * kLog2e, delta[c], visible, p.softcap, s[i], dp[i],
                        BIAS ? bv[i] : 0.f);
  }
}

// dK/dV's elementwise test in the masked instantiations, all bitwise: the
// rows that see this thread's keys key0 and key0 + 8 by the row/key window
// and below sq (common.cuh key_limit), with NB > 0 the keys' first NB
// FlashMask bands (b0, b1) and with INFO each row's segment id and position
// (`qinfo`, in the stage) against the key's (`kinfo`: key0's, staged with
// K/V; key0 + 8's 8 further); P and dS as dkv_p_ds.
template <bool SOFTCAP, int NB, bool INFO, bool BIAS = false>
__device__ __forceinline__ void dkv_p_ds_masked(float (&s)[kDkvRows / 2],
                                                float (&dp)[kDkvRows / 2], const float* lse,
                                                const float* delta, int key0, int m0,
                                                const int4* qinfo, const int4* kinfo,
                                                const BwdParams& p, int t, int4 b0, int4 b1,
                                                const float* bv = nullptr) {
  int rmin[2], rmax[2];
  int4 kt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xfa::key_limit(p.mask, key0 + 8 * r, p.sq, p.sk, rmin[r], rmax[r]);
    if (INFO) kt[r] = xfa::key_tokens(p.mask, xfa::token_at(kinfo, 8 * r));
  }
#pragma unroll
  for (int i = 0; i < kDkvRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);  // the query row in the tile
    const int r = (i >> 1) & 1, row = m0 + c;
    bool visible = (row >= rmin[r]) & (row <= rmax[r]);
    if (NB > 0) visible = visible & !xfa::banned<NB>(r ? b1 : b0, row);
    if (INFO) visible = visible & xfa::tokens_meet(kt[r], xfa::token_at(qinfo, c));
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse[c] * kLog2e, delta[c], visible, p.softcap, s[i], dp[i],
                        BIAS ? bv[i] : 0.f);
  }
}

// dQ: dS of one key tile, in place in fp32 (dp: dP -> dS), from S (s), this
// thread's rows row0 and row0 + 8 (lse2, delta per row) and the tile's keys
// n0 + c as columns; with MASK the elementwise causal / sk test and the
// parts of the tile's keys that are on (`parts`: bit 0 keys [0, 64), bit
// 1 [64, 128)); with NB > 0 also each column's first NB FlashMask bands
// (`bands`, in shared memory); with BIAS the tile's bias `bv`.
template <bool MASK, bool SOFTCAP, int N, int NB = 0, bool BIAS = false>
__device__ __forceinline__ void dq_ds(const float (&s)[N / 2], float (&dp)[N / 2],
                                      const float (&lse2)[2], const float (&delta)[2], int row0,
                                      int n0, const BwdParams& p, int t, int parts = 3,
                                      const int4* bands = nullptr, const float* bv = nullptr) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    bool visible = true;
    if (MASK) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1), col = n0 + c, row = row0 + 8 * r;
      visible = col < p.sk && (!p.causal || col <= row + p.sk - p.sq) &&
                ((parts >> ((i >> 2) >= 8 ? 1 : 0)) & 1);
      if (NB > 0) visible = visible & !xfa::banned<NB>(bands[c], row);  // the load unconditional
    }
    float pr;
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse2[r], delta[r], visible, p.softcap, pr, dp[i],
                        BIAS ? bv[i] : 0.f);
  }
}

// dQ's elementwise test in the masked instantiations, all bitwise: the key
// below sk, the row/key window, the parts of the tile's keys that are on,
// with NB > 0 each column's first NB FlashMask bands (`bands`) and with
// INFO each key's segment id and position (`kinfo`), both in the stage,
// against the row's (`qinfo`: row0's, staged with q_s; row0 + 8's 8
// further); dS as dq_ds.
template <bool SOFTCAP, int N, int NB, bool INFO, bool BIAS = false>
__device__ __forceinline__ void dq_ds_masked(const float (&s)[N / 2], float (&dp)[N / 2],
                                             const float (&lse2)[2], const float (&delta)[2],
                                             int row0, int n0, const BwdParams& p, int t,
                                             int parts, const int4* bands, const int4* kinfo,
                                             const int4* qinfo, const float* bv = nullptr) {
  int lo[2], hi[2];
  int4 qt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    xfa::row_limit(p.mask, row0 + 8 * r, p.sq, p.sk, lo[r], hi[r]);
    if (INFO) qt[r] = xfa::query_tokens(p.mask, xfa::token_at(qinfo, 8 * r));
  }
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    const int c = (i >> 2) * 8 + 2 * t + (i & 1), col = n0 + c, row = row0 + 8 * r;
    bool visible = (col <= hi[r]) & (col >= lo[r]) &
                   (((parts >> ((i >> 2) >= 8 ? 1 : 0)) & 1) != 0);
    if (NB > 0) visible = visible & !xfa::banned<NB>(bands[c], row);  // the load unconditional
    if (INFO) visible = visible & xfa::tokens_meet(qt[r], xfa::token_at(kinfo, c));
    float pr;
    p_ds<SOFTCAP, BIAS>(s[i], dp[i], lse2[r], delta[r], visible, p.softcap, pr, dp[i],
                        BIAS ? bv[i] : 0.f);
  }
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

// ---- dK/dV

// The producer's loads of one query tile (q_s, dO, LSE and delta of `head`
// at rows m0) into ring stage `st`, after its previous use is consumed; the
// tile-full barrier also waits for `extra` bytes (the masked tile's
// queries' info).
template <int D, bool MASKED = false>
__device__ __forceinline__ void dkv_load_tile(const CUtensorMap* tq, const CUtensorMap* tdo,
                                              const CUtensorMap* tlse, const CUtensorMap* tdelta,
                                              uint32_t base, int it, int m0, int head, int batch,
                                              int stat0, uint32_t extra = 0) {
  using S = DkvSmem<D, MASKED>;
  const uint32_t bar_t = base + S::kBar + 32;  // after K/V full[2] and empty[2]
  const int st = it % S::kStages;
  const uint32_t t_st = base + S::kRing + st * S::kStage;
  sm90::mbar_expect_tx(bar_t + 8 * st, 2 * S::kTile + 2 * kStatBox * 4 + extra);
  for (int hf = 0; hf < S::kHalves; ++hf) {
    sm90::tma_load_4d(t_st + hf * kDkvRows * kRow, tq, bar_t + 8 * st, hf * 64, m0, head, batch);
    sm90::tma_load_4d(t_st + S::kTile + hf * kDkvRows * kRow, tdo, bar_t + 8 * st, hf * 64, m0,
                      head, batch);
  }
  const int c0 = (stat0 + m0) & ~3;
  sm90::tma_load_1d(t_st + 2 * S::kTile, tlse, bar_t + 8 * st, c0);
  sm90::tma_load_1d(t_st + 2 * S::kTile + S::kStatStride, tdelta, bar_t + 8 * st, c0);
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tlse,
                         const __grid_constant__ CUtensorMap tdelta,
                         const __grid_constant__ CUtensorMap tqinfo,
                         const __grid_constant__ CUtensorMap tkinfo, const BwdParams p) {
  using S = DkvSmem<D, MASKED>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_kv = base + S::kBar, bar_kve = bar_kv + 16;  // [2] each
  const uint32_t bar_t = bar_kve + 16, bar_te = bar_t + 8 * S::kStages;
  const int n_nb = (p.sk + kDkvKeys - 1) / kDkvKeys;
  const int n_pairs = xfa::block_pairs(n_nb, p.hk, p.b);
  const int group = p.h / p.hk;
  // a bias shared by every batch: blocks batch first (common.cuh pair_block_by)
  const bool batch_fast = BIAS && p.bias.sb == 0 && p.b > 1;

  if (threadIdx.x == 0) {
    for (int kb = 0; kb < 2; ++kb) {
      sm90::mbar_init(bar_kv + 8 * kb, 1);
      sm90::mbar_init(bar_kve + 8 * kb, 8);  // the eight consumer warps
    }
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_t + 8 * st, 1);
      sm90::mbar_init(bar_te + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Unmasked, both roles walk the same blocks and count the same K/V loads
  // (kv, two buffers) and query tiles (it, the ring position), so buffers,
  // stages and parities agree without any other exchange. Masked, the
  // consumers take each block from its K/V buffer's slot and each tile
  // from its stage's word.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    int it = 0, kv = 0;
    if constexpr (!MASKED) {
      if (threadIdx.x == 0) {
        for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            int n_block, kv_head, batch;
            if (!xfa::pair_block_by(batch_fast, pair, half, n_nb, p.hk, p.b, false, n_block,
                                    kv_head, batch))
              continue;
            const int n0 = n_block * kDkvKeys;
            const xfa::QueryTilePlan pl = dkv_plan(n0, p.sq, p.sk, p.causal);
            const int kb = kv & 1;
            sm90::mbar_wait(bar_kve + 8 * kb, ((kv >> 1) & 1) ^ 1);  // the first pass is free
            sm90::mbar_expect_tx(bar_kv + 8 * kb, 2 * S::kKV);
            const uint32_t k_buf = base + S::kK + kb * 2 * S::kKV, v_buf = k_buf + S::kKV;
            for (int hf = 0; hf < S::kHalves; ++hf) {
              sm90::tma_load_4d(k_buf + hf * kDkvKeys * kRow, &tk, bar_kv + 8 * kb, hf * 64, n0,
                                kv_head, batch);
              sm90::tma_load_4d(v_buf + hf * kDkvKeys * kRow, &tv, bar_kv + 8 * kb, hf * 64, n0,
                                kv_head, batch);
            }
            ++kv;
            for (int gi = 0; gi < group; ++gi) {
              const int head = kv_head * group + gi;
              const int stat0 = (batch * p.h + head) * p.sq;
              for (int i = 0; i < pl.n_tiles(); ++i, ++it) {
                const int st = it % S::kStages;
                sm90::mbar_wait(bar_te + 8 * st, ((it / S::kStages) & 1) ^ 1);
                dkv_load_tile<D>(&tq, &tdo, &tlse, &tdelta, base, it, pl.tile(i) * kDkvRows, head,
                                 batch, stat0);
              }
            }
          }
        }
      }
    } else if (threadIdx.x < 32) {
      // ---- the masked producer: its whole warp decides, lane 0 issues (and
      // keeps the counts it and kv, and the tiles it emits and those of them
      // with the elementwise test)
      const xfa::MaskParams& m = p.mask;
      const bool lead = threadIdx.x == 0;
      int tiles = 0, elem = 0;
      for (;;) {
        int n_block = 0, kv_head = 0, batch = 0;
        const bool more =
            xfa::next_block_by(batch_fast, p.next, p.b, n_nb, p.hk, false, n_block, kv_head,
                               batch);
        const int kb = kv & 1;
        if (lead) {
          sm90::mbar_wait(bar_kve + 8 * kb, ((kv >> 1) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kBlk + 16 * kb) =
              make_int4(more ? n_block : kEnd, kv_head, batch, 0);
          if (more) {
            // with segments or positions, the block's keys' info too
            const bool info = m.k_info != nullptr;
            sm90::mbar_expect_tx(bar_kv + 8 * kb, 2 * S::kKV + (info ? kBlockInfoBytes : 0));
            const uint32_t k_buf = base + S::kK + kb * 2 * S::kKV, v_buf = k_buf + S::kKV;
            for (int hf = 0; hf < S::kHalves; ++hf) {
              sm90::tma_load_4d(k_buf + hf * kDkvKeys * kRow, &tk, bar_kv + 8 * kb, hf * 64,
                                n_block * kDkvKeys, kv_head, batch);
              sm90::tma_load_4d(v_buf + hf * kDkvKeys * kRow, &tv, bar_kv + 8 * kb, hf * 64,
                                n_block * kDkvKeys, kv_head, batch);
            }
            if (info)
              sm90::tma_load_2d(base + S::kKInfo + kb * kBlockInfoBytes, &tkinfo, bar_kv + 8 * kb,
                                0, batch * m.k_pad + n_block * kDkvKeys);
          } else {
            sm90::mbar_arrive(bar_kv + 8 * kb);
          }
        }
        ++kv;
        if (!more) break;
        const int n0 = n_block * kDkvKeys;
        const xfa::QueryTilePlan pl =
            xfa::query_window<kDkvRows, kDkvKeys>(m, batch, n0, p.sq, p.sk);
        const int n_masked = pl.n_masked();
        const int info_row = batch * m.q_pad;
        for (int gi = 0; gi < group; ++gi) {
          const int head = kv_head * group + gi;
          const int stat0 = (batch * p.h + head) * p.sq;
          const int* st = m.fm_vecs != nullptr
                              ? xfa::fm_tile_stats(m, batch, xfa::fm_head(m, head, p.h), n0,
                                                   kDkvKeys)
                              : nullptr;
          xfa::emit_tiles(
              pl.n_tiles(),
              [&](int i, int& m0) {
                m0 = pl.tile(i) * kDkvRows;
                return dkv_tile_flags(p, st, batch, head, n0, m0, i < n_masked);
              },
              [&](int m0, int flags) {
                const int s_ = it % S::kStages;
                sm90::mbar_wait(bar_te + 8 * s_, ((it / S::kStages) & 1) ^ 1);
                *reinterpret_cast<int4*>(smem + S::kRing + s_ * S::kStage + S::kWord) =
                    make_int4(m0, gi, flags, 0);
                const bool info = flags & kInfo;
                dkv_load_tile<D, true>(&tq, &tdo, &tlse, &tdelta, base, it, m0, head, batch, stat0,
                                       info ? S::kQInfoBytes : 0);
                if (info)
                  sm90::tma_load_2d(base + S::kRing + s_ * S::kStage + S::kQInfo, &tqinfo,
                                    base + S::kBar + 32 + 8 * s_, 0, info_row + m0);
                ++it;
                ++tiles;
                elem += flags & kElem;
              });
        }
        if (lead) {  // the block's end
          const int s_ = it % S::kStages;
          sm90::mbar_wait(bar_te + 8 * s_, ((it / S::kStages) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kRing + s_ * S::kStage + S::kWord) =
              make_int4(kEnd, 0, 0, 0);
          sm90::mbar_arrive(bar_t + 8 * s_);
        }
        ++it;
      }
      if (lead) {
        atomicAdd(p.next + 1, tiles);
        atomicAdd(p.next + 2, elem);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, kv = 0;
    int pair = blockIdx.x, half = 0;
    for (;;) {
      int n_block, kv_head, batch;
      const int kb = kv & 1;
      if constexpr (MASKED) {
        sm90::mbar_wait(bar_kv + 8 * kb, (kv >> 1) & 1);
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kBlk + 16 * kb);
        if (blk.x == kEnd) break;
        n_block = blk.x;
        kv_head = blk.y;
        batch = blk.z;
      } else {
        if (pair >= n_pairs) break;
        const bool ok = xfa::pair_block_by(batch_fast, pair, half, n_nb, p.hk, p.b, false,
                                           n_block, kv_head, batch);
        if (half == 1) pair += gridDim.x;
        half ^= 1;
        if (!ok) continue;
      }
      const int n0 = n_block * kDkvKeys;
      const xfa::QueryTilePlan pl = dkv_plan(n0, p.sq, p.sk, p.causal);
      const int n_tiles = pl.n_tiles(), n_masked = pl.n_masked();
      const uint32_t k_wg = base + S::kK + kb * 2 * S::kKV + cw * 64 * kRow;
      const uint32_t v_wg = k_wg + S::kKV;
      const int key0 = n0 + cw * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
      float dk[D / 2], dv[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
      if constexpr (!MASKED) sm90::mbar_wait(bar_kv + 8 * kb, (kv >> 1) & 1);
      // masked: the FlashMask bands of this thread's keys, of mask head bh
      int4 b0{}, b1{};
      int bh = -1;
      // the group's heads one after the other, each over its tiles
      for (int idx = 0;; ++idx, ++it) {
        const int st = it % S::kStages;
        const uint8_t* stage = smem + S::kRing + st * S::kStage;
        const uint32_t t_st = base + S::kRing + st * S::kStage;
        int gi, m0, flags;
        if constexpr (MASKED) {
          sm90::mbar_wait(bar_t + 8 * st, (it / S::kStages) & 1);
          const int4 w = *reinterpret_cast<const int4*>(stage + S::kWord);
          if (w.x == kEnd || !((w.z >> (kOnShift + cw)) & 1)) {
            if (lane == 0) sm90::mbar_arrive(bar_te + 8 * st);
            if (w.x == kEnd) {
              ++it;
              break;
            }
            continue;
          }
          m0 = w.x;
          gi = w.y;
          flags = w.z;
          const xfa::MaskParams& m = p.mask;
          const int fh = flags & kBand ? xfa::fm_head(m, kv_head * group + gi, p.h) : bh;
          if (fh != bh) {  // this thread's keys' bands, read under the products
            const int4* kb4 = p.bands + static_cast<int64_t>(batch * m.fm_heads + fh) * m.fm_skp;
            b0 = kb4[key0];
            b1 = kb4[key0 + 8];
            bh = fh;
          }
        } else {
          if (idx == group * n_tiles) break;
          gi = idx / n_tiles;
          const int i = idx - gi * n_tiles;
          m0 = pl.tile(i) * kDkvRows;
          flags = i < n_masked ? kElem : 0;
          sm90::mbar_wait(bar_t + 8 * st, (it / S::kStages) & 1);
        }
        float s[kDkvRows / 2], dp[kDkvRows / 2];
        sm90::wgmma_fence();
        // S^T = K q_s^T, dP^T = V dO^T
        issue_ss<D, kDkvRows>(s, k_wg, kDkvKeys * kRow, t_st, kDkvRows * kRow);
        issue_ss<D, kDkvRows>(dp, v_wg, kDkvKeys * kRow, t_st + S::kTile, kDkvRows * kRow);
        sm90::wgmma_commit();
        // BIAS: the tile's bias for query head kv_head * group + gi, under the products
        float bv[BIAS ? kDkvRows / 2 : 1];
        if constexpr (BIAS)
          xfa::load_bias_cols<kDkvRows>(
              bv, p.bias, batch * p.bias.sb + (kv_head * group + gi) * p.bias.sh, key0, m0, p.sq,
              p.sk, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        const int stat0 = (batch * p.h + kv_head * group + gi) * p.sq;
        const float* lse = reinterpret_cast<const float*>(stage + 2 * S::kTile) + ((stat0 + m0) & 3);
        const float* delta = lse + S::kStatStride / 4;
        if (!(flags & kElem)) {
          dkv_p_ds<false, SOFTCAP, 0, BIAS>(s, dp, lse, delta, key0, m0, p, t, {}, {}, bv);
        } else if constexpr (!MASKED) {
          dkv_p_ds<true, SOFTCAP, 0, BIAS>(s, dp, lse, delta, key0, m0, p, t, {}, {}, bv);
        } else {
          const int4* qinfo = reinterpret_cast<const int4*>(stage + S::kQInfo);
          const int4* kinfo = reinterpret_cast<const int4*>(smem + S::kKInfo +
                                                            kb * kBlockInfoBytes) +
                              (key0 - n0);
#define XFA_DKV(NB, I)                                                                        \
  dkv_p_ds_masked<SOFTCAP, NB, I, BIAS>(s, dp, lse, delta, key0, m0, qinfo, kinfo, p, t, b0, b1, \
                                        bv)
          const bool one_band = p.mask.fm_mode <= xfa::kFmCausal2;
          if (!(flags & kBand)) {
            if (flags & kInfo) XFA_DKV(0, true);
            else XFA_DKV(0, false);
          } else if (!(flags & kInfo)) {
            if (one_band) XFA_DKV(1, false);
            else XFA_DKV(2, false);
          } else {  // both tests, rare: the one-band modes' second band is empty
            XFA_DKV(2, true);
          }
#undef XFA_DKV
        }
        uint32_t pa[kDkvRows / 4], da[kDkvRows / 4];
        pack_pairs(s, pa);
        pack_pairs(dp, da);
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        sm90::fence_regs(pa);
        sm90::fence_regs(da);
        sm90::wgmma_fence();
        issue_rs<D, kDkvRows>(dv, pa, t_st + S::kTile, kDkvRows * kRow);  // dV += P^T dO
        issue_rs<D, kDkvRows>(dk, da, t_st, kDkvRows * kRow);             // dK += dS^T q_s
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dv);
        sm90::fence_regs(dk);
        if (lane == 0) sm90::mbar_arrive(bar_te + 8 * st);  // one arrival per consumer warp
      }
      if (lane == 0) sm90::mbar_arrive(bar_kve + 8 * kb);
      ++kv;
      store_rows<D>(p.dk + batch * p.dk_sb + kv_head * p.dk_sh, p.dk_ss, dk, key0, p.sk, 1.f, t);
      store_rows<D>(p.dv + batch * p.dv_sb + kv_head * p.dv_sh, p.dv_ss, dv, key0, p.sk, 1.f, t);
    }
  }
}

// ---- dQ

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tbands,
                        const __grid_constant__ CUtensorMap tkinfo,
                        const __grid_constant__ CUtensorMap tqinfo, const BwdParams p) {
  using S = DqSmem<D, MASKED>;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 16;  // [2] each
  const uint32_t bar_kv = bar_qe + 16, bar_e = bar_kv + 8 * S::kStages;
  const int n_mb = (p.sq + kDqRows - 1) / kDqRows;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);
  // a bias shared by every batch: blocks batch first (common.cuh pair_block_by)
  const bool batch_fast = BIAS && p.bias.sb == 0 && p.b > 1;

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(bar_q + 8 * qb, 1);
      sm90::mbar_init(bar_qe + 8 * qb, 8);
    }
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_kv + 8 * st, 1);
      sm90::mbar_init(bar_e + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // As in flash_fwd_kernel: unmasked, both roles count the same Q loads
  // (qk) and K/V tiles (it); masked, the consumers take each block from its
  // Q buffer's slot (every block takes a buffer, loaded or not) and each
  // tile from its stage's word.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    int it = 0, qk = 0;
    auto load_kv = [&](int n0, int kv_head, int batch, uint32_t extra) {
      const int st = it % S::kStages;
      const uint32_t k_st = base + S::kRing + st * S::kStage, v_st = k_st + S::kKV;
      sm90::mbar_expect_tx(bar_kv + 8 * st, 2 * S::kKV + extra);
      for (int hf = 0; hf < S::kHalves; ++hf) {
        sm90::tma_load_4d(k_st + hf * kN * kRow, &tk, bar_kv + 8 * st, hf * 64, n0, kv_head, batch);
        sm90::tma_load_4d(v_st + hf * kN * kRow, &tv, bar_kv + 8 * st, hf * 64, n0, kv_head, batch);
      }
    };
    auto load_q = [&](int q0, int head, int batch, uint32_t extra = 0) {
      const int qb = qk & 1;
      const uint32_t q_buf = base + S::kQ0 + qb * 2 * S::kQ;
      sm90::mbar_expect_tx(bar_q + 8 * qb, 2 * S::kQ + extra);
      for (int hf = 0; hf < S::kHalves; ++hf) {
        sm90::tma_load_4d(q_buf + hf * kDqRows * kRow, &tq, bar_q + 8 * qb, hf * 64, q0, head,
                          batch);
        sm90::tma_load_4d(q_buf + S::kQ + hf * kDqRows * kRow, &tdo, bar_q + 8 * qb, hf * 64, q0,
                          head, batch);
      }
    };
    if constexpr (!MASKED) {
      if (threadIdx.x == 0) {
        for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
          for (int half = 0; half < 2; ++half) {
            int m_block, head, batch, n_tiles, n_free;
            if (!xfa::pair_block_by(batch_fast, pair, half, n_mb, p.h, p.b, true, m_block, head,
                                    batch))
              continue;
            const int q0 = m_block * kDqRows;
            xfa::key_tiles<kDqRows, kN>(q0, p.sq, p.sk, p.causal, n_tiles, n_free);
            if (n_tiles == 0) continue;
            const int kv_head = head / (p.h / p.hk);
            sm90::mbar_wait(bar_qe + 8 * (qk & 1), ((qk >> 1) & 1) ^ 1);
            load_q(q0, head, batch);
            ++qk;
            for (int i = 0; i < n_tiles; ++i, ++it) {
              const int st = it % S::kStages;
              sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
              load_kv((n_tiles - 1 - i) * kN, kv_head, batch, 0);
            }
          }
        }
      }
    } else if (threadIdx.x < 32) {
      // ---- the masked producer: its whole warp decides, lane 0 issues (and
      // counts the tiles it emits, as in dK/dV)
      const xfa::MaskParams& m = p.mask;
      const bool lead = threadIdx.x == 0;
      int tiles = 0, elem = 0;
      for (;;) {
        int m_block = 0, head = 0, batch = 0, lo = 0, hi = 0, f_lo = 0, f_hi = 0;
        const bool more =
            xfa::next_block_by(batch_fast, p.next, p.b, n_mb, p.h, true, m_block, head, batch);
        const int q0 = m_block * kDqRows;
        if (more) xfa::key_window<kDqRows, kN>(m, batch, q0, p.sq, p.sk, lo, hi, f_lo, f_hi);
        const int n_tiles = hi - lo;
        const int qb = qk & 1;
        if (lead) {
          sm90::mbar_wait(bar_qe + 8 * qb, ((qk >> 1) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kBlk + 16 * qb) =
              make_int4(more ? m_block : kEnd, head, batch, 0);
          if (n_tiles > 0) {
            // with segments or positions, the block's queries' info too
            const bool info = m.q_info != nullptr;
            load_q(q0, head, batch, info ? kBlockInfoBytes : 0);
            if (info)
              sm90::tma_load_2d(base + S::kQInfo + qb * kBlockInfoBytes, &tqinfo, bar_q + 8 * qb,
                                0, batch * m.q_pad + q0);
          } else {
            sm90::mbar_arrive(bar_q + 8 * qb);
          }
        }
        ++qk;
        if (!more) break;
        const int kv_head = head / (p.h / p.hk);
        const int64_t band_row =
            m.fm_vecs != nullptr
                ? static_cast<int64_t>(batch * m.fm_heads + xfa::fm_head(m, head, p.h)) * m.fm_skp
                : 0;
        const int info_row = batch * m.k_pad;
        xfa::emit_tiles(
            n_tiles,
            [&](int i, int& n0) {
              const int tile = hi - 1 - i;
              n0 = tile * kN;
              return xfa::row_block_tile_flags<kN>(p.mask, batch, head, p.h, p.sq, p.sk, q0,
                                                    n0, (tile < f_lo) | (tile >= f_hi));
            },
            [&](int n0, int flags) {
              const int st = it % S::kStages;
              sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
              const int band = flags & kBand, info = flags & kInfo;
              *reinterpret_cast<int4*>(smem + S::kRing + st * S::kStage + S::kWord) =
                  make_int4(n0, flags, 0, 0);
              load_kv(n0, kv_head, batch, (band ? kN * 16 : 0) + (info ? kN * 16 : 0));
              if (band)
                sm90::tma_load_2d(base + S::kRing + st * S::kStage + S::kBands, &tbands,
                                  bar_kv + 8 * st, 0, static_cast<int>(band_row + n0));
              if (info)
                sm90::tma_load_2d(base + S::kRing + st * S::kStage + S::kKInfo, &tkinfo,
                                  bar_kv + 8 * st, 0, info_row + n0);
              ++it;
              ++tiles;
              elem += flags & kElem;
            });
        if (lead) {  // the block's end
          const int st = it % S::kStages;
          sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
          *reinterpret_cast<int4*>(smem + S::kRing + st * S::kStage + S::kWord) =
              make_int4(kEnd, 0, 0, 0);
          sm90::mbar_arrive(bar_kv + 8 * st);
        }
        ++it;
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
    int it = 0, qk = 0;
    int pair = blockIdx.x, half = 0;
    for (;;) {
      int m_block, head, batch, n_tiles = 0, n_free = 0;
      const int qb = qk & 1;
      if constexpr (MASKED) {
        sm90::mbar_wait(bar_q + 8 * qb, (qk >> 1) & 1);
        const int4 blk = *reinterpret_cast<const int4*>(smem + S::kBlk + 16 * qb);
        if (blk.x == kEnd) break;
        ++qk;
        m_block = blk.x;
        head = blk.y;
        batch = blk.z;
      } else {
        if (pair >= n_pairs) break;
        const bool ok = xfa::pair_block_by(batch_fast, pair, half, n_mb, p.h, p.b, true,
                                           m_block, head, batch);
        if (half == 1) pair += gridDim.x;
        half ^= 1;
        if (!ok) continue;
      }
      const int q0 = m_block * kDqRows;
      xfa::key_tiles<kDqRows, kN>(q0, p.sq, p.sk, p.causal, n_tiles, n_free);
      const int n_masked = n_tiles - n_free;  // the first tiles visited
      const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
      float lse2[2], delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        lse2[r] = row < p.sq ? p.lse[stat + row] * kLog2e : INFINITY;
        delta[r] = row < p.sq ? p.delta[stat + row] : 0.f;
      }
      float dq[D / 2];
#pragma unroll
      for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
      const uint32_t q_wg = base + S::kQ0 + qb * 2 * S::kQ + cw * 64 * kRow;
      const uint32_t do_wg = q_wg + S::kQ;
      if (!MASKED && n_tiles > 0) {
        sm90::mbar_wait(bar_q + 8 * qb, (qk >> 1) & 1);
        ++qk;
      }
      for (int i = 0;; ++i, ++it) {
        const int st = it % S::kStages;
        const uint8_t* stage = smem + S::kRing + st * S::kStage;
        const uint32_t k_st = base + S::kRing + st * S::kStage, v_st = k_st + S::kKV;
        int n0, flags, parts = 3;
        if constexpr (MASKED) {
          sm90::mbar_wait(bar_kv + 8 * st, (it / S::kStages) & 1);
          const int4 w = *reinterpret_cast<const int4*>(stage + S::kWord);
          parts = (w.y >> (kOnShift + 2 * cw)) & 3;
          if (w.x == kEnd || parts == 0) {
            if (lane == 0) {
              sm90::mbar_arrive(bar_e + 8 * st);
              // after the block's last products on q_s and dO in shared memory
              if (w.x == kEnd) sm90::mbar_arrive(bar_qe + 8 * qb);
            }
            if (w.x == kEnd) {
              ++it;
              break;
            }
            continue;
          }
          n0 = w.x;
          flags = w.y;
        } else {
          if (i == n_tiles) break;
          n0 = (n_tiles - 1 - i) * kN;
          flags = i < n_masked ? kElem : 0;
          sm90::mbar_wait(bar_kv + 8 * st, (it / S::kStages) & 1);
        }
        float s[kN / 2], dp[kN / 2];
        sm90::wgmma_fence();
        issue_ss<D, kN>(s, q_wg, kDqRows * kRow, k_st, kN * kRow);  // S = q_s K^T
        issue_ss<D, kN>(dp, do_wg, kDqRows * kRow, v_st, kN * kRow);  // dP = dO V^T
        sm90::wgmma_commit();
        float bv[BIAS ? kN / 2 : 1];  // BIAS: the tile's bias, under the products
        if constexpr (BIAS)
          xfa::load_bias_rows<kN>(bv, p.bias, batch * p.bias.sb + head * p.bias.sh, row0, n0,
                                  p.sq, p.sk, t);
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        // after the block's last products on q_s and dO in shared memory
        if (!MASKED && i == n_tiles - 1 && lane == 0) sm90::mbar_arrive(bar_qe + 8 * qb);
        if (!(flags & kElem)) {
          dq_ds<false, SOFTCAP, kN, 0, BIAS>(s, dp, lse2, delta, row0, n0, p, t, 3, nullptr, bv);
        } else if constexpr (!MASKED) {
          dq_ds<true, SOFTCAP, kN, 0, BIAS>(s, dp, lse2, delta, row0, n0, p, t, parts, nullptr, bv);
        } else {
          const int4* bands = reinterpret_cast<const int4*>(stage + S::kBands);
          const int4* kinfo = reinterpret_cast<const int4*>(stage + S::kKInfo);
          const int4* qinfo = reinterpret_cast<const int4*>(smem + S::kQInfo +
                                                            qb * kBlockInfoBytes) +
                              (row0 - q0);
#define XFA_DQ(NB, I)                                                                       \
  dq_ds_masked<SOFTCAP, kN, NB, I, BIAS>(s, dp, lse2, delta, row0, n0, p, t, parts, bands, kinfo, \
                                         qinfo, bv)
          const bool one_band = p.mask.fm_mode <= xfa::kFmCausal2;
          if (!(flags & kBand)) {
            if (flags & kInfo) XFA_DQ(0, true);
            else XFA_DQ(0, false);
          } else if (!(flags & kInfo)) {
            if (one_band) XFA_DQ(1, false);
            else XFA_DQ(2, false);
          } else {  // both tests, rare: the one-band modes' second band is empty
            XFA_DQ(2, true);
          }
#undef XFA_DQ
        }
        uint32_t da[kN / 4];
        pack_pairs(dp, da);
        sm90::fence_regs(dq);
        sm90::fence_regs(da);
        sm90::wgmma_fence();
        issue_rs<D, kN>(dq, da, k_st, kN * kRow);  // dQ += dS K
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(dq);
        if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);  // one arrival per consumer warp
      }
      store_rows<D>(p.dq + batch * p.dq_sb + head * p.dq_sh, p.dq_ss, dq, row0, p.sq, p.sm_scale,
                    t);
    }
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

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
cudaError_t launch_dkv_kernel(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = sm90::smem_limit_once(flash_bwd_dkv_kernel<D, SOFTCAP, MASKED, BIAS>,
                                          DkvSmem<D, MASKED>::kBytes, done);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size((p.sk + kDkvKeys - 1) / kDkvKeys, p.hk, p, MASKED, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, SOFTCAP, MASKED, BIAS><<<grid, kThreads, DkvSmem<D, MASKED>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], maps[7], p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS>
cudaError_t launch_dq_kernel(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  using S = DqSmem<D, MASKED>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      sm90::smem_limit_once(flash_bwd_dq_kernel<D, SOFTCAP, MASKED, BIAS>, S::kBytes, done);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size((p.sq + kDqRows - 1) / kDqRows, p.h, p, MASKED, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, SOFTCAP, MASKED, BIAS><<<grid, kThreads, S::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], p);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  if (p.bias.ptr != nullptr)
    return p.softcap > 0.f ? launch_dkv_kernel<D, true, MASKED, true>(maps, p, s)
                           : launch_dkv_kernel<D, false, MASKED, true>(maps, p, s);
  return p.softcap > 0.f ? launch_dkv_kernel<D, true, MASKED, false>(maps, p, s)
                         : launch_dkv_kernel<D, false, MASKED, false>(maps, p, s);
}

template <int D, bool MASKED>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  if (p.bias.ptr != nullptr)
    return p.softcap > 0.f ? launch_dq_kernel<D, true, MASKED, true>(maps, p, s)
                           : launch_dq_kernel<D, false, MASKED, true>(maps, p, s);
  return p.softcap > 0.f ? launch_dq_kernel<D, true, MASKED, false>(maps, p, s)
                         : launch_dq_kernel<D, false, MASKED, false>(maps, p, s);
}

}  // namespace

// q, dout and out: (b, h, sq, d) views with element strides (batch, head,
// seq) and a contiguous head dim, 16-byte aligned rows. Writes delta (b, h,
// sq) fp32 contiguous and, when qs is not null, q_s = bf16(q * sm_scale)
// as a contiguous (b, h, sq, d) tensor.
XFA_EXPORT int xfa_flash_bwd_prep(const void* q, const void* dout, const void* out, void* qs,
                                  void* delta, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                  int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t o_sb,
                                  int64_t o_sh, int64_t o_ss, int b, int h, int sq, int d,
                                  float sm_scale, int dtype, void* stream) {
  const int64_t rows = static_cast<int64_t>(b) * h * sq;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto t) -> cudaError_t {
    using T = decltype(t);
    const PrepParams<T> p{static_cast<const T*>(q), static_cast<const T*>(dout),
                          static_cast<const T*>(out), static_cast<T*>(qs),
                          static_cast<float*>(delta), q_sb, q_sh, q_ss, do_sb, do_sh, do_ss,
                          o_sb, o_sh, o_ss, rows, h, sq, sm_scale};
    const int per_block = kPrepThreads / (d * static_cast<int>(sizeof(T)) / 16);
    const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
    if (d == 64) flash_bwd_prep_kernel<64, T><<<grid, kPrepThreads, 0, s>>>(p);
    else if (d == 128) flash_bwd_prep_kernel<128, T><<<grid, kPrepThreads, 0, s>>>(p);
    else return cudaErrorInvalidValue;
    return cudaGetLastError();
  };
  if (dtype == xfa::kBF16) return static_cast<int>(run(bf16{}));
  if (dtype == xfa::kF32) return static_cast<int>(run(0.f));
  return static_cast<int>(cudaErrorInvalidValue);
}

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
// instantiations.
#define XFA_BWD_ARGS                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, void *dq, void *dk, void *dv, int64_t q_sb, int64_t q_sh, int64_t q_ss, \
      int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,      \
      int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, \
      int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, \
      int b, int h, int hk, int sq, int sk, int d, float sm_scale, float softcap, int causal,    \
      XFA_MASK_ARGS, const void *fm_bands, void *counters, XFA_BIAS_ARGS, void *stream
#define XFA_BWD_PARAMS                                                                         \
  const xfa::MaskParams mask = XFA_MASK_VALUES;                                                \
  const bool masked = xfa::mask_active(mask);                                                  \
  const BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta),          \
                    static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),    \
                    dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, b, h, hk,   \
                    sq, sk, sm_scale, softcap, causal, mask,                                   \
                    static_cast<const int4*>(fm_bands),                                        \
                    static_cast<int*>(counters), XFA_BIAS_VALUES};                             \
  cudaStream_t s = static_cast<cudaStream_t>(stream);                                          \
  if (masked) {                                                                                \
    if (counters == nullptr) return static_cast<int>(cudaErrorInvalidValue);                   \
    const cudaError_t err = cudaMemsetAsync(counters, 0, 3 * sizeof(int), s);                  \
    if (err != cudaSuccess) return static_cast<int>(err);                                      \
  }

XFA_EXPORT int xfa_flash_bwd_dkv(XFA_BWD_ARGS) {
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if ((d != 64 && d != 128) || sq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  XFA_BWD_PARAMS;
  CUtensorMap maps[8] = {};
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kDkvRows) ||
      !sm90::encode_bhsd(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kDkvRows) ||
      !sm90::encode_bhsd(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, kDkvKeys) ||
      !sm90::encode_bhsd(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, kDkvKeys) ||
      !sm90::encode_flat_f32(&maps[4], lse, static_cast<int64_t>(b) * h * sq, kStatBox) ||
      !sm90::encode_flat_f32(&maps[5], delta, static_cast<int64_t>(b) * h * sq, kStatBox) ||
      (masked && q_info != nullptr &&
       (!sm90::encode_rows_i32x4(&maps[6], q_info, static_cast<int64_t>(b) * q_pad, kDkvRows) ||
        !sm90::encode_rows_i32x4(&maps[7], k_info, static_cast<int64_t>(b) * k_pad, kDkvKeys))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d == 64) err = masked ? launch_dkv<64, true>(maps, p, s) : launch_dkv<64, false>(maps, p, s);
  else err = masked ? launch_dkv<128, true>(maps, p, s) : launch_dkv<128, false>(maps, p, s);
  return static_cast<int>(err);
}

XFA_EXPORT int xfa_flash_bwd_dq(XFA_BWD_ARGS) {
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if ((d != 64 && d != 128) || sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  XFA_BWD_PARAMS;
  CUtensorMap maps[7] = {};
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kDqRows) ||
      !sm90::encode_bhsd(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kDqRows) ||
      !sm90::encode_bhsd(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, dq_keys(d)) ||
      !sm90::encode_bhsd(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, dq_keys(d)) ||
      (fm_bands != nullptr &&
       !sm90::encode_rows_i32x4(&maps[4], fm_bands,
                                static_cast<int64_t>(b) * fm_heads * fm_skp, dq_keys(d))) ||
      (masked && k_info != nullptr &&
       (!sm90::encode_rows_i32x4(&maps[5], k_info, static_cast<int64_t>(b) * k_pad, dq_keys(d)) ||
        !sm90::encode_rows_i32x4(&maps[6], q_info, static_cast<int64_t>(b) * q_pad, kDqRows))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (d == 64) err = masked ? launch_dq<64, true>(maps, p, s) : launch_dq<64, false>(maps, p, s);
  else err = masked ? launch_dq<128, true>(maps, p, s) : launch_dq<128, false>(maps, p, s);
  return static_cast<int>(err);
}
