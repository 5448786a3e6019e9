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
//   - dQ (flash_bwd_dq_kernel, in flash_bwd_dq.cu, a source of its own so
//     that nvcc compiles it beside this one; what the two share is in
//     flash_bwd.cuh): a block is 128 query rows of one (batch, head) with q_s and dO resident (two buffers); K/V tiles (128 keys at
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
//
// * Attention dropout (DROPOUT, both kernels and instantiations, no bias;
//   bwd.py:158-172 of the TPU package): each consumer thread
//   regenerates the forward's keep mask inside the P / dS loop, one hash
//   per element (common.cuh dropout_base / dropout_keep_at; dK/dV's
//   transposed fragment has its keys as rows): dP is 0 where the mask
//   drops and times 1 / (1 - p) where it keeps, dS = P (dP - delta) with
//   the undropped P, and dV takes the dropped P, its 1 / (1 - p) in the
//   epilogue. Hashed in the loop rather than in a pass of its own before
//   it, the masked instantiations spill less (PERF.md section 6). The
//   pre-pass is unchanged: delta = rowsum(dO O) and O carries the dropout.
#include "flash_bwd.cuh"

namespace {

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

// ---- the elementwise work of dK/dV

// dK/dV: P^T and dS^T of one query tile, in place in fp32 (s: S^T -> P^T,
// dp: dP^T -> dS^T), this thread's keys key0 and key0 + 8 as rows and the
// tile's rows m0 + c as columns; LSE and delta per column from shared
// memory; with MASK the elementwise causal / sq test, with NB > 0 also the
// first NB FlashMask bands of the two keys (b0, b1); with BIAS the tile's
// bias `bv` (common.cuh load_bias_cols); with DROP the tile's dropout `dt`
// base `dbase` (common.cuh dropout_base, transposed), each element hashed in
// the loop.
template <bool MASK, bool SOFTCAP, int NB = 0, bool BIAS = false, bool DROP = false>
__device__ __forceinline__ void dkv_p_ds(float (&s)[kDkvRows / 2], float (&dp)[kDkvRows / 2],
                                         const float* lse, const float* delta, int key0, int m0,
                                         const BwdParams& p, int t, int4 b0 = int4{},
                                         int4 b1 = int4{}, const float* bv = nullptr,
                                         uint32_t dbase = 0) {
#pragma unroll
  for (int i = 0; i < kDkvRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);  // the query row in the tile
    bool visible = true;
    if (MASK) {
      const int key = key0 + ((i >> 1) & 1) * 8, row = m0 + c;
      visible = row < p.sq && (!p.causal || key <= row + p.sk - p.sq);
      if (NB > 0) visible = visible & !xfa::banned<NB>((i >> 1) & 1 ? b1 : b0, row);
    }
    p_ds<SOFTCAP, BIAS, DROP>(
        s[i], dp[i], lse[c] * kLog2e, delta[c], visible, p.softcap, s[i], dp[i],
        BIAS ? bv[i] : 0.f, DROP ? xfa::dropout_keep_at<true>(dbase, p.drop.threshold, i) : true,
        p.drop.scale);
  }
}

// dK/dV's elementwise test in the masked instantiations, all bitwise: the
// rows that see this thread's keys key0 and key0 + 8 by the row/key window
// and below sq (common.cuh key_limit), with NB > 0 the keys' first NB
// FlashMask bands (b0, b1) and with INFO each row's segment id and position
// (`qinfo`, in the stage) against the key's (`kinfo`: key0's, staged with
// K/V; key0 + 8's 8 further); P and dS as dkv_p_ds.
template <bool SOFTCAP, int NB, bool INFO, bool BIAS = false, bool DROP = false>
__device__ __forceinline__ void dkv_p_ds_masked(float (&s)[kDkvRows / 2],
                                                float (&dp)[kDkvRows / 2], const float* lse,
                                                const float* delta, int key0, int m0,
                                                const int4* qinfo, const int4* kinfo,
                                                const BwdParams& p, int t, int4 b0, int4 b1,
                                                const float* bv = nullptr,
                                                uint32_t dbase = 0) {
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
    p_ds<SOFTCAP, BIAS, DROP>(
        s[i], dp[i], lse[c] * kLog2e, delta[c], visible, p.softcap, s[i], dp[i],
        BIAS ? bv[i] : 0.f, DROP ? xfa::dropout_keep_at<true>(dbase, p.drop.threshold, i) : true,
        p.drop.scale);
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

template <int D, bool SOFTCAP, bool MASKED, bool BIAS, bool DROPOUT = false>
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
        // DROPOUT: the forward's keep mask regenerated in the loops below
        // (rows of the transposed fragment are this thread's keys)
        uint32_t dbase = 0;
        if constexpr (DROPOUT)
          dbase = xfa::dropout_base<true>(
              xfa::dropout_key(p.drop, batch, kv_head * group + gi, p.h), key0, m0, t);
        if (!(flags & kElem)) {
          dkv_p_ds<false, SOFTCAP, 0, BIAS, DROPOUT>(s, dp, lse, delta, key0, m0, p, t, {}, {}, bv,
                                                     dbase);
        } else if constexpr (!MASKED) {
          dkv_p_ds<true, SOFTCAP, 0, BIAS, DROPOUT>(s, dp, lse, delta, key0, m0, p, t, {}, {}, bv,
                                                    dbase);
        } else {
          const int4* qinfo = reinterpret_cast<const int4*>(stage + S::kQInfo);
          const int4* kinfo = reinterpret_cast<const int4*>(smem + S::kKInfo +
                                                            kb * kBlockInfoBytes) +
                              (key0 - n0);
#define XFA_DKV(NB, I)                                                                    \
  dkv_p_ds_masked<SOFTCAP, NB, I, BIAS, DROPOUT>(s, dp, lse, delta, key0, m0, qinfo, kinfo, p, \
                                                 t, b0, b1, bv, dbase)
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
      store_rows<D>(p.dv + batch * p.dv_sb + kv_head * p.dv_sh, p.dv_ss, dv, key0, p.sk,
                    DROPOUT ? p.drop.scale : 1.f, t);
    }
  }
}

template <int D, bool SOFTCAP, bool MASKED, bool BIAS, bool DROPOUT = false>
cudaError_t launch_dkv_kernel(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = sm90::smem_limit_once(flash_bwd_dkv_kernel<D, SOFTCAP, MASKED, BIAS, DROPOUT>,
                                          DkvSmem<D, MASKED>::kBytes, done);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size((p.sk + kDkvKeys - 1) / kDkvKeys, p.hk, p, MASKED, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<D, SOFTCAP, MASKED, BIAS, DROPOUT>
      <<<grid, kThreads, DkvSmem<D, MASKED>::kBytes, s>>>(maps[0], maps[1], maps[2], maps[3],
                                                         maps[4], maps[5], maps[6], maps[7], p);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dkv(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  if (p.drop.on)
    return p.softcap > 0.f ? launch_dkv_kernel<D, true, MASKED, false, true>(maps, p, s)
                           : launch_dkv_kernel<D, false, MASKED, false, true>(maps, p, s);
  if (p.bias.ptr != nullptr)
    return p.softcap > 0.f ? launch_dkv_kernel<D, true, MASKED, true>(maps, p, s)
                           : launch_dkv_kernel<D, false, MASKED, true>(maps, p, s);
  return p.softcap > 0.f ? launch_dkv_kernel<D, true, MASKED, false>(maps, p, s)
                         : launch_dkv_kernel<D, false, MASKED, false>(maps, p, s);
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
