// fp32 attention on the tensor cores: the forward, and the backward's dK/dV
// and dQ kernels, every product as three TF32 products (wgmma .tf32), fed
// by TMA rings.
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
//     both also through strides for fused_heads.py:105 `_bwd_kernel` (#6).
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
// Forward design (flash_fwd_fp32_kernel<D, PAGED, SOFTCAP>): a block is 128
// query rows of one (batch, head), consumer c owning rows [64c, 64c + 64);
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
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = xfa::sm90;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // the converters need the 56
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kDqRows = 128;     // query rows of a dQ block (64 a consumer)
// k-steps issued before a wait (d 128's dK/dV accumulators leave fewer registers)
template <int D>
constexpr int kChunk = D == 64 ? 8 : 2;

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
// paged producer and converters need 64 (at 56 they spilled), and the
// consumers may take only what the producer gives up, 128 x (168 - 64) >=
// 256 x (216 - 168) (more, and setmaxnreg.inc waits forever).
constexpr int kFwdProducerRegs = 64, kFwdConsumerRegs = 216;
static_assert(128 * (168 - kFwdProducerRegs) >= 256 * (kFwdConsumerRegs - 168),
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
};

template <int D>
struct FwdSmem {
  static constexpr int kQ = kFwdRows * D * 4;     // the resident q block
  static constexpr int kT = kFwdKeys<D> * D * 4;  // a tile of a stage
  // a stage: K (landed raw: its hi), K lo, V (landed raw), V^T hi, V^T lo
  static constexpr int kStage = 5 * kT;
  // barriers: Q full, Q empty, then per stage full, ready, empty
  static constexpr int kBar = kQ + kFwdStages * kStage;
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
template <int L, bool PAGED>
__device__ __forceinline__ bool fwd_block(const Fp32Params& p, int pair, int half, int n_mb,
                                          FwdBlock& fb) {
  int m_block;
  if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, fb.head, fb.batch)) return false;
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
// MASK the elementwise test against each row's keys [lo, hi]; then the
// running max m, s = P in fp32 (ex2 with the max and log2(e) folded in),
// this thread's share of the row sums l (the quad is summed at the end) and
// alpha, the factor that takes the running O to the new max.
template <int L, bool MASK, bool SOFTCAP>
__device__ __forceinline__ void fwd_softmax(float (&s)[L / 2], float (&m)[2], float (&l)[2],
                                            float (&alpha)[2], int n0, const int (&lo)[2],
                                            const int (&hi)[2], float cap, int t) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int r = (i >> 1) & 1;
    float x = s[i];
    if constexpr (SOFTCAP) x = tanhf(x / cap) * cap;
    if constexpr (MASK) {
      const int key = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
      if ((key < lo[r]) | (key > hi[r])) x = -INFINITY;
    }
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

template <int D, bool PAGED, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const Fp32Params p) {
  using S = FwdSmem<D>;
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

  // Every role walks the same blocks and counts the same q loads (qk) and
  // key tiles (it, the ring position), so stages and parities agree. A
  // block whose rows see no key loads nothing; its O is zeros, its LSE +inf.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 0) {  // the loads: a block's first tiles, then its q
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          FwdBlock fb;
          if (!fwd_block<L, PAGED>(p, pair, half, n_mb, fb) || fb.n == 0) continue;
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
          if (!fwd_block<L, PAGED>(p, pair, half, n_mb, fb)) continue;
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
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        FwdBlock fb;
        if (!fwd_block<L, PAGED>(p, pair, half, n_mb, fb)) continue;
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
        float o[D / 2];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
        float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
        if (fb.n > 0) {
          sm90::mbar_wait(bar_q, qk & 1);
          ++qk;
          // q_s = q * sm_scale in place over this consumer's rows
          float4* q4 = reinterpret_cast<float4*>(smem) + 64 * cw * 8;
          for (int j = 0; j < D / 32; ++j) {
            for (int i = wt; i < 64 * 8; i += 128) {
              float4& x = q4[j * kFwdRows * 8 + i];
              x = make_float4(x.x * p.sm_scale, x.y * p.sm_scale, x.z * p.sm_scale,
                              x.w * p.sm_scale);
            }
          }
          sm90::fence_proxy_async();  // before the next block's TMA overwrites them
          sm90::named_barrier(2 + cw, 128);
          for (int i = 0; i < fb.n; ++i, ++it) {
            const int st = it % kStages, use = it / kStages;
            const int n0 = (fb.first + i) * L;
            const uint32_t stage = base + S::kQ + st * S::kStage;
            if (tma_tiles) sm90::mbar_wait(bar_full + 8 * st, use & 1);
            sm90::mbar_wait(bar_ready + 8 * st, use & 1);
            if (has_rows && n0 <= hi_b && n0 + L - 1 >= lo_a) {
              float s[L / 2];
#pragma unroll
              for (int j = 0; j < L / 2; ++j) s[j] = 0.f;
              // S = q_s K^T
              product_a_smem<D, L, kFwdChunk>(s, smem, kFwdRows, 64 * cw, stage, stage + S::kT,
                                              w, g, t);
              float alpha[2];
              if (rc0 + 64 <= p.sq && n0 >= lo_b && n0 + L - 1 <= hi_a) {
                fwd_softmax<L, false, SOFTCAP>(s, m, l, alpha, n0, lo, hi, p.softcap, t);
              } else {
                fwd_softmax<L, true, SOFTCAP>(s, m, l, alpha, n0, lo, hi, p.softcap, t);
              }
#pragma unroll
              for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
              // O += P V, the tile's part on the tensor cores, added in fp32
              float pv[D / 2];
              issue_a_acc<D, L>(pv, s, stage + 3 * S::kT, stage + 4 * S::kT);
              sm90::wgmma_commit();
              sm90::wgmma_wait<0>();
              add_part(o, pv);
            }
            if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
          }
          if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s
        }
        // O / l, divided as the plain version divides; 0 where a row saw nothing
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float lr = l[r];
          lr += __shfl_xor_sync(0xffffffffu, lr, 1);
          lr += __shfl_xor_sync(0xffffffffu, lr, 2);
          const int row = row0 + 8 * r;
          if (row >= p.sq) continue;
          float* orow = p.out + fb.batch * p.o_sb + fb.head * p.o_sh + row * p.o_ss;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float2 v = lr > 0.f ? make_float2(o[4 * j + 2 * r] / lr, o[4 * j + 2 * r + 1] / lr)
                                      : make_float2(0.f, 0.f);
            *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = v;
          }
          if (p.lse_out != nullptr && t == 0)
            p.lse_out[(static_cast<int64_t>(fb.batch) * p.h + fb.head) * p.sq + row] =
                lr > 0.f ? m[r] + logf(lr) : INFINITY;
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
};

// P and dS of one element from its score x and dP, the row's LSE times
// log2(e) and delta: P = 2^(x log2(e) - lse2) on the SFU (ex2.approx, about
// 2^-22 of P; x log2(e) rounded once in the FMA), 0 where not visible.
template <bool SOFTCAP>
__device__ __forceinline__ void p_ds(float x, float& dp, float lse2, float delta, bool vis,
                                     float cap, float& pr) {
  float fac = 1.f;
  if constexpr (SOFTCAP) {
    const float th = tanhf(x / cap);
    x = th * cap;
    fac = 1.f - th * th;
  }
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
// -> dS^T); rows this thread's keys key0 and key0 + 8 (visible to rows
// [lo[r], hi[r]]), columns the tile's rows m0 + c with their LSE and delta
// from the stage.
template <int R, bool MASK, bool SOFTCAP>
__device__ __forceinline__ void dkv_p_ds(float (&s)[R / 2], float (&dp)[R / 2], const float* lse,
                                         const float* delta, const int (&lo)[2],
                                         const int (&hi)[2], int m0, float cap, int t) {
#pragma unroll
  for (int i = 0; i < R / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1), r = (i >> 1) & 1;
    const bool vis = !MASK || ((m0 + c >= lo[r]) & (m0 + c <= hi[r]));
    p_ds<SOFTCAP>(s[i], dp[i], lse[c] * sm90::kLog2e, delta[c], vis, cap, s[i]);
  }
}

// dQ: dS of one key tile in place (dp: dP -> dS) from S; rows this
// thread's rows row0 and row0 + 8 (LSE times log2(e) and delta per row,
// keys [lo[r], hi[r]] visible), columns the tile's keys n0 + c.
template <int L, bool MASK, bool SOFTCAP>
__device__ __forceinline__ void dq_ds(const float (&s)[L / 2], float (&dp)[L / 2],
                                      const float (&lse2)[2], const float (&delta)[2],
                                      const int (&lo)[2], const int (&hi)[2], int n0, float cap,
                                      int t) {
#pragma unroll
  for (int i = 0; i < L / 2; ++i) {
    const int r = (i >> 1) & 1, key = n0 + (i >> 2) * 8 + 2 * t + (i & 1);
    const bool vis = !MASK || ((key >= lo[r]) & (key <= hi[r]));
    float pr;
    p_ds<SOFTCAP>(s[i], dp[i], lse2[r], delta[r], vis, cap, pr);
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

template <int D>
struct DkvSmem {
  using T = BwdTiles<D>;
  static constexpr int kStages = T::kDkvStages;
  static constexpr int kKV = T::kKeys * D * 4;  // K or V of a block
  static constexpr int kT = T::kRows * D * 4;   // a tile of a stage
  // a stage: q_s (landed raw: its hi), q_s lo, q_s^T hi, q_s^T
  // lo, then the same four of dO, then the LSE and delta boxes
  static constexpr int kStatBox = T::kRows + 4;
  static constexpr int kStats = 8 * kT;
  static constexpr int kStage = 8 * kT + 1024;
  static constexpr int kRing = 2 * kKV;
  // barriers: K/V full, K/V empty, then per stage full, ready, empty
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
  static_assert(kStatBox * 4 <= 512, "the LSE and delta boxes fit their half KB");
};

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tlse,
                              const __grid_constant__ CUtensorMap tdelta,
                              const Fp32BwdParams p) {
  using S = DkvSmem<D>;
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

  // Every role walks the same blocks and counts the same K/V loads (kv) and
  // query tiles (it, the ring position), so stages and parities agree. A
  // block whose keys no row sees loads nothing; its dK and dV are zeros.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {  // the loads
      int it = 0, kv = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch, first, n_qt;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
          const int n0 = n_block * kKeys;
          query_tiles<R>(p, n0, kKeys, first, n_qt);
          if (n_qt == 0) continue;
          sm90::mbar_wait(bar_kve, (kv & 1) ^ 1);  // the first pass is free
          sm90::mbar_expect_tx(bar_kv, 2 * S::kKV);
          for (int j = 0; j < D / 32; ++j) {
            sm90::tma_load_4d(base + j * kKeys * 128, &tk, bar_kv, 32 * j, n0, kv_head, batch);
            sm90::tma_load_4d(base + S::kKV + j * kKeys * 128, &tv, bar_kv, 32 * j, n0, kv_head,
                              batch);
          }
          ++kv;
          for (int gi = 0; gi < group; ++gi) {
            const int head = kv_head * group + gi;
            const int stat0 = (batch * p.h + head) * p.sq;
            for (int i = 0; i < n_qt; ++i, ++it) {
              const int st = it % kStages;
              const uint32_t stage = base + S::kRing + st * S::kStage;
              const int m0 = (first + i) * R;
              sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
              sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT + 2 * S::kStatBox * 4);
              for (int j = 0; j < D / 32; ++j) {
                sm90::tma_load_4d(stage + j * R * 128, &tq, bar_full + 8 * st, 32 * j, m0, head,
                                  batch);
                sm90::tma_load_4d(stage + 4 * S::kT + j * R * 128, &tdo, bar_full + 8 * st,
                                  32 * j, m0, head, batch);
              }
              const int c0 = (stat0 + m0) & ~3;  // a 1-D box starts 16-byte aligned
              sm90::tma_load_1d(stage + S::kStats, &tlse, bar_full + 8 * st, c0);
              sm90::tma_load_1d(stage + S::kStats + 512, &tdelta, bar_full + 8 * st, c0);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters, stage by stage
      int n = 0;  // this CTA's query tiles
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch, first, n_qt;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
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
    sm90::setmaxnreg_inc<kConsumerRegs>();
    constexpr int kCols = T::kKeySplit ? D : 64;  // dK and dV columns a consumer owns
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const int kc = T::kKeySplit ? 64 * cw : 0;    // this consumer's first key in the block
    const int col0 = T::kKeySplit ? 0 : 64 * cw;  // and its first column
    int it = 0, kv = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int n_block, kv_head, batch, first, n_qt;
        if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
        const int n0 = n_block * kKeys;
        query_tiles<R>(p, n0, kKeys, first, n_qt);
        const int key0 = n0 + kc + 16 * w + g;  // this thread's keys: key0, key0 + 8
        int lo[2], hi[2];  // the rows each of them is visible to
        key_rows(p, key0, lo[0], hi[0]);
        key_rows(p, key0 + 8, lo[1], hi[1]);
        float* dk_out = p.dk + batch * p.dk_sb + kv_head * p.dk_sh + col0;
        float* dv_out = p.dv + batch * p.dv_sb + kv_head * p.dv_sh + col0;
        float dk[kCols / 2], dv[kCols / 2];
#pragma unroll
        for (int j = 0; j < kCols / 2; ++j) dk[j] = dv[j] = 0.f;
        if (n_qt > 0) {
          sm90::mbar_wait(bar_kv, kv & 1);
          ++kv;
        }
        for (int idx = 0; idx < group * n_qt; ++idx, ++it) {
          const int st = it % kStages, use = it / kStages;
          const int gi = idx / n_qt, m0 = (first + idx - gi * n_qt) * R;
          const uint32_t stage = base + S::kRing + st * S::kStage;
          const uint8_t* sp = smem + S::kRing + st * S::kStage;
          sm90::mbar_wait(bar_full + 8 * st, use & 1);  // the LSE and delta
          sm90::mbar_wait(bar_ready + 8 * st, use & 1);
          float s[R / 2], dp[R / 2];
#pragma unroll
          for (int j = 0; j < R / 2; ++j) s[j] = dp[j] = 0.f;
          // S^T = K q_s^T, dP^T = V dO^T
          product_a_smem<D, R>(s, smem, kKeys, kc, stage, stage + S::kT, w, g, t);
          product_a_smem<D, R>(dp, smem + S::kKV, kKeys, kc, stage + 4 * S::kT,
                               stage + 5 * S::kT, w, g, t);
          const int stat0 = (batch * p.h + kv_head * group + gi) * p.sq;
          const float* lse = reinterpret_cast<const float*>(sp + S::kStats) + ((stat0 + m0) & 3);
          const float* delta = lse + 128;  // 512 bytes on
          if (all_visible(p, m0, R, n0 + kc, 64)) {
            dkv_p_ds<R, false, SOFTCAP>(s, dp, lse, delta, lo, hi, m0, p.softcap, t);
          } else {
            dkv_p_ds<R, true, SOFTCAP>(s, dp, lse, delta, lo, hi, m0, p.softcap, t);
          }
          // dV += P^T dO, dK += dS^T q_s over this consumer's columns (the
          // transposes' rows col0 on), one wait for both
          const uint32_t cols = col0 * 4 * R;
          float pv[kCols / 2], pk[kCols / 2];
          issue_a_acc<kCols, R>(pv, s, stage + 6 * S::kT + cols, stage + 7 * S::kT + cols);
          issue_a_acc<kCols, R>(pk, dp, stage + 2 * S::kT + cols, stage + 3 * S::kT + cols);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          add_part(dv, pv);
          add_part(dk, pk);
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);  // one arrival per warp
        }
        store_acc<kCols>(dk_out, p.dk_ss, dk, key0, p.sk, 1.f, t);
        store_acc<kCols>(dv_out, p.dv_ss, dv, key0, p.sk, 1.f, t);
        if (n_qt > 0 && lane == 0) sm90::mbar_arrive(bar_kve);
      }
    }
  }
}

// ---- dQ

template <int D>
struct DqSmem {
  using T = BwdTiles<D>;
  static constexpr int kStages = T::kDqStages;
  static constexpr int kQ = kDqRows * D * 4;      // q_s or dO of a block
  static constexpr int kT = T::kDqKeys * D * 4;   // a tile of a stage
  // a stage: K (landed raw: its hi), K lo, K^T hi, K^T lo, V (raw), V lo
  static constexpr int kStage = 6 * kT;
  static constexpr int kRing = 2 * kQ;
  // barriers: Q full, Q empty, then per stage full, ready, empty
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (2 + 3 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_fp32_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv, const Fp32BwdParams p) {
  using S = DqSmem<D>;
  constexpr int L = BwdTiles<D>::kDqKeys, kStages = S::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 8;
  const uint32_t bar_full = bar_qe + 8, bar_ready = bar_full + 8 * kStages,
                 bar_empty = bar_ready + 8 * kStages;
  const int n_mb = (p.sq + kDqRows - 1) / kDqRows;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);

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

  // As dK/dV: every role walks the same blocks, Q loads (qk) and key tiles
  // (it); a block whose rows see no key loads nothing and writes zeros.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {  // the loads
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, first, n_kt;
          if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
          const int q0 = m_block * kDqRows;
          key_tiles<L>(p, q0, kDqRows, first, n_kt);
          if (n_kt == 0) continue;
          const int kv_head = head / (p.h / p.hk);
          sm90::mbar_wait(bar_qe, (qk & 1) ^ 1);
          sm90::mbar_expect_tx(bar_q, 2 * S::kQ);
          for (int j = 0; j < D / 32; ++j) {
            sm90::tma_load_4d(base + j * kDqRows * 128, &tq, bar_q, 32 * j, q0, head, batch);
            sm90::tma_load_4d(base + S::kQ + j * kDqRows * 128, &tdo, bar_q, 32 * j, q0, head,
                              batch);
          }
          ++qk;
          for (int i = 0; i < n_kt; ++i, ++it) {
            const int st = it % kStages;
            const uint32_t stage = base + S::kRing + st * S::kStage;
            const int n0 = (first + i) * L;
            sm90::mbar_wait(bar_empty + 8 * st, ((it / kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(bar_full + 8 * st, 2 * S::kT);
            for (int j = 0; j < D / 32; ++j) {
              sm90::tma_load_4d(stage + j * L * 128, &tk, bar_full + 8 * st, 32 * j, n0, kv_head,
                                batch);
              sm90::tma_load_4d(stage + 4 * S::kT + j * L * 128, &tv, bar_full + 8 * st, 32 * j,
                                n0, kv_head, batch);
            }
          }
        }
      }
    } else if (threadIdx.x >= 32) {  // the converters, stage by stage
      int n = 0;  // this CTA's key tiles
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, first, n_kt;
          if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
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
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int w = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, qk = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int m_block, head, batch, first, n_kt;
        if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
        const int q0 = m_block * kDqRows;
        key_tiles<L>(p, q0, kDqRows, first, n_kt);
        const int r0 = q0 + 64 * cw;                 // this consumer's first row
        const int row0 = r0 + 16 * w + g;            // this thread's rows: row0, row0 + 8
        float* dq_out = p.dq + batch * p.dq_sb + head * p.dq_sh;
        float dq[D / 2];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
        if (n_kt == 0) {
          store_acc<D>(dq_out, p.dq_ss, dq, row0, p.sq, 1.f, t);
          continue;
        }
        const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
        float lse2[2], delta[2];
        int lo[2], hi[2];  // the keys each row sees
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          lse2[r] = row < p.sq ? p.lse[stat + row] * sm90::kLog2e : INFINITY;
          delta[r] = row < p.sq ? p.delta[stat + row] : 0.f;
          row_keys(p, row, lo[r], hi[r]);
        }
        sm90::mbar_wait(bar_q, qk & 1);
        ++qk;
        for (int i = 0; i < n_kt; ++i, ++it) {
          const int st = it % kStages, use = it / kStages;
          const int n0 = (first + i) * L;
          const uint32_t stage = base + S::kRing + st * S::kStage;
          sm90::mbar_wait(bar_full + 8 * st, use & 1);
          sm90::mbar_wait(bar_ready + 8 * st, use & 1);
          float s[L / 2], dp[L / 2];
#pragma unroll
          for (int j = 0; j < L / 2; ++j) s[j] = dp[j] = 0.f;
          // S = q_s K^T, dP = dO V^T
          product_a_smem<D, L>(s, smem, kDqRows, 64 * cw, stage, stage + S::kT, w, g, t);
          product_a_smem<D, L>(dp, smem + S::kQ, kDqRows, 64 * cw, stage + 4 * S::kT,
                               stage + 5 * S::kT, w, g, t);
          if (all_visible(p, r0, 64, n0, L)) {
            dq_ds<L, false, SOFTCAP>(s, dp, lse2, delta, lo, hi, n0, p.softcap, t);
          } else {
            dq_ds<L, true, SOFTCAP>(s, dp, lse2, delta, lo, hi, n0, p.softcap, t);
          }
          float pq[D / 2];  // dQ += dS K
          issue_a_acc<D, L>(pq, dp, stage + 2 * S::kT, stage + 3 * S::kT);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          add_part(dq, pq);
          if (lane == 0) sm90::mbar_arrive(bar_empty + 8 * st);
        }
        if (lane == 0) sm90::mbar_arrive(bar_qe);  // done with q_s and dO
        store_acc<D>(dq_out, p.dq_ss, dq, row0, p.sq, p.sm_scale, t);
      }
    }
  }
}

// ------------------------------------------------------------ launches

// One persistent CTA per SM, or one per pair of blocks when there are fewer.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int bytes, std::atomic<uint64_t>& done, int pairs,
                     int& grid) {
  int sms = 0;
  cudaError_t err = sm90::smem_limit_once(kernel, bytes, done);
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  grid = pairs < sms ? pairs : sms;
  return err;
}

template <int D, bool SOFTCAP>
cudaError_t launch_dkv(const CUtensorMap* maps, const Fp32BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  const int n_nb = (p.sk + BwdTiles<D>::kKeys - 1) / BwdTiles<D>::kKeys;
  int grid = 0;
  const cudaError_t err = persistent_grid(flash_bwd_dkv_fp32_kernel<D, SOFTCAP>, DkvSmem<D>::kBytes,
                                   done, xfa::block_pairs(n_nb, p.hk, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fp32_kernel<D, SOFTCAP><<<grid, kThreads, DkvSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
cudaError_t launch_dq(const CUtensorMap* maps, const Fp32BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  int grid = 0;
  const cudaError_t err =
      persistent_grid(flash_bwd_dq_fp32_kernel<D, SOFTCAP>, DqSmem<D>::kBytes, done,
               xfa::block_pairs((p.sq + kDqRows - 1) / kDqRows, p.h, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fp32_kernel<D, SOFTCAP><<<grid, kThreads, DqSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(int which, const CUtensorMap* maps, const Fp32BwdParams& p,
                       cudaStream_t s) {
  if (which == 0)
    return p.softcap > 0.f ? launch_dkv<D, true>(maps, p, s) : launch_dkv<D, false>(maps, p, s);
  return p.softcap > 0.f ? launch_dq<D, true>(maps, p, s) : launch_dq<D, false>(maps, p, s);
}

template <int D, bool PAGED, bool SOFTCAP>
cudaError_t launch_fwd(const CUtensorMap* maps, const Fp32Params& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  int grid = 0;
  const cudaError_t err =
      persistent_grid(flash_fwd_fp32_kernel<D, PAGED, SOFTCAP>, FwdSmem<D>::kBytes, done,
                      xfa::block_pairs((p.sq + kFwdRows - 1) / kFwdRows, p.h, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_fwd_fp32_kernel<D, PAGED, SOFTCAP><<<grid, kThreads, FwdSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fwd_d(const CUtensorMap* maps, const Fp32Params& p, bool paged,
                         cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  if (paged)
    return cap ? launch_fwd<D, true, true>(maps, p, s) : launch_fwd<D, true, false>(maps, p, s);
  return cap ? launch_fwd<D, false, true>(maps, p, s) : launch_fwd<D, false, false>(maps, p, s);
}

}  // namespace

// q, out: (b, h, sq, d) fp32 by element strides (batch, head, seq); k, v:
// (b, hk, sk, d) by strides, or, with `table`, both the pages (num_pages,
// hk, 2, ps, d) fp32 contiguous (the strides unused, sk = npp * ps) with
// `table` (b, npp) int32 and `lengths` (b,) int32 (key count per batch row,
// its last sq keys the queries'); every row's head dim contiguous, every
// pointer and stride a multiple of 4 elements (16 bytes; q, k and v are
// read through TMA tensor maps). lse: (b, h, sq) fp32 contiguous or null.
// window: left, right (-1 no bound; causal is right 0).
XFA_EXPORT int xfa_flash_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                  int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                  int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                                  int64_t o_ss, int b, int h, int hk, int sq, int sk, int d,
                                  float sm_scale, float softcap, int left, int right,
                                  const void* table, const void* lengths, int ps, int npp,
                                  int num_pages, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (table != nullptr) != (lengths != nullptr) ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool paged = table != nullptr;
  const int keys = d == 64 ? kFwdKeys<64> : kFwdKeys<128>;
  Fp32Params p{};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch_fwd_d<64>(maps, p, paged, s)
                                  : launch_fwd_d<128>(maps, p, paged, s));
}

// which: 0 dK/dV, 1 dQ. q is q_s = q * sm_scale (flash_bwd.cu's pre-pass,
// fp32), (b, h, sq, d) like dout and dq; k, v, dk, dv (b, hk, sk, d); the
// 21 element strides (batch, head, seq) of q, k, v, dout, dq, dk, dv; every
// row's head dim contiguous, pointers and strides multiples of 4 elements
// (q_s, k, v and dout are read through TMA tensor maps). lse, delta: (b, h,
// sq) fp32 contiguous. Each launch overwrites its outputs (zero where no
// pair is visible).
XFA_EXPORT int xfa_flash_bwd_fp32(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                  int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                  int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                                  int64_t v_ss, int64_t do_sb, int64_t do_sh, int64_t do_ss,
                                  int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, int64_t dk_sb,
                                  int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh,
                                  int64_t dv_ss, int b, int h, int hk, int sq, int sk, int d,
                                  float sm_scale, float softcap, int left, int right, int which,
                                  void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (d != 64 && d != 128) || (which != 0 && which != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Fp32BwdParams p{static_cast<const float*>(lse), static_cast<const float*>(delta),
                        static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv),
                        dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, b, h, hk,
                        sq, sk, sm_scale, softcap, left, right};
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(d == 64 ? launch_bwd<64>(which, maps, p, s)
                                  : launch_bwd<128>(which, maps, p, s));
}
