// fp32 attention: the forward in full fp32 on the CUDA cores (FFMA), and the
// backward's dK/dV and dQ kernels as three TF32 products on the tensor cores
// (wgmma .tf32), fed by TMA rings.
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
// rounded to a narrower type (the backward's TF32 parts, hi and lo, carry
// each operand to within 2^-21).
//
// Arithmetic. The JAX contract for fp32 (err <= 2 err_lp + 1e-4 against an
// fp64 reference, err_lp ~ 1e-6, tests/test_flash_attn.py:23-35) rules out
// a single TF32 product (10 mantissa bits, about three decimal digits).
//   * Forward: every product an fp32 FFMA on the CUDA cores.
//   * Backward: every product A B as three TF32 products into fp32
//     accumulators, A_lo B_hi + A_hi B_lo (into one) and A_hi B_hi (into
//     another), lo·lo dropped. The tensor cores ignore a .tf32 operand's low
//     13 bits (truncation; scripts/tf32_probe.cu shows it on the H100), so
//     the raw fp32 value is its own hi part, x_hi = x & 0xffffe000 as they
//     read it, and x_lo = x - x_hi, exact in fp32 (hopper.cuh tf32_lo), of
//     whose 13 significant bits they keep 11: x = hi + lo to within 2^-21
//     |x|, and lo·lo is below 2^-20 of each product. Rounding with
//     cvt.rna.tf32.f32 would halve the hi error but made the kernels 1.23-
//     1.25x slower (scripts/ab_fp32_bwd.py rna; PERF.md §6, PR 16).
//     reference.py split_tf32 /
//     matmul_tf32x3 emulate this on the CPU (tests/test_torch_tf32x3.py).
//   * The tensor cores add a wgmma's products to its accumulator with
//     truncation too, so a sum kept on them for thousands of products
//     drifts toward zero (dV 1.9e-4 from float64 at sq 1100, GQA 4, against
//     5.7e-6 for the fp32 plain version, before this was done): the hi·hi
//     terms and the small terms sum in two accumulators, and dK, dV and dQ
//     are taken a tile at a time on the tensor cores and added to fp32
//     registers with rounding (product_a_smem, issue_a_acc).
//
// Bound on the H100: operations. FFMA peaks at 67 TFLOP/s; TF32 wgmma at
// 495 TFLOP/s, so the backward's bound is three TF32 products per product
// at that rate (the `chip_smoke.py` rows state the forward's bound the same
// way).
//
// Forward design: blocks of 256 threads (a 16 x 16 grid: ty = tid / 16, tx
// = tid % 16), tiles of 64 rows by 64 keys in shared memory, rows padded by
// four floats so that the 16-byte reads of a quarter warp (eight rows) hit
// every bank once. A thread computes a 4 x 4 part of each score tile, rows
// 4 ty .. 4 ty + 3 against keys tx, tx + 16, tx + 32, tx + 48, from float4
// reads along the head dim; the 16 threads of a row group (half a warp)
// reduce the row max and sum by shuffles; P V reads P back from shared
// memory, written and read by the same half warp, into a 4 x (D / 16)
// accumulator per thread. A block is 64 query rows of one (batch, head); K
// and V tiles come by cp.async, the next K under this tile's softmax and P
// V, the next V under the next scores.
//
// Backward design: flash_bwd.cu's dense backward (persistent CTAs, one per
// SM, blocks in equal-work pairs, common.cuh pair_block) on .tf32 wgmma.
// 384 threads: warpgroup 0 is the producer (setmaxnreg.dec): its thread 0
// issues every TMA load (4-D fp32 maps, hopper.cuh encode_bhsd_f32: boxes of
// 32 columns = one 128-byte swizzle row, so a row of d 64 is two boxes),
// and its warps 1-3 are the converters; warpgroups 1 and 2 are consumers of
// 64 rows each (setmaxnreg.inc). What differs from bf16, and what the
// design does about it:
//   * No transpose bit: .tf32 wgmma takes B from shared memory K-major only.
//     Three products need B with the query or key index contiguous: dV +=
//     P^T dO and dK += dS^T q_s need dO^T and q_s^T, dQ += dS K needs K^T.
//     The converters make them in shared memory from the TMA-landed tile.
//   * The split. A operands are split in registers k-step by k-step (lo =
//     x - x_hi, two instructions; hi is x itself): the resident tiles (K, V
//     in dK/dV; q_s, dO in dQ) are read from shared memory as the m64k8
//     fragment (a[i]: row g + 8 (i % 2), column t + 4 (i / 2)), P^T, dS^T and
//     dS come from the accumulators. B operands need both parts in shared
//     memory: the TMA-landed tile is hi, the converters write lo beside it
//     (and both parts of the transposes), 16 bytes a load or store. Every
//     product is then an RS wgmma issued three times.
//   * P/dS from the accumulators: a thread holds columns 2t and 2t + 1 of
//     each 8, where the A fragment wants t and t + 4. The fragment takes
//     them as they are (a = {x[4kk], x[4kk + 2], x[4kk + 1], x[4kk + 3]}),
//     and the converters write the transposed B rows in the matching
//     permuted k order: query or key 8j + 2t + e at k position 8j + t + 4e
//     (convert_item). No shuffle.
//   * Shared memory (227 KB) binds: an fp32 tile is twice bf16's, and each
//     B operand is there twice (hi, lo), three of them also transposed.
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

constexpr int kThreads = 256;
constexpr int kTile = 64;        // rows and keys of a tile
constexpr int kPad = 4;          // floats of padding per shared-memory row
constexpr int kLdP = kTile + kPad;

template <int D>
constexpr int kLd = D + kPad;

using xfa::cp_async16;
using xfa::cp_async_commit;
using xfa::cp_async_wait;

struct Fp32Params {
  const float* q;  // (b, h, sq, d) by strides
  const float* k;  // (b, hk, sk, d) by strides, or pages (P, hk, 2, ps, d)
  const float* v;
  float* out;      // (b, h, sq, d) by strides
  float* lse_out;  // (b, h, sq) contiguous, or null
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss;
  int h, hk, sq, sk;
  float sm_scale, softcap;
  int left, right;  // the window, -1 no bound; causal is right 0
  // paged K/V (PAGED): key j of batch row b at row j % ps of page
  // table[b * npp + j / ps] (clamped); lengths[b] keys, of which the last
  // sq are the queries (off = lengths[b] - sq)
  const int* table;
  const int* lengths;
  int ps, npp, num_pages;
};

// The keys of batch row `b` (min(length, capacity) when paged) and the
// causal offset of its rows.
template <bool PAGED>
__device__ __forceinline__ void seq_bounds(const Fp32Params& p, int b, int& sk, int& off) {
  if constexpr (PAGED) {
    const int len = p.lengths[b];
    sk = min(len, p.npp * p.ps);
    off = len - p.sq;
  } else {
    sk = p.sk;
    off = p.sk - p.sq;
  }
}

__device__ __forceinline__ bool visible(int r, int j, int off, int sk, int left, int right) {
  return j < sk && j >= 0 && (right < 0 || j <= r + off + right) &&
         (left < 0 || j >= r + off - left);
}

// 64 rows of D floats into shared memory (row stride kLd<D>) by cp.async;
// rows at or past n_valid are zero-filled. row(r) is the global address of
// row r (called for r < n_valid only).
template <int D, typename Row>
__device__ __forceinline__ void load_rows(float* dst, int n_valid, Row row) {
  constexpr int kChunks = D / 4;
#pragma unroll
  for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < n_valid;
    cp_async16(dst + r * kLd<D> + c, row(ok ? r : 0) + c, ok);
  }
}

// acc[i][j] += A[4 ty + i] . B[tx + 16 j] over D (rows of A and B in shared
// memory, stride kLd<D>), the sums in order of the head dim
template <int D>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll 4
  for (int e = 0; e < D; e += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (4 * ty + i) * kLd<D> + e);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * kLd<D> + e);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = acc[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        acc[i][j] = s;
      }
    }
  }
}

// acc[i][4 c + e] += sum_j P[4 ty + i][j] V[j][64 c + 4 tx + e] over the
// tile's 64 keys in order (P stride kLdP, V stride kLd<D>)
template <int D>
__device__ __forceinline__ void pv_tile(float (&acc)[4][D / 16], const float* P, const float* V,
                                        int ty, int tx) {
  constexpr int kC = D / 64;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float4 pr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pr[i] = *reinterpret_cast<const float4*>(P + (4 * ty + i) * kLdP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      float4 vr[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c)
        vr[c] = *reinterpret_cast<const float4*>(V + (j + jj) * kLd<D> + 64 * c + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pj = jj == 0 ? pr[i].x : jj == 1 ? pr[i].y : jj == 2 ? pr[i].z : pr[i].w;
#pragma unroll
        for (int c = 0; c < kC; ++c) {
          acc[i][4 * c] = fmaf(pj, vr[c].x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(pj, vr[c].y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(pj, vr[c].z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(pj, vr[c].w, acc[i][4 * c + 3]);
        }
      }
    }
  }
}

// max and sum over the 16 threads of a row group (lanes tx of one ty)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float softcapped(float s, float cap, float& t) {
  if (cap > 0.f) {
    t = tanhf(s / cap);
    return t * cap;
  }
  t = 0.f;
  return s;
}

// ------------------------------------------------------------------ forward

template <int D>
struct FwdSmem {
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile * kLd<D>;
  static constexpr int kV = kK + kTile * kLd<D>;
  static constexpr int kP = kV + kTile * kLd<D>;
  static constexpr int kBytes = (kP + kTile * kLdP) * 4;
};

template <int D, bool PAGED>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_fwd_fp32_kernel(const Fp32Params p) {
  using S = FwdSmem<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + S::kQ;
  float* k_s = smem + S::kK;
  float* v_s = smem + S::kV;
  float* p_s = smem + S::kP;
  const int m0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int kh = head / (p.h / p.hk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  int sk, off;
  seq_bounds<PAGED>(p, b, sk, off);

  // the key tiles any row of the block sees
  const int r1 = min(m0 + kTile, p.sq) - 1;
  int kmax = sk - 1, kmin = 0;
  if (p.right >= 0) kmax = min(kmax, r1 + off + p.right);
  if (p.left >= 0) kmin = max(kmin, m0 + off - p.left);
  const int t_lo = kmin / kTile;
  const int n_tiles = kmax >= kmin ? kmax / kTile - t_lo + 1 : 0;

  const float* qb = p.q + b * p.q_sb + head * p.q_sh;
  // key j's row of K (which 0) or V (1)
  auto key_row = [&](int which, int j) -> const float* {
    if constexpr (PAGED) {
      const int page = min(max(p.table[static_cast<int64_t>(b) * p.npp + j / p.ps], 0),
                           p.num_pages - 1);
      return p.k + ((static_cast<int64_t>(page) * p.hk + kh) * 2 + which) * p.ps * D +
             static_cast<int64_t>(j % p.ps) * D;
    } else {
      return which == 0 ? p.k + b * p.k_sb + kh * p.k_sh + j * p.k_ss
                        : p.v + b * p.v_sb + kh * p.v_sh + j * p.v_ss;
    }
  };
  auto load_kv = [&](int which, int t) {
    const int n0 = (t_lo + t) * kTile;
    load_rows<D>(which == 0 ? k_s : v_s, min(kTile, sk - n0),
                 [&](int r) { return key_row(which, n0 + r); });
  };

  // q_s = q * sm_scale, rounded to fp32 as the plain version rounds it
  load_rows<D>(q_s, min(kTile, p.sq - m0), [&](int r) { return qb + (m0 + r) * p.q_ss; });
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();
  if (n_tiles > 0) load_kv(1, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  for (int i = tid; i < kTile * D; i += kThreads) {
    float* x = q_s + (i / D) * kLd<D> + i % D;
    *x = *x * p.sm_scale;
  }

  float m_r[4], l_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<1>();  // K(t) (and q) have landed; V(t) may be in flight
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    dot_tile<D>(s, q_s, k_s, ty, tx);
    __syncthreads();  // every thread is done with K(t)
    if (t + 1 < n_tiles) load_kv(0, t + 1);
    cp_async_commit();

    const int n0 = (t_lo + t) * kTile;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + 4 * ty + i;
      float x[4], mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float th;
        const float sc = softcapped(s[i][j], p.softcap, th);
        x[j] = visible(r, n0 + tx + 16 * j, off, sk, p.left, p.right) ? sc : -INFINITY;
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m_r[i], group_max(mx));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_r[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(x[j] - m_use);
        p_s[(4 * ty + i) * kLdP + tx + 16 * j] = pj;
        sum += pj;
      }
      l_r[i] = l_r[i] * alpha + group_sum(sum);
      m_r[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    cp_async_wait<1>();  // V(t) has landed; K(t + 1) may be in flight
    __syncthreads();
    pv_tile<D>(acc, p_s, v_s, ty, tx);
    __syncthreads();  // every thread is done with V(t) and its P rows
    if (t + 1 < n_tiles) load_kv(1, t + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // O = acc / l, divided as the plain version divides
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (m0 + r >= p.sq) continue;
    float* orow = p.out + b * p.o_sb + head * p.o_sh + (m0 + r) * p.o_ss;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float l = l_r[i];
      const float4 o = l > 0.f ? make_float4(acc[i][4 * c] / l, acc[i][4 * c + 1] / l,
                                             acc[i][4 * c + 2] / l, acc[i][4 * c + 3] / l)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(orow + 64 * c + 4 * tx) = o;
    }
    if (p.lse_out != nullptr && tx == 0) {
      p.lse_out[(static_cast<int64_t>(b) * p.h + head) * p.sq + m0 + r] =
          l_r[i] > 0.f ? m_r[i] + logf(l_r[i]) : INFINITY;
    }
  }
}

// ----------------------------------------------------------------- backward

namespace sm90 = xfa::sm90;

constexpr int kBwdThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 56, kConsumerRegs = 224;  // the converters need the 56
constexpr int kConverters = 96;  // warps 1-3 of the producer warpgroup
constexpr int kDqRows = 128;     // query rows of a dQ block (64 a consumer)
// k-steps issued before a wait (d 128's dK/dV accumulators leave fewer registers)
template <int D>
constexpr int kChunk = D == 64 ? 8 : 2;

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
// accumulators, and a long sum (dK, dV over every query row of the group,
// dQ over every key) is taken a tile at a time on the tensor cores and
// added to its fp32 registers with rounding.

// C(64 x N) = A B^T over k = D (C zero on entry), issued, committed and
// waited for in chunks of kChunk<D> k-steps: A the 64 rows from a_row0 of a
// resident raw tile of a_rows rows (boxes of 32 columns x a_rows rows), read
// as m64k8 fragments and split in registers; B N rows in the natural layout,
// hi at b_hi and lo at b_lo (boxes of 32 columns x N rows). A_hi B_hi sums
// into c, A_lo B_hi + A_hi B_lo into a second accumulator, added at the end.
template <int D, int N>
__device__ __forceinline__ void product_a_smem(float (&c)[N / 2], const uint8_t* a_tile,
                                               int a_rows, int a_row0, uint32_t b_hi,
                                               uint32_t b_lo, int w, int g, int t) {
  const uint64_t dh = sm90::desc_b128(b_hi, 16), dl = sm90::desc_b128(b_lo, 16);
  const uint8_t* a_row = a_tile + (a_row0 + 16 * w + g) * 128 + 4 * t;  // row % 8 == g
  float small[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) small[i] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < D / 8; k0 += kChunk<D>) {
    uint32_t ah[kChunk<D>][4], al[kChunk<D>][4];
#pragma unroll
    for (int s = 0; s < kChunk<D>; ++s) {
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
    for (int s = 0; s < kChunk<D>; ++s) {
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
// (convert_item), hi at
// b_hi and lo at b_lo (rows of 4K bytes: K 32 128-byte swizzled, K 16
// 64-byte); three products a k-step, the small terms first. The caller
// waits and adds c to its fp32 registers.
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
  const uint64_t dh = K == 32 ? sm90::desc_b128(b_hi, 16) : sm90::desc_b64(b_hi);
  const uint64_t dl = K == 32 ? sm90::desc_b128(b_lo, 16) : sm90::desc_b64(b_lo);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) c[i] = 0.f;
  sm90::fence_regs(c);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    mma_tf32<N>(c, al[kk], dh + 2 * kk);
    mma_tf32<N>(c, ah[kk], dl + 2 * kk);
    mma_tf32<N>(c, ah[kk], dh + 2 * kk);
  }
}

// dst += part, after the wait for part's products
template <int N>
__device__ __forceinline__ void add_part(float (&dst)[N], float (&part)[N]) {
  sm90::fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] += part[i];
}

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
__global__ void __launch_bounds__(kBwdThreads, 1)
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
__global__ void __launch_bounds__(kBwdThreads, 1)
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

// One persistent CTA per SM, or one per pair of blocks when there are fewer.
template <typename Kernel>
cudaError_t bwd_grid(Kernel kernel, int bytes, std::atomic<uint64_t>& done, int pairs,
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
  const cudaError_t err = bwd_grid(flash_bwd_dkv_fp32_kernel<D, SOFTCAP>, DkvSmem<D>::kBytes,
                                   done, xfa::block_pairs(n_nb, p.hk, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_fp32_kernel<D, SOFTCAP><<<grid, kBwdThreads, DkvSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
cudaError_t launch_dq(const CUtensorMap* maps, const Fp32BwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  int grid = 0;
  const cudaError_t err =
      bwd_grid(flash_bwd_dq_fp32_kernel<D, SOFTCAP>, DqSmem<D>::kBytes, done,
               xfa::block_pairs((p.sq + kDqRows - 1) / kDqRows, p.h, p.b), grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_fp32_kernel<D, SOFTCAP><<<grid, kBwdThreads, DqSmem<D>::kBytes, s>>>(
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

// ------------------------------------------------------------ launches

// Launch the forward at head dim D, raising its shared-memory limit once per
// device.
template <int D, bool PAGED>
cudaError_t launch_fwd(dim3 grid, cudaStream_t s, const Fp32Params& p) {
  static std::atomic<uint64_t> done{0};
  const cudaError_t err =
      sm90::smem_limit_once(flash_fwd_fp32_kernel<D, PAGED>, FwdSmem<D>::kBytes, done);
  if (err != cudaSuccess) return err;
  flash_fwd_fp32_kernel<D, PAGED><<<grid, kThreads, FwdSmem<D>::kBytes, s>>>(p);
  return cudaGetLastError();
}

template <bool PAGED>
cudaError_t launch_fwd_d(int d, dim3 grid, cudaStream_t s, const Fp32Params& p) {
  if (d == 64) return launch_fwd<64, PAGED>(grid, s, p);
  if (d == 128) return launch_fwd<128, PAGED>(grid, s, p);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, h, sq, d) fp32 by element strides (batch, head, seq); k, v:
// (b, hk, sk, d) by strides, or, with `table`, both the pages (num_pages,
// hk, 2, ps, d) fp32 contiguous (the strides unused, sk = npp * ps) with
// `table` (b, npp) int32 and `lengths` (b,) int32 (key count per batch row,
// its last sq keys the queries'); every row's head dim contiguous, every
// pointer and stride a multiple of 4 elements (16 bytes). lse: (b, h, sq)
// fp32 contiguous or null. window: left, right (-1 no bound; causal is
// right 0).
XFA_EXPORT int xfa_flash_fwd_fp32(const void* q, const void* k, const void* v, void* out,
                                  void* lse, int64_t q_sb, int64_t q_sh, int64_t q_ss,
                                  int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb,
                                  int64_t v_sh, int64_t v_ss, int64_t o_sb, int64_t o_sh,
                                  int64_t o_ss, int b, int h, int hk, int sq, int sk, int d,
                                  float sm_scale, float softcap, int left, int right,
                                  const void* table, const void* lengths, int ps, int npp,
                                  int num_pages, void* stream) {
  if (b <= 0 || h <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (hk <= 0 || h % hk != 0 || (table != nullptr) != (lengths != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fp32Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.out = static_cast<float*>(out);
  p.lse_out = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.left = left;
  p.right = right;
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.ps = ps; p.npp = npp; p.num_pages = num_pages;
  const dim3 grid((sq + kTile - 1) / kTile, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(table != nullptr ? launch_fwd_d<true>(d, grid, s, p)
                                            : launch_fwd_d<false>(d, grid, s, p));
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
