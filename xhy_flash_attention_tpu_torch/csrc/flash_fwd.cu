// FlashAttention forward for bf16 q/k/v with fp32 accumulation.
//
// Replaces two TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78 `_fwd_kernel`
//     (kernel #1, driven by flash_attention_fwd, (b, h, s, d) layout);
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
// (+inf on rows with no visible key, whose output is 0).
//
// Softmax: the max-shifted online softmax. The TPU kernels use a zero shift,
// exp(min(s, 70)) (fwd.py:60-65, fused_heads.py:81). Both give the same
// P / l to fp32 rounding while scores stay under 70; the shifted form also
// stays finite above it. exp is taken as exp2 with log2(e) folded in.
//
// Bound on the H100: operations. Causal prefill at Llama-3-8B width
// (b2 h32 s2048 d128) does ~69 GFLOP (0.070 ms at 989 TFLOP/s) against
// ~50 MB of q/k/v/o traffic (0.015 ms at 3.35 TB/s), so only the tensor
// cores' rate matters, and on Hopper only wgmma reaches it.
//
// Two routes, chosen by whether a sparse mask is given:
//
// * Dense (flash_fwd_kernel): persistent CTAs, one per SM, of three
//   warpgroups; a CTA runs blocks of 128 query rows (kTileM) of one (batch,
//   head), taken in pairs that hold equal causal work (the heavier block j
//   from the end with block j from the start), pairs dealt round-robin in
//   head order so that the CTAs at work share the K/V of a few heads in L2.
//   - Warpgroup 0 is the producer: it gives up registers (setmaxnreg.dec)
//     and one thread issues TMA copies through 4-D tensor maps (d, s, h, b)
//     built from the strides: each block's Q (into the one of two
//     buffers the consumers have released), then its K and V tiles of 128
//     keys (kTileN) into a ring of kStages stages (4 at d 64, 2 at d 128)
//     that runs on across blocks, each stage with K-full, V-full and empty
//     mbarriers.
//     Rows or keys past sq / sk arrive as zeros and stop at the batch row's
//     end (no flattening).
//   - Warpgroups 1 and 2 are consumers of 64 rows each (setmaxnreg.inc).
//     They scale their Q rows in shared memory (fp32, rounded to bf16) and
//     fence them to the async proxy; then per key tile: S = Q K^T by
//     wgmma m64n128k16 from 128-byte-swizzled shared memory; the online
//     softmax in registers; O += P V by wgmma with P's bf16 fragment as the
//     register A operand and V read MN-major (the transpose bit on B).
//   - At d 64, inside a consumer, tile i's softmax runs while tile i - 1's
//     P.V is on the tensor cores (QK^T(i) and PV(i - 1) are issued
//     together).
//   - The key tiles are visited from the last to the first, so the tiles
//     that need the elementwise mask (a causal diagonal tile, the ragged
//     last tile) come first and the interior ones run with no mask test
//     (fwd.py fwd_tile_plan mirrors the plan, fwd_schedule the pairs; both
//     from common.cuh key_tiles and pair_block, shared with flash_bwd.cu).
//   - Epilogue: O is normalised, written to the consumer's staging rows in
//     shared memory (swizzled) and stored by TMA, which drops rows past sq,
//     while the next block's loads are under way; the LSE by one thread per
//     row.
//   Shared memory: d 128: 2 x Q 32 KB + O 32 KB + 2 x (K 32 + V 32) KB;
//   d 64: 2 x Q 16 KB + O 16 KB + 4 x (K 16 + V 16) KB.
//   Not yet used: ping-pong ordering of the two consumers, TMA multicast
//   of K/V across a cluster.
//
// * Masked (masked_flash_fwd_kernel; slice 4, the TPU kernel's FlashMask and
//   block-mask flags, fwd.py:244-264): mma.sync m16n8k16 on 64-key tiles.
//   A 64-key tile that the block mask turns off, or that the FlashMask stats
//   show masked for all of the block's 64 rows, is skipped before its K/V
//   are loaded; the elementwise band test runs only on tiles the stats do
//   not bypass (the tile's vectors are staged in shared memory beside K and
//   V). The mask head of query head i is i / (h / hm). A row whose every
//   tile is skipped or masked keeps m = -inf and l = 0 and writes 0 with LSE
//   +inf, whichever of its tiles come first. One block of four warps owns 64
//   query rows; each warp keeps its 16 rows of Q (pre-scaled, bf16) and the
//   O accumulator in registers; K and V tiles of 64 keys (common.py
//   FWD_KEY_TILE, the FlashMask stats' tile) are staged in padded shared
//   memory (V fragments through ldmatrix.trans).
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::ldmatrix_x2_trans;
using xfa::mma_16816;
using xfa::pack_a;
using xfa::pack_bf16;
namespace sm90 = xfa::sm90;
using sm90::issue_pv;
using sm90::issue_qk;

// ------------------------------------------------------------ dense route

constexpr int kTileM = 128;  // query rows per block (fwd.py FWD_DENSE_TILE_M)
constexpr int kTileN = 128;  // keys per tile (fwd.py FWD_DENSE_TILE_N)
constexpr int kDenseThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 8192;  // one 64-row x 128-byte swizzled box
static_assert(kTileN == sm90::kKeyTile && kBox == sm90::kBox64,
              "the tiles of hopper.cuh's issue_qk and issue_pv");

template <int D>
struct DenseSmem {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) tiles of a row
  // Q (two buffers) and O: [consumer 2][half][64 rows][128 B]; a K or V
  // stage: [half][128 keys][128 B]
  static constexpr int kQWarpgroup = kHalves * kBox;
  static constexpr int kQBuffer = 2 * kQWarpgroup;
  static constexpr int kStage = kTileN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kO = kQ + 2 * kQBuffer;
  static constexpr int kK = kO + 2 * kQWarpgroup;
  static constexpr int kV = kK + kStages * kStage;
  // barriers: Q full[2], Q empty[2], K full[], V full[], K/V empty[]
  static constexpr int kBar = kV + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (4 + 3 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct DenseParams {
  float* lse;  // (b, h, sq) contiguous, or null
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
};

// The online softmax of one tile's scores s (columns n0 .. n0 + kTileN - 1;
// this thread's rows row0 and row0 + 8), in place: softcap and, with MASK,
// the elementwise causal / sk test, then hopper.cuh's softmax_step (the
// paged prefill shares it): the running max m_i, s = P in fp32, this
// thread's share of the row sums l_i (the quad is summed at the end) and
// alpha, the factor that takes the running O to the new max.
template <bool MASK>
__device__ __forceinline__ void online_softmax(float (&s)[kTileN / 2], float (&m_i)[2],
                                               float (&l_i)[2], float (&alpha)[2], int n0,
                                               int row0, const DenseParams& p, int t) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < kTileN / 2; ++i) s[i] = tanhf(s[i] / p.softcap) * p.softcap;
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

// P in bf16 pairs: pa[4kk .. 4kk + 3] is the A fragment of k-step kk
__device__ __forceinline__ void pack_p(const float (&s)[kTileN / 2], uint32_t (&pa)[kTileN / 4]) {
#pragma unroll
  for (int i = 0; i < kTileN / 4; ++i) pa[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

template <int D>
__global__ void __launch_bounds__(kDenseThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
                     const DenseParams p) {
  using S = DenseSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 16;  // [2] each
  const uint32_t bar_k = bar_qe + 16, bar_v = bar_k + 8 * S::kStages, bar_e = bar_v + 8 * S::kStages;
  const int n_mb = (p.sq + kTileM - 1) / kTileM;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);

  if (threadIdx.x == 0) {
    for (int qb = 0; qb < 2; ++qb) {
      sm90::mbar_init(bar_q + 8 * qb, 1);
      sm90::mbar_init(bar_qe + 8 * qb, 8);  // the eight consumer warps
    }
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_k + 8 * st, 1);
      sm90::mbar_init(bar_v + 8 * st, 1);
      sm90::mbar_init(bar_e + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup index, warp-uniform for the compiler: the two roles are
  // one if-else that never reconverges, so each keeps its own register
  // budget. Both roles walk the same blocks and count the same K/V tiles
  // (it, the ring position) and Q loads (qk, a ring of two buffers), so
  // stages and parities agree without any other exchange.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    // ---- producer warpgroup: one thread keeps the TMA copies in flight
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, n_tiles, n_free;
          if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
          xfa::key_tiles<kTileM, kTileN>(m_block * kTileM, p.sq, p.sk, p.causal, n_tiles, n_free);
          if (n_tiles == 0) continue;
          const int q0 = m_block * kTileM, kv_head = head / (p.h / p.hk);
          // Q goes to the buffer the consumers released two blocks ago; the
          // second consumer's rows may lie wholly past sq: not loaded (it
          // computes on stale rows that the store drops)
          const int qb = qk & 1;
          sm90::mbar_wait(bar_qe + 8 * qb, ((qk >> 1) & 1) ^ 1);  // the first pass is free
          const int wgs = q0 + 64 < p.sq ? 2 : 1;
          sm90::mbar_expect_tx(bar_q + 8 * qb, wgs * S::kQWarpgroup);
          for (int w = 0; w < wgs; ++w)
            for (int hf = 0; hf < S::kHalves; ++hf)
              sm90::tma_load_4d(base + S::kQ + qb * S::kQBuffer + w * S::kQWarpgroup + hf * kBox,
                                &tq, bar_q + 8 * qb, hf * 64, q0 + w * 64, head, batch);
          ++qk;
          for (int i = 0; i < n_tiles; ++i, ++it) {
            const int st = it % S::kStages, n0 = (n_tiles - 1 - i) * kTileN;
            const uint32_t k_st = base + S::kK + st * S::kStage;
            const uint32_t v_st = base + S::kV + st * S::kStage;
            // the first pass over the ring is free
            sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(bar_k + 8 * st, S::kStage);
            for (int hf = 0; hf < S::kHalves; ++hf)
              sm90::tma_load_4d(k_st + hf * kTileN * 128, &tk, bar_k + 8 * st, hf * 64, n0,
                                kv_head, batch);
            sm90::mbar_expect_tx(bar_v + 8 * st, S::kStage);
            for (int hf = 0; hf < S::kHalves; ++hf)
              sm90::tma_load_4d(v_st + hf * kTileN * 128, &tv, bar_v + 8 * st, hf * 64, n0,
                                kv_head, batch);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const uint32_t o_wg = base + S::kO + cw * S::kQWarpgroup;
    uint8_t* o_wg_ptr = smem + S::kO + cw * S::kQWarpgroup;
    auto stage = [&](int i) { return i % S::kStages; };
    auto parity = [&](int i) { return static_cast<uint32_t>((i / S::kStages) & 1); };
    int it = 0, qk = 0;
    bool stored = false;  // this thread has a TMA store in flight

    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int m_block, head, batch, n_tiles, n_free;
        if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
        xfa::key_tiles<kTileM, kTileN>(m_block * kTileM, p.sq, p.sk, p.causal, n_tiles, n_free);
        const int q0 = m_block * kTileM;
        const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
        const int n_masked = n_tiles - n_free;           // the first tiles visited
        auto col0 = [&](int i) { return (n_tiles - 1 - i) * kTileN; };

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
          // q * sm_scale in fp32, rounded to bf16, in place: every element
          // alike, so the swizzle does not matter
          uint4* qv = reinterpret_cast<uint4*>(q_wg_ptr);
          for (int c = wt; c < S::kQWarpgroup / 16; c += 128) {
            uint4 x = qv[c];
            uint32_t* w = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
              w[j] = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
            }
            qv[c] = x;
          }
          sm90::fence_proxy_async();  // the writes above, before wgmma reads them
          sm90::named_barrier(1 + cw, 128);
          ++qk;
        }
        // after the block's last QK^T: its Q buffer may be loaded again
        auto q_done = [&]() {
          if (lane == 0) sm90::mbar_arrive(bar_qe + 8 * qb);
        };

        float s[kTileN / 2];
        uint32_t pa[kTileN / 4];
        float alpha[2];
        if constexpr (D == 64) {
          // Tile i's softmax runs while tile i - 1's P.V is on the tensor
          // cores: QK^T(i) and PV(i - 1) are issued together, QK^T(i) is
          // waited for (wgmma groups complete in order), then PV(i - 1);
          // then O is rescaled and P(i) packed into the registers PV(i - 1)
          // read. (At d 128, S, O and P in flight together are more than
          // ptxas keeps in flight: it serialises the wgmmas, and the tiles
          // run one by one.)
          if (n_tiles > 0) {
            sm90::mbar_wait(bar_k + 8 * stage(it), parity(it));
            sm90::wgmma_fence();
            issue_qk<D>(s, q_wg, base + S::kK + stage(it) * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s);
            if (n_tiles == 1) q_done();
            if (n_masked > 0) {
              online_softmax<true>(s, m_i, l_i, alpha, col0(0), row0, p, t);
            } else {
              online_softmax<false>(s, m_i, l_i, alpha, col0(0), row0, p, t);
            }
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
            sm90::wgmma_wait<1>();
            sm90::fence_regs(s);
            if (i == n_tiles - 1) q_done();
            if (i < n_masked) {
              online_softmax<true>(s, m_i, l_i, alpha, col0(i), row0, p, t);
            } else {
              online_softmax<false>(s, m_i, l_i, alpha, col0(i), row0, p, t);
            }
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
          // one tile after the other: QK^T, softmax, P.V
          for (int i = 0; i < n_tiles; ++i) {
            const int st = stage(it + i);
            sm90::mbar_wait(bar_k + 8 * st, parity(it + i));
            sm90::wgmma_fence();
            issue_qk<D>(s, q_wg, base + S::kK + st * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s);
            if (i == n_tiles - 1) q_done();
            if (i < n_masked) {
              online_softmax<true>(s, m_i, l_i, alpha, col0(i), row0, p, t);
            } else {
              online_softmax<false>(s, m_i, l_i, alpha, col0(i), row0, p, t);
            }
            pack_p(s, pa);
#pragma unroll
            for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
            sm90::mbar_wait(bar_v + 8 * st, parity(it + i));
            sm90::fence_regs(o);
            sm90::fence_regs(pa);
            sm90::wgmma_fence();
            issue_pv<D>(o, pa, base + S::kV + st * S::kStage);
            sm90::wgmma_wait<0>();
            sm90::fence_regs(o);
            if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);  // one arrival per consumer warp
          }
        }
        it += n_tiles;

        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
          l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
          inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
        }
        // O into this consumer's staging rows, in the swizzled layout the TMA
        // store reads, once the previous block's store has read them
        if (stored) sm90::tma_store_wait_read();
        sm90::named_barrier(1 + cw, 128);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int r = warp * 16 + g + 8 * rr;
            const int off = (j >> 3) * kBox + r * 128 + (((j & 7) ^ (r & 7)) << 4) + t * 4;
            *reinterpret_cast<uint32_t*>(o_wg_ptr + off) =
                pack_bf16(o[4 * j + 2 * rr] * inv[rr], o[4 * j + 2 * rr + 1] * inv[rr]);
          }
        }
        sm90::fence_proxy_async();
        sm90::named_barrier(1 + cw, 128);
        stored = wt == 0 && q0 + cw * 64 < p.sq;
        if (stored) {
          for (int hf = 0; hf < S::kHalves; ++hf)
            sm90::tma_store_4d(&to, o_wg + hf * kBox, hf * 64, q0 + cw * 64, head, batch);
          sm90::tma_store_commit();
        }
        if (p.lse != nullptr && t == 0) {
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int row = row0 + 8 * rr;
            if (row < p.sq)
              p.lse[(static_cast<int64_t>(batch) * p.h + head) * p.sq + row] =
                  l_i[rr] > 0.f ? m_i[rr] + logf(l_i[rr]) : INFINITY;
          }
        }
      }
    }
    if (stored) sm90::tma_store_wait_read();  // shared memory stays until read
  }
}

// The dynamic shared-memory limit of an instance, raised once per device.
template <int D>
cudaError_t dense_smem_attribute() {
  static std::atomic<uint64_t> done{0};
  return sm90::smem_limit_once(flash_fwd_kernel<D>, DenseSmem<D>::kBytes, done);
}

// One persistent CTA per SM (shared memory allows no second), or one per
// pair of query blocks when there are fewer.
template <int D>
cudaError_t launch_dense(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                         const CUtensorMap& to, const DenseParams& p, cudaStream_t s) {
  cudaError_t err = dense_smem_attribute<D>();
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  const int pairs = xfa::block_pairs((p.sq + kTileM - 1) / kTileM, p.h, p.b);
  flash_fwd_kernel<D><<<pairs < sms ? pairs : sms, kDenseThreads, DenseSmem<D>::kBytes, s>>>(
      tq, tk, tv, to, p);
  return cudaGetLastError();
}

// ----------------------------------------------------------- masked route

constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per tile (common.py FWD_KEY_TILE)
constexpr int kThreads = 128;

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (b, h, sq) contiguous, or null
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
  xfa::MaskParams mask;
};

template <int D>
__global__ void __launch_bounds__(kThreads) masked_flash_fwd_kernel(const FwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) bf16 ks[kBlockN * kStride];
  __shared__ __align__(16) bf16 vs[kBlockN * kStride];
  __shared__ int fm_s[4][kBlockN];  // the tile's FlashMask vectors

  // heaviest causal q blocks first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m_block * kBlockM + warp * 16;
  const int offset = p.sk - p.sq;
  const xfa::MaskParams& mk = p.mask;
  const int q0 = m_block * kBlockM, q1 = min(q0 + kBlockM, p.sq);

  const bf16* qb = p.q + batch * p.q_sb + head * p.q_sh;
  const bf16* kb = p.k + batch * p.k_sb + kv_head * p.k_sh;
  const bf16* vb = p.v + batch * p.v_sb + kv_head * p.v_sh;
  bf16* ob = p.o + batch * p.o_sb + head * p.o_sh;

  // Q fragments (A operand), scaled in fp32 and rounded to bf16.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * t;
      uint32_t val = 0;
      if (row < p.sq) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qb + row * p.q_ss + col));
        val = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
      }
      qf[kk][r] = val;
    }
  }

  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  int n_tiles = (p.sk + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_row = min((m_block + 1) * kBlockM, p.sq) - 1;
    const int max_col = last_row + offset;
    n_tiles = max_col < 0 ? 0 : min(n_tiles, max_col / kBlockN + 1);
  }

  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * kBlockN;
    bool band = false;  // the same for every thread: skips keep barriers uniform
    if (!xfa::mask_tile(mk, batch, head, p.h, q0, q1, n0, kBlockN, band)) continue;
    __syncthreads();  // the previous tile is fully consumed
    if (band && threadIdx.x < kBlockN) {
      const int fh = xfa::fm_head(mk, head, p.h);
      for (int vi = 0; vi < xfa::fm_nv(mk.fm_mode); ++vi)
        fm_s[vi][threadIdx.x] = xfa::fm_vec(mk, batch, fh, vi, n0 + threadIdx.x);
    }
    for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const int key = n0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < p.sk) {
        kv = *reinterpret_cast<const uint4*>(kb + key * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * kStride + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * kStride + c]) = vv;
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
        const bf16* kr = &ks[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    // softcap and mask; fragment element e sits at row g + (e >= 2) * 8,
    // column 2t + (e & 1) of n-tile j
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e];
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const int c = col - n0;
        const bool visible =
            col < p.sk && (!p.causal || col <= row + offset) &&
            !(band && xfa::fm_banned(mk.fm_mode, row, fm_s[0][c], fm_s[1][c], fm_s[2][c],
                                     fm_s[3][c]));
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
    const int row = row0 + g + i * 8;
    if (row >= p.sq) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
    bf16* orow = ob + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o_acc[j][2 * i] * inv, o_acc[j][2 * i + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<int64_t>(batch) * p.h + head) * p.sq + row] =
          l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : INFINITY;
    }
  }
}

}  // namespace

// q/k/v/o strides are in elements for the (batch, head, seq) axes; the
// head-dim axis is contiguous; pointers and strides are multiples of 16
// bytes (the tensor maps' rule). lse may be null. The mask arguments
// (XFA_MASK_ARGS, common.cuh) carry FlashMask stats per 64-key tile; with
// none given the dense route runs.
XFA_EXPORT int xfa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                             int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                             int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int b,
                             int h, int hk, int sq, int sk, int d, float sm_scale,
                             float softcap, int causal, XFA_MASK_ARGS, void* stream) {
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const xfa::MaskParams mask = XFA_MASK_VALUES;
  if (mask.fm_vecs == nullptr && mask.bm == nullptr) {
    CUtensorMap tq, tk, tv, to;
    const int skm = sk > 0 ? sk : 1;  // no key tile is visited when sk == 0
    if (!sm90::encode_bhsd(&tq, q, b, h, sq, d, q_sb, q_sh, q_ss, 64) ||
        !sm90::encode_bhsd(&tk, k, b, hk, skm, d, k_sb, k_sh, k_ss, kTileN) ||
        !sm90::encode_bhsd(&tv, v, b, hk, skm, d, v_sb, v_sh, v_ss, kTileN) ||
        !sm90::encode_bhsd(&to, o, b, h, sq, d, o_sb, o_sh, o_ss, 64))
      return static_cast<int>(cudaErrorInvalidValue);
    const DenseParams p{static_cast<float*>(lse), b, h, hk, sq, sk, sm_scale, softcap, causal};
    const cudaError_t err = d == 64 ? launch_dense<64>(tq, tk, tv, to, p, s)
                                    : launch_dense<128>(tq, tk, tv, to, p, s);
    return static_cast<int>(err);
  }
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.causal = causal;
  p.mask = mask;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, h, b);
  if (d == 64) masked_flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(p);
  else masked_flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
