// The dQ kernel of the attention backward (#3, bwd.py:511 `_bwd_dq_kernel`
// of the TPU package, and #6's dQ through strides) -> flash_bwd_dq_kernel,
// and its entry xfa_flash_bwd_dq. A source of its own beside flash_bwd.cu
// (the pre-pass and dK/dV), so that nvcc compiles the two side by side;
// the design, and what the two share (flash_bwd.cuh), is described at the
// top of flash_bwd.cu.
#include "flash_bwd.cuh"

namespace {

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

// dQ: dS of one key tile, in place in fp32 (dp: dP -> dS), from S (s), this
// thread's rows row0 and row0 + 8 (lse2, delta per row) and the tile's keys
// n0 + c as columns; with MASK the elementwise causal / sk test and the
// parts of the tile's keys that are on (`parts`: bit 0 keys [0, 64), bit
// 1 [64, 128)); with NB > 0 also each column's first NB FlashMask bands
// (`bands`, in shared memory); with BIAS the tile's bias `bv`; with DROP the
// tile's dropout base `dbase` (common.cuh dropout_base), each element hashed in
// the loop.
template <bool MASK, bool SOFTCAP, int N, int NB = 0, bool BIAS = false, bool DROP = false>
__device__ __forceinline__ void dq_ds(const float (&s)[N / 2], float (&dp)[N / 2],
                                      const float (&lse2)[2], const float (&delta)[2], int row0,
                                      int n0, const BwdParams& p, int t, int parts = 3,
                                      const int4* bands = nullptr, const float* bv = nullptr,
                                      uint32_t dbase = 0) {
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
    p_ds<SOFTCAP, BIAS, DROP>(
        s[i], dp[i], lse2[r], delta[r], visible, p.softcap, pr, dp[i], BIAS ? bv[i] : 0.f,
        DROP ? xfa::dropout_keep_at<false>(dbase, p.drop.threshold, i) : true, p.drop.scale);
  }
}

// dQ's elementwise test in the masked instantiations, all bitwise: the key
// below sk, the row/key window, the parts of the tile's keys that are on,
// with NB > 0 each column's first NB FlashMask bands (`bands`) and with
// INFO each key's segment id and position (`kinfo`), both in the stage,
// against the row's (`qinfo`: row0's, staged with q_s; row0 + 8's 8
// further); dS as dq_ds.
template <bool SOFTCAP, int N, int NB, bool INFO, bool BIAS = false, bool DROP = false>
__device__ __forceinline__ void dq_ds_masked(const float (&s)[N / 2], float (&dp)[N / 2],
                                             const float (&lse2)[2], const float (&delta)[2],
                                             int row0, int n0, const BwdParams& p, int t,
                                             int parts, const int4* bands, const int4* kinfo,
                                             const int4* qinfo, const float* bv = nullptr,
                                             uint32_t dbase = 0) {
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
    p_ds<SOFTCAP, BIAS, DROP>(
        s[i], dp[i], lse2[r], delta[r], visible, p.softcap, pr, dp[i], BIAS ? bv[i] : 0.f,
        DROP ? xfa::dropout_keep_at<false>(dbase, p.drop.threshold, i) : true, p.drop.scale);
  }
}

// ---- dQ

template <int D, bool SOFTCAP, bool MASKED, bool BIAS, bool DROPOUT = false>
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
        // DROPOUT: the forward's keep mask regenerated in the loops below
        uint32_t dbase = 0;
        if constexpr (DROPOUT)
          dbase = xfa::dropout_base<false>(xfa::dropout_key(p.drop, batch, head, p.h), row0, n0, t);
        if (!(flags & kElem)) {
          dq_ds<false, SOFTCAP, kN, 0, BIAS, DROPOUT>(s, dp, lse2, delta, row0, n0, p, t, 3, nullptr,
                                                      bv, dbase);
        } else if constexpr (!MASKED) {
          dq_ds<true, SOFTCAP, kN, 0, BIAS, DROPOUT>(s, dp, lse2, delta, row0, n0, p, t, parts,
                                                     nullptr, bv, dbase);
        } else {
          const int4* bands = reinterpret_cast<const int4*>(stage + S::kBands);
          const int4* kinfo = reinterpret_cast<const int4*>(stage + S::kKInfo);
          const int4* qinfo = reinterpret_cast<const int4*>(smem + S::kQInfo +
                                                            qb * kBlockInfoBytes) +
                              (row0 - q0);
#define XFA_DQ(NB, I)                                                                     \
  dq_ds_masked<SOFTCAP, kN, NB, I, BIAS, DROPOUT>(s, dp, lse2, delta, row0, n0, p, t, parts, bands, \
                                                  kinfo, qinfo, bv, dbase)
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

template <int D, bool SOFTCAP, bool MASKED, bool BIAS, bool DROPOUT = false>
cudaError_t launch_dq_kernel(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  using S = DqSmem<D, MASKED>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err = sm90::smem_limit_once(flash_bwd_dq_kernel<D, SOFTCAP, MASKED, BIAS, DROPOUT>,
                                          S::kBytes, done);
  int grid = 0;
  if (err == cudaSuccess) err = grid_size((p.sq + kDqRows - 1) / kDqRows, p.h, p, MASKED, grid);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<D, SOFTCAP, MASKED, BIAS, DROPOUT><<<grid, kThreads, S::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], maps[6], p);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdParams& p, cudaStream_t s) {
  if (p.drop.on)
    return p.softcap > 0.f ? launch_dq_kernel<D, true, MASKED, false, true>(maps, p, s)
                           : launch_dq_kernel<D, false, MASKED, false, true>(maps, p, s);
  if (p.bias.ptr != nullptr)
    return p.softcap > 0.f ? launch_dq_kernel<D, true, MASKED, true>(maps, p, s)
                           : launch_dq_kernel<D, false, MASKED, true>(maps, p, s);
  return p.softcap > 0.f ? launch_dq_kernel<D, true, MASKED, false>(maps, p, s)
                         : launch_dq_kernel<D, false, MASKED, false>(maps, p, s);
}

}  // namespace

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
