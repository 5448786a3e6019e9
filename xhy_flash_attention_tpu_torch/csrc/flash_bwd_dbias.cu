// The gradient of the attention bias, dbias = P (dP - delta) summed over
// the batches and heads that share each bias element, for bf16 q/k/v/dO
// and an fp32 or bf16 bias, accumulated in fp32 (fp32 q/k/v/dO run
// flash_fp32.cu's flash_bwd_dbias_fp32_kernel).
//
// Replaces the dbias output of the TPU kernel
// xhy_flash_attention_tpu/ops/flash_attention/bwd.py:180 `_bwd_dkv_kernel`
// (kernel #2 with has_bias): ds_raw = p * (dp - delta), the gradient of the
// scores before the softcap derivative, since the bias enters after softcap
// (bwd.py:131-132, 173); dbias written per (query tile, key tile)
// (bwd.py:411-415), accumulated over a GQA group for a head-broadcast bias
// (bwd.py:448-456), zero on skipped tiles (bwd.py:477-481), the batch
// streamed for a batch-broadcast bias so that no (b, h, sq, sk) fp32
// workspace exists (bwd.py:757-800), and summed over the broadcast axes
// (bwd.py:1302-1312). Its P and dS for dK, dV and dQ come from the bias
// instantiations of flash_bwd.cu's kernels, which read the bias as the
// forward does.
//
// Why a kernel of its own. A bias element is shared by bb < b batches or
// bh < h heads, and the port sums over them without atomics and without a
// workspace: every element of dbias is summed by one thread, over the
// (batch, head) pairs that share it in one fixed order (batch, then head),
// in registers, and written once. So a unit of work is a tile of the bias
// (128 query rows x 64 keys: its bias, its sums and the tile's S and dP,
// 128 registers a thread) and it streams those pairs' q_s, dO, K and V;
// dQ's and dK/dV's units are a (batch, head) each and cannot hold such a
// sum. Each element
// is written once per pass: a second pass gives the same bits. The price:
// S = q_s K^T and dP = dO V^T are computed once more (two products a tile
// beside the pair's seven). For a per-head bias the dQ kernel computes
// every dS this kernel does; folding its store there would save both
// products (PERF.md section 7).
//
// The design is the dQ kernel's (flash_bwd.cu): persistent CTAs, one per
// SM, of three warpgroups. Warpgroup 0, the producer (setmaxnreg.dec), has
// one thread issue TMA copies through 4-D tensor maps (d, s, h, b): for
// each (batch, head) of a unit, its 128 rows of q_s and dO and its K and V
// tile, into a ring of stages (4 at d 64, 2 at d 128) with full and empty
// mbarriers. Warpgroups 1 and 2, the consumers, own 64 rows each: the
// unit's bias in registers (common.cuh load_bias_rows, read once per
// unit), then per (batch, head) S and dP by SS wgmma, P = exp2(S log2(e)
// - LSE log2(e)) after softcap, bias and the elementwise mask (causal and
// sk; in the MASKED instantiation the row/key window, segment ids and
// positions), and acc += P (dP - delta). The unit's dbias leaves by plain
// stores in the bias's dtype. Units (bias batch, bias head, query block,
// key tile) whose every pair the row/key window masks are skipped: the
// wrapper zero-fills dbias, as the TPU kernel zeroes skipped tiles.
// Shared memory: d 64: 4 x (q_s 16 + dO 16 + K 8 + V 8) KB; d 128: 2 x
// (32 + 32 + 16 + 16) KB. Each (batch, head) of a unit moves its q_s, dO,
// K and V tiles (96 KB at d 128) for two 128 x 64 x 128 products: L2
// traffic, not the tensor cores, sets its time (0.15-0.5 of its bound on
// the card, PERF.md section 6); a unit of more keys needs its sums
// out of registers.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = xfa::sm90;
using sm90::ex2;
using sm90::issue_ss;
using sm90::kLog2e;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kRow = 128;   // bytes of a swizzled row: 64 bf16
constexpr int kRows = 128;  // query rows of a unit, 64 a consumer
__host__ __device__ constexpr int db_keys(int) { return 64; }

template <int D>
struct DbSmem {
  static constexpr int kN = db_keys(D);
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;
  // a stage: q_s and dO [half][128 rows][128 B], then K and V [half][kN
  // keys][128 B]
  static constexpr int kQ = kRows * D * 2;
  static constexpr int kKV = kN * D * 2;
  static constexpr int kStage = 2 * kQ + 2 * kKV;
  // barriers: full[], empty[]
  static constexpr int kBar = kStages * kStage;
  static constexpr int kBytes = kBar + 16 * kStages + 1024;  // + alignment slack
  static_assert(kStage % 1024 == 0, "128-byte swizzled tiles start 1024-byte aligned");
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct DbParams {
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  xfa::BiasParams bias;
  void* dbias;  // (bb, bh, sq, sk) in the bias's dtype, by the strides below
  int64_t db_sb, db_sh, db_ss;
  int b, h, hk, sq, sk, bb, bh;
  float softcap;
  int causal;
  xfa::MaskParams mask;  // the row/key window, segment ids and positions
};

// Unit u: (bias batch bi, bias head hi, query block, key tile), key tile
// fastest; false when the row/key window masks every pair of the tile.
template <int N, bool MASKED>
__device__ __forceinline__ bool unit_at(const DbParams& p, int u, int n_mb, int n_nt, int& bi,
                                        int& hi, int& q0, int& n0) {
  n0 = (u % n_nt) * N;
  u /= n_nt;
  q0 = (u % n_mb) * kRows;
  u /= n_mb;
  hi = u % p.bh;
  bi = u / p.bh;
  const int left = MASKED ? p.mask.left : -1;
  const int right = MASKED ? p.mask.right : (p.causal ? 0 : -1);
  const int off = p.sk - p.sq, q1 = min(q0 + kRows, p.sq) - 1, n1 = min(n0 + N, p.sk) - 1;
  return !(right >= 0 && n0 > q1 + off + right) && !(left >= 0 && n1 < q0 + off - left);
}

// The (batch, head) of member mi of a unit: every batch for a
// batch-broadcast bias (else bi), every head for a head-broadcast one (else
// hi), batch first.
__device__ __forceinline__ void member(const DbParams& p, int mi, int bi, int hi, int& batch,
                                       int& head) {
  const int heads = p.bh == 1 ? p.h : 1;
  batch = p.bb == 1 ? mi / heads : bi;
  head = p.bh == 1 ? mi % heads : hi;
}

// acc += P (dP - delta) of one (batch, head) over the unit's tile, this
// thread's rows row0 and row0 + 8 (lse2 = LSE log2(e), delta per row) and
// keys n0 + c: the score s after softcap plus the bias bv, the elementwise
// test (causal and sk; MASKED: the row/key window [lo, hi] of each row and
// with INFO the segment / position test against the rows' limits qt), P 0
// where a pair is masked or the row sees no key (LSE +inf).
template <bool SOFTCAP, bool MASKED, bool INFO, int N>
__device__ __forceinline__ void accumulate(float (&acc)[N / 2], const float (&s)[N / 2],
                                           const float (&dp)[N / 2], const float (&bv)[N / 2],
                                           const float (&lse2)[2], const float (&delta)[2],
                                           const int (&lo)[2], const int (&hi)[2],
                                           const int4 (&qt)[2], const int4* kinfo, int row0,
                                           int n0, const DbParams& p, int t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1, c = (i >> 2) * 8 + 2 * t + (i & 1), col = n0 + c;
    bool visible;
    if constexpr (MASKED) {
      visible = (col >= lo[r]) & (col <= hi[r]);
      if (INFO) {
        const int2 k = col < p.sk ? xfa::token_at(kinfo, col) : make_int2(INT_MIN, 0);
        visible = visible & xfa::tokens_meet(qt[r], k);
      }
    } else {
      const int row = row0 + 8 * r;
      visible = (col < p.sk) & (!p.causal | (col <= row + p.sk - p.sq));
    }
    float x = s[i];
    if (SOFTCAP) x = tanhf(x / p.softcap) * p.softcap;
    x += bv[i];
    const float pr = visible ? ex2(fmaf(x, kLog2e, -lse2[r])) : 0.f;
    acc[i] += pr * (dp[i] - delta[r]);
  }
}

template <int D, bool SOFTCAP, bool MASKED>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dbias_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tdo,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const DbParams p) {
  using S = DbSmem<D>;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_f = base + S::kBar, bar_e = bar_f + 8 * S::kStages;
  const int n_mb = (p.sq + kRows - 1) / kRows, n_nt = (p.sk + kN - 1) / kN;
  const int n_units = p.bb * p.bh * n_mb * n_nt;
  const int members = (p.bb == 1 ? p.b : 1) * (p.bh == 1 ? p.h : 1);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_f + 8 * st, 1);
      sm90::mbar_init(bar_e + 8 * st, 8);  // the eight consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the same units and members and count the same stages
  // (it), so stages and parities agree without any other exchange.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int bi, hi, q0, n0;
        if (!unit_at<kN, MASKED>(p, u, n_mb, n_nt, bi, hi, q0, n0)) continue;
        for (int mi = 0; mi < members; ++mi, ++it) {
          int batch, head;
          member(p, mi, bi, hi, batch, head);
          const int kv_head = head / group;
          const int st = it % S::kStages;
          const uint32_t stage = base + st * S::kStage;
          sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);  // the first pass is free
          sm90::mbar_expect_tx(bar_f + 8 * st, S::kStage);
          for (int hf = 0; hf < S::kHalves; ++hf) {
            sm90::tma_load_4d(stage + hf * kRows * kRow, &tq, bar_f + 8 * st, hf * 64, q0, head,
                              batch);
            sm90::tma_load_4d(stage + S::kQ + hf * kRows * kRow, &tdo, bar_f + 8 * st, hf * 64,
                              q0, head, batch);
            sm90::tma_load_4d(stage + 2 * S::kQ + hf * kN * kRow, &tk, bar_f + 8 * st, hf * 64,
                              n0, kv_head, batch);
            sm90::tma_load_4d(stage + 2 * S::kQ + S::kKV + hf * kN * kRow, &tv, bar_f + 8 * st,
                              hf * 64, n0, kv_head, batch);
          }
        }
      }
    }
  } else {
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const xfa::MaskParams& m = p.mask;
    const bool info = MASKED && m.q_info != nullptr;
    int it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      int bi, hi, q0, n0;
      if (!unit_at<kN, MASKED>(p, u, n_mb, n_nt, bi, hi, q0, n0)) continue;
      const int row0 = q0 + cw * 64 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
      float bv[kN / 2], acc[kN / 2];
      xfa::load_bias_rows<kN>(bv, p.bias, bi * p.bias.sb + hi * p.bias.sh, row0, n0, p.sq, p.sk,
                              t);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
      int lo[2] = {0, 0}, hi_[2] = {0, 0};
      if constexpr (MASKED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) xfa::row_limit(m, row0 + 8 * r, p.sq, p.sk, lo[r], hi_[r]);
      }
      for (int mi = 0; mi < members; ++mi, ++it) {
        int batch, head;
        member(p, mi, bi, hi, batch, head);
        const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
        float lse2[2], delta[2];
        int4 qt[2] = {};
        const int4* kinfo = nullptr;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          lse2[r] = row < p.sq ? p.lse[stat + row] * kLog2e : INFINITY;
          delta[r] = row < p.sq ? p.delta[stat + row] : 0.f;
          if (info)
            qt[r] = xfa::query_tokens(
                m, row < p.sq ? xfa::token_at(m.q_info + static_cast<int64_t>(batch) * m.q_pad, row)
                              : make_int2(INT_MIN, 0));
        }
        if (info) kinfo = m.k_info + static_cast<int64_t>(batch) * m.k_pad;
        const int st = it % S::kStages;
        const uint32_t stage = base + st * S::kStage;
        sm90::mbar_wait(bar_f + 8 * st, (it / S::kStages) & 1);
        float s[kN / 2], dp[kN / 2];
        sm90::wgmma_fence();
        issue_ss<D, kN>(s, stage + cw * 64 * kRow, kRows * kRow, stage + 2 * S::kQ,
                        kN * kRow);  // S = q_s K^T
        issue_ss<D, kN>(dp, stage + S::kQ + cw * 64 * kRow, kRows * kRow,
                        stage + 2 * S::kQ + S::kKV, kN * kRow);  // dP = dO V^T
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        sm90::fence_regs(s);
        sm90::fence_regs(dp);
        if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);  // one arrival per consumer warp
        if (info) {
          accumulate<SOFTCAP, MASKED, true, kN>(acc, s, dp, bv, lse2, delta, lo, hi_, qt, kinfo,
                                                row0, n0, p, t);
        } else {
          accumulate<SOFTCAP, MASKED, false, kN>(acc, s, dp, bv, lse2, delta, lo, hi_, qt, kinfo,
                                                 row0, n0, p, t);
        }
      }
      // the unit's dbias, once, in the bias's dtype
      const int64_t out = bi * p.db_sb + hi * p.db_sh;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
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

template <int D, bool SOFTCAP, bool MASKED>
cudaError_t launch_dbias_kernel(const CUtensorMap* maps, const DbParams& p, cudaStream_t s) {
  using S = DbSmem<D>;
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      sm90::smem_limit_once(flash_bwd_dbias_kernel<D, SOFTCAP, MASKED>, S::kBytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  const int units = p.bb * p.bh * ((p.sq + kRows - 1) / kRows) * ((p.sk + S::kN - 1) / S::kN);
  flash_bwd_dbias_kernel<D, SOFTCAP, MASKED><<<units < sms ? units : sms, kThreads, S::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch_dbias(const CUtensorMap* maps, const DbParams& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch_dbias_kernel<D, true, MASKED>(maps, p, s)
                         : launch_dbias_kernel<D, false, MASKED>(maps, p, s);
}

}  // namespace

// q is q_s (the backward pre-pass's bf16(q * sm_scale)); q, k, v and dout
// are (b, h|hk, s, d) views with element strides (batch, head, seq) and a
// contiguous head dim, read through TMA tensor maps (pointers and strides
// multiples of 16 bytes); lse and delta (b, h, sq) fp32 contiguous. The bias
// (XFA_BIAS_ARGS, common.cuh BiasParams) is (bb, bh, sq, sk), bb in {1, b},
// bh in {1, h}; dbias, of the bias's dtype, by its strides db_* (even, as
// the bias's), is written on every tile that the row/key window leaves a
// pair in and must be zero elsewhere. The mask arguments carry the
// row/key window, segment ids and positions (no FlashMask, no block mask:
// the TPU package takes no bias with them).
XFA_EXPORT int xfa_flash_bwd_dbias(const void* q, const void* k, const void* v, const void* dout,
                                   const void* lse, const void* delta, void* dbias, int64_t q_sb,
                                   int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
                                   int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,
                                   int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t db_sb,
                                   int64_t db_sh, int64_t db_ss, int b, int h, int hk, int sq,
                                   int sk, int d, int bb, int bh, float softcap, int causal,
                                   XFA_MASK_ARGS, XFA_BIAS_ARGS, void* stream) {
  if (b <= 0 || sq <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if ((d != 64 && d != 128) || bias == nullptr || dbias == nullptr || (bb != 1 && bb != b) ||
      (bh != 1 && bh != h) || fm_vecs != nullptr || bm != nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const xfa::MaskParams mask = XFA_MASK_VALUES;
  const bool masked = xfa::mask_active(mask);
  const DbParams p{static_cast<const float*>(lse), static_cast<const float*>(delta),
                   XFA_BIAS_VALUES, dbias, db_sb, db_sh, db_ss, b, h, hk, sq, sk, bb, bh,
                   softcap, causal, mask};
  const int keys = db_keys(d);
  CUtensorMap maps[4] = {};
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kRows) ||
      !sm90::encode_bhsd(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kRows) ||
      !sm90::encode_bhsd(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, keys) ||
      !sm90::encode_bhsd(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, keys))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (d == 64)
    err = masked ? launch_dbias<64, true>(maps, p, s) : launch_dbias<64, false>(maps, p, s);
  else
    err = masked ? launch_dbias<128, true>(maps, p, s) : launch_dbias<128, false>(maps, p, s);
  return static_cast<int>(err);
}
