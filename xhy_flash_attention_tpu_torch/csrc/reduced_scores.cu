// Reduced attention scores for bf16 q/k with an fp32 LSE:
//   reduced[b, h, j] = sum_i exp(sm_scale * (q_i . k_j) - lse_i)
// the attention mass key j received, recomputed from a forward's LSE.
//
// Replaces xhy_flash_attention_tpu/ops/flash_attention/reduced_scores.py:34
// `_reduced_kernel` (kernel #12). What it computes, as the TPU kernel does:
// q . k accumulated in fp32 from the bf16 inputs, then scaled by sm_scale in
// fp32 (the TPU kernel's `s *= sm_scale`; unlike the attention forward, q
// is not pre-scaled and rounded); P = exp(s - lse), 0 on rows with LSE +inf;
// rows past sq add nothing; with `causal` only key j <= i + sk - sq counts
// (the TPU package's superset of the reference, which always reduces the
// full rectangle). GQA: kv_head = head / (h / hk).
//
// Bound on the H100. Each visible (row, key) pair costs 2d FLOPs on the
// tensor cores and one exp on the SFU (16 ex2 a clock per SM, ~3.9e12 a
// second at 1.83 GHz on 132 SMs). At d 128 the two take about as long
// (989e12 / 256 FLOP = 3.9e12 pairs a second): operations bound it, and
// the exponent unit as much as the tensor cores; at d 64 the exponents take
// twice as long as the products, so the exponent unit bounds it. The bytes
// (q, k and lse read once, the fp32 output) are far less. So the design
// keeps both units busy at once.
//
// Design, the dK/dV kernel of flash_bwd.cu turned to the first product
// alone: persistent CTAs, one per SM, of a producer warpgroup and two
// consumer warpgroups. A work unit is a key block of 128 keys of one
// (batch, kv head), dealt in equal-work causal pairs (common.cuh
// pair_block, heavy-first key blocks, as dK/dV). The producer (one
// thread) loads the block's K by TMA once into one of two buffers (the
// next block's load overlaps this one), then streams a ring of 64-row q
// tiles, with their LSE by 1-D TMA from a 16-byte aligned start, for every
// head of the GQA group in a fixed order: K is read once per group, not
// once per head. Query tiles before the causal edge are never loaded; the
// diagonal and ragged tiles come first and take the elementwise test, the
// interior ones none (common.cuh query_tiles, bwd.py bwd_dkv_tile_plan).
// Each consumer owns 64 keys and computes S^T = K q^T by SS wgmma
// m64n64k16 (its keys as rows), P = ex2(fma(s, sm_scale log2 e, -lse log2
// e)) and sums each key's P in registers. A consumer runs a tile's product,
// then its exponents; the two consumers interleave, so that one's
// exponents run under the other's product and both units stay busy (a
// consumer that issued the next tile's product before the exponents, with
// two accumulators in turn, was serialised by ptxas, warning C7514). A
// head's sums go out at the end of its tiles: each thread's partial sums,
// then the quad in a fixed order; no atomics, so the result is bitwise
// equal from launch to launch.
//
// Shared memory: d 128: 2 x K 32 KB + 8 x (q 16 + lse 1) KB; d 64: 2 x K
// 16 KB + 8 x (q 8 + lse 1) KB.
#include "common.cuh"
#include "hopper.cuh"

namespace {

namespace sm90 = xfa::sm90;
using sm90::ex2;
using sm90::issue_ss;
using sm90::kLog2e;

constexpr int kThreads = 384;  // producer warpgroup + two consumers
constexpr int kKeys = 128;     // keys per block, 64 per consumer
constexpr int kRows = 64;      // query rows per streamed tile
constexpr int kRow = 128;      // bytes of a swizzled row: 64 bf16
constexpr int kStages = 8;
// A tile's LSE arrives by 1-D TMA as kStatBox floats from the 16-byte
// aligned element at or before its first row: the tile's rows sit
// `(first row) % 4` floats in.
constexpr int kStatBox = kRows + 4;

template <int D>
struct ReducedSmem {
  static constexpr int kHalves = D / 64;
  // K of a block: [half][128 keys][128 B], two buffers; a stage of the
  // query ring: q [half][64 rows][128 B], then its LSE box
  static constexpr int kK = kKeys * D * 2;
  static constexpr int kTile = kRows * D * 2;
  static constexpr int kStage = kTile + 1024;
  static constexpr int kRing = 2 * kK;
  // barriers: K full[2], K empty[2], tile full[], tile empty[]
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kStatBox * 4 <= 1024, "the LSE box fits its stage");
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct ReducedParams {
  float* out;  // (b, h, sk) contiguous
  int b, h, hk, sq, sk;
  float scale2;  // sm_scale * log2(e)
  int causal;
};

// One tile's exponents added to this thread's two key sums: s = S^T (its
// keys key0 and key0 + 8 as rows, the tile's rows m0 + c as columns), lse
// per column from shared memory; with MASK the elementwise causal / sq
// test.
template <bool MASK>
__device__ __forceinline__ void add_tile(const float (&s)[kRows / 2], const float* lse, int key0,
                                         int m0, const ReducedParams& p, int t, float (&acc)[2]) {
#pragma unroll
  for (int i = 0; i < kRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);  // the query row in the tile
    float x = ex2(fmaf(s[i], p.scale2, -lse[c] * kLog2e));
    if (MASK) {
      const int key = key0 + ((i >> 1) & 1) * 8, row = m0 + c;
      const bool visible = (row < p.sq) & ((p.causal == 0) | (key <= row + p.sk - p.sq));
      x = visible ? x : 0.f;
    }
    acc[(i >> 1) & 1] += x;
  }
}

// The sums of this thread's keys over the quad (a fixed order), written
// by its first thread for keys below sk; acc is cleared for the next head.
__device__ __forceinline__ void store_sums(float* out, float (&acc)[2], int key0, int sk, int t) {
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
    reduced_scores_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tlse, const ReducedParams p) {
  using S = ReducedSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_k = base + S::kBar, bar_ke = bar_k + 16;  // [2] each
  const uint32_t bar_t = bar_ke + 16, bar_te = bar_t + 8 * kStages;
  const int n_nb = (p.sk + kKeys - 1) / kKeys;
  const int n_pairs = xfa::block_pairs(n_nb, p.hk, p.b);
  const int group = p.h / p.hk;

  if (threadIdx.x == 0) {
    for (int kb = 0; kb < 2; ++kb) {
      sm90::mbar_init(bar_k + 8 * kb, 1);
      sm90::mbar_init(bar_ke + 8 * kb, 8);  // the eight consumer warps
    }
    for (int st = 0; st < kStages; ++st) {
      sm90::mbar_init(bar_t + 8 * st, 1);
      sm90::mbar_init(bar_te + 8 * st, 8);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // Both roles walk the same blocks and count the same K loads (kv, two
  // buffers) and query tiles (it, the ring position), so buffers, stages
  // and parities agree without any other exchange. A block whose keys no
  // row sees loads nothing: its consumers write zeros.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    // ---- producer: one thread keeps the TMA copies in flight
    if (threadIdx.x == 0) {
      int it = 0, kv = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
          const int n0 = n_block * kKeys;
          const xfa::QueryTilePlan pl = xfa::query_tiles<kRows, kKeys>(n0, p.sq, p.sk, p.causal);
          if (pl.n_tiles() == 0) continue;
          const int kb = kv & 1;
          sm90::mbar_wait(bar_ke + 8 * kb, ((kv >> 1) & 1) ^ 1);  // the first pass is free
          sm90::mbar_expect_tx(bar_k + 8 * kb, S::kK);
          for (int hf = 0; hf < S::kHalves; ++hf)
            sm90::tma_load_4d(base + kb * S::kK + hf * kKeys * kRow, &tk, bar_k + 8 * kb, hf * 64,
                              n0, kv_head, batch);
          ++kv;
          for (int gi = 0; gi < group; ++gi) {
            const int head = kv_head * group + gi;
            const int stat0 = (batch * p.h + head) * p.sq;
            for (int i = 0; i < pl.n_tiles(); ++i, ++it) {
              const int st = it % kStages, m0 = pl.tile(i) * kRows;
              const uint32_t t_st = base + S::kRing + st * S::kStage;
              sm90::mbar_wait(bar_te + 8 * st, ((it / kStages) & 1) ^ 1);
              sm90::mbar_expect_tx(bar_t + 8 * st, S::kTile + kStatBox * 4);
              for (int hf = 0; hf < S::kHalves; ++hf)
                sm90::tma_load_4d(t_st + hf * kRows * kRow, &tq, bar_t + 8 * st, hf * 64, m0,
                                  head, batch);
              sm90::tma_load_1d(t_st + S::kTile, &tlse, bar_t + 8 * st, (stat0 + m0) & ~3);
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, kv = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int n_block, kv_head, batch;
        if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
        const int n0 = n_block * kKeys;
        const xfa::QueryTilePlan pl = xfa::query_tiles<kRows, kKeys>(n0, p.sq, p.sk, p.causal);
        const int n_tiles = pl.n_tiles(), n_masked = pl.n_masked();
        const int key0 = n0 + cw * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
        float* out = p.out + static_cast<int64_t>(batch * p.h + kv_head * group) * p.sk;
        float acc[2] = {0.f, 0.f};
        if (n_tiles == 0) {  // no row sees these keys
          for (int gi = 0; gi < group; ++gi) store_sums(out + gi * p.sk, acc, key0, p.sk, t);
          continue;
        }
        const int kb = kv & 1;
        const uint32_t k_wg = base + kb * S::kK + cw * 64 * kRow;
        sm90::mbar_wait(bar_k + 8 * kb, (kv >> 1) & 1);

        // The group's heads one after the other, each over its tiles
        for (int gi = 0; gi < group; ++gi) {
          const int stat0 = (batch * p.h + kv_head * group + gi) * p.sq;
          for (int i = 0; i < n_tiles; ++i, ++it) {
            const int st = it % kStages, m0 = pl.tile(i) * kRows;
            const uint32_t t_st = base + S::kRing + st * S::kStage;
            float s[kRows / 2];
            sm90::mbar_wait(bar_t + 8 * st, (it / kStages) & 1);
            sm90::wgmma_fence();
            issue_ss<D, kRows>(s, k_wg, kKeys * kRow, t_st, kRows * kRow);  // S^T = K q^T
            sm90::wgmma_commit();
            sm90::wgmma_wait<0>();
            sm90::fence_regs(s);
            const float* lse = reinterpret_cast<const float*>(smem + S::kRing + st * S::kStage +
                                                              S::kTile) + ((stat0 + m0) & 3);
            if (i < n_masked) {
              add_tile<true>(s, lse, key0, m0, p, t, acc);
            } else {
              add_tile<false>(s, lse, key0, m0, p, t, acc);
            }
            if (lane == 0) sm90::mbar_arrive(bar_te + 8 * st);  // one arrival per consumer warp
          }
          store_sums(out + gi * p.sk, acc, key0, p.sk, t);
        }
        if (lane == 0) sm90::mbar_arrive(bar_ke + 8 * kb);  // after the block's last product
        ++kv;
      }
    }
  }
}

template <int D>
cudaError_t launch_reduced(const CUtensorMap* maps, const ReducedParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err = sm90::smem_limit_once(reduced_scores_kernel<D>, ReducedSmem<D>::kBytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  const int pairs = xfa::block_pairs((p.sk + kKeys - 1) / kKeys, p.hk, p.b);
  reduced_scores_kernel<D><<<pairs < sms ? pairs : sms, kThreads, ReducedSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], p);
  return cudaGetLastError();
}

}  // namespace

// q (b, h, sq, d) and k (b, hk, sk, d) bf16 with element strides for the
// (batch, head, seq) axes, head dim contiguous, pointers and strides
// multiples of 16 bytes (the tensor maps' rule); lse (b, h, sq) and out
// (b, h, sk) fp32 contiguous. Every output element is written.
XFA_EXPORT int xfa_reduced_scores(const void* q, const void* k, const void* lse, void* out,
                                  int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                  int64_t k_sh, int64_t k_ss, int b, int h, int hk, int sq,
                                  int sk, int d, float sm_scale, int causal, void* stream) {
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq <= 0)  // no row: every sum is 0
    return static_cast<int>(
        cudaMemsetAsync(out, 0, static_cast<size_t>(b) * h * sk * sizeof(float), s));
  CUtensorMap maps[3];
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kRows) ||
      !sm90::encode_bhsd(&maps[1], k, b, hk, sk, d, k_sb, k_sh, k_ss, kKeys) ||
      !sm90::encode_flat_f32(&maps[2], lse, static_cast<int64_t>(b) * h * sq, kStatBox))
    return static_cast<int>(cudaErrorInvalidValue);
  const ReducedParams p{static_cast<float*>(out), b, h, hk, sq, sk, sm_scale * kLog2e, causal};
  const cudaError_t err =
      d == 64 ? launch_reduced<64>(maps, p, s) : launch_reduced<128>(maps, p, s);
  return static_cast<int>(err);
}
