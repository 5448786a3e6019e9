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
// -> flash_bwd_prep_kernel.
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
// the pair against ~0.3 GB of traffic), and on Hopper only wgmma reaches
// the tensor cores' rate. Three routes:
//
// * Pre-pass (flash_bwd_prep_kernel): delta = rowsum(dO * O) in fp32 (each
//   product rounded, summed in a fixed order) in one read of dO and O, and
//   on the dense route q_s = bf16(q * sm_scale) once into a contiguous
//   (b, h, sq, d) buffer that both dense kernels read through TMA (the
//   plain version's bits; no kernel scales Q in shared memory).
//
// * Dense (no mask), the forward's design (flash_fwd.cu) turned to the
//   backward: persistent CTAs, one per SM, of three warpgroups; warpgroup 0
//   the producer (setmaxnreg.dec; one thread issues TMA through 4-D tensor
//   maps (d, s, h, b) built from the strides, 128-byte swizzled), warpgroups
//   1 and 2 consumers of 64 rows each (setmaxnreg.inc). Blocks are dealt in
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
//     d 64, 64 at d 128) stream through a ring, last to first, the masked ones first
//     (common.cuh key_tiles; bwd.py bwd_dq_tile_plan). Per tile: S = q_s
//     K^T and dP = dO V^T by SS wgmma, P and dS in registers with the row's
//     LSE and delta, dQ += dS K by RS wgmma with K MN-major; sm_scale in
//     the epilogue.
//   Each consumer runs its tiles one by one (products, then the elementwise
//   work, then products); the two consumers interleave on the tensor cores.
//   Softcap and the elementwise mask are template flags, so that the
//   unrolled elementwise loops test nothing per element. The outputs leave
//   by plain stores from the accumulators, which take any strides (the
//   packed layout of #6 included).
//   Shared memory: dK/dV d 128: 2 x (K 32 + V 32) KB + 2 x (q_s 16 + dO 16
//   + stats 1) KB; d 64: 2 x (16 + 16) KB + 4 x (8 + 8 + 1) KB. dQ d 128:
//   2 x (q_s 32 + dO 32) KB + 2 x (K 16 + V 16) KB; d 64: 2 x (16 + 16) KB
//   + 4 x (K 16 + V 16) KB.
//   Tried and dropped (PERF.md §6): a tile's P and dS under the previous
//   tile's RS products inside a consumer; the two consumers taking turns
//   (ping-pong) to issue; K/V (dK/dV) or q_s/dO (dQ) held as register A
//   fragments across tiles (the fragments read back wrong after the first
//   tile, and reloading them per tile reads as many shared-memory bytes as
//   SS).
//
// * Masked (slice 4, the TPU kernels' FlashMask and block-mask flags,
//   bwd.py:332-350, 582-600): masked_flash_bwd_dkv_kernel and
//   masked_flash_bwd_dq_kernel, mma.sync tiles, delta from the pre-pass and
//   q scaled in the kernels.
//   - dKV: grid (key tiles of 64, kv head, batch); four warps own 16 keys
//     each. K and V tiles stay in shared memory; the block walks the group's
//     query heads and the query tiles that see its keys (kQT rows: 64 at
//     d 64, 32 at d 128 to bound registers), staging q_s, dO, LSE and delta
//     per tile. Each warp computes S^T = K q_s^T and dP^T = V dO^T with its
//     keys as rows, so dV += P^T dO and dK += dS^T q_s take P^T and dS^T
//     straight from the accumulators as A fragments; dO and q_s come through
//     ldmatrix.trans.
//   - dQ: grid (query tiles of 64, head, batch); four warps own 16 rows,
//     holding q_s and dO fragments in registers; key tiles (64 at d 64, 32 at
//     d 128) up to the causal edge are staged in shared memory; dQ += dS K
//     through ldmatrix.trans of the K tile.
//   Both kernels skip, unread, the tiles the forward skips, and run the
//   elementwise band test only on tiles the FlashMask stats do not bypass;
//   stats come per each kernel's own key tile (64 keys in dK/dV, kKT in dQ).
//   In dK/dV a key tile serves the g query heads of its group, and each
//   reads its own mask head, head / (h / hm): the block reloads its keys'
//   vectors per head, and skips every query tile whose rows are all masked.
//   In causal_1 (a causal document mask) that ends the query loop at the
//   tile's largest LTStart, the end of the last document its keys belong
//   to: the work a packed batch saves.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::ldmatrix_x2_trans;
using xfa::mma_16816;
using xfa::mma_abt_smem_a;
using xfa::pack_a;
using xfa::pack_bf16;
using xfa::stage_rows;
namespace sm90 = xfa::sm90;
using sm90::ex2;
using sm90::kLog2e;

// ------------------------------------------------------------- pre-pass

struct PrepParams {
  const bf16* q;
  const bf16* dout;
  const bf16* out;
  bf16* qs;      // (b, h, sq, d) contiguous, or null
  float* delta;  // (b, h, sq) contiguous
  int64_t q_sb, q_sh, q_ss, do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  int64_t rows;  // b * h * sq
  int h, sq;
  float sm_scale;
};

constexpr int kPrepThreads = 256;

// D / 8 threads per (batch, head, row), 16 bytes of each tensor a thread.
template <int D>
__global__ void __launch_bounds__(kPrepThreads) flash_bwd_prep_kernel(const PrepParams p) {
  constexpr int kLanes = D / 8;
  const int64_t r =
      static_cast<int64_t>(blockIdx.x) * (kPrepThreads / kLanes) + threadIdx.x / kLanes;
  const int c = (threadIdx.x % kLanes) * 8;
  float acc = 0.f;
  if (r < p.rows) {
    const int64_t bh = r / p.sq;
    const int64_t row = r - bh * p.sq;
    const int64_t batch = bh / p.h, head = bh - batch * p.h;
    const uint4 dv = *reinterpret_cast<const uint4*>(p.dout + batch * p.do_sb + head * p.do_sh +
                                                     row * p.do_ss + c);
    const uint4 ov = *reinterpret_cast<const uint4*>(p.out + batch * p.o_sb + head * p.o_sh +
                                                     row * p.o_ss + c);
    const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
    const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 a = __bfloat1622float2(d2[j]), b = __bfloat1622float2(o2[j]);
      acc += __fmul_rn(a.x, b.x);
      acc += __fmul_rn(a.y, b.y);
    }
    if (p.qs != nullptr) {
      uint4 qv = *reinterpret_cast<const uint4*>(p.q + batch * p.q_sb + head * p.q_sh +
                                                 row * p.q_ss + c);
      uint32_t* w = reinterpret_cast<uint32_t*>(&qv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[j]));
        w[j] = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
      }
      *reinterpret_cast<uint4*>(p.qs + r * D + c) = qv;
    }
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (r < p.rows && threadIdx.x % kLanes == 0) p.delta[r] = acc;
}

// ------------------------------------------------------------ dense route

constexpr int kDenseThreads = 384;  // producer warpgroup + two consumers
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


template <int D>
struct DkvSmem {
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) tiles of a row
  // K or V of a block: [half][128 keys][128 B]; buffer kb holds K at
  // kK + 2 kb kKV and V after it
  static constexpr int kKV = kDkvKeys * D * 2;
  static constexpr int kK = 0;
  // a stage of the query ring: q_s and dO [half][64 rows][128 B], then the
  // tile's LSE and delta boxes (kStatBox floats each, kStatStride apart)
  static constexpr int kTile = kDkvRows * D * 2;
  static constexpr int kStatStride = 512;
  static constexpr int kStage = 2 * kTile + 2 * kStatStride;
  static constexpr int kRing = kK + 4 * kKV;
  // barriers: K/V full[2], K/V empty[2], tile full[], tile empty[]
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

template <int D>
struct DqSmem {
  static constexpr int kN = dq_keys(D);
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;
  // q_s or dO of a block: [half][128 rows][128 B]; buffer qb holds q_s at
  // kQ0 + 2 qb kQ and dO after it
  static constexpr int kQ = kDqRows * D * 2;
  static constexpr int kQ0 = 0;
  // a stage of the key ring: K then V, [half][kN keys][128 B]
  static constexpr int kKV = kN * D * 2;
  static constexpr int kRing = kQ0 + 4 * kQ;
  static constexpr int kStage = 2 * kKV;
  // barriers: Q full[2], Q empty[2], K/V full[], K/V empty[]
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

struct DenseBwdParams {
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
  int b, h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
};

// The query tiles of kDkvRows rows that the key block at n0 visits for each
// head of its group: tiles [first, n_qt), the masked ones first (the causal
// diagonal tiles [first, f0), then the ragged tail [f1, n_qt)), then the
// free ones [f0, f1), whose rows are all below sq and see every key of the
// block below sk (keys past sk are not written, so they do not count).
// Mirrored by bwd.py bwd_dkv_tile_plan.
struct DkvPlan {
  int first, f0, f1, n_qt;
  __device__ __forceinline__ int n_tiles() const { return n_qt - first; }
  __device__ __forceinline__ int n_masked() const { return (f0 - first) + (n_qt - f1); }
  __device__ __forceinline__ int tile(int i) const {
    const int diag = f0 - first, masked = n_masked();
    return i < diag ? first + i : (i < masked ? f1 + i - diag : f0 + i - masked);
  }
};

__device__ __forceinline__ DkvPlan dkv_plan(int n0, int sq, int sk, int causal) {
  DkvPlan pl;
  pl.n_qt = (sq + kDkvRows - 1) / kDkvRows;
  pl.first = 0;
  int free_from = 0;
  if (causal) {
    const int offset = sk - sq;
    pl.first = max(0, n0 - offset) / kDkvRows;  // the tile of the first row that sees key n0
    // the first row that sees the block's last key, rounded up to a tile
    const int last_key = min(n0 + kDkvKeys, sk) - 1;
    free_from = (max(0, last_key - offset) + kDkvRows - 1) / kDkvRows;
  }
  pl.f0 = min(max(free_from, pl.first), pl.n_qt);
  pl.f1 = min(max(sq / kDkvRows, pl.f0), pl.n_qt);
  return pl;
}

// C(64 x N) = A B^T over k = D (issued, not committed): A (64 rows) and B
// (N rows) K-major in 128-byte-swizzled shared memory, their 64-column
// halves a_half and b_half bytes apart.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2], uint32_t a, uint32_t a_half, uint32_t b,
                                         uint32_t b_half) {
  const uint64_t da = sm90::desc_b128(a, 16), db = sm90::desc_b128(b, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns = 32 bytes inside the swizzled row; past 64 columns, the
    // next half (offsets in the descriptor's 16-byte units)
    const uint32_t col = (kk & 3) * 2;
    const uint64_t ak = da + (kk >> 2) * (a_half >> 4) + col;
    const uint64_t bk = db + (kk >> 2) * (b_half >> 4) + col;
    if constexpr (N == 64) {
      sm90::wgmma_ss_n64(c, ak, bk, kk > 0);
    } else {
      sm90::wgmma_ss_n128(c, ak, bk, kk > 0);
    }
  }
}

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
// lse2 = LSE log2(e), delta; visible false gives 0 for both. SOFTCAP is a
// template flag so that the unrolled loops carry no test per element.
template <bool SOFTCAP>
__device__ __forceinline__ void p_ds(float x, float dp, float lse2, float delta, bool visible,
                                     float softcap, float& pr, float& ds) {
  float fac = 1.f;
  if (SOFTCAP) {
    const float th = tanhf(x / softcap);
    x = th * softcap;
    fac = 1.f - th * th;
  }
  pr = visible ? ex2(fmaf(x, kLog2e, -lse2)) : 0.f;
  ds = pr * (dp - delta) * fac;
}

// dK/dV: P^T and dS^T of one query tile, in place in fp32 (s: S^T -> P^T,
// dp: dP^T -> dS^T), this thread's keys key0 and key0 + 8 as rows and the
// tile's rows m0 + c as columns; LSE and delta per column from shared
// memory; with MASK the elementwise causal / sq test.
template <bool MASK, bool SOFTCAP>
__device__ __forceinline__ void dkv_p_ds(float (&s)[kDkvRows / 2], float (&dp)[kDkvRows / 2],
                                         const float* lse, const float* delta, int key0, int m0,
                                         const DenseBwdParams& p, int t) {
#pragma unroll
  for (int i = 0; i < kDkvRows / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);  // the query row in the tile
    bool visible = true;
    if (MASK) {
      const int key = key0 + ((i >> 1) & 1) * 8, row = m0 + c;
      visible = row < p.sq && (!p.causal || key <= row + p.sk - p.sq);
    }
    p_ds<SOFTCAP>(s[i], dp[i], lse[c] * kLog2e, delta[c], visible, p.softcap, s[i], dp[i]);
  }
}

// dQ: dS of one key tile, in place in fp32 (dp: dP -> dS), from S (s), this
// thread's rows row0 and row0 + 8 (lse2, delta per row) and the tile's keys
// n0 + c as columns; with MASK the elementwise causal / sk test.
template <bool MASK, bool SOFTCAP, int N>
__device__ __forceinline__ void dq_ds(const float (&s)[N / 2], float (&dp)[N / 2],
                                      const float (&lse2)[2], const float (&delta)[2], int row0,
                                      int n0, const DenseBwdParams& p, int t) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const int r = (i >> 1) & 1;
    bool visible = true;
    if (MASK) {
      const int col = n0 + (i >> 2) * 8 + 2 * t + (i & 1), row = row0 + 8 * r;
      visible = col < p.sk && (!p.causal || col <= row + p.sk - p.sq);
    }
    float pr;
    p_ds<SOFTCAP>(s[i], dp[i], lse2[r], delta[r], visible, p.softcap, pr, dp[i]);
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

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kDenseThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tdo,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tlse,
                         const __grid_constant__ CUtensorMap tdelta, const DenseBwdParams p) {
  using S = DkvSmem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_kv = base + S::kBar, bar_kve = bar_kv + 16;  // [2] each
  const uint32_t bar_t = bar_kve + 16, bar_te = bar_t + 8 * S::kStages;
  const int n_nb = (p.sk + kDkvKeys - 1) / kDkvKeys;
  const int n_pairs = xfa::block_pairs(n_nb, p.hk, p.b);
  const int group = p.h / p.hk;

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

  // Both roles walk the same blocks and count the same K/V loads (kv, two
  // buffers) and query tiles (it, the ring position), so buffers, stages
  // and parities agree without any other exchange.
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, kv = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int n_block, kv_head, batch;
          if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
          const int n0 = n_block * kDkvKeys;
          const DkvPlan pl = dkv_plan(n0, p.sq, p.sk, p.causal);
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
              const int m0 = pl.tile(i) * kDkvRows, st = it % S::kStages;
              const uint32_t t_st = base + S::kRing + st * S::kStage;
              sm90::mbar_wait(bar_te + 8 * st, ((it / S::kStages) & 1) ^ 1);
              sm90::mbar_expect_tx(bar_t + 8 * st, 2 * S::kTile + 2 * kStatBox * 4);
              for (int hf = 0; hf < S::kHalves; ++hf) {
                sm90::tma_load_4d(t_st + hf * kDkvRows * kRow, &tq, bar_t + 8 * st, hf * 64, m0,
                                  head, batch);
                sm90::tma_load_4d(t_st + S::kTile + hf * kDkvRows * kRow, &tdo, bar_t + 8 * st,
                                  hf * 64, m0, head, batch);
              }
              const int c0 = (stat0 + m0) & ~3;
              sm90::tma_load_1d(t_st + 2 * S::kTile, &tlse, bar_t + 8 * st, c0);
              sm90::tma_load_1d(t_st + 2 * S::kTile + S::kStatStride, &tdelta, bar_t + 8 * st, c0);
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    int it = 0, kv = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int n_block, kv_head, batch;
        if (!xfa::pair_block(pair, half, n_nb, p.hk, false, n_block, kv_head, batch)) continue;
        const int n0 = n_block * kDkvKeys;
        const DkvPlan pl = dkv_plan(n0, p.sq, p.sk, p.causal);
        const int n_tiles = pl.n_tiles(), n_masked = pl.n_masked();
        const int kb = kv & 1;
        const uint32_t k_wg = base + S::kK + kb * 2 * S::kKV + cw * 64 * kRow;
        const uint32_t v_wg = k_wg + S::kKV;
        const int key0 = n0 + cw * 64 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
        float dk[D / 2], dv[D / 2];
#pragma unroll
        for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
        sm90::mbar_wait(bar_kv + 8 * kb, (kv >> 1) & 1);
        // the group's heads one after the other, each over the plan's tiles
        for (int idx = 0; idx < group * n_tiles; ++idx, ++it) {
          const int st = it % S::kStages;
          const int gi = idx / n_tiles, i = idx - gi * n_tiles, m0 = pl.tile(i) * kDkvRows;
          const uint32_t t_st = base + S::kRing + st * S::kStage;
          sm90::mbar_wait(bar_t + 8 * st, (it / S::kStages) & 1);
          float s[kDkvRows / 2], dp[kDkvRows / 2];
          sm90::wgmma_fence();
          // S^T = K q_s^T, dP^T = V dO^T
          issue_ss<D, kDkvRows>(s, k_wg, kDkvKeys * kRow, t_st, kDkvRows * kRow);
          issue_ss<D, kDkvRows>(dp, v_wg, kDkvKeys * kRow, t_st + S::kTile, kDkvRows * kRow);
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          const int stat0 = (batch * p.h + kv_head * group + gi) * p.sq;
          const float* lse = reinterpret_cast<const float*>(smem + S::kRing + st * S::kStage +
                                                            2 * S::kTile) +
                             ((stat0 + m0) & 3);
          if (i < n_masked) {
            dkv_p_ds<true, SOFTCAP>(s, dp, lse, lse + S::kStatStride / 4, key0, m0, p, t);
          } else {
            dkv_p_ds<false, SOFTCAP>(s, dp, lse, lse + S::kStatStride / 4, key0, m0, p, t);
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
}

template <int D, bool SOFTCAP>
__global__ void __launch_bounds__(kDenseThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tdo,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv, const DenseBwdParams p) {
  using S = DqSmem<D>;
  constexpr int kN = S::kN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_q = base + S::kBar, bar_qe = bar_q + 16;  // [2] each
  const uint32_t bar_kv = bar_qe + 16, bar_e = bar_kv + 8 * S::kStages;
  const int n_mb = (p.sq + kDqRows - 1) / kDqRows;
  const int n_pairs = xfa::block_pairs(n_mb, p.h, p.b);

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

  // As in flash_fwd_kernel: both roles count the same Q loads (qk) and K/V
  // tiles (it).
  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      int it = 0, qk = 0;
      for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
        for (int half = 0; half < 2; ++half) {
          int m_block, head, batch, n_tiles, n_free;
          if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
          const int q0 = m_block * kDqRows;
          xfa::key_tiles<kDqRows, kN>(q0, p.sq, p.sk, p.causal, n_tiles, n_free);
          if (n_tiles == 0) continue;
          const int kv_head = head / (p.h / p.hk);
          const int qb = qk & 1;
          sm90::mbar_wait(bar_qe + 8 * qb, ((qk >> 1) & 1) ^ 1);
          sm90::mbar_expect_tx(bar_q + 8 * qb, 2 * S::kQ);
          const uint32_t q_buf = base + S::kQ0 + qb * 2 * S::kQ;
          for (int hf = 0; hf < S::kHalves; ++hf) {
            sm90::tma_load_4d(q_buf + hf * kDqRows * kRow, &tq, bar_q + 8 * qb, hf * 64, q0, head,
                              batch);
            sm90::tma_load_4d(q_buf + S::kQ + hf * kDqRows * kRow, &tdo, bar_q + 8 * qb, hf * 64,
                              q0, head, batch);
          }
          ++qk;
          for (int i = 0; i < n_tiles; ++i, ++it) {
            const int st = it % S::kStages, n0 = (n_tiles - 1 - i) * kN;
            const uint32_t k_st = base + S::kRing + st * S::kStage, v_st = k_st + S::kKV;
            sm90::mbar_wait(bar_e + 8 * st, ((it / S::kStages) & 1) ^ 1);
            sm90::mbar_expect_tx(bar_kv + 8 * st, 2 * S::kKV);
            for (int hf = 0; hf < S::kHalves; ++hf) {
              sm90::tma_load_4d(k_st + hf * kN * kRow, &tk, bar_kv + 8 * st, hf * 64, n0, kv_head,
                                batch);
              sm90::tma_load_4d(v_st + hf * kN * kRow, &tv, bar_kv + 8 * st, hf * 64, n0, kv_head,
                                batch);
            }
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
    int it = 0, qk = 0;
    for (int pair = blockIdx.x; pair < n_pairs; pair += gridDim.x) {
      for (int half = 0; half < 2; ++half) {
        int m_block, head, batch, n_tiles, n_free;
        if (!xfa::pair_block(pair, half, n_mb, p.h, true, m_block, head, batch)) continue;
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
        const int qb = qk & 1;
        const uint32_t q_wg = base + S::kQ0 + qb * 2 * S::kQ + cw * 64 * kRow;
        const uint32_t do_wg = q_wg + S::kQ;
        if (n_tiles > 0) {
          sm90::mbar_wait(bar_q + 8 * qb, (qk >> 1) & 1);
          ++qk;
        }
        for (int i = 0; i < n_tiles; ++i) {
          const int cur = it + i, st = cur % S::kStages;
          const uint32_t k_st = base + S::kRing + st * S::kStage, v_st = k_st + S::kKV;
          sm90::mbar_wait(bar_kv + 8 * st, (cur / S::kStages) & 1);
          float s[kN / 2], dp[kN / 2];
          sm90::wgmma_fence();
          issue_ss<D, kN>(s, q_wg, kDqRows * kRow, k_st, kN * kRow);  // S = q_s K^T
          issue_ss<D, kN>(dp, do_wg, kDqRows * kRow, v_st, kN * kRow);  // dP = dO V^T
          sm90::wgmma_commit();
          sm90::wgmma_wait<0>();
          sm90::fence_regs(s);
          sm90::fence_regs(dp);
          // after the block's last products on q_s and dO in shared memory
          if (i == n_tiles - 1 && lane == 0) sm90::mbar_arrive(bar_qe + 8 * qb);
          const int n0 = (n_tiles - 1 - i) * kN;
          if (i < n_masked) {
            dq_ds<true, SOFTCAP, kN>(s, dp, lse2, delta, row0, n0, p, t);
          } else {
            dq_ds<false, SOFTCAP, kN>(s, dp, lse2, delta, row0, n0, p, t);
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
        it += n_tiles;
        store_rows<D>(p.dq + batch * p.dq_sb + head * p.dq_sh, p.dq_ss, dq, row0, p.sq, p.sm_scale,
                      t);
      }
    }
  }
}

template <int D, bool SOFTCAP>
cudaError_t launch_dkv_kernel(const CUtensorMap* maps, const DenseBwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      sm90::smem_limit_once(flash_bwd_dkv_kernel<D, SOFTCAP>, DkvSmem<D>::kBytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  // one persistent CTA per SM (shared memory allows no second), or one per
  // pair of blocks when there are fewer
  const int pairs = xfa::block_pairs((p.sk + kDkvKeys - 1) / kDkvKeys, p.hk, p.b);
  flash_bwd_dkv_kernel<D, SOFTCAP>
      <<<pairs < sms ? pairs : sms, kDenseThreads, DkvSmem<D>::kBytes, s>>>(
          maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], p);
  return cudaGetLastError();
}

template <int D, bool SOFTCAP>
cudaError_t launch_dq_kernel(const CUtensorMap* maps, const DenseBwdParams& p, cudaStream_t s) {
  static std::atomic<uint64_t> done{0};
  cudaError_t err =
      sm90::smem_limit_once(flash_bwd_dq_kernel<D, SOFTCAP>, DqSmem<D>::kBytes, done);
  int sms = 0;
  if (err == cudaSuccess) err = sm90::sm_count(sms);
  if (err != cudaSuccess) return err;
  const int pairs = xfa::block_pairs((p.sq + kDqRows - 1) / kDqRows, p.h, p.b);
  flash_bwd_dq_kernel<D, SOFTCAP><<<pairs < sms ? pairs : sms, kDenseThreads, DqSmem<D>::kBytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dense_dkv(const CUtensorMap* maps, const DenseBwdParams& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch_dkv_kernel<D, true>(maps, p, s)
                         : launch_dkv_kernel<D, false>(maps, p, s);
}

template <int D>
cudaError_t launch_dense_dq(const CUtensorMap* maps, const DenseBwdParams& p, cudaStream_t s) {
  return p.softcap > 0.f ? launch_dq_kernel<D, true>(maps, p, s)
                         : launch_dq_kernel<D, false>(maps, p, s);
}

// ----------------------------------------------------------- masked route

constexpr int kThreads = 128;     // four warps
constexpr int kKeysPerBlock = 64;  // dKV: 16 keys per warp
constexpr int kRowsPerBlock = 64;  // dQ: 16 query rows per warp

struct BwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss;
  int64_t dq_sb, dq_sh, dq_ss;
  int64_t dk_sb, dk_sh, dk_ss;
  int64_t dv_sb, dv_sh, dv_ss;
  int h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
  xfa::MaskParams mask;
};

// As xfa::mma_abt_smem_a, with the A operand already in registers (D / 16
// k-steps).
template <int D, int N>
__device__ __forceinline__ void mma_abt_reg_a(float (&acc)[N / 8][4], const uint32_t (&a)[D / 16][4],
                                              const bf16* b_tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* br = &b_tile[(j * 8 + g) * (D + 8) + kk * 16 + 2 * t];
      mma_16816(acc[j], a[kk], *reinterpret_cast<const uint32_t*>(br),
                *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc (16 x D) += A(16 x K, the fp32 fragments `src`, rounded to bf16) times
// the staged (K rows x D) tile, read through ldmatrix.trans.
template <int D, int K>
__device__ __forceinline__ void mma_ab_trans(float (&acc)[D / 8][4], const float (&src)[K / 8][4],
                                             const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    pack_a(a, src, kk);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      uint32_t b0, b1;
      ldmatrix_x2_trans(b0, b1, &tile[(kk * 16 + (lane & 15)) * (D + 8) + j * 8]);
      mma_16816(acc[j], a, b0, b1);
    }
  }
}

// P and dS of one score element s (fp32, before softcap) with its dP:
// returns P and turns dp into dS. Invisible elements give 0 for both.
__device__ __forceinline__ float p_and_ds(float s, float& dp, float lse, float delta, bool visible,
                                          float softcap) {
  float fac = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    s = th * softcap;
    fac = 1.f - th * th;
  }
  const float pr = visible ? expf(s - lse) : 0.f;
  float ds = pr * (dp - delta);
  dp = ds * fac;
  return pr;
}

template <int D>
__host__ __device__ constexpr int dkv_query_tile() { return D == 128 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return (2 * kKeysPerBlock + 2 * dkv_query_tile<D>()) * (D + 8) * sizeof(bf16) +
         2 * dkv_query_tile<D>() * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads) masked_flash_bwd_dkv_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kQT = dkv_query_tile<D>();
  constexpr int kStride = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* vs = ks + kKeysPerBlock * kStride;
  bf16* qs = vs + kKeysPerBlock * kStride;
  bf16* dos = qs + kQT * kStride;
  float* lse_s = reinterpret_cast<float*>(dos + kQT * kStride);
  float* delta_s = lse_s + kQT;
  __shared__ int fm_s[4][kKeysPerBlock];  // the block's keys' FlashMask vectors

  const int n0 = blockIdx.x * kKeysPerBlock;  // low key tiles see most rows: first
  const int kv_head = blockIdx.y, batch = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + warp * 16;  // this warp's first key
  const int offset = p.sk - p.sq;
  const int group = p.h / p.hk;
  const xfa::MaskParams& mk = p.mask;

  stage_rows<D, kKeysPerBlock, false>(ks, p.k + batch * p.k_sb + kv_head * p.k_sh, p.k_ss, n0,
                                      p.sk, 1.f);
  stage_rows<D, kKeysPerBlock, false>(vs, p.v + batch * p.v_sb + kv_head * p.v_sh, p.v_ss, n0,
                                      p.sk, 1.f);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;
  }

  // causal: the first query row that sees key n0 is n0 - offset
  int m_begin = 0;
  if (p.causal && n0 - offset > 0) m_begin = (n0 - offset) / kQT;
  const int n_qtiles = (p.sq + kQT - 1) / kQT;

  for (int gi = 0; gi < group; ++gi) {
    const int head = kv_head * group + gi;
    const bf16* qb = p.q + batch * p.q_sb + head * p.q_sh;
    const bf16* dob = p.dout + batch * p.do_sb + head * p.do_sh;
    const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;
    int m_end = n_qtiles;
    if (mk.fm_vecs != nullptr) {  // this head's mask head: its vectors
      const int fh = xfa::fm_head(mk, head, p.h);
      __syncthreads();  // the previous head's last tile is consumed
      if (threadIdx.x < kKeysPerBlock) {
        for (int vi = 0; vi < xfa::fm_nv(mk.fm_mode); ++vi)
          fm_s[vi][threadIdx.x] = xfa::fm_vec(mk, batch, fh, vi, n0 + threadIdx.x);
      }
      if (mk.fm_mode == xfa::kFmCausal1) {  // rows >= max LTStart: all masked
        const int lts_max = xfa::fm_tile_stats(mk, batch, fh, n0, kKeysPerBlock)[0];
        m_end = min(m_end, (lts_max + kQT - 1) / kQT);
      }
    }
    for (int mt = m_begin; mt < m_end; ++mt) {
      const int m0 = mt * kQT;
      bool band = false;  // uniform over the block
      if (!xfa::mask_tile(mk, batch, head, p.h, m0, min(m0 + kQT, p.sq), n0, kKeysPerBlock,
                           band))
        continue;
      __syncthreads();  // the previous tile is consumed (and K/V staged)
      stage_rows<D, kQT, true>(qs, qb, p.q_ss, m0, p.sq, p.sm_scale);
      stage_rows<D, kQT, false>(dos, dob, p.do_ss, m0, p.sq, 1.f);
      for (int i = threadIdx.x; i < kQT; i += kThreads) {
        const int row = m0 + i;
        lse_s[i] = row < p.sq ? p.lse[stat + row] : INFINITY;
        delta_s[i] = row < p.sq ? p.delta[stat + row] : 0.f;
      }
      __syncthreads();

      // S^T = K q_s^T and dP^T = V dO^T: this warp's 16 keys x kQT rows
      float s[kQT / 8][4], dp[kQT / 8][4];
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      }
      mma_abt_smem_a<D, kQT>(s, ks, warp * 16, qs, g, t);
      mma_abt_smem_a<D, kQT>(dp, vs, warp * 16, dos, g, t);

      // element e of n-tile j: key g + (e >> 1) * 8 of the warp, query
      // j * 8 + 2t + (e & 1) of the tile
#pragma unroll
      for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + g + (e >> 1) * 8;
          const int qi = j * 8 + 2 * t + (e & 1);
          const int row = m0 + qi;
          const int c = key - n0;
          const bool visible =
              key < p.sk && row < p.sq && (!p.causal || key <= row + offset) &&
              !(band && xfa::fm_banned(mk.fm_mode, row, fm_s[0][c], fm_s[1][c], fm_s[2][c],
                                       fm_s[3][c]));
          s[j][e] = p_and_ds(s[j][e], dp[j][e], lse_s[qi], delta_s[qi], visible, p.softcap);
        }
      }
      mma_ab_trans<D, kQT>(dv_acc, s, dos, lane);   // dV += P^T dO
      mma_ab_trans<D, kQT>(dk_acc, dp, qs, lane);   // dK += dS^T q_s
    }
  }

  bf16* dkb = p.dk + batch * p.dk_sb + kv_head * p.dk_sh;
  bf16* dvb = p.dv + batch * p.dv_sb + kv_head * p.dv_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = key0 + g + i * 8;
    if (key >= p.sk) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + key * p.dk_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dk_acc[j][2 * i], dk_acc[j][2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + key * p.dv_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dv_acc[j][2 * i], dv_acc[j][2 * i + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads) masked_flash_bwd_dq_kernel(const BwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kKT = D == 128 ? 32 : 64;  // keys per tile
  constexpr int kStride = D + 8;
  __shared__ __align__(16) bf16 ks[kKT * kStride];
  __shared__ __align__(16) bf16 vs[kKT * kStride];
  __shared__ int fm_s[4][kKT];  // the tile's FlashMask vectors

  // heaviest causal query tiles first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m_block * kRowsPerBlock + warp * 16;
  const int offset = p.sk - p.sq;
  const xfa::MaskParams& mk = p.mask;
  const int q0 = m_block * kRowsPerBlock, q1 = min(q0 + kRowsPerBlock, p.sq);

  const bf16* qb = p.q + batch * p.q_sb + head * p.q_sh;
  const bf16* dob = p.dout + batch * p.do_sb + head * p.do_sh;
  const bf16* kb = p.k + batch * p.k_sb + kv_head * p.k_sh;
  const bf16* vb = p.v + batch * p.v_sb + kv_head * p.v_sh;
  const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;

  // q_s and dO fragments (A operands) of this warp's 16 rows
  uint32_t qf[D / 16][4], df[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * t;
      uint32_t qv = 0, dv = 0;
      if (row < p.sq) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qb + row * p.q_ss + col));
        qv = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
        dv = *reinterpret_cast<const uint32_t*>(dob + row * p.do_ss + col);
      }
      qf[kk][r] = qv;
      df[kk][r] = dv;
    }
  }
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + i * 8;
    lse_r[i] = row < p.sq ? p.lse[stat + row] : INFINITY;
    delta_r[i] = row < p.sq ? p.delta[stat + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) dq_acc[j][0] = dq_acc[j][1] = dq_acc[j][2] = dq_acc[j][3] = 0.f;

  int n_tiles = (p.sk + kKT - 1) / kKT;
  if (p.causal) {
    const int last_row = min((m_block + 1) * kRowsPerBlock, p.sq) - 1;
    const int max_col = last_row + offset;
    n_tiles = max_col < 0 ? 0 : min(n_tiles, max_col / kKT + 1);
  }

  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * kKT;
    bool band = false;  // uniform over the block
    if (!xfa::mask_tile(mk, batch, head, p.h, q0, q1, n0, kKT, band)) continue;
    __syncthreads();  // the previous tile is consumed
    stage_rows<D, kKT, false>(ks, kb, p.k_ss, n0, p.sk, 1.f);
    stage_rows<D, kKT, false>(vs, vb, p.v_ss, n0, p.sk, 1.f);
    if (band && threadIdx.x < kKT) {
      const int fh = xfa::fm_head(mk, head, p.h);
      for (int vi = 0; vi < xfa::fm_nv(mk.fm_mode); ++vi)
        fm_s[vi][threadIdx.x] = xfa::fm_vec(mk, batch, fh, vi, n0 + threadIdx.x);
    }
    __syncthreads();

    float s[kKT / 8][4], dp[kKT / 8][4];
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
    mma_abt_reg_a<D, kKT>(s, qf, ks, g, t);   // S = q_s K^T
    mma_abt_reg_a<D, kKT>(dp, df, vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        const int c = col - n0;
        const bool visible =
            col < p.sk && row < p.sq && (!p.causal || col <= row + offset) &&
            !(band && xfa::fm_banned(mk.fm_mode, row, fm_s[0][c], fm_s[1][c], fm_s[2][c],
                                     fm_s[3][c]));
        p_and_ds(s[j][e], dp[j][e], lse_r[e >> 1], delta_r[e >> 1], visible, p.softcap);
      }
    }
    mma_ab_trans<D, kKT>(dq_acc, dp, ks, lane);  // dQ += dS K
  }

  bf16* dqb = p.dq + batch * p.dq_sb + head * p.dq_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + i * 8;
    if (row >= p.sq) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dqb + row * p.dq_ss + j * 8 + 2 * t) =
          __floats2bfloat162_rn(dq_acc[j][2 * i] * p.sm_scale,
                                dq_acc[j][2 * i + 1] * p.sm_scale);
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, void* dk, void* dv,
                      const int64_t* st, int h, int hk, int sq, int sk, float sm_scale,
                      float softcap, int causal, const xfa::MaskParams& mask) {
  BwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  int64_t* fields[] = {&p.q_sb,  &p.q_sh,  &p.q_ss,  &p.k_sb,  &p.k_sh,  &p.k_ss,  &p.v_sb,
                       &p.v_sh,  &p.v_ss,  &p.do_sb, &p.do_sh, &p.do_ss, &p.dq_sb, &p.dq_sh,
                       &p.dq_ss, &p.dk_sb, &p.dk_sh, &p.dk_ss, &p.dv_sb, &p.dv_sh, &p.dv_ss};
  for (int i = 0; i < 21; ++i) *fields[i] = st[i];
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.causal = causal;
  p.mask = mask;
  return p;
}

bool has_masks(const BwdParams& p) { return p.mask.fm_vecs != nullptr || p.mask.bm != nullptr; }

template <int D>
cudaError_t launch_masked_dkv(const BwdParams& p, int b, cudaStream_t s) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(masked_flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + kKeysPerBlock - 1) / kKeysPerBlock, p.hk, b);
  masked_flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_masked_dq(const BwdParams& p, int b, cudaStream_t s) {
  const dim3 grid((p.sq + kRowsPerBlock - 1) / kRowsPerBlock, p.h, b);
  masked_flash_bwd_dq_kernel<D><<<grid, kThreads, 0, s>>>(p);
  return cudaGetLastError();
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
                                  float sm_scale, void* stream) {
  const int64_t rows = static_cast<int64_t>(b) * h * sq;
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  const PrepParams p{static_cast<const bf16*>(q), static_cast<const bf16*>(dout),
                     static_cast<const bf16*>(out), static_cast<bf16*>(qs),
                     static_cast<float*>(delta), q_sb, q_sh, q_ss, do_sb, do_sh, do_ss, o_sb,
                     o_sh, o_ss, rows, h, sq, sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_block = kPrepThreads / (d / 8);
  const unsigned grid = static_cast<unsigned>((rows + per_block - 1) / per_block);
  if (d == 64) flash_bwd_prep_kernel<64><<<grid, kPrepThreads, 0, s>>>(p);
  else if (d == 128) flash_bwd_prep_kernel<128><<<grid, kPrepThreads, 0, s>>>(p);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// The 21 strides, in elements, are (batch, head, seq) of q, k, v, dout, dq,
// dk and dv in that order; the head-dim axis of every tensor is contiguous.
// lse and delta are (b, h, sq) fp32 contiguous. The mask arguments
// (XFA_MASK_ARGS, common.cuh) carry FlashMask stats per key tile of the
// kernel launched: 64 keys for dK/dV, kKT (64 at d 64, 32 at d 128) for dQ.
// With no mask the dense kernels run, and `q` is q_s, the pre-pass's
// bf16(q * sm_scale), read through TMA tensor maps: pointers and strides
// multiples of 16 bytes; with a mask the masked kernels run on q itself.
// dk/dv are written by xfa_flash_bwd_dkv, dq by xfa_flash_bwd_dq; each
// launch overwrites its outputs (no zero fill needed) for sq, sk > 0.
#define XFA_BWD_ARGS                                                                           \
  const void *q, const void *k, const void *v, const void *dout, const void *lse,              \
      const void *delta, void *dq, void *dk, void *dv, int64_t q_sb, int64_t q_sh, int64_t q_ss, \
      int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss,      \
      int64_t do_sb, int64_t do_sh, int64_t do_ss, int64_t dq_sb, int64_t dq_sh, int64_t dq_ss, \
      int64_t dk_sb, int64_t dk_sh, int64_t dk_ss, int64_t dv_sb, int64_t dv_sh, int64_t dv_ss, \
      int b, int h, int hk, int sq, int sk, int d, float sm_scale, float softcap, int causal,    \
      XFA_MASK_ARGS, void *stream
#define XFA_BWD_PARAMS                                                                        \
  const int64_t st[21] = {q_sb,  q_sh,  q_ss,  k_sb,  k_sh,  k_ss,  v_sb,  v_sh,  v_ss,  do_sb, \
                          do_sh, do_ss, dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, \
                          dv_ss};                                                              \
  const BwdParams p = make_params(q, k, v, dout, lse, delta, dq, dk, dv, st, h, hk, sq, sk,    \
                                  sm_scale, softcap, causal, XFA_MASK_VALUES);                 \
  const DenseBwdParams dp{static_cast<const float*>(lse), static_cast<const float*>(delta),    \
                          static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), \
                          dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss, b, h,   \
                          hk, sq, sk, sm_scale, softcap, causal};                              \
  cudaStream_t s = static_cast<cudaStream_t>(stream)

XFA_EXPORT int xfa_flash_bwd_dkv(XFA_BWD_ARGS) {
  XFA_BWD_PARAMS;
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (has_masks(p))
    return static_cast<int>(d == 64 ? launch_masked_dkv<64>(p, b, s)
                                    : launch_masked_dkv<128>(p, b, s));
  if (sq <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[6];
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kDkvRows) ||
      !sm90::encode_bhsd(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kDkvRows) ||
      !sm90::encode_bhsd(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, kDkvKeys) ||
      !sm90::encode_bhsd(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, kDkvKeys) ||
      !sm90::encode_flat_f32(&maps[4], lse, static_cast<int64_t>(b) * h * sq, kStatBox) ||
      !sm90::encode_flat_f32(&maps[5], delta, static_cast<int64_t>(b) * h * sq, kStatBox))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(d == 64 ? launch_dense_dkv<64>(maps, dp, s)
                                  : launch_dense_dkv<128>(maps, dp, s));
}

XFA_EXPORT int xfa_flash_bwd_dq(XFA_BWD_ARGS) {
  XFA_BWD_PARAMS;
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  if (has_masks(p))
    return static_cast<int>(d == 64 ? launch_masked_dq<64>(p, b, s)
                                    : launch_masked_dq<128>(p, b, s));
  if (sk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4];
  if (!sm90::encode_bhsd(&maps[0], q, b, h, sq, d, q_sb, q_sh, q_ss, kDqRows) ||
      !sm90::encode_bhsd(&maps[1], dout, b, h, sq, d, do_sb, do_sh, do_ss, kDqRows) ||
      !sm90::encode_bhsd(&maps[2], k, b, hk, sk, d, k_sb, k_sh, k_ss, dq_keys(d)) ||
      !sm90::encode_bhsd(&maps[3], v, b, hk, sk, d, v_sb, v_sh, v_ss, dq_keys(d)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(d == 64 ? launch_dense_dq<64>(maps, dp, s)
                                  : launch_dense_dq<128>(maps, dp, s));
}
