// Decode and chunked-prefill attention against a paged KV cache.
//
// Replaces two TPU kernels, one C entry here behind two entries of
// inference/paged.py (separate launch counts, as flash_fwd.cu serves two):
//   * xhy_flash_attention_tpu/inference/paged.py:149 `_paged_decode_kernel`
//     (the "page" entry: head dims other than 128, or one page per sequence);
//   * xhy_flash_attention_tpu/inference/paged.py:219
//     `_paged_decode_chunked_kernel` (the "chunked" entry: every engine
//     decode, chunked-prefill and speculative step at d = 128).
// The TPU split into two kernels follows the cost of its DMA descriptors;
// here the kernels gather key rows through the page table themselves, so one
// entry serves both.
//
// What it computes, as the TPU kernels do: pages (P, hk, 2, ps, d) hold K
// (index 0) and V (index 1) rows; key j of sequence b lives in page
// page_table[b, j / ps] (clamped to [0, P - 1], as paged.py _gather clamps)
// at row j % ps. Rows are PackGQA, sq * g per KV head (row r = si * g + gi),
// and row r sees keys j <= pos = length - sq + r / g (with a window also
// j >= pos - window_left); a sequence of length 0 gives zeros. s = (q . k) *
// sm_scale in fp32, with int8 / e4m3 pages s = (q . k) * k_scale[j] *
// sm_scale over the linear per-sequence scales kv_scales (b, hk, 2, npp *
// ps); optional softcap; online softmax in fp32; P (times v_scale[j] for
// quantized pages) rounded to bf16 for P.V, as the TPU kernels round it to
// the query dtype; output divided by the fp32 row sum. int8 and e4m3
// payloads convert to bf16 exactly, so the TPU kernels' exponent rebias
// folded into the scales is not needed. fp32 pages take fp32 queries: the
// decode regime runs decode_body's fp32 path (scores on CUDA cores, P kept
// in fp32, as the plain version keeps it), the prefill regime the paged
// instantiation of flash_fp32.cu's forward (inference/paged.py routes it).
//
// Two regimes with two bounds, chosen on the host from sq * g (a shape,
// never a device value, so a call can be captured in a CUDA graph):
//
// * Decode (sq * g <= 16: every engine decode step, short speculative
//   steps). Bound by bytes: each key row is read once for the g rows of its
//   KV head. This is flash_decode.cu's kernel (decode_body of
//   decode_core.cuh, kPaged): each (batch, kv head) spread over a cluster of
//   1-8 CTAs (inference/paged.py paged_launch_plan sizes it from the
//   capacity npp * ps, b * hk and the SM count, never from lengths), each CTA
//   a tile-aligned run of the sequence's visible keys found on the device
//   from lengths and window_left (a CTA whose run is empty loads nothing);
//   64-key K/V tiles gathered through the page table by 16-byte cp.async
//   into a 3-6 stage ring with their scales (one table read a tile when ps
//   is a multiple of 64, else one a key); warps own keys, rows padded to 16
//   for mma.sync scores, P.V on CUDA cores; 1-byte payloads converted by
//   integer tricks; the warps merged in shared memory, then the cluster in
//   distributed shared memory in rank order (no workspace, no atomics, no
//   second launch; two calls give the same bits). Shared rather than copied:
//   the paged form differs in the row address and in P * v_scale rounded to
//   bf16, both template branches, and a second copy would have to follow
//   every later change of the first.
//
// * Prefill (sq * g > 16: chunked prefill, sq 512 -> 2048 rows per KV head;
//   long verify steps). Bound by operations, so the tensor cores through
//   wgmma, as flash_fwd.cu's dense forward: a CTA of three warpgroups owns
//   128 PackGQA rows of one (batch, kv head) (grid (row blocks, hk, b), the
//   blocks that see the most keys first).
//   - Warpgroup 0 produces K/V tiles of 128 keys into a ring (2 stages at
//     d 128, 4 at d 64; full and empty mbarriers). bf16 pages with ps a
//     multiple of 128: one thread, one TMA load per 64-column half of K and
//     of V through a 5-D tensor map over the pages (d, ps, 2, hk, P), the
//     page from page_table[b, n0 / ps] as a coordinate. Other page sizes:
//     all 128 threads, 16-byte cp.async per key row into the 128-byte
//     swizzled layout, the page looked up per row. 1-byte pages: cp.async
//     of the raw tile and its scales into a staging buffer, then each thread
//     converts the chunks it copied itself (no barrier between them) into
//     the swizzled bf16 stage and fences them to the async proxy.
//   - Warpgroups 1 and 2 consume 64 rows each: Q rows gathered from (b, sq,
//     h, d) into swizzled shared memory as they are (the scale comes after
//     QK^T); per tile S = Q K^T by wgmma m64n128k16, scores times k_scale *
//     sm_scale, softcap (a template flag: a run-time test inside the
//     unrolled loop doubled the dense backward's time), the mask only on the
//     tiles that need it, the online softmax, P * v_scale rounded to bf16 as
//     the register A operand of O += P V (V MN-major); O written straight
//     from registers to its (si, gi) rows.
//   - The block's keys run from max(0, first row's pos - window_left) to
//     its last row's pos: tiles outside are never loaded. They are visited
//     last to first, so the tile on the causal diagonal comes first; a tile
//     is masked unless every row of the block sees all of it
//     (paged.py prefill_tile_plan mirrors the plan).
#include <climits>

#include "decode_core.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace sm90 = xfa::sm90;
using xfa::pack_bf16;

// ------------------------------------------------------------ decode regime

// The query type of a page type: fp32 pages take fp32 queries (the
// CUDA-core scores of decode_body, P kept in fp32), the others bf16.
template <typename C>
using QueryOf = std::conditional_t<std::is_same<C, float>::value, float, bf16>;

template <typename C, int D, int kRows>
__global__ void __launch_bounds__(kThreads, 2) paged_decode_kernel(const DecodeParams p) {
  decode_body<QueryOf<C>, C, D, false, kRows, true>(p);
}

// ----------------------------------------------------------- prefill regime

constexpr int kPrefillM = 128;             // PackGQA rows per CTA (two consumers of 64)
constexpr int kPrefillN = sm90::kKeyTile;  // keys per tile (128)
constexpr int kPrefillThreads = 384;       // producer warpgroup + two consumers
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

struct PrefillParams {
  const bf16* q;         // (b, sq, h, d) contiguous
  const void* pages;     // (num_pages, hk, 2, ps, d) contiguous
  const float* scales;   // (b, hk, 2, npp * ps) contiguous, or null
  const int* table;      // (b, npp)
  const int* lengths;    // (b,)
  bf16* out;             // (b, sq, h, d)
  int sq, h, hk, ps, npp, num_pages;
  float sm_scale, softcap;
  int window_left;
  int tma;  // K/V tiles by TMA (bf16 pages, ps % kPrefillN == 0), else cp.async
};

template <typename C, int D>
struct PrefillSmem {
  static constexpr bool kQuant = sizeof(C) == 1;  // int8 / e4m3 pages with scales
  static constexpr int kStages = D == 64 ? 4 : 2;
  static constexpr int kHalves = D / 64;  // 64-column (128-byte) boxes of a row
  // Q: [consumer 2][half][64 rows][128 B]; a K or V stage: [half][128 keys][128 B]
  static constexpr int kQWarpgroup = kHalves * sm90::kBox64;
  static constexpr int kTile = kPrefillN * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kQWarpgroup;
  static constexpr int kV = kK + kStages * kTile;
  // 1-byte pages: the raw K and V rows of the tile being converted, the
  // scales of every stage [stage][k, v][key] and the raw scales [k, v][key]
  static constexpr int kRaw = kV + kStages * kTile;
  static constexpr int kRawRows = kQuant ? kPrefillN * D : 0;
  static constexpr int kSc = kRaw + 2 * kRawRows;
  static constexpr int kRawSc = kSc + (kQuant ? kStages * 2 * kPrefillN * 4 : 0);
  // barriers: full[], empty[]
  static constexpr int kBar = kRawSc + (kQuant ? 2 * kPrefillN * 4 : 0);
  static constexpr int kBytes = kBar + 16 * kStages + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "over the 227 KB a block may use");
};

// The keys of row block m_block (rows r0 .. r1): tiles t_last down to
// t_last - n_tiles + 1, and the first and last rows' positions (paged.py
// prefill_tile_plan is the same computation).
struct BlockPlan {
  int t_last, n_tiles, pos_first, pos_last;
};

__device__ __forceinline__ BlockPlan block_plan(const PrefillParams& p, int length, int m_block) {
  const int g = p.h / p.hk, rows = p.sq * g, cap = p.npp * p.ps;
  const int r0 = m_block * kPrefillM, r1 = min(r0 + kPrefillM, rows) - 1;
  BlockPlan bp;
  bp.pos_first = length - p.sq + r0 / g;
  bp.pos_last = length - p.sq + r1 / g;
  const int hi = min(bp.pos_last, cap - 1);
  const int lo = p.window_left >= 0 ? max(0, bp.pos_first - p.window_left) : 0;
  bp.t_last = hi / kPrefillN;
  bp.n_tiles = hi >= lo ? bp.t_last - lo / kPrefillN + 1 : 0;
  return bp;
}

// Whether the tile at n0 needs the elementwise mask: some row of the block
// does not see all of it.
__device__ __forceinline__ bool tile_masked(const PrefillParams& p, const BlockPlan& bp, int n0) {
  const int cap = p.npp * p.ps;
  const bool all_before = n0 + kPrefillN - 1 <= min(bp.pos_first, cap - 1);
  const bool all_after = p.window_left < 0 || n0 >= bp.pos_last - p.window_left;
  return !(all_before && all_after);
}

// The online softmax of one tile's accumulators s (register i: row g + 8 *
// ((i / 2) % 2), column 8 * (i / 4) + 2t + (i % 2)), in place: scales,
// softcap and, with MASK, the elementwise test against this thread's rows'
// key range [lo_r, hi_r], then hopper.cuh's softmax_step (flash_fwd.cu's
// step too): the running max m_i, s = P in fp32, this thread's share of the
// row sums l_i (before v_scale) and alpha.
template <bool MASK, bool SOFTCAP, bool QUANT>
__device__ __forceinline__ void prefill_softmax(float (&s)[kPrefillN / 2], float (&m_i)[2],
                                                float (&l_i)[2], float (&alpha)[2], int n0,
                                                const int (&lo_r)[2], const int (&hi_r)[2],
                                                const float* ksc, const PrefillParams& p,
                                                int t) {
#pragma unroll
  for (int i = 0; i < kPrefillN / 2; ++i) {
    const int c = (i >> 2) * 8 + 2 * t + (i & 1);
    float x = s[i] * (QUANT ? ksc[c] * p.sm_scale : p.sm_scale);
    if (SOFTCAP) x = tanhf(x / p.softcap) * p.softcap;
    if (MASK) {
      const int col = n0 + c, rr = (i >> 1) & 1;
      if (col > hi_r[rr] || col < lo_r[rr]) x = -INFINITY;
    }
    s[i] = x;
  }
  sm90::softmax_step(s, m_i, l_i, alpha);
}

// Byte offset of 16-byte chunk c (of D / 8) of key row j in a swizzled tile
template <int D>
__device__ __forceinline__ int swz(int j, int c) {
  return (c >> 3) * (kPrefillN * 128) + j * 128 + (((c & 7) ^ (j & 7)) << 4);
}

template <typename C, int D, bool SOFTCAP>
__global__ void __launch_bounds__(kPrefillThreads, 1)
    paged_prefill_kernel(const __grid_constant__ CUtensorMap tkv, const PrefillParams p) {
  using S = PrefillSmem<C, D>;
  constexpr bool kQuant = S::kQuant;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (sm90::smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = sm90::smem_addr(smem);
  const uint32_t bar_f = base + S::kBar, bar_e = bar_f + 8 * S::kStages;
  float* sc = reinterpret_cast<float*>(smem + S::kSc);

  const int m_block = gridDim.x - 1 - blockIdx.x;  // the blocks that see the most keys first
  const int kh = blockIdx.y, b = blockIdx.z;
  const int gq = p.h / p.hk, rows = p.sq * gq, cap = p.npp * p.ps;
  const int length = p.lengths[b];
  const BlockPlan bp = block_plan(p, length, m_block);
  const int hi = min(bp.pos_last, cap - 1);  // the block's last key

  if (threadIdx.x == 0) {
    for (int st = 0; st < S::kStages; ++st) {
      sm90::mbar_init(bar_f + 8 * st, p.tma ? 1 : 128);  // TMA: the expect_tx arrival
      sm90::mbar_init(bar_e + 8 * st, 8);                 // the eight consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int warpgroup = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (warpgroup == 0) {
    // ---- producer warpgroup
    sm90::setmaxnreg_dec<kProducerRegs>();
    const int pt = threadIdx.x;
    const C* pages = static_cast<const C*>(p.pages);
    const int* table = p.table + static_cast<int64_t>(b) * p.npp;
    const int64_t page_stride = static_cast<int64_t>(p.hk) * 2 * p.ps * D;
    const int64_t head_off = static_cast<int64_t>(kh) * 2 * p.ps * D;
    auto page_of = [&](int key) { return min(max(table[key / p.ps], 0), p.num_pages - 1); };
    auto n0_of = [&](int i) { return (bp.t_last - i) * kPrefillN; };
    auto empty_parity = [&](int i) { return static_cast<uint32_t>(((i / S::kStages) & 1) ^ 1); };
    // K row of `key` (V follows ps rows later); keys past the block's last
    // are not read (the copies zero-fill them)
    auto key_row = [&](int key) {
      const int k = key <= hi ? key : 0;
      return pages + page_of(k) * page_stride + head_off + static_cast<int64_t>(k % p.ps) * D;
    };
    if (p.tma) {
      if (pt == 0) {
        for (int i = 0; i < bp.n_tiles; ++i) {
          const int st = i % S::kStages, n0 = n0_of(i);
          const uint32_t k_st = base + S::kK + st * S::kTile, v_st = base + S::kV + st * S::kTile;
          sm90::mbar_wait(bar_e + 8 * st, empty_parity(i));  // the first pass is free
          const int page = page_of(n0), row = n0 % p.ps;
          sm90::mbar_expect_tx(bar_f + 8 * st, 2 * S::kTile);
          for (int hf = 0; hf < S::kHalves; ++hf) {
            sm90::tma_load_5d(k_st + hf * kPrefillN * 128, &tkv, bar_f + 8 * st, hf * 64, row, 0, kh,
                              page);
            sm90::tma_load_5d(v_st + hf * kPrefillN * 128, &tkv, bar_f + 8 * st, hf * 64, row, 1, kh,
                              page);
          }
        }
      }
    } else if constexpr (!kQuant) {
      // bf16 pages of any size: each thread copies 16-byte chunks of key
      // rows into the swizzled stage; a stage is full once every thread's
      // copies into it have landed (two tiles in flight per thread)
      constexpr int kChunks = D / 8;
      auto load = [&](int i, int st) {
        const int n0 = n0_of(i);
        uint8_t* kt = smem + S::kK + st * S::kTile;
        uint8_t* vt = smem + S::kV + st * S::kTile;
#pragma unroll
        for (int it = 0; it < kPrefillN * kChunks / 128; ++it) {
          const int idx = pt + it * 128, j = idx / kChunks, c = idx % kChunks;
          const C* src = key_row(n0 + j) + c * 8;
          cp_async16(kt + swz<D>(j, c), src, n0 + j <= hi);
          cp_async16(vt + swz<D>(j, c), src + static_cast<int64_t>(p.ps) * D, n0 + j <= hi);
        }
      };
      for (int i = 0; i < bp.n_tiles; ++i) {
        const int st = i % S::kStages;
        sm90::mbar_wait(bar_e + 8 * st, empty_parity(i));
        load(i, st);
        cp_async_commit();
        if (i > 0) {
          cp_async_wait<1>();
          sm90::fence_proxy_async();  // the copies, before wgmma reads them
          sm90::mbar_arrive(bar_f + 8 * ((i - 1) % S::kStages));
        }
      }
      if (bp.n_tiles > 0) {
        cp_async_wait<0>();
        sm90::fence_proxy_async();
        sm90::mbar_arrive(bar_f + 8 * ((bp.n_tiles - 1) % S::kStages));
      }
    } else {
      // 1-byte pages: each thread copies chunks of 16 raw bytes (and two
      // scales) into the staging buffer and converts the same chunks into
      // the swizzled bf16 stage, so it waits for its own copies only; the
      // next tile's copies run while the consumers work
      constexpr int kRawChunks = D / 16;
      uint8_t* raw = smem + S::kRaw;
      float* raw_sc = reinterpret_cast<float*>(smem + S::kRawSc);
      const float* scales = p.scales + (static_cast<int64_t>(b) * p.hk + kh) * 2 * cap;
      auto load_raw = [&](int i) {
        const int n0 = n0_of(i);
#pragma unroll
        for (int it = 0; it < kPrefillN * kRawChunks / 128; ++it) {
          const int idx = pt + it * 128, j = idx / kRawChunks, c = idx % kRawChunks;
          const C* src = key_row(n0 + j) + c * 16;
          cp_async16(raw + j * D + c * 16, src, n0 + j <= hi);
          cp_async16(raw + S::kRawRows + j * D + c * 16, src + static_cast<int64_t>(p.ps) * D,
                     n0 + j <= hi);
        }
        const int key = n0 + pt;
        const bool ok = key <= hi;
        cp_async4(raw_sc + pt, scales + (ok ? key : 0), ok);
        cp_async4(raw_sc + kPrefillN + pt, scales + cap + (ok ? key : 0), ok);
      };
      auto convert = [&](const uint8_t* src, uint8_t* dst, int j, int c) {
        const uint4 w = *reinterpret_cast<const uint4*>(src);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
        uint32_t o[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = pack_bf16(byte_to_float(ws[e / 2], 2 * (e % 2), C{}),
                           byte_to_float(ws[e / 2], 2 * (e % 2) + 1, C{}));
        *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c)) = make_uint4(o[0], o[1], o[2], o[3]);
        *reinterpret_cast<uint4*>(dst + swz<D>(j, 2 * c + 1)) = make_uint4(o[4], o[5], o[6], o[7]);
      };
      if (bp.n_tiles > 0) load_raw(0);
      cp_async_commit();
      for (int i = 0; i < bp.n_tiles; ++i) {
        const int st = i % S::kStages;
        cp_async_wait<0>();
        sm90::mbar_wait(bar_e + 8 * st, empty_parity(i));
        uint8_t* kt = smem + S::kK + st * S::kTile;
        uint8_t* vt = smem + S::kV + st * S::kTile;
#pragma unroll
        for (int it = 0; it < kPrefillN * kRawChunks / 128; ++it) {
          const int idx = pt + it * 128, j = idx / kRawChunks, c = idx % kRawChunks;
          convert(raw + j * D + c * 16, kt, j, c);
          convert(raw + S::kRawRows + j * D + c * 16, vt, j, c);
        }
        sc[st * 2 * kPrefillN + pt] = raw_sc[pt];
        sc[st * 2 * kPrefillN + kPrefillN + pt] = raw_sc[kPrefillN + pt];
        sm90::fence_proxy_async();  // the bf16 tiles, before wgmma reads them
        sm90::mbar_arrive(bar_f + 8 * st);
        if (i + 1 < bp.n_tiles) load_raw(i + 1);
        cp_async_commit();
      }
    }
  } else {
    // ---- consumer warpgroups: 64 rows each
    sm90::setmaxnreg_inc<kConsumerRegs>();
    const int cw = warpgroup - 1;
    const int wt = threadIdx.x & 127;
    const int warp = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
    const int rq0 = m_block * kPrefillM + cw * 64;  // this consumer's first row
    const uint32_t q_wg = base + S::kQ + cw * S::kQWarpgroup;
    uint8_t* q_wg_ptr = smem + S::kQ + cw * S::kQWarpgroup;

    // Q rows (PackGQA: row r is token r / g, head kh * g + r % g) as they
    // are, into the swizzled layout; rows past sq * g are zero
    constexpr int kChunks = D / 8;
    for (int c = wt; c < 64 * kChunks; c += 128) {
      const int lr = c / kChunks, ch = c % kChunks, r = rq0 + lr;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) {
        const int si = r / gq, gi = r % gq;
        v = *reinterpret_cast<const uint4*>(
            p.q + ((static_cast<int64_t>(b) * p.sq + si) * p.h + kh * gq + gi) * D + ch * 8);
      }
      *reinterpret_cast<uint4*>(q_wg_ptr + (ch >> 3) * sm90::kBox64 + lr * 128 +
                                (((ch & 7) ^ (lr & 7)) << 4)) = v;
    }
    sm90::fence_proxy_async();  // the writes above, before wgmma reads them
    sm90::named_barrier(1 + cw, 128);

    // this thread's rows row_a and row_a + 8: the keys each sees
    const int row_a = rq0 + warp * 16 + g;
    int lo_r[2], hi_r[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pos = length - p.sq + (row_a + 8 * rr) / gq;
      hi_r[rr] = min(pos, cap - 1);
      lo_r[rr] = p.window_left >= 0 ? pos - p.window_left : INT_MIN;
    }
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};
    float s[kPrefillN / 2];
    uint32_t pa[kPrefillN / 4];
    float alpha[2];

    for (int i = 0; i < bp.n_tiles; ++i) {
      const int st = i % S::kStages, n0 = (bp.t_last - i) * kPrefillN;
      sm90::mbar_wait(bar_f + 8 * st, static_cast<uint32_t>((i / S::kStages) & 1));
      sm90::wgmma_fence();
      sm90::issue_qk<D>(s, q_wg, base + S::kK + st * S::kTile);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(s);
      const float* ksc = sc + st * 2 * kPrefillN;
      const float* vsc = ksc + kPrefillN;
      if (tile_masked(p, bp, n0)) {
        prefill_softmax<true, SOFTCAP, kQuant>(s, m_i, l_i, alpha, n0, lo_r, hi_r, ksc, p, t);
      } else {
        prefill_softmax<false, SOFTCAP, kQuant>(s, m_i, l_i, alpha, n0, lo_r, hi_r, ksc, p, t);
      }
      // P (times v_scale) rounded to bf16 pairs: pa[4kk .. 4kk + 3] is the A
      // fragment of k-step kk
#pragma unroll
      for (int j = 0; j < kPrefillN / 4; ++j) {
        const int c = (j >> 1) * 8 + 2 * t;
        pa[j] = kQuant ? pack_bf16(s[2 * j] * vsc[c], s[2 * j + 1] * vsc[c + 1])
                       : pack_bf16(s[2 * j], s[2 * j + 1]);
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];
      sm90::fence_regs(o);
      sm90::fence_regs(pa);
      sm90::wgmma_fence();
      sm90::issue_pv<D>(o, pa, base + S::kV + st * S::kTile);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      if (lane == 0) sm90::mbar_arrive(bar_e + 8 * st);  // one arrival per consumer warp
    }

    // O / l straight to the output rows (0 where a row saw nothing)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_i[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = l > 0.f ? 1.f / l : 0.f;
      const int row = row_a + 8 * rr;
      if (row >= rows) continue;
      const int si = row / gq, gi = row % gq;
      bf16* orow = p.out + ((static_cast<int64_t>(b) * p.sq + si) * p.h + kh * gq + gi) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
            __floats2bfloat162_rn(o[4 * j + 2 * rr] * inv, o[4 * j + 2 * rr + 1] * inv);
      }
    }
  }
}

template <typename C, int D, bool SOFTCAP>
cudaError_t launch_prefill(const CUtensorMap& tkv, const PrefillParams& p, int b,
                           cudaStream_t s) {
  using S = PrefillSmem<C, D>;
  static std::atomic<uint64_t> done{0};
  auto kernel = paged_prefill_kernel<C, D, SOFTCAP>;
  const cudaError_t err = sm90::smem_limit_once(kernel, S::kBytes, done);
  if (err != cudaSuccess) return err;
  const int rows = p.sq * (p.h / p.hk);
  const dim3 grid((rows + kPrefillM - 1) / kPrefillM, p.hk, b);
  kernel<<<grid, kPrefillThreads, S::kBytes, s>>>(tkv, p);
  return cudaGetLastError();
}

template <typename C>
cudaError_t prefill_d(const CUtensorMap& tkv, const PrefillParams& p, int b, int d,
                      cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  if (d == 64)
    return cap ? launch_prefill<C, 64, true>(tkv, p, b, s) : launch_prefill<C, 64, false>(tkv, p, b, s);
  if (d == 128)
    return cap ? launch_prefill<C, 128, true>(tkv, p, b, s)
               : launch_prefill<C, 128, false>(tkv, p, b, s);
  return cudaErrorInvalidValue;
}

// The decode regime: kernel instance for the page type, head dim and rows
// (4 for rows <= 4, else kMaxRows), on clusters of `cluster` CTAs.
template <typename C>
cudaError_t decode_d(const DecodeParams& p, int b, int d, int rows, int cluster, cudaStream_t s) {
  auto launch = [&](auto dd, auto rows_cap) -> cudaError_t {
    constexpr int D = decltype(dd)::value;
    auto kernel = paged_decode_kernel<C, D, decltype(rows_cap)::value>;
    static std::atomic<uint64_t> done{0};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err = cluster_config(kernel, Smem<QueryOf<C>, C, D>::kBytes, dim3(cluster, p.hk, b),
                                     cluster, s, cfg, attr, done);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  };
  using R4 = std::integral_constant<int, 4>;
  using R16 = std::integral_constant<int, kMaxRows>;
  if (d == 64)
    return rows <= 4 ? launch(std::integral_constant<int, 64>{}, R4{})
                     : launch(std::integral_constant<int, 64>{}, R16{});
  if (d == 128)
    return rows <= 4 ? launch(std::integral_constant<int, 128>{}, R4{})
                     : launch(std::integral_constant<int, 128>{}, R16{});
  return cudaErrorInvalidValue;
}

}  // namespace

// q, out: (b, sq, h, d) contiguous, q on a 16-byte boundary, bf16 (fp32
// with fp32 pages); pages: (num_pages, hk, 2, ps, d) contiguous of
// page_dtype (0 fp32, 1 bf16, 2 int8 with scales, 3 e4m3 with scales) on a
// 16-byte boundary; scales: (b, hk, 2, npp
// * ps) fp32 contiguous or null; table: (b, npp) int32; lengths: (b,) int32
// counting the sq new tokens. sq * (h / hk) <= 16 rows take the decode
// regime on clusters of `cluster` CTAs (1, 2, 4 or 8) per (batch, kv head);
// more rows the prefill regime (cluster is not read), which fp32 pages
// take in flash_fp32.cu (xfa_flash_fwd_fp32 with a page table).
XFA_EXPORT int xfa_paged_decode(const void* q, const void* pages, const void* scales,
                                const void* table, const void* lengths, void* out, int b, int sq,
                                int h, int hk, int ps, int npp, int num_pages, int d,
                                int page_dtype, float sm_scale, float softcap,
                                int window_left, int cluster, void* stream) {
  const bool quant = page_dtype == xfa::kI8 || page_dtype == xfa::kE4M3;
  if (quant != (scales != nullptr) || (!quant && page_dtype != xfa::kBF16 && page_dtype != xfa::kF32))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  const int rows = sq * (h / hk), cap = npp * ps;
  // fp32 pages: the decode regime here, the prefill regime in flash_fp32.cu
  if (page_dtype == xfa::kF32 && rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (rows <= kMaxRows) {
    if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
    DecodeParams p{};
    p.q = q;
    p.k = pages;
    p.v = pages;
    p.k_scale = static_cast<const float*>(scales);
    p.v_scale = quant ? static_cast<const float*>(scales) + cap : nullptr;
    p.lengths = static_cast<const int*>(lengths);
    p.out = out;
    p.sq = sq; p.h = h; p.hk = hk; p.S = cap;
    p.splits = 1;
    p.sm_scale = sm_scale;
    p.softcap = softcap;
    p.window_left = window_left;
    p.sc_sh = 2 * static_cast<int64_t>(cap);
    p.table = static_cast<const int*>(table);
    p.ps = ps; p.npp = npp; p.num_pages = num_pages;
    switch (page_dtype) {
      case xfa::kI8:
        err = decode_d<int8_t>(p, b, d, rows, cluster, s);
        break;
      case xfa::kE4M3:
        err = decode_d<__nv_fp8_e4m3>(p, b, d, rows, cluster, s);
        break;
      case xfa::kF32:
        err = decode_d<float>(p, b, d, rows, cluster, s);
        break;
      default:
        err = decode_d<bf16>(p, b, d, rows, cluster, s);
    }
    return static_cast<int>(err);
  }
  PrefillParams p;
  p.q = static_cast<const bf16*>(q);
  p.pages = pages;
  p.scales = static_cast<const float*>(scales);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.out = static_cast<bf16*>(out);
  p.sq = sq; p.h = h; p.hk = hk; p.ps = ps; p.npp = npp; p.num_pages = num_pages;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window_left = window_left;
  p.tma = !quant && ps % kPrefillN == 0;
  CUtensorMap tkv{};
  if (p.tma && !sm90::encode_pages(&tkv, pages, num_pages, hk, ps, d, kPrefillN))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (page_dtype) {
    case xfa::kI8:
      err = prefill_d<int8_t>(tkv, p, b, d, s);
      break;
    case xfa::kE4M3:
      err = prefill_d<__nv_fp8_e4m3>(tkv, p, b, d, s);
      break;
    default:
      err = prefill_d<bf16>(tkv, p, b, d, s);
  }
  return static_cast<int>(err);
}
