// Helpers shared by the port's CUDA kernels.
//
// Every kernel source exposes a plain C entry point (no PyTorch headers) that
// launches on the caller's stream and returns cudaGetLastError(); the Python
// wrappers load the shared library with ctypes and raise on a non-zero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#define XFA_EXPORT extern "C" __attribute__((visibility("default")))

namespace xfa {

// dtype codes passed from Python (ops/_cuda.py DTYPE_CODES and, for KV
// caches, CACHE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

// The finite mask value of the TPU package (common.py DEFAULT_MASK_VALUE):
// the running max that split-KV partials report for a split that sees no key.
constexpr float kMaskValue = -0.7f * FLT_MAX;

__device__ __forceinline__ float load_as_float(const void* p, int64_t i, int dt) {
  return dt == kBF16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_from_float(void* p, int64_t i, float v, int dt) {
  if (dt == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
// int8 and e4m3 cache payloads convert exactly (Hopper converts e4m3 natively,
// subnormals included)
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// cp.async of 16 (or 4) bytes into shared memory; with ok false nothing is
// read and the destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block; every thread gets the total. `red` holds one
// float per warp. The leading barrier lets a block call this twice in a row.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
  return warp_sum(v);
}

// ---- mma.sync m16n8k16 (bf16 in, fp32 accumulate), used by the decode
// body (decode_core.cuh). Fragment layouts (PTX ISA, "mma.m16n8k16"), g = lane / 4,
// t = lane % 4:
//   A (16x16, row-major): a[r] holds row g + (r & 1) * 8, columns
//     (r >> 1) * 8 + 2t and 2t + 1;
//   B (16x8, "col"): b0 holds k = 2t, 2t + 1 of column n = g; b1 k + 8;
//   C (16x8, fp32): c[e] sits at row g + (e >> 1) * 8, column 2t + (e & 1).
// The C fragments of n-tiles 2kk and 2kk + 1 are, packed to bf16, the A
// fragment of k-step kk of a following product.

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of k-step kk for the 16 rows starting at `row` of a staged tile.
template <int D>
__device__ __forceinline__ void smem_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int row,
                                       int kk, int g, int t) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    a[r] = *reinterpret_cast<const uint32_t*>(
        &tile[(row + g + (r & 1) * 8) * (D + 8) + kk * 16 + (r >> 1) * 8 + 2 * t]);
  }
}

// ---- FlashMask and block-sparse masks (ops/flash_attention/common.py
// KernelMasks). FlashMask: each key column carries NV row indices; the
// bands [LTStart, LTEnd) and [UTStart, UTEnd) are masked (half-open, as
// the TPU package's fm_banned, common.py:244-266); per key tile max/min of
// each vector decide whether a (query tile, key tile) pair is masked
// everywhere (skip: never loaded) or nowhere (bypass: no elementwise band
// test). The causal part of the causal modes is the kernels' causal flag.
// Block mask: a 0/1 entry per (gq rows, gk keys) block at the user's
// granularity, a multiple of 64: the kernels' 128-key and 128-row blocks
// may straddle two, so they decide per 64-row or 64-key part.
enum FmMode : int { kFmNone = 0, kFmCausal1 = 1, kFmCausal2 = 2, kFmFull2 = 3, kFmFull4 = 4 };

//
// Windows, segment ids and positions (ops common.py resolve_window,
// token_info, token_stats, tile_ranges). The row/key window (left, right)
// makes key c visible to row r when r + off - left <= c <= r + off + right
// (off = sk - sq; -1: no bound; the causal flag is right 0 here); with
// positions the position window applies to the position values instead
// (kpos <= qpos + pright, kpos >= qpos - pleft) and the row/key window is
// off; segment ids make a pair visible only when they are equal. Each token
// carries (segment id, position, 0, 0); per kernel tile [segment min, max,
// position min, max] decide skip and bypass of a tile pair, and per block a
// range [lo, hi) of tiles that may hold a visible pair bounds the
// candidates the producer evaluates (a packed batch's block sees its own
// documents' tiles only).
struct MaskParams {
  const int* fm_vecs;   // (b, fm_heads, nv, fm_skp) int32 (padding masked), or null
  const int* fm_stats;  // (b, fm_heads, fm_skp / tile, nv, 2): max, min per key tile
  int fm_mode, fm_heads, fm_skp;
  const int* bm;        // (b|1, hm|1, ceil(sq/gq), bm_nk) int32, or null
  int64_t bm_sb, bm_sh;  // 0 on a broadcast axis
  int bm_heads, bm_nk, gq, gk;
  int left, right, pleft, pright;  // the row/key and the position windows
  const int4* q_info;  // (b, q_pad) per query (segment, position, 0, 0), or null
  const int4* k_info;  // (b, k_pad) per key
  const int4* q_st;    // (b, n_qst) per query tile of the kernel
  const int4* k_st;    // (b, n_kst) per key tile
  const int2* range;   // (b, n_rng) candidate tiles [lo, hi) per block
  int q_pad, k_pad, n_qst, n_kst, n_rng;
};

// The trailing arguments of every attention entry point that takes masks.
#define XFA_MASK_ARGS                                                                        \
  const void *fm_vecs, const void *fm_stats, int fm_mode, int fm_heads, int fm_skp,          \
      const void *bm, int64_t bm_sb, int64_t bm_sh, int bm_heads, int bm_nk, int gq, int gk, \
      int win_left, int win_right, int pos_left, int pos_right, const void *q_info,          \
      const void *k_info, const void *q_st, const void *k_st, const void *tile_range,        \
      int q_pad, int k_pad, int n_qst, int n_kst, int n_rng
#define XFA_MASK_VALUES                                                                     \
  xfa::MaskParams {                                                                         \
    static_cast<const int*>(fm_vecs), static_cast<const int*>(fm_stats), fm_mode, fm_heads,  \
        fm_skp, static_cast<const int*>(bm), bm_sb, bm_sh, bm_heads, bm_nk, gq, gk, win_left, \
        win_right, pos_left, pos_right, static_cast<const int4*>(q_info),                    \
        static_cast<const int4*>(k_info), static_cast<const int4*>(q_st),                    \
        static_cast<const int4*>(k_st), static_cast<const int2*>(tile_range), q_pad, k_pad,   \
        n_qst, n_kst, n_rng                                                                  \
  }

// True when a kernel must run its masked instantiation.
__host__ __device__ __forceinline__ bool mask_active(const MaskParams& m) {
  return m.fm_vecs != nullptr || m.bm != nullptr || m.q_info != nullptr || m.left >= 0 ||
         m.right >= 0;
}

__host__ __device__ __forceinline__ int fm_nv(int mode) {
  return mode == kFmCausal1 ? 1 : (mode == kFmFull4 ? 4 : 2);
}

// The FlashMask head that query head `head` of `h` reads.
__device__ __forceinline__ int fm_head(const MaskParams& m, int head, int h) {
  return head / (h / m.fm_heads);
}

// Stats of the key tile starting at col0 (tiles of tile_keys keys):
// st[v * 2] = max, st[v * 2 + 1] = min of vector v.
__device__ __forceinline__ const int* fm_tile_stats(const MaskParams& m, int batch, int fh,
                                                    int col0, int tile_keys) {
  const int nv = fm_nv(m.fm_mode);
  return m.fm_stats + (static_cast<int64_t>(batch * m.fm_heads + fh) * (m.fm_skp / tile_keys) +
                       col0 / tile_keys) * nv * 2;
}

// Skip (every element masked) and bypass (none masked) of query rows [q0,
// q1) against a key tile with FlashMask stats `st` (fm_tile_stats); both
// conservative across the tile's columns (common.py fm_skip_bypass).
__device__ __forceinline__ void fm_decide(int mode, const int* st, int q0, int q1, bool& skip,
                                          bool& bypass) {
  switch (mode) {
    case kFmCausal1:
      skip = q0 >= st[0];
      bypass = q1 <= st[1];
      break;
    case kFmCausal2:  // [LTStart, LTEnd)
      skip = q0 >= st[0] && q1 <= st[3];
      bypass = q1 <= st[1] || q0 >= st[2];
      break;
    case kFmFull2:  // [LTStart, UTEnd)
      skip = q0 >= st[0] || q1 <= st[3];
      bypass = q1 <= st[1] && q0 >= st[2];
      break;
    default:  // [LTStart, LTEnd, UTStart, UTEnd)
      skip = (q0 >= st[0] && q1 <= st[3]) || (q0 >= st[4] && q1 <= st[7]);
      bypass = (q1 <= st[1] || q0 >= st[2]) && (q1 <= st[5] || q0 >= st[6]);
  }
}

// The block-mask entry of (row, col) for query head `head` of `h`: true
// when it is on or there is no block mask.
__device__ __forceinline__ bool bm_on(const MaskParams& m, int batch, int head, int h, int row,
                                      int col) {
  if (m.bm == nullptr) return true;
  const int bh = head / (h / m.bm_heads);
  return m.bm[batch * m.bm_sb + bh * m.bm_sh + static_cast<int64_t>(row / m.gq) * m.bm_nk +
              col / m.gk] != 0;
}

// ---- persistent schedules of the attention kernels (flash_fwd.cu,
// flash_bwd.cu, reduced_scores.cu)

// The key tiles of N keys that a block of M query rows at q0 visits, [0,
// n_tiles), and how many of them from tile 0 on need no elementwise mask,
// n_free (every key of such a tile is below sk and visible to every row of
// the block; rows past sq are not written, so they do not count); the
// others are the last n_tiles - n_free. Mirrored by fwd.py key_tile_plan.
template <int M, int N>
__device__ __forceinline__ void key_tiles(int q0, int sq, int sk, int causal, int& n_tiles,
                                          int& n_free) {
  n_tiles = (sk + N - 1) / N;
  n_free = sk / N;
  if (causal) {
    const int offset = sk - sq;
    const int max_col = min(q0 + M, sq) - 1 + offset;  // the block's last row sees up to here
    n_tiles = max_col < 0 ? 0 : min(n_tiles, max_col / N + 1);
    const int seen = q0 + offset + 1;  // keys [0, seen) are visible to the block's first row
    n_free = min(n_free, seen <= 0 ? 0 : seen / N);
  }
  n_free = min(n_free, n_tiles);
}

// The persistent CTAs take pairs c, c + gridDim.x, ... of the n_blocks
// blocks of each (batch, head): pair j is the heavier block first, then its
// partner, so that every pair of a causal row of blocks holds the same
// work; the middle block of an odd count is a pair alone. With heavy_last
// block n_blocks - 1 - j is the heavier (query blocks: the last rows see
// the most keys), else block j (key blocks: the first keys are seen by the
// most rows). Pairs are numbered head by head, so the CTAs at work at one
// time share a few heads' tensors in L2. Mirrored by fwd.py pair_schedule.
__host__ __device__ __forceinline__ int block_pairs(int n_blocks, int heads, int b) {
  return (n_blocks + 1) / 2 * heads * b;
}

// Block `half` (0: the heavier, 1: the lighter) of pair `pair`; false when
// the pair has no second block.
__device__ __forceinline__ bool pair_block(int pair, int half, int n_blocks, int heads,
                                           bool heavy_last, int& block, int& head, int& batch) {
  const int per_head = (n_blocks + 1) / 2;
  const int j = pair % per_head, bh = pair / per_head;
  head = bh % heads;
  batch = bh / heads;
  const int heavy = heavy_last ? n_blocks - 1 - j : j;
  block = half == 0 ? heavy : n_blocks - 1 - heavy;
  return half == 0 || j != n_blocks - 1 - j;
}

// pair_block and next_block with the batch taken fastest when
// `batch_fast` (a bias instantiation's bias shared by every batch: the CTAs
// at work at one time then read one head's bias from L2, where by head
// order each batch reads the heads' bias from memory again).
__device__ __forceinline__ bool pair_block_by(bool batch_fast, int pair, int half, int n_blocks,
                                              int heads, int b, bool heavy_last, int& block,
                                              int& head, int& batch) {
  return batch_fast ? pair_block(pair, half, n_blocks, b, heavy_last, block, batch, head)
                    : pair_block(pair, half, n_blocks, heads, heavy_last, block, head, batch);
}

// The query tiles of M rows that the key block of N keys at n0 visits for
// each head of its group: tiles [first, n_qt), the masked ones first (the
// causal diagonal tiles [first, f0), then the ragged tail [f1, n_qt)), then
// the free ones [f0, f1), whose rows are all below sq and see every key of
// the block below sk (keys past sk are not written, so they do not count).
// Mirrored by bwd.py bwd_dkv_tile_plan.
struct QueryTilePlan {
  int first, f0, f1, n_qt;
  __device__ __forceinline__ int n_tiles() const { return n_qt - first; }
  __device__ __forceinline__ int n_masked() const { return (f0 - first) + (n_qt - f1); }
  __device__ __forceinline__ int tile(int i) const {
    const int diag = f0 - first, masked = n_masked();
    return i < diag ? first + i : (i < masked ? f1 + i - diag : f0 + i - masked);
  }
};

template <int M, int N>
__device__ __forceinline__ QueryTilePlan query_tiles(int n0, int sq, int sk, int causal) {
  QueryTilePlan pl;
  pl.n_qt = (sq + M - 1) / M;
  pl.first = 0;
  int free_from = 0;
  if (causal) {
    const int offset = sk - sq;
    pl.first = max(0, n0 - offset) / M;  // the tile of the first row that sees key n0
    // the first row that sees the block's last key, rounded up to a tile
    const int last_key = min(n0 + N, sk) - 1;
    free_from = (max(0, last_key - offset) + M - 1) / M;
  }
  pl.f0 = min(max(free_from, pl.first), pl.n_qt);
  pl.f1 = min(max(sq / M, pl.f0), pl.n_qt);
  return pl;
}

// The key tiles of N keys [lo, hi) that rows [q0, q0 + M) below sq may see
// under the row/key window of `m`, and [f_lo, f_hi) among them the free
// ones (every key below sk and visible to every row below sq); considered
// last to first. Cut to the block's tile range when there are segments or
// positions (block = q0 / M). Mirrored by fwd.py key_window_plan and
// masked_row_block_plan.
template <int M, int N>
__device__ __forceinline__ void key_window(const MaskParams& m, int batch, int q0, int sq, int sk,
                                           int& lo, int& hi, int& f_lo, int& f_hi) {
  const int off = sk - sq, r1 = min(q0 + M, sq) - 1;
  const int kmax = m.right < 0 ? sk - 1 : min(sk - 1, r1 + off + m.right);
  const int kmin = m.left < 0 ? 0 : max(0, q0 + off - m.left);
  lo = hi = f_lo = f_hi = 0;
  if (kmax < kmin) return;
  lo = kmin / N;
  hi = kmax / N + 1;
  const int fmax = m.right < 0 ? sk : min(sk, q0 + off + m.right + 1);
  const int fmin = m.left < 0 ? 0 : max(0, r1 + off - m.left);
  f_lo = max(lo, (fmin + N - 1) / N);
  f_hi = min(hi, max(fmax, 0) / N);
  if (m.range != nullptr) {
    const int2 r = m.range[static_cast<int64_t>(batch) * m.n_rng + q0 / M];
    lo = max(lo, r.x);
    hi = max(lo, min(hi, r.y));
  }
}

// The query tiles of M rows that the key block of N keys at n0 visits
// under the row/key window of `m` (query_tiles for any window), cut to the
// block's tile range with segments or positions (block = n0 / N). Mirrored
// by bwd.py query_window and bwd_masked_dkv_tile_plan.
template <int M, int N>
__device__ __forceinline__ QueryTilePlan query_window(const MaskParams& m, int batch, int n0,
                                                      int sq, int sk) {
  QueryTilePlan pl{0, 0, 0, 0};
  const int off = sk - sq, k1 = min(n0 + N, sk) - 1;
  const int rmin = m.right < 0 ? 0 : max(0, n0 - off - m.right);
  const int rmax = m.left < 0 ? sq - 1 : min(sq - 1, k1 - off + m.left);
  if (rmax < rmin) return pl;
  int first = rmin / M, end = rmax / M + 1;
  const int free_from = m.right < 0 ? 0 : max(0, k1 - off - m.right);
  int t_end = sq / M;
  if (m.left >= 0) {
    const int x = n0 - off + m.left + 1;
    t_end = min(t_end, x > 0 ? x / M : 0);
  }
  if (m.range != nullptr) {
    const int2 r = m.range[static_cast<int64_t>(batch) * m.n_rng + n0 / N];
    first = max(first, r.x);
    end = max(first, min(end, r.y));
  }
  pl.first = first;
  pl.n_qt = end;
  pl.f0 = min(max((free_from + M - 1) / M, first), end);
  pl.f1 = min(max(t_end, pl.f0), end);
  return pl;
}

// ---- the masked attention kernels' producer (flash_fwd.cu, flash_bwd.cu)
//
// Which tiles a block visits depends on the mask, so warp 0 of the
// producer warpgroup decides and the consumers follow: it evaluates 32
// candidate tiles at a time (a lane each) and its lane 0 hands each visited
// tile over with a word in the tile's ring stage: (first row or key, or kEnd
// after a block's last tile; flags; ...). A consumer computes the tile only
// when one of its parts is on: dK/dV part c (its 64 keys) at bit
// kOnShift + c; in a block of 128 query rows (the forward, dQ), consumer
// c's 64 rows against the tile's keys [0, 64) and [64, 128) at bits
// kOnShift + 2c and kOnShift + 2c + 1 (both the same for a 64-key tile).
constexpr int kEnd = -1;
constexpr int kElem = 1;  // the elementwise test
constexpr int kBand = 2;  // the FlashMask band test (the bands in the stage, or per thread)
constexpr int kInfo = 4;  // the segment / position test (the tokens' info in the stage)
constexpr int kOnShift = 3;
constexpr int kRowBlock = 128;  // query rows of a forward or dQ block, 64 per consumer

// The segment / position decision of a query tile with stats qs against a
// key tile with ks ([segment min, max, position min, max]): -1 skipped (the
// segment ranges do not meet, or the positions lie outside the window
// everywhere), 0 bypassed (one segment on both sides, the window met
// everywhere), else kElem | kInfo. Mirrored by fwd.py token_flags.
__device__ __forceinline__ int token_flags(const MaskParams& m, int4 qs, int4 ks) {
  bool skip = (qs.x > ks.y) | (ks.x > qs.y);
  bool bypass = (qs.x == qs.y) & (ks.x == ks.y) & (qs.x == ks.x);
  if (m.pright >= 0) {
    skip |= ks.z > qs.w + m.pright;
    bypass &= ks.w <= qs.z + m.pright;
  }
  if (m.pleft >= 0) {
    skip |= ks.w < qs.z - m.pleft;
    bypass &= ks.z >= qs.w - m.pleft;
  }
  return skip ? -1 : (bypass ? 0 : kElem | kInfo);
}

// The flags of the key tile of N keys at n0 against the block of kRowBlock
// query rows at q0 of (batch, head), or -1 when it is skipped: skipped when
// the FlashMask stats (per tile of N keys) mask the block's rows everywhere
// or no part is on (a part starting at or past sq or sk is off), or the
// segment / position stats (token_flags) skip it; kElem with `elem` (the
// window / ragged test of the plan), with the band test (not bypassed), the
// segment / position test and when one consumer's two key parts differ (the
// keys straddle two block-mask entries). Mirrored by fwd.py
// masked_row_block_plan.
template <int N>
__device__ __forceinline__ int row_block_tile_flags(const MaskParams& m, int batch, int head,
                                                    int h, int sq, int sk, int q0, int n0,
                                                    bool elem) {
  int flags = elem ? kElem : 0;
  if (m.fm_vecs != nullptr) {
    bool skip, bypass;
    fm_decide(m.fm_mode, fm_tile_stats(m, batch, fm_head(m, head, h), n0, N), q0,
              min(q0 + kRowBlock, sq), skip, bypass);
    if (skip) return -1;
    if (!bypass) flags |= kElem | kBand;
  }
  if (m.q_info != nullptr) {
    const int tf = token_flags(m, m.q_st[static_cast<int64_t>(batch) * m.n_qst + q0 / kRowBlock],
                               m.k_st[static_cast<int64_t>(batch) * m.n_kst + n0 / N]);
    if (tf < 0) return -1;
    flags |= tf;
  }
  int on = 0;  // the parts that start below sq and sk
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int kh = 0; kh < 2; ++kh)
      if ((q0 + 64 * c < sq) & (n0 + (N == 128 ? 64 * kh : 0) < sk)) on |= 1 << (2 * c + kh);
  if (m.bm != nullptr && on != 0) {
    // the four entries loaded unconditionally (indices clamped into range),
    // so that their latencies overlap: the producer decides faster
    const int* bm = m.bm + batch * m.bm_sb + (head / (h / m.bm_heads)) * m.bm_sh;
    int e[4];
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int kh = 0; kh < 2; ++kh) {
        const int row = min(q0 + 64 * c, sq - 1), key = min(n0 + (N == 128 ? 64 * kh : 0), sk - 1);
        e[2 * c + kh] = bm[static_cast<int64_t>(row / m.gq) * m.bm_nk + key / m.gk];
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) on &= ~((e[i] == 0 ? 1 : 0) << i);
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const int parts = (on >> (2 * c)) & 3;
    if (parts == 1 || parts == 2) flags |= kElem;  // the keys straddle two entries
  }
  return on == 0 ? -1 : flags | on << kOnShift;
}

// The limits of the masked kernels' elementwise test, made per tile at the
// top of the test from the parameters and the tile's staged tokens (a few
// operations), so that nothing stays in registers across the tile loop
// (held there, they spilled: 13-37% on the masked rows,
// scripts/ab_trees.py). A query row sees the keys [lo, hi] (the row/key
// window, and hi below sk); with segments or positions, a query's (segment
// id, position) q gives (segment, lowest, highest key position it sees).
__device__ __forceinline__ void row_limit(const MaskParams& m, int row, int sq, int sk, int& lo,
                                          int& hi) {
  const int c = row + sk - sq;
  hi = m.right < 0 ? sk - 1 : min(sk - 1, c + m.right);
  lo = m.left < 0 ? INT_MIN : c - m.left;
}

__device__ __forceinline__ int4 query_tokens(const MaskParams& m, int2 q) {
  return make_int4(q.x, m.pleft < 0 ? INT_MIN : q.y - m.pleft,
                   m.pright < 0 ? INT_MAX : q.y + m.pright, 0);
}

// A key (dK/dV) is seen by the rows [rmin, rmax] (the window, rmax below
// sq); with segments or positions its (segment id, position) k gives
// (segment, lowest, highest query position that sees it).
__device__ __forceinline__ void key_limit(const MaskParams& m, int key, int sq, int sk, int& rmin,
                                          int& rmax) {
  const int c = key - (sk - sq);
  rmin = m.right < 0 ? INT_MIN : c - m.right;
  rmax = m.left < 0 ? sq - 1 : min(sq - 1, c + m.left);
}

__device__ __forceinline__ int4 key_tokens(const MaskParams& m, int2 k) {
  return make_int4(k.x, m.pright < 0 ? INT_MIN : k.y - m.pright,
                   m.pleft < 0 ? INT_MAX : k.y + m.pleft, 0);
}

// A token's (segment id, position) from staged info rows (padding holds 0).
__device__ __forceinline__ int2 token_at(const int4* info, int i) {
  return *reinterpret_cast<const int2*>(info + i);
}

// The segment / position test: a token t = (segment id, position) against
// the other side's limits L = (segment, lowest, highest position).
__device__ __forceinline__ bool tokens_meet(int4 L, int2 t) {
  return (t.x == L.x) & (t.y >= L.y) & (t.y <= L.z);
}

// Bytes of a block's 128 tokens' info, staged with its Q (the forward, dQ)
// or its K/V (dK/dV).
constexpr int kBlockInfoBytes = 128 * 16;

// True when `row` falls in one of a column's first NB FlashMask bands b =
// [lo1, hi1), [lo2, hi2) (ops common.py fm_bands; the causal modes have
// one, the full modes two); bitwise operators, since short-circuit ones
// become a branch per element.
template <int NB>
__device__ __forceinline__ bool banned(const int4 b, int row) {
  const bool first = (row >= b.x) & (row < b.y);
  return NB == 1 ? first : first | ((row >= b.z) & (row < b.w));
}

// The next block of a masked kernel's dynamic scheduler: each item (pair
// * 2 + half of pair_block) taken once from the counter next[0] (lane 0 of
// the calling warp, all 32 lanes calling; the entry clears it on the
// stream), the heavier pairs of every (batch, head) first (pair j of each
// before pair j + 1 of any). False after the last block.
__device__ __forceinline__ bool next_block(int* next, int b, int n_blocks, int heads,
                                           bool heavy_last, int& block, int& head, int& batch) {
  const int per_head = (n_blocks + 1) / 2, n_bh = heads * b;
  for (;;) {
    int item = 0;
    if ((threadIdx.x & 31) == 0) item = atomicAdd(next, 1);
    item = __shfl_sync(0xffffffffu, item, 0);
    const int j = (item >> 1) / n_bh;
    if (j >= per_head) return false;
    const int pair = ((item >> 1) - j * n_bh) * per_head + j;
    if (pair_block(pair, item & 1, n_blocks, heads, heavy_last, block, head, batch)) return true;
  }
}

// ---- attention bias (ops fwd.py bias_c_args): a (bb, bh, sq, sk) fp32
// or bf16 tensor added to the scores after softcap, before the masks (the
// TPU kernels' fwd.py:353-354, bwd.py:131-132). Broadcasting is by
// strides: batch or head stride 0 on a broadcast axis; keys contiguous;
// the pointer and the row stride even, so that a key pair (2t, 2t + 1) of
// an accumulator fragment is one 8-byte (fp32) or 4-byte (bf16) load (an
// odd sk comes padded to an even row by the wrapper).
struct BiasParams {
  const void* ptr;       // null: no bias
  int64_t sb, sh, ss;    // element strides of the batch, head and row axes
  int dtype;             // kF32 or kBF16
};

#define XFA_BIAS_ARGS \
  const void *bias, int64_t bias_sb, int64_t bias_sh, int64_t bias_ss, int bias_dtype
#define XFA_BIAS_VALUES \
  xfa::BiasParams { bias, bias_sb, bias_sh, bias_ss, bias_dtype }

__device__ __forceinline__ float2 bias_pair(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 bias_pair(const __nv_bfloat16* p) {
  const unsigned int w = __ldg(reinterpret_cast<const unsigned int*>(p));
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}
__device__ __forceinline__ float bias_one(const float* p) { return __ldg(p); }
__device__ __forceinline__ float bias_one(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// The loads below are unconditional, their row and key clamped into the
// tensor (no byte past it is read): an element at or past sq or sk gets a
// neighbour's value, and every kernel masks such an element (the
// elementwise test of a ragged tile, P 0 on rows past sq) or drops its
// result (rows past sq, keys past sk). Loads guarded per pair took the
// forward and dK/dV 30-40% longer on the card (PERF.md section 6).
template <int N, typename T>
__device__ __forceinline__ void bias_rows(float (&b)[N / 2], const T* p, int64_t ss, int row0,
                                          int n0, int sq, int sk, int t) {
  const int cmax = (sk - 1) & ~1;  // the last pair's first key
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float2 v =
          bias_pair(p + min(row0 + 8 * r, sq - 1) * ss + min(n0 + 8 * j + 2 * t, cmax));
      b[4 * j + 2 * r] = v.x;
      b[4 * j + 2 * r + 1] = v.y;
    }
  }
}

// The bias of a row-major accumulator fragment of N keys (wgmma m64nN:
// register i at row row0 + ((i >> 1) & 1) * 8, key n0 + (i >> 2) * 8 + 2t
// + (i & 1)) of the (batch, head) at element offset `base`. Issued before
// the wait on the scores' wgmma, so that the loads run under the products.
template <int N>
__device__ __forceinline__ void load_bias_rows(float (&b)[N / 2], const BiasParams& bp,
                                               int64_t base, int row0, int n0, int sq, int sk,
                                               int t) {
  if (bp.dtype == kBF16)
    bias_rows<N>(b, static_cast<const __nv_bfloat16*>(bp.ptr) + base, bp.ss, row0, n0, sq, sk, t);
  else
    bias_rows<N>(b, static_cast<const float*>(bp.ptr) + base, bp.ss, row0, n0, sq, sk, t);
}

template <int M, typename T>
__device__ __forceinline__ void bias_cols(float (&b)[M / 2], const T* p, int64_t ss, int key0,
                                          int m0, int sq, int sk, int t) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i)
    b[i] = bias_one(p + min(m0 + (i >> 2) * 8 + 2 * t + (i & 1), sq - 1) * ss +
                    min(key0 + ((i >> 1) & 1) * 8, sk - 1));
}

// The bias of a transposed fragment (dK/dV's S^T: register i at key key0 +
// ((i >> 1) & 1) * 8 and query row m0 + (i >> 2) * 8 + 2t + (i & 1)); one
// element a load (the pair's two rows are a row stride apart).
template <int M>
__device__ __forceinline__ void load_bias_cols(float (&b)[M / 2], const BiasParams& bp,
                                               int64_t base, int key0, int m0, int sq, int sk,
                                               int t) {
  if (bp.dtype == kBF16)
    bias_cols<M>(b, static_cast<const __nv_bfloat16*>(bp.ptr) + base, bp.ss, key0, m0, sq, sk, t);
  else
    bias_cols<M>(b, static_cast<const float*>(bp.ptr) + base, bp.ss, key0, m0, sq, sk, t);
}

// ---- attention dropout (ops common.py Dropout and dropout_keep_mask; the
// TPU package's common.py:120-144): an element of P at (row, col), the
// global positions in the (b, h, s) tensors, is kept when a counter-based
// hash of (seed, salt, row, col) is at or above the threshold, so that the
// backward, with other tiles, regenerates the forward's mask. The salt is
// batch * h + head over the query heads. Kept elements are
// scaled by 1 / (1 - p), which the kernels fold into their epilogue (the
// forward's O, dV) or into dP.
struct DropoutParams {
  int on;              // 0: no dropout
  uint32_t seed;       // the seed's low 32 bits
  uint32_t threshold;  // keep when the hash is >= threshold
  float scale;         // 1 / (1 - p)
};

#define XFA_DROPOUT_ARGS \
  int drop, unsigned int drop_seed, unsigned int drop_threshold, float drop_scale
#define XFA_DROPOUT_VALUES \
  xfa::DropoutParams { drop, drop_seed, drop_threshold, drop_scale }

constexpr uint32_t kDropRow = 0x9E3779B1u, kDropCol = 0x85EBCA77u, kDropSalt = 0xC2B2AE3Du;

// The part of the hash that a (batch, query head) shares: seed ^ salt * C.
__device__ __forceinline__ uint32_t dropout_key(const DropoutParams& d, int batch, int head,
                                                int h) {
  return d.seed ^ (static_cast<uint32_t>(batch * h + head) * kDropSalt);
}

// The finalizer of the mix x = row * kDropRow + col * kDropCol + key.
__device__ __forceinline__ bool dropout_keep(uint32_t x, uint32_t threshold) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x >= threshold;
}

// The mix of a thread's first register of an accumulator fragment (wgmma
// m64nN: register i at fragment row r0 + ((i >> 1) & 1) * 8 and column c0
// + (i >> 2) * 8 + 2t + (i & 1), the map of load_bias_rows): the mix of
// register i is this base plus a constant of i, so a tile holds one
// register for its hash and an element costs the finalizer and an add.
// The fragment's rows are query rows and its columns keys (the forward's
// S, dQ's S and dP), or TRANSPOSED its rows keys and its columns query
// rows (dK/dV's S^T and dP^T).
template <bool TRANSPOSED>
__device__ __forceinline__ uint32_t dropout_base(uint32_t key, int r0, int c0, int t) {
  constexpr uint32_t kR = TRANSPOSED ? kDropCol : kDropRow;
  constexpr uint32_t kC = TRANSPOSED ? kDropRow : kDropCol;
  return static_cast<uint32_t>(r0) * kR + static_cast<uint32_t>(c0 + 2 * t) * kC + key;
}

// Whether register i of the fragment whose base is `base` is kept.
template <bool TRANSPOSED>
__device__ __forceinline__ bool dropout_keep_at(uint32_t base, uint32_t threshold, int i) {
  constexpr uint32_t kR = TRANSPOSED ? kDropCol : kDropRow;
  constexpr uint32_t kC = TRANSPOSED ? kDropRow : kDropCol;
  return dropout_keep(base + static_cast<uint32_t>((i >> 1) & 1) * 8u * kR +
                          static_cast<uint32_t>((i >> 2) * 8 + (i & 1)) * kC,
                      threshold);
}

// f(i, keep) for each of the E registers of the fragment, the forward's
// pass over P.
template <int E, bool TRANSPOSED, typename F>
__device__ __forceinline__ void dropout_each(const DropoutParams& d, uint32_t key, int r0, int c0,
                                             int t, F f) {
  const uint32_t base = dropout_base<TRANSPOSED>(key, r0, c0, t);
#pragma unroll
  for (int i = 0; i < E; ++i) f(i, dropout_keep_at<TRANSPOSED>(base, d.threshold, i));
}

__device__ __forceinline__ bool next_block_by(bool batch_fast, int* next, int b, int n_blocks,
                                              int heads, bool heavy_last, int& block, int& head,
                                              int& batch) {
  return batch_fast ? next_block(next, heads, n_blocks, b, heavy_last, block, batch, head)
                    : next_block(next, b, n_blocks, heads, heavy_last, block, head, batch);
}

// Emit, with the producer's whole warp, the tiles a block visits for one
// head: candidates i in [0, n) evaluated 32 at a time by `flags(i, first)`
// (-1: skipped; `first` its row or key), the ones with kElem first, then
// the others, each in candidate order, through `emit(first, flags)` on
// lane 0. Up to 32 candidates are evaluated once, more once per pass.
// `before()` runs on the whole warp before each emit (the masked forward
// decides its next block there while the ring is full).
struct NoOp {
  __device__ __forceinline__ void operator()() const {}
};
template <typename Flags, typename Emit, typename Before = NoOp>
__device__ __forceinline__ void emit_tiles(int n, Flags flags, Emit emit, Before before = {}) {
  const int lane = threadIdx.x & 31;
  int f = -1, first = 0;
  for (int pass = 0; pass < 2; ++pass) {
    for (int c = 0; c < n; c += 32) {
      if (pass == 0 || n > 32) f = c + lane < n ? flags(c + lane, first) : -1;
      uint32_t sel = __ballot_sync(0xffffffffu, f >= 0 && ((f & kElem) != 0) == (pass == 0));
      while (sel != 0) {
        const int j = __ffs(sel) - 1;
        sel &= sel - 1;
        const int fj = __shfl_sync(0xffffffffu, f, j), first_j = __shfl_sync(0xffffffffu, first, j);
        before();
        if (lane == 0) emit(first_j, fj);
      }
    }
  }
}

}  // namespace xfa
