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

// ---- mma.sync m16n8k16 (bf16 in, fp32 accumulate), shared by the attention
// kernels. Fragment layouts (PTX ISA, "mma.m16n8k16"), g = lane / 4,
// t = lane % 4:
//   A (16x16, row-major): a[r] holds row g + (r & 1) * 8, columns
//     (r >> 1) * 8 + 2t and 2t + 1;
//   B (16x8, "col"): b0 holds k = 2t, 2t + 1 of column n = g; b1 k + 8;
//   C (16x8, fp32): c[e] sits at row g + (e >> 1) * 8, column 2t + (e & 1).
// The C fragments of n-tiles 2kk and 2kk + 1 are, packed to bf16, the A
// fragment of k-step kk of a following product (see pack_a).

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

// Two transposed 8x8 bf16 matrices: lanes 0-7 address the rows of the first,
// lanes 8-15 the rows of the second.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

// The A fragment of k-step kk from fp32 C fragments c[2kk], c[2kk + 1],
// rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Stage rows [row0, row0 + ROWS) of a (seq, D) bf16 slice with row stride
// `stride` into shared memory with padded rows of D + 8 (conflict-free
// fragment reads), THREADS threads cooperating. Rows at or past `limit` are
// zero. With SCALE the values are multiplied by `scale` in fp32 and rounded
// to bf16 (q_s).
template <int D, int ROWS, bool SCALE, int THREADS = 128>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int64_t stride, int row0, int limit, float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += THREADS) {
    const int r = idx / kChunks, c = (idx % kChunks) * 8;
    const int row = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < limit) {
      val = *reinterpret_cast<const uint4*>(src + row * stride + c);
      if (SCALE) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
          w[i] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(&dst[r * (D + 8) + c]) = val;
  }
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

// acc[j] (16 x 8 n-tiles, N columns) += A(16 x D) B^T where A's 16 rows
// start at `a_row` of the staged `a_tile` and B's N rows are staged in
// `b_tile` (rows = columns of the product, D = the contraction).
template <int D, int N>
__device__ __forceinline__ void mma_abt_smem_a(float (&acc)[N / 8][4],
                                               const __nv_bfloat16* a_tile, int a_row,
                                               const __nv_bfloat16* b_tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    smem_a<D>(a, a_tile, a_row, kk, g, t);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const __nv_bfloat16* br = &b_tile[(j * 8 + g) * (D + 8) + kk * 16 + 2 * t];
      mma_16816(acc[j], a, *reinterpret_cast<const uint32_t*>(br),
                *reinterpret_cast<const uint32_t*>(br + 8));
    }
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
// granularity, a multiple of 64: the forward's tiles of 64 lie inside one
// entry; the backward's 128-key and 128-row blocks may straddle two
// (flash_bwd.cu decides per 64-row or 64-key part).
enum FmMode : int { kFmNone = 0, kFmCausal1 = 1, kFmCausal2 = 2, kFmFull2 = 3, kFmFull4 = 4 };

struct MaskParams {
  const int* fm_vecs;   // (b, fm_heads, nv, fm_skp) int32 (padding masked), or null
  const int* fm_stats;  // (b, fm_heads, fm_skp / tile, nv, 2): max, min per key tile
  int fm_mode, fm_heads, fm_skp;
  const int* bm;        // (b|1, hm|1, ceil(sq/gq), bm_nk) int32, or null
  int64_t bm_sb, bm_sh;  // 0 on a broadcast axis
  int bm_heads, bm_nk, gq, gk;
};

// The trailing arguments of every attention entry point that takes masks.
#define XFA_MASK_ARGS                                                                        \
  const void *fm_vecs, const void *fm_stats, int fm_mode, int fm_heads, int fm_skp,          \
      const void *bm, int64_t bm_sb, int64_t bm_sh, int bm_heads, int bm_nk, int gq, int gk
#define XFA_MASK_VALUES                                                                    \
  xfa::MaskParams {                                                                        \
    static_cast<const int*>(fm_vecs), static_cast<const int*>(fm_stats), fm_mode, fm_heads, \
        fm_skp, static_cast<const int*>(bm), bm_sb, bm_sh, bm_heads, bm_nk, gq, gk         \
  }

__host__ __device__ __forceinline__ int fm_nv(int mode) {
  return mode == kFmCausal1 ? 1 : (mode == kFmFull4 ? 4 : 2);
}

// The FlashMask head that query head `head` of `h` reads.
__device__ __forceinline__ int fm_head(const MaskParams& m, int head, int h) {
  return head / (h / m.fm_heads);
}

// Vector v of key column `col` for (batch, mask head fh).
__device__ __forceinline__ int fm_vec(const MaskParams& m, int batch, int fh, int v, int col) {
  return m.fm_vecs[(static_cast<int64_t>(batch * m.fm_heads + fh) * fm_nv(m.fm_mode) + v) *
                       m.fm_skp + col];
}

// Stats of the key tile starting at col0 (tiles of tile_keys keys):
// st[v * 2] = max, st[v * 2 + 1] = min of vector v.
__device__ __forceinline__ const int* fm_tile_stats(const MaskParams& m, int batch, int fh,
                                                    int col0, int tile_keys) {
  const int nv = fm_nv(m.fm_mode);
  return m.fm_stats + (static_cast<int64_t>(batch * m.fm_heads + fh) * (m.fm_skp / tile_keys) +
                       col0 / tile_keys) * nv * 2;
}

// True when an element at `row` of a column with vectors a, b, c, d is
// masked out (the vectors past the mode's NV are not read).
__device__ __forceinline__ bool fm_banned(int mode, int row, int a, int b, int c, int d) {
  switch (mode) {
    case kFmCausal1: return row >= a;
    case kFmCausal2: return row >= a && row < b;
    case kFmFull2: return row >= a || row < b;
    default: return (row >= a && row < b) || (row >= c && row < d);
  }
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

// The tile decision for query rows [q0, q1) of (batch, head) against the
// key tile of tile_keys keys at col0, a tile inside one block-mask entry:
// false when the tile is skipped; `band` set when the elementwise FlashMask
// test is needed (the tile is neither skipped nor bypassed). The same for
// every thread of a block.
__device__ __forceinline__ bool mask_tile(const MaskParams& m, int batch, int head, int h, int q0,
                                          int q1, int col0, int tile_keys, bool& band) {
  band = false;
  if (!bm_on(m, batch, head, h, q0, col0)) return false;
  if (m.fm_vecs == nullptr) return true;
  bool skip, bypass;
  fm_decide(m.fm_mode, fm_tile_stats(m, batch, fm_head(m, head, h), col0, tile_keys), q0, q1,
            skip, bypass);
  band = !bypass;
  return !skip;
}

// ---- persistent schedules of the dense attention kernels (flash_fwd.cu,
// flash_bwd.cu)

// The key tiles of N keys that a block of M query rows at q0 visits, [0,
// n_tiles), and how many of them from tile 0 on need no elementwise mask,
// n_free (every key of such a tile is below sk and visible to every row of
// the block; rows past sq are not written, so they do not count); the
// others are the last n_tiles - n_free. Mirrored by fwd.py _key_tile_plan.
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
// time share a few heads' tensors in L2. Mirrored by fwd.py _pair_schedule.
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

}  // namespace xfa
