// The few-query decode attention kernel body shared by flash_decode.cu
// (dense caches, whole or split) and paged_decode.cu (its decode regime:
// paged caches, sq * g <= 16 rows per KV head). Each source wraps
// decode_body in its own __global__ kernel; flash_decode.cu's header states
// the design (clusters of 1-8 CTAs over tile-aligned key runs, a cp.async
// ring, tensor-core scores, a warp-order then rank-order merge in shared and
// distributed shared memory).
//
// The paged form (kPaged) differs only in where a key row lives and in one
// rounding: key j of batch row b is row j % ps of page table[b * npp + j /
// ps] (clamped to [0, num_pages - 1]), read once per tile when ps is a
// multiple of the 64-key tile and per key otherwise; and P * v_scale is
// rounded to bf16 before P.V, as the paged TPU kernels round it
// (xhy_flash_attention_tpu/inference/paged.py:207, :371).
#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;        // keys per tile
constexpr int kMaxRows = 16;     // sq * g
constexpr int kMaxCluster = 8;   // the portable cluster size
// bytes of shared memory for the K/V ring: three stages of bf16 d128 tiles
// (two in flight while one is computed), and two CTAs still fit on an SM (30
// clusters of 8 on the card)
constexpr int kRingBudget = 102 * 1024;

struct DecodeParams {
  const void* q;        // (b, sq, h, d) contiguous
  const void* k;        // cache, strides below (elements), head dim contiguous
  const void* v;
  const float* k_scale;  // (cache b, hk, S) contiguous, or null
  const float* v_scale;
  const int* lengths;       // (b,)
  const int* kv_batch_idx;  // (b,) or null
  const int* leftpad;       // (b,) or null
  void* out;                // (b, sq, h, d) without partials
  float* part_out;          // (b, hk, splits, rows, d), or null
  float* part_m;            // (b, hk, splits, rows)
  float* part_l;
  int64_t k_sb, k_sh, v_sb, v_sh;
  int k_ss, v_ss;  // sequence strides: offsets inside one (batch, head) fit in 32 bits
  int sq, h, hk, S;
  int splits, split_len;  // splits of split_len keys (partials only)
  float sm_scale, softcap;
  int window_left;
  int64_t sc_sh;  // the scales' (batch, head) stride: S, or 2 * S for pages
  // a paged cache (kPaged): k points at pages (num_pages, hk, 2, ps, D), key
  // j of batch row b at row j % ps of page table[b * npp + j / ps] (clamped)
  const int* table;
  int ps, npp, num_pages;
};

// Shared memory of one CTA: the ring of K/V tiles (and, for 1-byte
// payloads, their scales), q (bf16 rows padded to 16 for the tensor-core
// scores of a bf16 query, else fp32), and each warp's P and alpha. After
// the last tile the ring holds the warps' row states and the CTA's merged
// accumulator rows.
template <typename T, typename C, int D>
struct Smem {
  static constexpr bool kQuant = sizeof(C) == 1;  // int8 / e4m3 payload with scales
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(C)) + 16;  // padded key row
  static constexpr int kTileBytes = kTile * kRowBytes;
  static constexpr int kStageBytes = 2 * kTileBytes;  // K and V
  static constexpr int kStages = kRingBudget / kStageBytes < 2   ? 2
                                 : kRingBudget / kStageBytes > 6 ? 6
                                                                 : kRingBudget / kStageBytes;
  static constexpr int kRing = kStages * kStageBytes;
  static constexpr int kScales = kQuant ? kStages * 2 * kTile * 4 : 0;  // [stage][k, v][key]
  static constexpr int kQRow = kMma ? (D + 8) * 2 : D * 4;  // q row: bf16 padded, or fp32
  static constexpr int kQ = kRing + kScales;
  static constexpr int kPw = kQ + kMaxRows * kQRow;             // p_w [warp][row][8 keys]
  static constexpr int kAw = kPw + kWarps * kMaxRows * 8 * 4;   // alpha_w [warp][row]
  static constexpr int kBytes = kAw + kWarps * kMaxRows * 4;
  // after the loop: the warps' acc [warp][row][D], m, l [warp][row], then
  // the CTA's acc_s [row][D]
  static constexpr int kAcc = kWarps * kMaxRows * (D + 2) * 4;
  static_assert(kRing >= kAcc + kMaxRows * D * 4, "the ring holds the row states");
};

// Byte i of w, an int8 or e4m3 cache element, as a float: exact, and without
// the conversion unit (16 results per SM and clock on Hopper).
// int8 x: the bits 0x4B0000uu with u = x + 128 are the float 2^23 + u.
__device__ __forceinline__ float byte_to_float(uint32_t w, int i, int8_t) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}
// e4m3 s.eeee.mmm: the fp32 bits s.0000eeee.mmm0... hold the same value
// times 2^-120 (a normal e4m3 becomes a normal float, a subnormal one a
// subnormal float), so a multiply by 2^120 restores it exactly. The two NaN
// codes of e4m3fn, which quantize_kv never writes, read as +-480.
__device__ __forceinline__ float byte_to_float(uint32_t w, int i, __nv_fp8_e4m3) {
  const uint32_t t = __byte_perm(w, 0u, 0x0444 | (i << 12));  // byte i in the top byte
  return __uint_as_float((t & 0x80000000u) | ((t >> 4) & 0x07F00000u)) * 0x1p120f;
}

// Element i of a 32-bit word of cache elements as a float, exact
__device__ __forceinline__ float elem_to_float(uint32_t w, int, float) { return __uint_as_float(w); }
__device__ __forceinline__ float elem_to_float(uint32_t w, int i, __nv_bfloat16) {
  return __uint_as_float(i == 0 ? w << 16 : w & 0xffff0000u);
}
template <typename C>
__device__ __forceinline__ float elem_to_float(uint32_t w, int i, C tag) {
  return byte_to_float(w, i, tag);
}

// Four 8x8 bf16 matrices: lanes 8i .. 8i + 7 address the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Elements e and e + 1 of a key row in shared memory as a bf16x2 (the B
// fragment of mma.sync); exact for bf16, int8 and e4m3 values
__device__ __forceinline__ uint32_t bf16_pair(const unsigned char* row, int e, __nv_bfloat16) {
  return *reinterpret_cast<const uint32_t*>(row + 2 * e);
}
template <typename C>
__device__ __forceinline__ uint32_t bf16_pair(const unsigned char* row, int e, C tag) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(row + e);
  return xfa::pack_bf16(byte_to_float(w, 0, tag), byte_to_float(w, 1, tag));
}

// N consecutive cache elements (2 to 32 bytes, aligned to their size or to
// 16) from shared memory as floats, read with the widest loads that fit
template <typename C, int N>
__device__ __forceinline__ void load_floats(float* f, const unsigned char* src) {
  constexpr int kBytes = N * static_cast<int>(sizeof(C));
  constexpr int kPerWord = 4 / static_cast<int>(sizeof(C));
  uint32_t w[(kBytes + 3) / 4];
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int i = 0; i < kBytes / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
  } else if constexpr (kBytes == 8) {
    const uint2 x = *reinterpret_cast<const uint2*>(src);
    w[0] = x.x;
    w[1] = x.y;
  } else if constexpr (kBytes == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(src);
  } else {
    static_assert(kBytes == 2, "2 to 32 bytes");
    w[0] = *reinterpret_cast<const uint16_t*>(src);
  }
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = elem_to_float(w[e / kPerWord], e % kPerWord, C{});
}

using xfa::cp_async16;
using xfa::cp_async4;
using xfa::cp_async_commit;
using xfa::cp_async_wait;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The kernel body, inlined into each source's __global__ kernel (so that
// the profiler tells flash_decode_kernel and paged_decode_kernel apart).
// kRows: the rows a thread's accumulators hold, 4 (rows <= 4: every sq = 1,
// g <= 4 step) or kMaxRows. kPaged: keys reached through the page table, and
// P * v_scale rounded to bf16 before P.V (the paged TPU kernels round it).
template <typename T, typename C, int D, bool kPartial, int kRows, bool kPaged>
__device__ __forceinline__ void decode_body(const DecodeParams& p) {
  using L = Smem<T, C, D>;
  constexpr bool kQuant = L::kQuant;
  constexpr bool kMma = L::kMma;
  constexpr int kVec = 16 / static_cast<int>(sizeof(C));  // elements per 16-byte chunk
  constexpr int kChunks = D / kVec;                        // chunks per key row
  constexpr int kCols = D / 32;                            // P.V columns per lane
  constexpr int kQuarter = D / 4;                          // d elements per lane (CUDA-core scores)
  extern __shared__ __align__(16) unsigned char smem[];
  float* sc_s = reinterpret_cast<float*>(smem + L::kRing);
  unsigned char* q_s = smem + L::kQ;
  float* acc_s = reinterpret_cast<float*>(smem + L::kAcc);  // after the loop
  __shared__ float m_s[kMaxRows], l_s[kMaxRows];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int kh = blockIdx.y;
  const int b = kPartial ? blockIdx.z / p.splits : blockIdx.z;
  const int split = kPartial ? blockIdx.z % p.splits : 0;
  const int sq = p.sq, h = p.h, hk = p.hk;
  const int g = h / hk;
  const int rows = sq * g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;  // mma fragment coordinates

  // q rows first (they need no length): bf16 rows padded to 16 for
  // mma.sync, or fp32; rows past sq * g are zero
  {
    constexpr int kQChunks = D * static_cast<int>(sizeof(T)) / 16;
    const T* q = static_cast<const T*>(p.q);
    for (int i = tid; i < kMaxRows * kQChunks; i += kThreads) {
      const int r = i / kQChunks, c = (i % kQChunks) * (16 / static_cast<int>(sizeof(T)));
      const bool ok = r < rows;
      const int si = ok ? r / g : 0, gi = ok ? r % g : 0;
      cp_async16(q_s + r * L::kQRow + c * static_cast<int>(sizeof(T)),
                 q + ((static_cast<int64_t>(b) * sq + si) * h + kh * g + gi) * D + c, ok);
    }
  }

  const int cb = p.kv_batch_idx != nullptr ? p.kv_batch_idx[b] : b;
  const int lp = p.leftpad != nullptr ? p.leftpad[b] : 0;
  const int end_pos = lp + p.lengths[b];  // one past the sequence's last column
  // dense: this (batch, head)'s rows; paged: kv head kh of page 0
  const C* kbase = static_cast<const C*>(p.k) +
                   (kPaged ? static_cast<int64_t>(kh) * 2 * p.ps * D : cb * p.k_sb + kh * p.k_sh);
  const C* vbase = static_cast<const C*>(p.v) + cb * p.v_sb + kh * p.v_sh;
  const int64_t page_stride = kPaged ? static_cast<int64_t>(hk) * 2 * p.ps * D : 0;
  const int* ptable = kPaged ? p.table + static_cast<int64_t>(b) * p.npp : nullptr;
  const int64_t sc_off = (static_cast<int64_t>(cb) * hk + kh) * p.sc_sh;

  // the keys any row can see, cut to this split
  int start = lp;
  if (p.window_left >= 0) start = max(start, end_pos - sq - p.window_left);
  int stop = min(end_pos, p.S);
  if (kPartial) {
    start = max(start, split * p.split_len);
    stop = min(stop, (split + 1) * p.split_len);
  }
  start = max(0, start);
  // this CTA's chunk: the tiles from the tile holding `start` (tiles start
  // at the split's first key) to `stop`, cut into csize runs of `per` tiles
  // (decode_kernel.py cta_chunk is the same computation in Python)
  const int first = kPartial ? split * p.split_len : 0;
  const int start_al = first + ((start - first) / kTile) * kTile;
  const int n_all = stop > start_al ? (stop - start_al + kTile - 1) / kTile : 0;
  const int per = (n_all + csize - 1) / csize;
  const int t_lo = min(n_all, rank * per);
  const int n_tiles = min(n_all, t_lo + per) - t_lo;
  const int key0 = start_al + t_lo * kTile;

  // K and V rows of tile k into ring stage `stage`; keys outside [start,
  // stop) are zero-filled, never read
  auto load_tile = [&](int k, int stage) {
    const int n0 = key0 + k * kTile;
    unsigned char* kt = smem + stage * L::kStageBytes;
    unsigned char* vt = kt + L::kTileBytes;
    static_assert(kTile * kChunks % kThreads == 0, "whole rounds of copies");
    // pages that hold whole tiles: one table read for the tile
    int tile_page = 0, tile_off = 0;
    if constexpr (kPaged) {
      if (p.ps % kTile == 0) {
        tile_page = min(max(ptable[n0 / p.ps], 0), p.num_pages - 1);
        tile_off = n0 % p.ps;
      }
    }
#pragma unroll
    for (int it = 0; it < kTile * kChunks / kThreads; ++it) {
      const int i = tid + it * kThreads;
      const int j = i / kChunks, c = (i % kChunks) * kVec;
      const int key = n0 + j;
      const bool ok = key >= start && key < stop;
      const int row = ok ? key : 0;
      const int so = j * L::kRowBytes + c * static_cast<int>(sizeof(C));
      if constexpr (kPaged) {
        int page = tile_page, off = tile_off + j;
        if (p.ps % kTile != 0) {  // a tile may span pages: a table read per key
          page = min(max(ptable[row / p.ps], 0), p.num_pages - 1);
          off = row % p.ps;
        }
        const C* krow = kbase + page * page_stride + static_cast<int64_t>(off) * D + c;
        cp_async16(kt + so, krow, ok);
        cp_async16(vt + so, krow + static_cast<int64_t>(p.ps) * D, ok);
      } else {
        cp_async16(kt + so, kbase + row * p.k_ss + c, ok);
        cp_async16(vt + so, vbase + row * p.v_ss + c, ok);
      }
    }
    if (kQuant && tid < 2 * kTile) {
      const int j = tid % kTile, key = n0 + j;
      const bool ok = key >= start && key < stop;
      const float* src = (tid < kTile ? p.k_scale : p.v_scale) + sc_off + (ok ? key : 0);
      cp_async4(sc_s + (stage * 2 + tid / kTile) * kTile + j, src, ok);
    }
  };
#pragma unroll
  for (int s = 0; s < L::kStages - 1; ++s) {  // q joins the first group
    if (s < n_tiles) load_tile(s, s);
    cp_async_commit();
  }

  // Warp w owns keys 8w .. 8w + 7 of every tile, with its own online softmax
  // and accumulator rows, so the loop needs one barrier per tile (for the
  // ring). Softmax state: rows g8 and g8 + 8 (replicated over the quad).
  constexpr int kHalves = kRows > 8 ? 2 : 1;  // rows g8 (and g8 + 8)
  float m_r[2] = {-INFINITY, -INFINITY}, l_r[2] = {0.f, 0.f};
  // the keys row g8 + 8 * half sees: [lo_r, hi_r], empty past sq * g
  int lo_r[2], hi_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g8 + half * 8, pos = end_pos - sq + r / g;
    lo_r[half] = p.window_left >= 0 ? max(lp, pos - p.window_left) : lp;
    hi_r[half] = r < rows ? min(pos, stop - 1) : -1;
  }
  float acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }
  float* p_w = reinterpret_cast<float*>(smem + L::kPw) + warp * kMaxRows * 8;
  float* alpha_w = reinterpret_cast<float*>(smem + L::kAw) + warp * kMaxRows;
  // q's A fragments: in registers with 4-row accumulators, else read from
  // shared memory at every tile (in registers they would crowd out the
  // 16-row accumulators)
  constexpr bool kQaRegs = kMma && kRows == 4;
  uint32_t qa[kQaRegs ? D / 16 : 1][4];

  for (int k = 0; k < n_tiles; ++k) {
    cp_async_wait<L::kStages - 2>();
    __syncthreads();  // tile k (and q) have landed; every warp is done with tile k - 1
    {
      const int nk = k + L::kStages - 1;
      if (nk < n_tiles) load_tile(nk, nk % L::kStages);
      cp_async_commit();
    }
    const int stage = k % L::kStages;
    const unsigned char* kt = smem + stage * L::kStageBytes;
    const unsigned char* vt = kt + L::kTileBytes;
    const float* ksc = sc_s + stage * 2 * kTile;
    const float* vsc = ksc + kTile;
    const int jw = warp * 8;  // this warp's first key in the tile

    // x[e]: the score of row g8 + (e >> 1) * 8 and key jw + 2 * t4 + (e & 1)
    float x[4];
    if constexpr (kMma) {
      // q . k on the tensor cores, all 16 (padded) rows; products and sums
      // in fp32, K exact in bf16; two chains of products, even and odd
      // k-steps, halve the latency
      const __nv_bfloat16* qb = reinterpret_cast<const __nv_bfloat16*>(q_s);
      if constexpr (kQaRegs) {
        if (k == 0) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) xfa::smem_a<D>(qa[kk], qb, 0, kk, g8, t4);
        }
      }
      float xo[4] = {0.f, 0.f, 0.f, 0.f};
      x[0] = x[1] = x[2] = x[3] = 0.f;
      const unsigned char* krow = kt + (jw + g8) * L::kRowBytes;
#pragma unroll
      for (int kk = 0; kk < D / 16; kk += 2) {
        // B fragments of k-steps kk and kk + 1: bf16 rows by ldmatrix
        // (lane l addresses key jw + l % 8 at d 16 kk + 8 (l / 8)), 1-byte
        // rows converted pair by pair
        uint32_t bf[4];
        if constexpr (std::is_same<C, __nv_bfloat16>::value) {
          ldmatrix_x4(bf, kt + (jw + (lane & 7)) * L::kRowBytes + (kk * 16 + (lane >> 3) * 8) * 2);
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) bf[i] = bf16_pair(krow, kk * 16 + i * 8 + 2 * t4, C{});
        }
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          uint32_t a[4];
          if constexpr (kQaRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qa[kk + h2][i];
          } else {
            xfa::smem_a<D>(a, qb, 0, kk + h2, g8, t4);
          }
          if (h2)
            xfa::mma_16816(xo, a, bf[2], bf[3]);
          else
            xfa::mma_16816(x, a, bf[0], bf[1]);
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] += xo[e];
    } else {
      // q . k on CUDA cores in fp32: lane = (key jw + g8, d quarter t4), the
      // quarters summed over the quad; through p_w into the fragment layout
      const float* qf = reinterpret_cast<const float*>(q_s);
      float kf[kQuarter];
      const unsigned char* kq = kt + (jw + g8) * L::kRowBytes + t4 * kQuarter * static_cast<int>(sizeof(C));
#pragma unroll
      for (int c = 0; c < kQuarter; c += kVec) {
        load_floats<C, kVec>(kf + c, kq + c * static_cast<int>(sizeof(C)));
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r >= rows) break;
        const float* qr = qf + r * D + t4 * kQuarter;
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int e = 0; e < kQuarter; e += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + e);
          s0 = fmaf(qv.x, kf[e], s0);
          s1 = fmaf(qv.y, kf[e + 1], s1);
          s0 = fmaf(qv.z, kf[e + 2], s0);
          s1 = fmaf(qv.w, kf[e + 3], s1);
        }
        const float s = quad_sum(s0 + s1);
        if (t4 == 0) p_w[r * 8 + g8] = s;
      }
      __syncwarp();
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = g8 + (e >> 1) * 8;
        x[e] = r < rows ? p_w[r * 8 + 2 * t4 + (e & 1)] : 0.f;
      }
      __syncwarp();
    }

    // scale, softcap and mask; online softmax of rows g8 and g8 + 8 over
    // this warp's 8 keys
    const int n0 = key0 + k * kTile;
#pragma unroll
    for (int e = 0; e < 2 * kHalves; ++e) {
      const int j = jw + 2 * t4 + (e & 1), key = n0 + j;
      float s = x[e] * (kQuant ? ksc[j] * p.sm_scale : p.sm_scale);
      if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
      x[e] = key >= lo_r[e >> 1] && key <= hi_r[e >> 1] ? s : -INFINITY;
    }
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const int r = g8 + half * 8;
      const float m_new = fmaxf(m_r[half], quad_max(fmaxf(x[2 * half], x[2 * half + 1])));
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_r[half] - m_use);
      const float p0 = expf(x[2 * half] - m_use), p1 = expf(x[2 * half + 1] - m_use);
      l_r[half] = l_r[half] * alpha + quad_sum(p0 + p1);
      m_r[half] = m_new;
      if (r < rows) {
        // P.V takes p * v_scale: folded in here, after the row sum
        const int j = jw + 2 * t4;
        float2 pv = kQuant ? make_float2(p0 * vsc[j], p1 * vsc[j + 1]) : make_float2(p0, p1);
        if constexpr (kPaged && kMma) pv = __bfloat1622float2(__float22bfloat162_rn(pv));
        *reinterpret_cast<float2*>(&p_w[r * 8 + 2 * t4]) = pv;
        if (t4 == 0) alpha_w[r] = alpha;
      }
    }
    __syncwarp();

    // O = O * alpha + P V over this warp's keys: lane = kCols columns, P in
    // fp32, each V element read and converted once
    float vf[8][kCols];
#pragma unroll
    for (int k8 = 0; k8 < 8; ++k8) {
      load_floats<C, kCols>(vf[k8], vt + (jw + k8) * L::kRowBytes +
                                        lane * kCols * static_cast<int>(sizeof(C)));
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= rows) break;
      const float4 pa = *reinterpret_cast<const float4*>(&p_w[r * 8]);
      const float4 pb = *reinterpret_cast<const float4*>(&p_w[r * 8 + 4]);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float alpha = alpha_w[r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        float a = acc[r][c] * alpha;
#pragma unroll
        for (int k8 = 0; k8 < 8; ++k8) a = fmaf(pr[k8], vf[k8][c], a);
        acc[r][c] = a;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' row states

  // merge the warps in warp order into this CTA's m_s, l_s, acc_s
  float* accw = reinterpret_cast<float*>(smem);             // [warp][row][D]
  float* mw = accw + kWarps * kMaxRows * D;                 // [warp][row]
  float* lw = mw + kWarps * kMaxRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int c = 0; c < kCols; ++c) accw[(warp * kMaxRows + r) * D + lane * kCols + c] = acc[r][c];
  }
  if (t4 == 0) {
#pragma unroll
    for (int half = 0; half < kHalves; ++half) {
      const int r = g8 + half * 8;
      if (r < rows) {
        mw[warp * kMaxRows + r] = m_r[half];
        lw[warp * kMaxRows + r] = l_r[half];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, col = i % D;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mw[w * kMaxRows + r]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = m == -INFINITY ? 0.f : expf(mw[w * kMaxRows + r] - m);
      l += lw[w * kMaxRows + r] * wt;
      a += accw[(w * kMaxRows + r) * D + col] * wt;
    }
    acc_s[i] = a;
    if (col == 0) {
      m_s[r] = m;
      l_s[r] = l;
    }
  }
  cluster.sync();  // every CTA's m_s, l_s and acc_s are final

  // this CTA's share of the (row, column) outputs, merged over the cluster
  // in rank order: m = max m_i, w_i = exp(m_i - m), l = sum l_i w_i,
  // out = sum w_i acc_i / l (one round of reads of the other CTAs)
  for (int i = rank * kThreads + tid; i < rows * D; i += csize * kThreads) {
    const int r = i / D, col = i % D;
    float mc[kMaxCluster], lc[kMaxCluster], ac[kMaxCluster];
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      const bool in = c < csize;
      mc[c] = in ? *cluster.map_shared_rank(&m_s[r], c) : -INFINITY;
      lc[c] = in ? *cluster.map_shared_rank(&l_s[r], c) : 0.f;
      ac[c] = in ? cluster.map_shared_rank(acc_s, c)[i] : 0.f;
    }
    float m = -INFINITY;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) m = fmaxf(m, mc[c]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      const float w = m == -INFINITY ? 0.f : expf(mc[c] - m);
      l += lc[c] * w;
      a += ac[c] * w;
    }
    const float o = l > 0.f ? a / l : 0.f;
    if (kPartial) {
      const int64_t cell = ((static_cast<int64_t>(b) * hk + kh) * p.splits + split) * rows + r;
      p.part_out[cell * D + col] = o;
      if (col == 0) {
        p.part_m[cell] = l > 0.f ? m : xfa::kMaskValue;
        p.part_l[cell] = l;
      }
    } else {
      const int si = r / g, gi = r % g;
      const int64_t off = ((static_cast<int64_t>(b) * sq + si) * h + kh * g + gi) * D + col;
      static_cast<T*>(p.out)[off] = xfa::from_float<T>(o);
    }
  }
  cluster.sync();  // the other CTAs' shared memory stays alive until every read is done
}

template <typename X>
struct Tag {
  using type = X;
};

// A launch configuration with a cluster of `cluster` CTAs along x; raises the
// kernel's dynamic shared memory limit first, once per device (`done`: the
// instance's own set of devices already raised).
template <typename Kernel>
cudaError_t cluster_config(Kernel kernel, int smem, dim3 grid, int cluster, cudaStream_t s,
                           cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                           std::atomic<uint64_t>& done) {
  const cudaError_t err = xfa::sm90::smem_limit_once(kernel, smem, done);
  if (err != cudaSuccess) return err;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

inline bool valid_cluster(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

}  // namespace
