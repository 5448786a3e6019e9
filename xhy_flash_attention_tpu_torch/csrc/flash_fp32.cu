// fp32 attention: forward, dK/dV and dQ kernels in full fp32 on the CUDA
// cores (FFMA), with tiles staged in shared memory.
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
// rounded below fp32.
//
// Arithmetic: every product is an fp32 FFMA on the CUDA cores. The JAX
// contract for fp32 (err <= 2 err_lp + 1e-4 against an fp64 reference,
// err_lp ~ 1e-6, tests/test_flash_attn.py:23-35) rules out a single TF32
// product (about three decimal digits). 3xTF32 on wgmma would reach the
// tensor cores; this is the simple kernel first.
//
// Bound on the H100: operations. FFMA peaks at 67 TFLOP/s; the
// `chip_smoke.py` rows state the bound as three TF32 products at 495
// TFLOP/s, what an fp32-accurate tensor-core kernel would need.
//
// Design: blocks of 256 threads (a 16 x 16 grid: ty = tid / 16, tx = tid %
// 16), tiles of 64 rows by 64 keys in shared memory, rows padded by four
// floats so that the 16-byte reads of a quarter warp (eight rows) hit every
// bank once. A thread computes a 4 x 4 part of each score tile, rows 4 ty
// .. 4 ty + 3 against keys tx, tx + 16, tx + 32, tx + 48, from float4 reads
// along the head dim; the 16 threads of a row group (half a warp) reduce
// the row max and sum by shuffles. The second product of each step (P V,
// dS K, P^T dO, dS^T q_s) reads P or dS back from shared memory, written
// and read by the same half warp, into a 4 x (D / 16) accumulator per
// thread (columns 4 tx + 64 c .. + 3: conflict-free float4 reads). Every
// output element is summed by one thread in a fixed order, so two runs give
// the same bits, dQ included, with no atomics.
//   * Forward: a block is 64 query rows of one (batch, head); K and V tiles
//     come by cp.async, the next K under this tile's softmax and P V, the
//     next V under the next scores.
//   * dQ: a block is 64 query rows with q_s and dO resident; per key tile
//     S and dP, then dQ += dS K.
//   * dK/dV: a block is 64 keys of one (batch, kv head) with K and V
//     resident; per head of the group and query tile, S^T and dP^T (keys
//     as rows), then dV += P^T dO and dK += dS^T q_s.
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
  const float* q;  // (b, h, sq, d) by strides; the backward's q is q_s
  const float* k;  // (b, hk, sk, d) by strides, or pages (P, hk, 2, ps, d)
  const float* v;
  const float* dout;
  const float* lse;    // (b, h, sq) contiguous
  const float* delta;  // (b, h, sq) contiguous
  float* out;          // forward: O; backward: dq
  float* lse_out;      // forward: (b, h, sq) contiguous, or null
  float* dk;
  float* dv;
  int64_t q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int64_t do_sb, do_sh, do_ss, o_sb, o_sh, o_ss;
  int64_t dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss;
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

// accumulator rows 4 ty + i (< n) to `dst`'s rows (stride ld), columns 64 c +
// 4 tx, times `scale`
template <int D>
__device__ __forceinline__ void store_rows(float* dst, int64_t ld, const float (&acc)[4][D / 16],
                                           const float* scale, int n, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c) {
      const float4 o = make_float4(acc[i][4 * c] * scale[i], acc[i][4 * c + 1] * scale[i],
                                   acc[i][4 * c + 2] * scale[i], acc[i][4 * c + 3] * scale[i]);
      *reinterpret_cast<float4*>(dst + r * ld + 64 * c + 4 * tx) = o;
    }
  }
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

// ----------------------------------------------------------------- dQ

template <int D>
struct DqSmem {
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + kTile * kLd<D>;
  static constexpr int kK = kDo + kTile * kLd<D>;
  static constexpr int kV = kK + kTile * kLd<D>;
  static constexpr int kDs = kV + kTile * kLd<D>;
  static constexpr int kBytes = (kDs + kTile * kLdP) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dq_fp32_kernel(const Fp32Params p) {
  using S = DqSmem<D>;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + S::kQ;
  float* do_s = smem + S::kDo;
  float* k_s = smem + S::kK;
  float* v_s = smem + S::kV;
  float* ds_s = smem + S::kDs;
  const int m0 = blockIdx.x * kTile, head = blockIdx.y, b = blockIdx.z;
  const int kh = head / (p.h / p.hk);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int sk = p.sk, off = p.sk - p.sq;
  const int r1 = min(m0 + kTile, p.sq) - 1;
  int kmax = sk - 1, kmin = 0;
  if (p.right >= 0) kmax = min(kmax, r1 + off + p.right);
  if (p.left >= 0) kmin = max(kmin, m0 + off - p.left);
  const int t_lo = kmin / kTile;
  const int n_tiles = kmax >= kmin ? kmax / kTile - t_lo + 1 : 0;
  const int n_rows = min(kTile, p.sq - m0);

  const float* qb = p.q + b * p.q_sb + head * p.q_sh;
  const float* dob = p.dout + b * p.do_sb + head * p.do_sh;
  const float* kb = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kh * p.v_sh;
  load_rows<D>(q_s, n_rows, [&](int r) { return qb + (m0 + r) * p.q_ss; });
  load_rows<D>(do_s, n_rows, [&](int r) { return dob + (m0 + r) * p.do_ss; });
  cp_async_commit();

  float lse[4], dlt[4], acc[4][D / 16];
  const int64_t stat = (static_cast<int64_t>(b) * p.h + head) * p.sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + 4 * ty + i;
    lse[i] = r < p.sq ? p.lse[stat + r] : INFINITY;
    dlt[i] = r < p.sq ? p.delta[stat + r] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int n0 = (t_lo + t) * kTile;
    load_rows<D>(k_s, min(kTile, sk - n0), [&](int r) { return kb + (n0 + r) * p.k_ss; });
    load_rows<D>(v_s, min(kTile, sk - n0), [&](int r) { return vb + (n0 + r) * p.v_ss; });
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    dot_tile<D>(s, q_s, k_s, ty, tx);
    dot_tile<D>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = m0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float th;
        const float sc = softcapped(s[i][j], p.softcap, th);
        float ds = 0.f;
        if (visible(r, n0 + tx + 16 * j, off, sk, p.left, p.right)) {
          const float pij = expf(sc - lse[i]);
          ds = pij * (dp[i][j] - dlt[i]);
          if (p.softcap > 0.f) ds *= 1.f - th * th;
        }
        ds_s[(4 * ty + i) * kLdP + tx + 16 * j] = ds;
      }
    }
    __syncwarp();  // dS rows 4 ty .. 4 ty + 3 come from this half warp
    pv_tile<D>(acc, ds_s, k_s, ty, tx);
    __syncthreads();  // every thread is done with K, V and its dS rows
  }
  const float scale[4] = {p.sm_scale, p.sm_scale, p.sm_scale, p.sm_scale};
  store_rows<D>(p.out + b * p.o_sb + head * p.o_sh + m0 * p.o_ss, p.o_ss, acc, scale, n_rows,
                ty, tx);
}

// --------------------------------------------------------------- dK / dV

template <int D>
struct DkvSmem {
  static constexpr int kK = 0;
  static constexpr int kV = kK + kTile * kLd<D>;
  static constexpr int kQ = kV + kTile * kLd<D>;
  static constexpr int kDo = kQ + kTile * kLd<D>;
  static constexpr int kP = kDo + kTile * kLd<D>;
  static constexpr int kDs = kP + kTile * kLdP;
  static constexpr int kStats = kDs + kTile * kLdP;  // lse, delta of the tile's rows
  static constexpr int kBytes = (kStats + 2 * kTile) * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads, D == 64 ? 2 : 1)
    flash_bwd_dkv_fp32_kernel(const Fp32Params p) {
  using S = DkvSmem<D>;
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem + S::kK;
  float* v_s = smem + S::kV;
  float* q_s = smem + S::kQ;
  float* do_s = smem + S::kDo;
  float* p_s = smem + S::kP;
  float* ds_s = smem + S::kDs;
  float* lse_s = smem + S::kStats;
  float* dlt_s = lse_s + kTile;
  const int n0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int g = p.h / p.hk;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int sk = p.sk, off = p.sk - p.sq;
  const int n_keys = min(kTile, sk - n0);
  // the query rows any key of the block is visible to
  const int n1 = n0 + n_keys - 1;
  int rmin = 0, rmax = p.sq - 1;
  if (p.right >= 0) rmin = max(rmin, n0 - off - p.right);
  if (p.left >= 0) rmax = min(rmax, n1 - off + p.left);
  const int m_lo = rmin / kTile;
  const int n_tiles = rmax >= rmin ? rmax / kTile - m_lo + 1 : 0;

  const float* kb = p.k + b * p.k_sb + kh * p.k_sh;
  const float* vb = p.v + b * p.v_sb + kh * p.v_sh;
  load_rows<D>(k_s, n_keys, [&](int r) { return kb + (n0 + r) * p.k_ss; });
  load_rows<D>(v_s, n_keys, [&](int r) { return vb + (n0 + r) * p.v_ss; });
  cp_async_commit();

  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  for (int hg = 0; hg < g; ++hg) {
    const int head = kh * g + hg;
    const float* qb = p.q + b * p.q_sb + head * p.q_sh;
    const float* dob = p.dout + b * p.do_sb + head * p.do_sh;
    const int64_t stat = (static_cast<int64_t>(b) * p.h + head) * p.sq;
    for (int t = 0; t < n_tiles; ++t) {
      const int m0 = (m_lo + t) * kTile;
      const int n_rows = min(kTile, p.sq - m0);
      load_rows<D>(q_s, n_rows, [&](int r) { return qb + (m0 + r) * p.q_ss; });
      load_rows<D>(do_s, n_rows, [&](int r) { return dob + (m0 + r) * p.do_ss; });
      cp_async_commit();
      if (tid < kTile) {
        const int r = m0 + tid;
        lse_s[tid] = r < p.sq ? p.lse[stat + r] : INFINITY;
        dlt_s[tid] = r < p.sq ? p.delta[stat + r] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();
      // S^T and dP^T: keys 4 ty + i (rows of K, V) against query rows tx +
      // 16 j (rows of q_s, dO)
      float s[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
      dot_tile<D>(s, k_s, q_s, ty, tx);
      dot_tile<D>(dp, v_s, do_s, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + 4 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int rr = tx + 16 * j, r = m0 + rr;
          float th;
          const float sc = softcapped(s[i][j], p.softcap, th);
          float pij = 0.f, ds = 0.f;
          if (r < p.sq && visible(r, key, off, sk, p.left, p.right)) {
            pij = expf(sc - lse_s[rr]);
            ds = pij * (dp[i][j] - dlt_s[rr]);
            if (p.softcap > 0.f) ds *= 1.f - th * th;
          }
          p_s[(4 * ty + i) * kLdP + rr] = pij;
          ds_s[(4 * ty + i) * kLdP + rr] = ds;
        }
      }
      __syncwarp();  // P^T and dS^T rows 4 ty .. 4 ty + 3 come from this half warp
      pv_tile<D>(dv, p_s, do_s, ty, tx);
      pv_tile<D>(dk, ds_s, q_s, ty, tx);
      __syncthreads();  // every thread is done with q_s, dO and the stats
    }
  }
  cp_async_wait<0>();  // K and V, when no tile ran
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows<D>(p.dk + b * p.dk_sb + kh * p.dk_sh + n0 * p.dk_ss, p.dk_ss, dk, one, n_keys, ty,
                tx);
  store_rows<D>(p.dv + b * p.dv_sb + kh * p.dv_sh + n0 * p.dv_ss, p.dv_ss, dv, one, n_keys, ty,
                tx);
}

enum Kind { kFwd, kFwdPaged, kDkv, kDq };

// Launch kernel `kind` at head dim D, raising its shared-memory limit once
// per device.
template <Kind kind, int D>
cudaError_t launch(dim3 grid, cudaStream_t s, const Fp32Params& p) {
  static std::atomic<uint64_t> done{0};
  auto kernel = kind == kFwd        ? flash_fwd_fp32_kernel<D, false>
                : kind == kFwdPaged ? flash_fwd_fp32_kernel<D, true>
                : kind == kDkv      ? flash_bwd_dkv_fp32_kernel<D>
                                    : flash_bwd_dq_fp32_kernel<D>;
  constexpr int bytes = kind == kDkv  ? DkvSmem<D>::kBytes
                        : kind == kDq ? DqSmem<D>::kBytes
                                      : FwdSmem<D>::kBytes;
  const cudaError_t err = xfa::sm90::smem_limit_once(kernel, bytes, done);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <Kind kind>
cudaError_t launch_d(int d, dim3 grid, cudaStream_t s, const Fp32Params& p) {
  if (d == 64) return launch<kind, 64>(grid, s, p);
  if (d == 128) return launch<kind, 128>(grid, s, p);
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
  return static_cast<int>(table != nullptr ? launch_d<kFwdPaged>(d, grid, s, p)
                                            : launch_d<kFwd>(d, grid, s, p));
}

// which: 0 dK/dV, 1 dQ. q is q_s = q * sm_scale (flash_bwd.cu's pre-pass,
// fp32), (b, h, sq, d) like dout and dq; k, v, dk, dv (b, hk, sk, d); the
// 21 element strides (batch, head, seq) of q, k, v, dout, dq, dk, dv; every
// row's head dim contiguous, pointers and strides multiples of 4 elements.
// lse, delta: (b, h, sq) fp32 contiguous. Each launch overwrites its
// outputs (zero where no pair is visible).
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
  if (hk <= 0 || h % hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  Fp32Params p{};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.out = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.do_sb = do_sb; p.do_sh = do_sh; p.do_ss = do_ss;
  p.o_sb = dq_sb; p.o_sh = dq_sh; p.o_ss = dq_ss;
  p.dk_sb = dk_sb; p.dk_sh = dk_sh; p.dk_ss = dk_ss;
  p.dv_sb = dv_sb; p.dv_sh = dv_sh; p.dv_ss = dv_ss;
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.left = left;
  p.right = right;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 0)
    return static_cast<int>(launch_d<kDkv>(d, dim3((sk + kTile - 1) / kTile, hk, b), s, p));
  if (which == 1)
    return static_cast<int>(launch_d<kDq>(d, dim3((sq + kTile - 1) / kTile, h, b), s, p));
  return static_cast<int>(cudaErrorInvalidValue);
}
