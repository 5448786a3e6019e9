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
//
// What they compute, as the TPU kernels do (bwd.py:106-177): q is scaled by
// sm_scale in fp32 and rounded to bf16 (q_s); S = q_s K^T in fp32, optional
// softcap t = tanh(S / c), S = t c; the causal mask is aligned to the bottom
// right (key j visible to query i when j <= i + sk - sq); P = exp(S - LSE)
// from the forward's LSE (+inf on rows with no key gives P = 0);
// dP = dO V^T; dS = P (dP - delta) (1 - t^2), delta = rowsum(dO * O) given
// in fp32; P and dS are rounded to bf16 for the products
//   dV = P^T dO,  dK = dS^T q_s,  dQ = (dS K) sm_scale.
// GQA: dK/dV sum over the query heads of the group inside one block.
//
// Why two kernels. JAX's merged mode (bwd.py:9-23) carries dQ across a
// sequential KV grid axis in VMEM. A Hopper grid has no sequential axis:
// without fp32 atomics (which would make dQ depend on block order) a merged
// kernel needs an fp32 dQ partials workspace of b*h*(s/64)*s*d*4 bytes, 4.3
// GB at b16 h16 s2048 d64. The split pair recomputes S and dP once more (7
// products per tile instead of 5) and is bitwise deterministic: every output
// element is summed by one thread in a fixed order.
//
// Bound on the H100: operations (b16 h16 s2048 d64 causal: 3.8e11 FLOPs in
// the pair against ~0.3 GB of traffic). Design, simple first, mma.sync tiles
// as in flash_fwd.cu:
//   * dKV: grid (key tiles of 64, kv head, batch); four warps own 16 keys
//     each. K and V tiles stay in shared memory; the block walks the group's
//     query heads and the query tiles that see its keys (kQT rows: 64 at
//     d 64, 32 at d 128 to bound registers), staging q_s, dO, LSE and delta
//     per tile. Each warp computes S^T = K q_s^T and dP^T = V dO^T with its
//     keys as rows, so dV += P^T dO and dK += dS^T q_s take P^T and dS^T
//     straight from the accumulators as A fragments; dO and q_s come through
//     ldmatrix.trans.
//   * dQ: grid (query tiles of 64, head, batch); four warps own 16 rows,
//     holding q_s and dO fragments in registers; key tiles (64 at d 64, 32 at
//     d 128) up to the causal edge are staged in shared memory; dQ += dS K
//     through ldmatrix.trans of the K tile.
// Sparse masks (slice 4, the TPU kernels' FlashMask and block-mask flags,
// bwd.py:332-350, 582-600): both kernels skip, unread, the tiles the
// forward skips, and run the elementwise band test only on tiles the
// FlashMask stats do not bypass; stats come per each kernel's own key tile
// (64 keys in dK/dV, kKT in dQ). In dK/dV a key tile serves the g query
// heads of its group, and each reads its own mask head, head / (h / hm):
// the block reloads its keys' vectors per head, and skips every query tile
// whose rows are all masked. In causal_1 (a causal document mask) that ends
// the query loop at the tile's largest LTStart, the end of the last
// document its keys belong to: the work a packed batch saves. The mask code
// is a template branch (MASKED): the kernels without masks compile as they
// did before it.
// Not yet used: wgmma, TMA, cp.async pipelining — the work of later tuning.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::ldmatrix_x2_trans;
using xfa::mma_16816;
using xfa::mma_abt_smem_a;
using xfa::pack_a;
using xfa::pack_bf16;
using xfa::stage_rows;

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

template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const BwdParams p) {
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
    if (MASKED && mk.fm_vecs != nullptr) {  // this head's mask head: its vectors
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
      if (MASKED && !xfa::mask_tile(mk, batch, head, p.h, m0, min(m0 + kQT, p.sq), n0,
                                    kKeysPerBlock, band))
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

template <int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const BwdParams p) {
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
    if (MASKED && !xfa::mask_tile(mk, batch, head, p.h, q0, q1, n0, kKT, band)) continue;
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

template <int D, bool MASKED>
cudaError_t launch_dkv(const BwdParams& p, int b, cudaStream_t s) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D, MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + kKeysPerBlock - 1) / kKeysPerBlock, p.hk, b);
  flash_bwd_dkv_kernel<D, MASKED><<<grid, kThreads, smem, s>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int b, cudaStream_t s) {
  return has_masks(p) ? launch_dkv<D, true>(p, b, s) : launch_dkv<D, false>(p, b, s);
}

}  // namespace

// The 21 strides, in elements, are (batch, head, seq) of q, k, v, dout, dq,
// dk and dv in that order; the head-dim axis of every tensor is contiguous.
// lse and delta are (b, h, sq) fp32 contiguous. The mask arguments
// (XFA_MASK_ARGS, common.cuh) carry FlashMask stats per key tile of the
// kernel launched: 64 keys for dK/dV, kKT (64 at d 64, 32 at d 128) for dQ. dk/dv are written by
// xfa_flash_bwd_dkv, dq by xfa_flash_bwd_dq; each launch overwrites its
// outputs (no zero fill needed).
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
  cudaStream_t s = static_cast<cudaStream_t>(stream)

XFA_EXPORT int xfa_flash_bwd_dkv(XFA_BWD_ARGS) {
  XFA_BWD_PARAMS;
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  if (d == 64) return static_cast<int>(launch_dkv<64>(p, b, s));
  if (d == 128) return static_cast<int>(launch_dkv<128>(p, b, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

XFA_EXPORT int xfa_flash_bwd_dq(XFA_BWD_ARGS) {
  XFA_BWD_PARAMS;
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((sq + kRowsPerBlock - 1) / kRowsPerBlock, h, b);
  const bool masked = has_masks(p);
  if (d == 64) {
    if (masked) flash_bwd_dq_kernel<64, true><<<grid, kThreads, 0, s>>>(p);
    else flash_bwd_dq_kernel<64, false><<<grid, kThreads, 0, s>>>(p);
  } else if (d == 128) {
    if (masked) flash_bwd_dq_kernel<128, true><<<grid, kThreads, 0, s>>>(p);
    else flash_bwd_dq_kernel<128, false><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
