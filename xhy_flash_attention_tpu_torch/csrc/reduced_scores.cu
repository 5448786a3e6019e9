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
// Determinism. The TPU kernel gets it from its sequential q-block grid axis
// accumulating in VMEM; the reference adds with atomicAdd. Here one block
// owns 64 keys of one (batch, head) and walks the query tiles in order,
// each thread summing its keys' column partials in a fixed order
// (registers, then two fixed shuffles): no atomics, bitwise equal across
// runs.
//
// Bound on the H100: operations (2 b h d N_visible FLOPs against q, k, lse
// read once and the fp32 output). Design, simple first, the mma.sync tiles
// of flash_bwd.cu's dK/dV kernel: four warps own 16 keys each and compute
// S^T = K q^T with their keys as rows, so a key's partial sums stay in one
// thread group. K stays in shared memory; q tiles of 64 rows and their LSE
// are staged per step; query tiles before the causal edge are never read.
// Not yet used: wgmma, TMA, cp.async double buffering.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using xfa::mma_abt_smem_a;
using xfa::stage_rows;

constexpr int kThreads = 128;
constexpr int kKeys = 64;  // keys per block, 16 per warp
constexpr int kQT = 64;    // query rows per staged tile

struct ReducedParams {
  const bf16* q;
  const bf16* k;
  const float* lse;  // (b, h, sq) contiguous
  float* out;        // (b, h, sk) contiguous
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int h, hk, sq, sk;
  float sm_scale;
  int causal;
};

template <int D>
__global__ void __launch_bounds__(kThreads) reduced_scores_kernel(const ReducedParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;
  __shared__ __align__(16) bf16 ks[kKeys * kStride];
  __shared__ __align__(16) bf16 qs[kQT * kStride];
  __shared__ float lse_s[kQT];

  const int n0 = blockIdx.x * kKeys;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = n0 + warp * 16;  // this warp's first key
  const int offset = p.sk - p.sq;
  const bf16* qb = p.q + batch * p.q_sb + head * p.q_sh;
  const int64_t stat = (static_cast<int64_t>(batch) * p.h + head) * p.sq;

  stage_rows<D, kKeys, false>(ks, p.k + batch * p.k_sb + kv_head * p.k_sh, p.k_ss, n0, p.sk,
                              1.f);

  // causal: the first query row that sees key n0 is n0 - offset
  int m_begin = 0;
  if (p.causal && n0 - offset > 0) m_begin = (n0 - offset) / kQT;
  const int n_qtiles = (p.sq + kQT - 1) / kQT;

  float acc[2] = {0.f, 0.f};  // keys g and g + 8 of this warp
  for (int mt = m_begin; mt < n_qtiles; ++mt) {
    const int m0 = mt * kQT;
    __syncthreads();  // the previous tile is consumed (and K staged)
    stage_rows<D, kQT, false>(qs, qb, p.q_ss, m0, p.sq, 1.f);
    for (int i = threadIdx.x; i < kQT; i += kThreads) {
      const int row = m0 + i;
      lse_s[i] = row < p.sq ? p.lse[stat + row] : INFINITY;
    }
    __syncthreads();

    // S^T = K q^T: this warp's 16 keys x 64 rows; element e of n-tile j is
    // key g + (e >> 1) * 8, row j * 8 + 2t + (e & 1) of the tile
    float s[kQT / 8][4];
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mma_abt_smem_a<D, kQT>(s, ks, warp * 16, qs, g, t);

    float part[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kQT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + g + (e >> 1) * 8;
        const int qi = j * 8 + 2 * t + (e & 1);
        const int row = m0 + qi;
        const bool valid = row < p.sq && (!p.causal || key <= row + offset);
        part[e >> 1] += valid ? expf(s[j][e] * p.sm_scale - lse_s[qi]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 1);
      part[i] += __shfl_xor_sync(0xffffffffu, part[i], 2);
      acc[i] += part[i];
    }
  }

  if (t == 0) {
    float* ob = p.out + (static_cast<int64_t>(batch) * p.h + head) * p.sk;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = key0 + g + i * 8;
      if (key < p.sk) ob[key] = acc[i];
    }
  }
}

}  // namespace

// q (b, h, sq, d) and k (b, hk, sk, d) bf16 with element strides for the
// (batch, head, seq) axes, head dim contiguous; lse (b, h, sq) and out
// (b, h, sk) fp32 contiguous. Every output element is written.
XFA_EXPORT int xfa_reduced_scores(const void* q, const void* k, const void* lse, void* out,
                                  int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                                  int64_t k_sh, int64_t k_ss, int b, int h, int hk, int sq,
                                  int sk, int d, float sm_scale, int causal, void* stream) {
  ReducedParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.lse = static_cast<const float*>(lse);
  p.out = static_cast<float*>(out);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.causal = causal;
  if (b <= 0 || sk <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((sk + kKeys - 1) / kKeys, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    reduced_scores_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (d == 128) {
    reduced_scores_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
