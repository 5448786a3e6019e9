// FlashAttention-2 forward for bf16 q/k/v with fp32 accumulation.
//
// Replaces two TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/fwd.py:78 `_fwd_kernel`
//     (driven by flash_attention_fwd, (b, h, s, d) layout);
//   * xhy_flash_attention_tpu/ops/flash_attention/fused_heads.py:59
//     `_fwd_kernel` (the packed projection layout (b, s, h*d)).
// The kernel takes element strides for the batch, head and sequence axes of
// q, k, v and o (the head-dim stride is 1), so both layouts are read and
// written in place with no copy.
//
// What it computes, as the TPU kernels do: q is scaled by sm_scale in fp32
// and rounded to bf16 before QK^T; scores accumulate in fp32; optional
// softcap tanh(s / c) * c; causal mask aligned to the bottom right
// (key j visible to query i when j <= i + sk - sq); GQA through
// kv_head = head / (h / hk); P is rounded to bf16 for P.V; the output is
// divided by the fp32 row sum; an optional fp32 LSE (+inf on rows with no
// visible key, whose output is 0).
//
// Softmax: the max-shifted online softmax. The TPU kernels use a zero shift,
// exp(min(s, 70)) (fwd.py:60-65, fused_heads.py:81). Both give the same
// P / l to fp32 rounding while scores stay under 70; the shifted form also
// stays finite above it.
//
// Bound on the H100: operations. Causal prefill at Llama-3-8B width
// (b2 h32 s2048 d128) does ~69 GFLOP against ~50 MB of q/k/v/o traffic.
// Design: one block of four warps owns 64 query rows of one (batch, head);
// each warp keeps its 16 rows of Q (pre-scaled, bf16) and the O accumulator
// in registers and runs mma.sync m16n8k16 bf16 tiles. K and V tiles of 64
// keys are staged in padded shared memory (conflict-free fragment reads; V
// fragments come through ldmatrix.trans). KV tiles past the causal edge are
// never loaded. Not yet used: wgmma, TMA, cp.async double buffering, warp
// specialisation — the work of later tuning.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBlockM = 64;  // query rows per block (16 per warp)
constexpr int kBlockN = 64;  // keys per tile
constexpr int kThreads = 128;

struct FwdParams {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  float* lse;  // (b, h, sq) contiguous, or null
  int64_t q_sb, q_sh, q_ss;
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  int h, hk, sq, sk;
  float sm_scale, softcap;
  int causal;
};

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

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const FwdParams p) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kStride = D + 8;  // padded smem row (bf16): conflict-free fragment reads
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  __shared__ __align__(16) bf16 ks[kBlockN * kStride];
  __shared__ __align__(16) bf16 vs[kBlockN * kStride];

  // heaviest causal q blocks first
  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int head = blockIdx.y, batch = blockIdx.z;
  const int kv_head = head / (p.h / p.hk);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = m_block * kBlockM + warp * 16;
  const int offset = p.sk - p.sq;

  const bf16* qb = p.q + batch * p.q_sb + head * p.q_sh;
  const bf16* kb = p.k + batch * p.k_sb + kv_head * p.k_sh;
  const bf16* vb = p.v + batch * p.v_sb + kv_head * p.v_sh;
  bf16* ob = p.o + batch * p.o_sb + head * p.o_sh;

  // Q fragments (A operand), scaled in fp32 and rounded to bf16.
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + g + (r & 1) * 8;
      const int col = kk * 16 + (r >> 1) * 8 + 2 * t;
      uint32_t val = 0;
      if (row < p.sq) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(qb + row * p.q_ss + col));
        val = pack_bf16(f.x * p.sm_scale, f.y * p.sm_scale);
      }
      qf[kk][r] = val;
    }
  }

  float o_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o_acc[j][0] = o_acc[j][1] = o_acc[j][2] = o_acc[j][3] = 0.f;
  // this thread's two rows: g and g + 8 of the warp's 16
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};

  int n_tiles = (p.sk + kBlockN - 1) / kBlockN;
  if (p.causal) {
    const int last_row = min((m_block + 1) * kBlockM, p.sq) - 1;
    const int max_col = last_row + offset;
    n_tiles = max_col < 0 ? 0 : min(n_tiles, max_col / kBlockN + 1);
  }

  for (int nt = 0; nt < n_tiles; ++nt) {
    const int n0 = nt * kBlockN;
    __syncthreads();  // the previous tile is fully consumed
    for (int idx = threadIdx.x; idx < kBlockN * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = (idx % kChunks) * 8;
      const int key = n0 + r;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < p.sk) {
        kv = *reinterpret_cast<const uint4*>(kb + key * p.k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + key * p.v_ss + c);
      }
      *reinterpret_cast<uint4*>(&ks[r * kStride + c]) = kv;
      *reinterpret_cast<uint4*>(&vs[r * kStride + c]) = vv;
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 rows x 64 keys
    float s[kBlockN / 8][4];
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < kBlockN / 8; ++j) {
        const bf16* kr = &ks[(j * 8 + g) * kStride + kk * 16 + 2 * t];
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_16816(s[j], qf[kk], b0, b1);
      }
    }

    // softcap and mask; fragment element e sits at row g + (e >= 2) * 8,
    // column 2t + (e & 1) of n-tile j
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + g + (e >> 1) * 8;
        const int col = n0 + j * 8 + 2 * t + (e & 1);
        float x = s[j][e];
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        const bool visible = col < p.sk && (!p.causal || col <= row + offset);
        x = visible ? x : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m_i[i], mx[i]);
      // a row with nothing visible yet keeps a zero shift so exp() gives 0
      m_use[i] = m_new == -INFINITY ? 0.f : m_new;
      alpha[i] = expf(m_i[i] - m_use[i]);
      m_i[i] = m_new;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < kBlockN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m_use[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_i[i] = l_i[i] * alpha[i] + rs[i];
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o_acc[j][0] *= alpha[0];
      o_acc[j][1] *= alpha[0];
      o_acc[j][2] *= alpha[1];
      o_acc[j][3] *= alpha[1];
    }

    // O += P V: the S accumulators of n-tiles 2kk and 2kk+1 are the A
    // fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, &vs[(kk * 16 + (lane & 15)) * kStride + j * 8]);
        mma_16816(o_acc[j], a, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + i * 8;
    if (row >= p.sq) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
    bf16* orow = ob + row * p.o_ss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o_acc[j][2 * i] * inv, o_acc[j][2 * i + 1] * inv);
    }
    if (p.lse != nullptr && t == 0) {
      p.lse[(static_cast<int64_t>(batch) * p.h + head) * p.sq + row] =
          l_i[i] > 0.f ? m_i[i] + logf(l_i[i]) : INFINITY;
    }
  }
}

}  // namespace

// q/k/v/o strides are in elements for the (batch, head, seq) axes; the
// head-dim axis is contiguous. lse may be null.
XFA_EXPORT int xfa_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                             int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb,
                             int64_t k_sh, int64_t k_ss, int64_t v_sb, int64_t v_sh,
                             int64_t v_ss, int64_t o_sb, int64_t o_sh, int64_t o_ss, int b,
                             int h, int hk, int sq, int sk, int d, float sm_scale,
                             float softcap, int causal, void* stream) {
  FwdParams p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_ss = q_ss;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_ss = o_ss;
  p.h = h; p.hk = hk; p.sq = sq; p.sk = sk;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.causal = causal;
  if (b <= 0 || sq <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid((sq + kBlockM - 1) / kBlockM, h, b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) {
    flash_fwd_kernel<64><<<grid, kThreads, 0, s>>>(p);
  } else if (d == 128) {
    flash_fwd_kernel<128><<<grid, kThreads, 0, s>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
