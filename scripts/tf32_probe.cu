// What the fp32 backward (csrc/flash_fp32.cu) assumes of the H100's TF32
// tensor cores and of its own tile layouts, checked on the card:
//
//   mkdir -p build && nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//       -I xhy_flash_attention_tpu_torch/csrc -o build/tf32_probe scripts/tf32_probe.cu
//   build/tf32_probe       # from the repository's root, on the card (~10 s)
//
// Prints, and ends with "PROBE OK" when the layouts hold:
//   1. a 4-D fp32 tensor map (hopper.cuh encode_bhsd_f32) lands boxes of 32
//      columns 128-byte swizzled as flash_fp32.cu's swz<128> addresses them,
//      with rows past the tensor zero-filled;
//   2. wgmma .tf32 with A in registers (a[i]: row g + 8 (i % 2), column t +
//      4 (i / 2)) and B K-major, 128-byte swizzled (rows of 32 floats, a
//      k-step 32 bytes on) and 64-byte swizzled (rows of 16 floats), at N
//      16, 32, 64 and 128, against a float64 product on the host;
//   3. how the tensor cores read a .tf32 operand whose low 13 bits are set:
//      as it is, truncated or otherwise (counted, not checked);
//   4. how they add to an accumulator: 1.0 plus 0.75 of its ulp, 64 times,
//      as rounding (1 + 64 ulp), truncation (1.0) or otherwise (printed).
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "hopper.cuh"

using namespace xfa::sm90;

namespace {

__device__ __forceinline__ uint32_t off128(int r, int c) {  // rows of 32 floats
  return r * 128 + (((c / 4) ^ (r % 8)) * 16) + (c % 4) * 4;
}
__device__ __forceinline__ uint32_t off64(int r, int c) {  // rows of 16 floats
  return r * 64 + (((c / 4) ^ ((r / 2) % 4)) * 16) + (c % 4) * 4;
}

struct Out {
  int tma_bad;
  float d1[64 * 16];  // A (64 x 32) B (32 x 16), 128-byte swizzle
  float d2[64 * 16];  // A (64 x 16) B (16 x 16), 64-byte swizzle
  float d3[64 * 16];  // A with its low bits set, times an identity
  float d32[64 * 32], d64[64 * 64], d128[64 * 128];  // A (64 x 8) B (8 x N)
  float acc[64 * 16];  // 1.0 + 64 x 0.75 ulp
};

template <int N>
__device__ void store_acc(float* dst, const float* acc, int w, int g, int t) {
  for (int i = 0; i < N / 2; ++i)
    dst[(16 * w + g + 8 * ((i / 2) % 2)) * N + 8 * (i / 4) + 2 * t + (i % 2)] = acc[i];
}

__global__ void probe(const __grid_constant__ CUtensorMap tx, const float* X, const float* A1,
                      const float* B1, const float* A2, const float* B2, const float* A3,
                      const float* Bn, Out* out) {
  extern __shared__ uint8_t raw[];
  uint8_t* sm = raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(sm), bar = base + 65536;
  const int tid = threadIdx.x, w = tid / 32, g = (tid % 32) / 4, t = tid % 4;
  if (tid == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  // 1. boxes (columns 0..31, rows 0..31) at 0 and (32..63, 32..63) at 4096
  if (tid == 0) {
    mbar_expect_tx(bar, 8192);
    tma_load_4d(base, &tx, bar, 0, 0, 0, 0);
    tma_load_4d(base + 4096, &tx, bar, 32, 32, 0, 0);
  }
  mbar_wait(bar, 0);
  int bad = 0;
  for (int i = tid; i < 32 * 32; i += 128) {
    const int r = i / 32, c = i % 32;
    const float w1 = r + 32 < 40 ? X[(r + 32) * 64 + 32 + c] : 0.f;
    bad += (*reinterpret_cast<float*>(sm + off128(r, c)) != X[r * 64 + c]) +
           (*reinterpret_cast<float*>(sm + 4096 + off128(r, c)) != w1);
  }
  atomicAdd(&out->tma_bad, bad);
  __syncthreads();
  // B operands, K-major: row n holds B[k][n] at column k
  for (int i = tid; i < 16 * 32; i += 128)
    *reinterpret_cast<float*>(sm + 8192 + off128(i / 32, i % 32)) = B1[(i % 32) * 16 + i / 32];
  for (int i = tid; i < 16 * 16; i += 128)
    *reinterpret_cast<float*>(sm + 12288 + off64(i / 16, i % 16)) = B2[(i % 16) * 16 + i / 16];
  for (int i = tid; i < 16 * 32; i += 128) {  // identity: B[k][n] = (n % 8 == k)
    const int n = i / 32, k = i % 32;
    *reinterpret_cast<float*>(sm + 16384 + off128(n, k)) = (k < 8 && n % 8 == k) ? 1.f : 0.f;
  }
  for (int i = tid; i < 128 * 32; i += 128) {
    const int n = i / 32, k = i % 32;
    *reinterpret_cast<float*>(sm + 20480 + off128(n, k)) = k < 8 ? Bn[k * 128 + n] : 0.f;
  }
  for (int i = tid; i < 16 * 32; i += 128) {  // column sums 0.75 x 2^-23: 2^-24 + 2^-25
    const int k = i % 32;
    *reinterpret_cast<float*>(sm + 40960 + off128(i / 32, k)) =
        k == 0 ? ldexpf(1.f, -24) : k == 1 ? ldexpf(1.f, -25) : 0.f;
  }
  fence_proxy_async();
  __syncthreads();
  auto afrag = [&](const float* A, int ld, int kk, uint32_t (&a)[4]) {
    for (int i = 0; i < 4; ++i)
      a[i] = __float_as_uint(A[(16 * w + g + 8 * (i % 2)) * ld + 8 * kk + t + 4 * (i / 2)]);
  };
  {  // 2. K 32, 128-byte swizzle, four k-steps
    float acc[8] = {};
    uint32_t a[4][4];
    for (int kk = 0; kk < 4; ++kk) afrag(A1, 32, kk, a[kk]);
    wgmma_fence();
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n16_tf32(acc, a[kk], desc_b128(base + 8192, 16) + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc<16>(out->d1, acc, w, g, t);
  }
  {  // K 16, 64-byte swizzle, two k-steps
    float acc[8] = {};
    uint32_t a[2][4];
    for (int kk = 0; kk < 2; ++kk) afrag(A2, 16, kk, a[kk]);
    wgmma_fence();
    for (int kk = 0; kk < 2; ++kk) wgmma_rs_n16_tf32(acc, a[kk], desc_b64(base + 12288) + 2 * kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc<16>(out->d2, acc, w, g, t);
  }
  {  // 3. the operand's low bits
    float acc[8] = {};
    uint32_t a[4];
    afrag(A3, 8, 0, a);
    wgmma_fence();
    wgmma_rs_n16_tf32(acc, a, desc_b128(base + 16384, 16));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    store_acc<16>(out->d3, acc, w, g, t);
  }
  {  // N 32, 64, 128
    uint32_t a[4];
    afrag(A1, 32, 0, a);
    float c32[16] = {}, c64[32] = {}, c128[64] = {};
    const uint64_t db = desc_b128(base + 20480, 16);
    wgmma_fence();
    wgmma_rs_n32_tf32(c32, a, db);
    wgmma_rs_n64_tf32(c64, a, db);
    wgmma_rs_n128_tf32(c128, a, db);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(c32);
    fence_regs(c64);
    fence_regs(c128);
    store_acc<32>(out->d32, c32, w, g, t);
    store_acc<64>(out->d64, c64, w, g, t);
    store_acc<128>(out->d128, c128, w, g, t);
  }
  {  // 4. 1.0 + 64 x (0.75 ulp), one wgmma a step
    float acc[8];
    for (int i = 0; i < 8; ++i) acc[i] = 1.f;
    const uint32_t one[4] = {0x3f800000u, 0x3f800000u, 0x3f800000u, 0x3f800000u};
    for (int s = 0; s < 64; ++s) {
      fence_regs(acc);
      wgmma_fence();
      wgmma_rs_n16_tf32(acc, one, desc_b128(base + 40960, 16));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
    }
    store_acc<16>(out->acc, acc, w, g, t);
  }
}

float tf32_exact(float x) {
  uint32_t b;
  memcpy(&b, &x, 4);
  b &= 0xffffe000u;
  memcpy(&x, &b, 4);
  return x;
}

double worst_err(const char* what, const float* got, const std::vector<float>& A, int lda,
                 const std::vector<float>& B, int ldb, int K, int N) {
  double worst = 0;
  for (int r = 0; r < 64; ++r)
    for (int n = 0; n < N; ++n) {
      double s = 0;
      for (int k = 0; k < K; ++k) s += double(A[r * lda + k]) * B[k * ldb + n];
      worst = fmax(worst, fabs(s - got[r * N + n]));
    }
  printf("%s: max |err| %.3g\n", what, worst);
  return worst;
}

}  // namespace

int main() {
  srand(1);
  auto rnd = [] { return tf32_exact((rand() / float(RAND_MAX)) * 2.f - 1.f); };
  std::vector<float> X(40 * 64), A1(64 * 32), B1(32 * 16), A2(64 * 16), B2(16 * 16), A3(64 * 8),
      Bn(8 * 128);
  for (auto* v : {&X, &A1, &B1, &A2, &B2, &Bn})
    for (auto& x : *v) x = rnd();
  for (int i = 0; i < 64 * 8; ++i) {  // 1 + (i / 8) 2^-10 with bits 10..12 set (below tf32's ulp)
    const uint32_t b = 0x3f800000u | (uint32_t(i % 8 + 1) << 10) | (uint32_t(i / 8) << 13);
    memcpy(&A3[i], &b, 4);
  }
  auto up = [&](const std::vector<float>& h) {
    float* d;
    cudaMalloc(&d, h.size() * 4);
    cudaMemcpy(d, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
    return d;
  };
  float *dX = up(X), *dA1 = up(A1), *dB1 = up(B1), *dA2 = up(A2), *dB2 = up(B2), *dA3 = up(A3),
        *dBn = up(Bn);
  Out* dout;
  cudaMalloc(&dout, sizeof(Out));
  cudaMemset(dout, 0, sizeof(Out));
  CUtensorMap map;
  if (!encode_bhsd_f32(&map, dX, 1, 1, 40, 64, 40 * 64, 40 * 64, 64, 32)) {
    printf("encode_bhsd_f32 failed\n");
    return 1;
  }
  const int smem = 65536 + 1024 + 64;
  cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  probe<<<1, 128, smem>>>(map, dX, dA1, dB1, dA2, dB2, dA3, dBn, dout);
  const cudaError_t e = cudaDeviceSynchronize();
  printf("kernel: %s\n", cudaGetErrorString(e));
  if (e != cudaSuccess) return 1;
  Out h;
  cudaMemcpy(&h, dout, sizeof(Out), cudaMemcpyDeviceToHost);
  printf("1. TMA boxes: %d elements misplaced\n", h.tma_bad);
  double worst = 0;
  worst = fmax(worst, worst_err("2. RS n16, 128-byte swizzle, K 32", h.d1, A1, 32, B1, 16, 32, 16));
  worst = fmax(worst, worst_err("   RS n16, 64-byte swizzle, K 16", h.d2, A2, 16, B2, 16, 16, 16));
  worst = fmax(worst, worst_err("   RS n32", h.d32, A1, 32, Bn, 128, 8, 32));
  worst = fmax(worst, worst_err("   RS n64", h.d64, A1, 32, Bn, 128, 8, 64));
  worst = fmax(worst, worst_err("   RS n128", h.d128, A1, 32, Bn, 128, 8, 128));
  int as_is = 0, truncated = 0, other = 0;
  for (int r = 0; r < 64; ++r)
    for (int n = 0; n < 16; ++n) {
      const float a = A3[r * 8 + n % 8], d = h.d3[r * 16 + n];
      as_is += d == a;
      truncated += d != a && d == tf32_exact(a);
      other += d != a && d != tf32_exact(a);
    }
  printf("3. operands with low bits set (%d of 1024 have none): read as they are %d, "
         "truncated %d, otherwise %d\n", 128, as_is - 128, truncated, other);
  const double ulps = (double(h.acc[0]) - 1.0) / ldexp(1.0, -23);
  printf("4. 1.0 + 64 x 0.75 ulp on the tensor cores: 1 + %.0f ulp (rounding: 64, truncation: 0, "
         "exact: 48)\n", ulps);
  const bool ok = h.tma_bad == 0 && worst < 1e-5;
  printf("PROBE %s\n", ok ? "OK" : "FAILED");
  return ok ? 0 : 1;
}
