// Hopper (sm_90a) building blocks written in PTX: mbarriers, TMA tile
// copies through tensor maps, warpgroup matrix multiplies (wgmma) and
// register reallocation (setmaxnreg), and the host side they need: tensor
// maps, the SM count, the dynamic shared-memory limit. The attention
// forward (flash_fwd.cu) and backward (flash_bwd.cu), the paged prefill
// (paged_decode.cu), the reduced scores (reduced_scores.cu) and the fp32
// forward and backward (flash_fp32.cu, on .tf32 wgmma) are built from them.
//
// Shared-memory tiles use the 128-byte swizzle that TMA writes and wgmma
// reads: a tile is a stack of 128-byte rows (64 bf16), the 16-byte chunk c
// of row r stored at chunk c ^ (r % 8), every tile starting on a 1024-byte
// boundary. Wider rows (d 128) are split into 64-column tiles. The e4m3
// forward's d 64 rows are 64 bytes, in the 64-byte swizzle (desc_b64).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no driver call is linked)
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace xfa {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// make the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// whether the phase of parity `parity` has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// ---- TMA

// copy the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory; completion adds the box's bytes to `bar`'s transaction count
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the same through a 2-D tensor map
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// the same through a 5-D tensor map
__device__ __forceinline__ void tma_load_5d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4)
      : "memory");
}

// copy the box of a 1-D tensor map at element c0 into shared memory; c0
// times the element size must be a multiple of 16 bytes (an unaligned start
// faults as an illegal instruction); past the end the box arrives as zeros
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

// store a shared-memory box to (c0, c1, c2, c3); the parts outside the
// tensor are not written
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until the committed stores have read their shared memory (the
// global writes complete on their own)
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy (wgmma, TMA) accesses
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a barrier over `threads` threads (a multiple of 32) with its own id
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---- register reallocation between warpgroups (every warp of a warpgroup
// executes the same one)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the SFU (exp taken as exp2 with log2(e) folded into its argument)
constexpr float kLog2e = 1.4426950408889634f;
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ---- wgmma

// Shared-memory matrix descriptor for a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout B128.
// K-major (rows of the M or N axis, K contiguous): SBO = 1024 between
// 8-row groups; LBO unused. MN-major (rows of the K axis, M or N
// contiguous): SBO = 1024 between 8-row groups of K, LBO = the distance
// between 64-column tiles of the M or N axis.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr, uint32_t lbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of a wgmma's accumulator or
// A registers across the fences and waits around it: call before
// wgmma_fence() on what the wgmma reads, after wgmma_wait() on what it wrote.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Fragments (PTX ISA, "wgmma .m64nNk16"): warp w of the warpgroup holds
// rows 16w .. 16w + 15; with g = lane / 4, t = lane % 4, accumulator
// register i sits at row 16w + g + 8 * ((i / 2) % 2), column
// 8 * (i / 4) + 2t + (i % 2). The A fragment in registers of k-step kk is
// the mma.sync m16n8k16 one (common.cuh), so the accumulators of columns
// 16kk .. 16kk + 15, rounded to bf16 pairs, are A's registers for k-step kk.
// D(64 x 128) = A B (+ D when scale_d): A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                                  int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64) = A B (+ D when scale_d): A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64) += A B: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 128) += A B: A (bf16 pairs) in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// C(64 x N) = A B^T over k = D (issued, not committed; flash_bwd.cu,
// reduced_scores.cu): A (64 rows) and B (N rows) K-major in
// 128-byte-swizzled shared memory, their 64-column halves a_half and b_half
// bytes apart.
template <int D, int N>
__device__ __forceinline__ void issue_ss(float (&c)[N / 2], uint32_t a, uint32_t a_half,
                                         uint32_t b, uint32_t b_half) {
  const uint64_t da = desc_b128(a, 16), db = desc_b128(b, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns = 32 bytes inside the swizzled row; past 64 columns, the
    // next half (offsets in the descriptor's 16-byte units)
    const uint32_t col = (kk & 3) * 2;
    const uint64_t ak = da + (kk >> 2) * (a_half >> 4) + col;
    const uint64_t bk = db + (kk >> 2) * (b_half >> 4) + col;
    if constexpr (N == 64) {
      wgmma_ss_n64(c, ak, bk, kk > 0);
    } else {
      wgmma_ss_n128(c, ak, bk, kk > 0);
    }
  }
}

// ---- attention tiles (flash_fwd.cu, paged_decode.cu): a consumer
// warpgroup's 64 query rows against a tile of kKeyTile keys. Q sits in
// 128-byte-swizzled boxes of 64 rows x 64 columns (kBox64 bytes apart), K and
// V in boxes of kKeyTile keys x 64 columns (kKeyTile * 128 bytes apart).
constexpr int kKeyTile = 128;
constexpr int kBox64 = 8192;

// S = Q K^T of one key tile into s (issued and committed, not waited for):
// wgmma m64n128k16, Q and K K-major from the swizzled tiles.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[kKeyTile / 2], uint32_t q_wg, uint32_t k_st) {
  const uint64_t dq = desc_b128(q_wg, 16), dk = desc_b128(k_st, 16);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    // 16 columns = 32 bytes inside the swizzled row; past 64 columns, the
    // next 64-column tile (offsets in the descriptor's 16-byte units)
    const uint32_t col = (kk & 3) * 2;
    wgmma_ss_n128(s, dq + (kk >> 2) * (kBox64 >> 4) + col,
                  dk + (kk >> 2) * (kKeyTile * 128 >> 4) + col, kk > 0);
  }
  wgmma_commit();
}

// O += P V of one key tile (issued and committed): P's bf16 pairs as the
// register A operand, V MN-major (16 keys = 16 rows of 128 bytes a k-step;
// LBO steps to V's second 64 columns).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kKeyTile / 4],
                                         uint32_t v_st) {
  const uint64_t dv = desc_b128(v_st, kKeyTile * 128);
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64(o, &pa[4 * kk], dv + kk * (16 * 128 >> 4));
    } else {
      wgmma_rs_n128(o, &pa[4 * kk], dv + kk * (16 * 128 >> 4));
    }
  }
  wgmma_commit();
}

// The online softmax step of one key tile, after the caller's scale, softcap
// and mask: s holds the scores of this thread's rows (register i: row
// ((i / 2) % 2) * 8 past the thread's first, as wgmma lays out m64n128).
// Updates the running max m_i, turns s into P in fp32 (exp2 with the max
// folded in), adds this thread's share of the row sums to l_i (the quad is
// summed at the end) and returns in alpha the factor that takes the running
// O to the new max.
__device__ __forceinline__ void softmax_step(float (&s)[kKeyTile / 2], float (&m_i)[2],
                                             float (&l_i)[2], float (&alpha)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m_i[r], mx[r]);
    // a row with nothing visible yet keeps a zero shift so exp() gives 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    alpha[r] = ex2((m_i[r] - m_use) * kLog2e);
    shift[r] = m_use * kLog2e;
    m_i[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kKeyTile / 2; ++i) {
    s[i] = ex2(fmaf(s[i], kLog2e, -shift[(i >> 1) & 1]));
    rs[(i >> 1) & 1] += s[i];
  }
  l_i[0] = l_i[0] * alpha[0] + rs[0];
  l_i[1] = l_i[1] * alpha[1] + rs[1];
}

// ---- the e4m3 forward's variants (flash_fwd.cu flash_fwd_kernel, FP8): QK^T
// on e4m3 wgmma (k32, both operands K-major, as FP8 wgmma requires), P.V on
// f16 wgmma with V converted to f16 in shared memory

// Shared-memory matrix descriptor for a 64-byte-swizzled K-major operand
// (rows of 64 bytes, the 16-byte chunk c of row r at c ^ ((r / 2) % 4),
// 8-row groups 512 bytes apart; LBO unused), layout B64. The e4m3 rows of
// d 64 are 64 bytes; those of d 128 are one 128-byte row (desc_b128).
__device__ __forceinline__ uint64_t desc_b64(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// D(64 x 128) = A B (+ D when scale_d): e4m3 A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n128_e4m3(float (&d)[64], uint64_t desc_a,
                                                   uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.f32.e4m3.e4m3 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D(64 x 64) += A B: A (f16 pairs) in registers, B (f16) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_f16(float (&d)[32], const uint32_t* a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 128) += A B: A (f16 pairs) in registers, B (f16) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128_f16(float (&d)[64], const uint32_t* a,
                                                  uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S = Q K^T of one key tile from e4m3 tiles (issued and committed): Q's 64
// rows and K's kKeyTile rows of D bytes, 128-byte swizzled at d 128 (one
// swizzle row a tile row), 64-byte swizzled at d 64; k32 = 32 bytes a step,
// as bf16's k16.
template <int D>
__device__ __forceinline__ void issue_qk_e4m3(float (&s)[kKeyTile / 2], uint32_t q_wg,
                                              uint32_t k_st) {
  const uint64_t dq = D == 128 ? desc_b128(q_wg, 16) : desc_b64(q_wg);
  const uint64_t dk = D == 128 ? desc_b128(k_st, 16) : desc_b64(k_st);
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) wgmma_ss_n128_e4m3(s, dq + 2 * kk, dk + 2 * kk, kk > 0);
  wgmma_commit();
}

// O += P V of one key tile (issued and committed), issue_pv in f16: P's f16
// pairs as the register A operand, V (f16, issue_pv's layout) MN-major.
template <int D>
__device__ __forceinline__ void issue_pv_f16(float (&o)[D / 2],
                                             const uint32_t (&pa)[kKeyTile / 4], uint32_t v_st) {
  const uint64_t dv = desc_b128(v_st, kKeyTile * 128);
#pragma unroll
  for (int kk = 0; kk < kKeyTile / 16; ++kk) {
    if constexpr (D == 64) {
      wgmma_rs_n64_f16(o, &pa[4 * kk], dv + kk * (16 * 128 >> 4));
    } else {
      wgmma_rs_n128_f16(o, &pa[4 * kk], dv + kk * (16 * 128 >> 4));
    }
  }
  wgmma_commit();
}

// ---- tf32 (flash_fp32.cu): fp32 products as three TF32
// products on wgmma m64nNk8 .tf32, which takes both shared-memory operands
// K-major only (the .tf32 form has no transpose bit). Its A fragment in
// registers (PTX ISA, "wgmma .m64nNk8", tf32): with g = lane / 4, t = lane
// % 4, a[i] holds row 16w + g + 8 (i % 2), column t + 4 (i / 2) of the
// k-step's 8 columns; the accumulator is laid out as for bf16 (above).

// The tensor cores read a .tf32 operand's 32 bits and ignore the low 13
// (the mantissa's last 13 bits: truncation, seen on the H100 by
// scripts/tf32_probe.cu), so a raw fp32 value serves as its own hi part,
// tf32(x) = x & 0xffffe000. tf32_lo(x) = x - tf32(x) is exact in fp32 and
// has at most 13 significant bits, of which the tensor cores keep 11: x =
// hi + lo to within 2^-21 |x|. An infinite x gives a NaN lo (no test: one
// made the fp32 backward 1.35x slower, scripts/ab_fp32_bwd.py rna_finite
// against rna). reference.py split_tf32 emulates this.
__device__ __forceinline__ float tf32_lo(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x);
  lo = __float_as_uint(tf32_lo(x));
}

// D(64 x 16) += A B: A's tf32 fragment in registers, B (tf32) K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n16_tf32(float (&d)[8], const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 32) += A B: A's tf32 fragment in registers, B (tf32) K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n32_tf32(float (&d)[16], const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 64) += A B: A's tf32 fragment in registers, B (tf32) K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n64_tf32(float (&d)[32], const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D(64 x 128) += A B: A's tf32 fragment in registers, B (tf32) K-major in
// shared memory
__device__ __forceinline__ void wgmma_rs_n128_tf32(float (&d)[64], const uint32_t* a,
                                               uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---- host side

// cuTensorMapEncodeTiled, a driver-API call, found through the runtime so
// that the library links against nothing but the CUDA runtime
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A (b, h, s, d) bf16 view with element strides (sb, sh, ss) and a
// contiguous head dim as a 4-D map (d, s, h, b) with boxes of 64 columns x
// `rows` rows, 128-byte swizzled. A box past s (or d) is filled with zeros
// on loads and clipped on stores, inside its own batch row and head.
inline bool encode_bhsd(CUtensorMap* map, const void* ptr, int b, int h, int s, int d, int64_t sb,
                        int64_t sh, int64_t ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  // an axis of extent 1 is never stepped: any aligned stride will do
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {s > 1 ? static_cast<cuuint64_t>(ss) * 2 : 16,
                                 h > 1 ? static_cast<cuuint64_t>(sh) * 2 : 16,
                                 b > 1 ? static_cast<cuuint64_t>(sb) * 2 : 16};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (b, h, s, d) fp32 view with element strides (sb, sh, ss) and a
// contiguous head dim as a 4-D map (d, s, h, b) with boxes of 32 columns
// (128 bytes) x `rows` rows, 128-byte swizzled: a row of d 64 is two boxes,
// of d 128 four. A box past s is filled with zeros on loads, inside its own
// batch row and head.
inline bool encode_bhsd_f32(CUtensorMap* map, const void* ptr, int b, int h, int s, int d,
                            int64_t sb, int64_t sh, int64_t ss, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {s > 1 ? static_cast<cuuint64_t>(ss) * 4 : 16,
                                 h > 1 ? static_cast<cuuint64_t>(sh) * 4 : 16,
                                 b > 1 ? static_cast<cuuint64_t>(sb) * 4 : 16};
  const cuuint32_t box[4] = {32, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (b, h, s, d) one-byte (e4m3) view with element strides (sb, sh, ss)
// and a contiguous head dim as a 4-D map (d, s, h, b) with boxes of d
// columns x `rows` rows: `swizzle` CU_TENSOR_MAP_SWIZZLE_128B (d 128) or
// _64B (d 64) for wgmma's K-major operands, _NONE for rows read by threads.
// Strides and the pointer must be multiples of 16 bytes.
inline bool encode_bhsd_e4m3(CUtensorMap* map, const void* ptr, int b, int h, int s, int d,
                             int64_t sb, int64_t sh, int64_t ss, int rows,
                             CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[3] = {s > 1 ? static_cast<cuuint64_t>(ss) : 16,
                                 h > 1 ? static_cast<cuuint64_t>(sh) : 16,
                                 b > 1 ? static_cast<cuuint64_t>(sb) : 16};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(d), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16 KV pages (num_pages, hk, 2, ps, d), contiguous, as a 5-D map (d, ps,
// 2, hk, num_pages) with boxes of 64 columns x `rows` rows of one page, K or
// V and head, 128-byte swizzled (rows <= ps); with `f32`, fp32 pages and
// boxes of 32 columns (128 bytes, as encode_bhsd_f32).
inline bool encode_pages(CUtensorMap* map, const void* ptr, int num_pages, int hk, int ps, int d,
                         int rows, bool f32 = false) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(d) * (f32 ? 4 : 2);
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(ps), 2,
                              static_cast<cuuint64_t>(hk), static_cast<cuuint64_t>(num_pages)};
  const cuuint64_t strides[4] = {row, row * ps, 2 * row * ps, 2 * row * ps * hk};
  const cuuint32_t box[5] = {f32 ? 32u : 64u, static_cast<cuuint32_t>(rows), 1, 1, 1};
  const cuuint32_t step[5] = {1, 1, 1, 1, 1};
  return fn(map, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
            const_cast<void*>(ptr), dims, strides, box,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `n` contiguous fp32 values as a 1-D map with boxes of `box` values (a
// multiple of 4), not swizzled; a box past n is filled with zeros.
inline bool encode_flat_f32(CUtensorMap* map, const void* ptr, int64_t n, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {16};  // rank 1: no stride is read
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t step[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides, boxes,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// `rows` contiguous rows of 4 int32 (16 bytes) as a 2-D map with boxes of
// `box` rows (at most 256), not swizzled; rows past the end arrive as zeros.
inline bool encode_rows_i32x4(CUtensorMap* map, const void* ptr, int64_t rows, int box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {4, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {16};
  const cuuint32_t boxes[2] = {4, static_cast<cuuint32_t>(box)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 2, const_cast<void*>(ptr), dims, strides, boxes,
            step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The device's SM count, read once per device.
inline cudaError_t sm_count(int& count) {
  static std::atomic<int> counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  count = counts[dev & 63].load(std::memory_order_relaxed);
  if (count > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) counts[dev & 63].store(count, std::memory_order_relaxed);
  return err;
}

// Raise a kernel's dynamic shared-memory limit to `bytes`, once per device
// (per-launch host calls would set the time of short calls); `done` is the
// kernel's own set of devices already raised.
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, int bytes, std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = 1ull << (dev & 63);
  if (done.load(std::memory_order_relaxed) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

}  // namespace sm90
}  // namespace xfa
