// Few-query decode attention against a dense (b, hk, S, d) KV cache, whole
// or split, each (batch, kv head[, split]) spread over a thread-block cluster.
//
// Replaces two TPU kernels:
//   * xhy_flash_attention_tpu/ops/flash_attention/decode_kernel.py:47
//     `_decode_kernel` (entry xfa_flash_decode without partials): the
//     normalised output;
//   * xhy_flash_attention_tpu/inference/combine.py:75 `_splitkv_kernel`
//     (with partials): per split of split_len keys, the normalised partial
//     output out_i and its running max m_i and sum l_i, which
//     merge_attention_partials (plain PyTorch) combines.
// What it computes, as the TPU kernels do:
//   * PackGQA: the g = h / hk query heads of one KV head and the sq new
//     tokens fold into sq * g rows (row r = si * g + gi);
//   * the sequence occupies cache columns [lp, lp + length) (lp = leftpad_k,
//     0 without it); row r sees cache position j when lp <= j <= pos with
//     pos = lp + length - sq + r / g and, with a window, j >= pos - window_left;
//   * kv_batch_idx remaps query batch row b to cache batch row kv_batch_idx[b];
//   * the cache is bf16 or fp32 (the query's dtype), or an int8 / e4m3
//     payload with per-token fp32 scales: s = (q . k) * k_scale[j] * sm_scale
//     and P.V takes p * v_scale[j]. int8 and e4m3 convert exactly here, so the
//     TPU kernels' rebias folded into the scales (common.py:44) is not needed;
//   * s in fp32, optional softcap tanh(s / c) * c, online softmax in fp32,
//     output divided by the row sum (0 when a row sees nothing).
// P stays in fp32 for P.V here (the TPU kernels round it to the query dtype
// for the matrix unit); the plain versions keep fp32 too.
//
// Bound on the H100: bytes. A step reads 2 * length * d cache elements per
// (b, kv head) and does ~4 * sq * g operations per element (16 at g = 4),
// far below the ~295 operations per byte where the tensor cores would
// become the limit. So the design keeps bytes in flight on every SM and
// keeps the work per tile short enough to hide under them:
//   * the grid is (cluster, hk, b * splits): the c CTAs of a cluster (c in
//     1, 2, 4, 8; decode_kernel.py decode_launch_plan picks it so that the
//     grid holds about one CTA per SM) each take a contiguous, tile-aligned
//     run of the row's visible keys, found on the device from lengths,
//     leftpad and window_left. A CTA whose run is empty loads nothing;
//   * each CTA streams its K and V tiles of 64 keys through a ring of 2-6
//     stages in dynamic shared memory (three for bf16 d128: two tiles in
//     flight while one is computed), filled by 16-byte cp.async copies that
//     zero-fill keys outside the visible range; 1-byte payloads travel as
//     bytes and their scales come with their tile; key rows are padded by 16
//     bytes so that reads of neighbouring keys hit different banks. At most
//     ~111 KB and 128 registers a CTA, so two CTAs fit on an SM and 30
//     clusters of 8 on the card;
//   * warp w owns keys 8w .. 8w + 7 of every tile, with its own online
//     softmax and accumulator rows, so a tile costs one barrier (for the
//     ring). Scores of a bf16 query run on the tensor cores (mma.sync
//     m16n8k16, rows padded to 16, K exact in bf16: bf16, int8 and e4m3
//     values are, and the products sum in fp32); an fp32 query's on CUDA
//     cores in fp32. The softmax works on the mma fragments (quad shuffles);
//     P.V on CUDA cores in fp32, each lane D / 32 columns of every row, each
//     V element read and converted once. int8 and e4m3 convert by integer
//     tricks, not the conversion unit (16 results per SM and clock);
//   * the warps merge in warp order in shared memory, then the cluster in
//     distributed shared memory: each CTA leaves (m, l) and its fp32
//     accumulator rows in its own shared memory, and after cluster.sync()
//     every CTA merges its share of the output columns over all CTAs in rank
//     order, with the formula of merge_attention_partials. No workspace, no
//     atomics, no second launch; the order is fixed, so two calls give the
//     same bits.
// Caches are read in place through element strides for their batch, head
// and sequence axes, so flash_attn_with_kvcache's (b, S, hk, d) caches cost
// no copy; the pointer and those strides are multiples of 16 bytes.
// The kernel body is decode_body of decode_core.cuh, which paged_decode.cu's
// decode regime shares (keys through a page table, P rounded to bf16).
#include "decode_core.cuh"

namespace {

template <typename T, typename C, int D, bool kPartial, int kRows>
__global__ void __launch_bounds__(kThreads, 2) flash_decode_kernel(const DecodeParams p) {
  decode_body<T, C, D, kPartial, kRows, false>(p);
}

template <typename T, typename C, int D, typename F>
cudaError_t dispatch_p(bool partial, int rows, F& f) {
  using R4 = std::integral_constant<int, 4>;
  using R16 = std::integral_constant<int, kMaxRows>;
  const auto dd = std::integral_constant<int, D>{};
  if (partial)
    return rows <= 4 ? f(Tag<T>{}, Tag<C>{}, dd, std::true_type{}, R4{})
                     : f(Tag<T>{}, Tag<C>{}, dd, std::true_type{}, R16{});
  return rows <= 4 ? f(Tag<T>{}, Tag<C>{}, dd, std::false_type{}, R4{})
                   : f(Tag<T>{}, Tag<C>{}, dd, std::false_type{}, R16{});
}

template <typename T, typename C, typename F>
cudaError_t dispatch_d(int d, bool partial, int rows, F& f) {
  if (d == 64) return dispatch_p<T, C, 64>(partial, rows, f);
  if (d == 128) return dispatch_p<T, C, 128>(partial, rows, f);
  return cudaErrorInvalidValue;
}

template <typename T, typename F>
cudaError_t dispatch_c(int cache_dtype, int d, bool partial, int rows, F& f) {
  switch (cache_dtype) {
    case xfa::kI8:
      return dispatch_d<T, int8_t>(d, partial, rows, f);
    case xfa::kE4M3:
      return dispatch_d<T, __nv_fp8_e4m3>(d, partial, rows, f);
    default:
      return dispatch_d<T, T>(d, partial, rows, f);
  }
}

template <typename F>
cudaError_t dispatch(int dtype, int cache_dtype, int d, bool partial, int rows, F& f) {
  return dtype == xfa::kBF16 ? dispatch_c<__nv_bfloat16>(cache_dtype, d, partial, rows, f)
                             : dispatch_c<float>(cache_dtype, d, partial, rows, f);
}

}  // namespace

// q: (b, sq, h, d) contiguous on a 16-byte boundary, dtype 0 fp32 / 1 bf16.
// k, v: caches of dtype cache_dtype (the query's, or 2 int8 / 3 e4m3 with
// k_scale, v_scale: (cache b, hk, S) fp32 contiguous), element strides for
// batch, head and sequence
// (pointer and strides multiples of 16 bytes). lengths: (b,) int32 counting
// the sq new tokens; kv_batch_idx and leftpad: (b,) int32 or null. Without
// part_out it writes out (b, sq, h, d) (and num_splits must be 1); with it
// the partials part_out (b, hk, splits, sq * g, d) fp32 and part_m, part_l
// (b, hk, splits, sq * g) over splits of split_len keys. Each (batch, kv
// head, split) runs on a cluster of `cluster` CTAs (1, 2, 4 or 8).
XFA_EXPORT int xfa_flash_decode(const void* q, const void* k, const void* v, const void* k_scale,
                                const void* v_scale, const void* lengths,
                                const void* kv_batch_idx, const void* leftpad, void* out,
                                void* part_out, void* part_m, void* part_l, int64_t k_sb,
                                int64_t k_sh, int k_ss, int64_t v_sb, int64_t v_sh, int v_ss,
                                int b, int sq, int h, int hk, int S, int d,
                                int dtype, int cache_dtype, int num_splits, int split_len,
                                int cluster, float sm_scale, float softcap, int window_left,
                                void* stream) {
  if (sq * (h / hk) > kMaxRows || num_splits < 1 || (part_out == nullptr && num_splits != 1) ||
      !valid_cluster(cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((cache_dtype == xfa::kI8 || cache_dtype == xfa::kE4M3) != (k_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (b <= 0) return static_cast<int>(cudaGetLastError());
  DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.kv_batch_idx = static_cast<const int*>(kv_batch_idx);
  p.leftpad = static_cast<const int*>(leftpad);
  p.out = out;
  p.part_out = static_cast<float*>(part_out);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.sq = sq; p.h = h; p.hk = hk; p.S = S;
  p.sc_sh = S;
  p.table = nullptr;
  p.ps = p.npp = p.num_pages = 0;
  p.splits = num_splits;
  p.split_len = split_len;
  p.sm_scale = sm_scale;
  p.softcap = softcap;
  p.window_left = window_left;
  const dim3 grid(cluster, hk, b * num_splits);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto t, auto c, auto dd, auto partial, auto rows_cap) -> cudaError_t {
    using T = typename decltype(t)::type;
    using C = typename decltype(c)::type;
    constexpr int D = decltype(dd)::value;
    auto kernel = flash_decode_kernel<T, C, D, decltype(partial)::value, decltype(rows_cap)::value>;
    static std::atomic<uint64_t> done{0};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err =
        cluster_config(kernel, Smem<T, C, D>::kBytes, grid, cluster, s, cfg, attr, done);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(&cfg, kernel, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  };
  return static_cast<int>(
      dispatch(dtype, cache_dtype, d, part_out != nullptr, sq * (h / hk), launch));
}

// How many clusters of `cluster` CTAs of the kernel instance for these codes
// and rows the card holds at once (cudaOccupancyMaxActiveClusters), into
// *count.
XFA_EXPORT int xfa_flash_decode_max_clusters(int dtype, int cache_dtype, int d, int partial,
                                             int rows, int cluster, int* count) {
  if (!valid_cluster(cluster)) return static_cast<int>(cudaErrorInvalidValue);
  auto query = [&](auto t, auto c, auto dd, auto part, auto rows_cap) -> cudaError_t {
    using T = typename decltype(t)::type;
    using C = typename decltype(c)::type;
    constexpr int D = decltype(dd)::value;
    auto kernel = flash_decode_kernel<T, C, D, decltype(part)::value, decltype(rows_cap)::value>;
    static std::atomic<uint64_t> done{0};
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    const cudaError_t err = cluster_config(kernel, Smem<T, C, D>::kBytes, dim3(cluster), cluster,
                                           nullptr, cfg, attr, done);
    if (err != cudaSuccess) return err;
    return cudaOccupancyMaxActiveClusters(count, kernel, &cfg);
  };
  return static_cast<int>(dispatch(dtype, cache_dtype, d, partial != 0, rows, query));
}
