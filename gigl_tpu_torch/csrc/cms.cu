// K13 cms_add and K14 cms_estimate — replace gigl_tpu/losses/
// count_min_sketch.py _cms_hash (:38-47), cms_add (:50-58), cms_estimate
// (:61-66) and cms_sampling_probability (:69-77): the count-min sketch that
// estimates each retrieval candidate's sampling probability for the logQ
// correction.
//
// Hash of id into row r (all uint32 arithmetic, wrapping):
//   h_r(id) = mix32(uint32(id) + r * 0x9E3779B9) % width
// with mix32 the sampler's finalizer (gigl_common.cuh; the reference's
// _cms_hash applies the same steps).
//   K13: new_table[r, h_r(id)] = table[r, h_r(id)] + (count of id), for every
//        id and row, masked candidate columns included (the reference counts
//        them all); new_total = total + n (int32, wrapping). The input sketch
//        is never written: cms_add is functional, as the reference's is.
//   K14: est[i] = min_r table[r, h_r(ids[i])] (int32) and, when asked,
//        prob[i] = float(est[i]) / max(float(total), 1) (IEEE division).
//
// Bound: latency. At the flagship (n = 1024 candidate ids, depth 5, width
// 2048: a 40 KB table) each kernel moves ~50 KB, ~0.015 us of HBM time, and
// does ~10^5 integer operations: both are a launch's latency. Design: K13
// stages the whole table in shared memory when it fits (48 KB, the default
// sketch is 40 KB): one block copies it in, adds one count per (row, id) with
// shared-memory atomics (integer adds commute, so every order gives the same
// table) and writes the new table out; a larger table takes a copy kernel
// and a pass of global atomics. total is read and written on the device, so
// a training step needs no host synchronisation and can be captured in a
// CUDA graph. K14: one thread per id, walking the rows.
#include <climits>
#include <cstdint>

#include "gigl_common.cuh"

namespace {

constexpr int kAddThreads = 1024;
constexpr int kThreads = 256;
constexpr long long kSharedBytes = 48 * 1024;

__device__ __forceinline__ int64_t bucket(int32_t id, uint32_t row,
                                          uint32_t width) {
  const uint32_t x = static_cast<uint32_t>(id) + row * 0x9E3779B9u;
  return static_cast<int64_t>(gigl::mix32(x) % width);
}

__device__ __forceinline__ int32_t add_total(const int32_t* total, long long n) {
  return static_cast<int32_t>(static_cast<uint32_t>(*total) +
                              static_cast<uint32_t>(n));
}

__global__ void cms_add_shared(const int32_t* __restrict__ table, int depth,
                               int width, const int32_t* __restrict__ ids,
                               long long n, const int32_t* __restrict__ total,
                               int32_t* __restrict__ out,
                               int32_t* __restrict__ out_total) {
  extern __shared__ int32_t sketch[];
  const long long cells = static_cast<long long>(depth) * width;
  for (long long i = threadIdx.x; i < cells; i += blockDim.x)
    sketch[i] = table[i];
  __syncthreads();
  for (long long i = threadIdx.x; i < n * depth; i += blockDim.x) {
    const long long k = i / depth;
    const int r = static_cast<int>(i - k * depth);
    atomicAdd(sketch + static_cast<long long>(r) * width +
                  bucket(ids[k], r, width),
              1);
  }
  __syncthreads();
  for (long long i = threadIdx.x; i < cells; i += blockDim.x)
    out[i] = sketch[i];
  if (threadIdx.x == 0) *out_total = add_total(total, n);
}

__global__ void cms_copy(const int32_t* __restrict__ table, long long cells,
                         int32_t* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < cells) out[i] = table[i];
}

__global__ void cms_add_global(int depth, int width,
                               const int32_t* __restrict__ ids, long long n,
                               const int32_t* __restrict__ total,
                               int32_t* __restrict__ out,
                               int32_t* __restrict__ out_total) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i == 0) *out_total = add_total(total, n);
  if (i >= n * depth) return;
  const long long k = i / depth;
  const int r = static_cast<int>(i - k * depth);
  atomicAdd(out + static_cast<long long>(r) * width + bucket(ids[k], r, width),
            1);
}

__global__ void cms_estimate_kernel(const int32_t* __restrict__ table,
                                    int depth, int width,
                                    const int32_t* __restrict__ ids,
                                    long long n,
                                    const int32_t* __restrict__ total,
                                    int32_t* __restrict__ est,
                                    float* __restrict__ prob) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t id = ids[i];
  int32_t m = INT_MAX;
  for (int r = 0; r < depth; ++r)
    m = min(m, __ldg(table + static_cast<long long>(r) * width +
                     bucket(id, r, width)));
  if (est != nullptr) est[i] = m;
  if (prob != nullptr)
    prob[i] = __fdiv_rn(static_cast<float>(m),
                        fmaxf(static_cast<float>(*total), 1.f));
}

unsigned blocks_for(long long work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

}  // namespace

// table: [depth, width] int32, total: int32 scalar (device); ids: [n]
// int32. Writes out: [depth, width] int32 (a buffer other than table) and
// out_total: int32 scalar.
extern "C" int gigl_cms_add(const void* table, int depth, int width,
                            const void* ids, long long n, const void* total,
                            void* out, void* out_total, void* stream) {
  if (depth <= 0 || width <= 0 || n < 0 || table == out)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(depth) * width;
  const auto* t = static_cast<const int32_t*>(table);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* tot = static_cast<const int32_t*>(total);
  auto* o = static_cast<int32_t*>(out);
  auto* ot = static_cast<int32_t*>(out_total);
  if (cells * 4 <= kSharedBytes) {
    cms_add_shared<<<1, kAddThreads, static_cast<size_t>(cells * 4), s>>>(
        t, depth, width, id, n, tot, o, ot);
  } else {
    cms_copy<<<blocks_for(cells, kThreads), kThreads, 0, s>>>(t, cells, o);
    const long long work = n * depth > 0 ? n * depth : 1;
    cms_add_global<<<blocks_for(work, kThreads), kThreads, 0, s>>>(
        depth, width, id, n, tot, o, ot);
  }
  return static_cast<int>(cudaGetLastError());
}

// est: [n] int32 or NULL; prob: [n] fp32 or NULL (needs total).
extern "C" int gigl_cms_estimate(const void* table, int depth, int width,
                                 const void* ids, long long n,
                                 const void* total, void* est, void* prob,
                                 void* stream) {
  if (depth <= 0 || width <= 0 || n < 0 || (prob != nullptr && !total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    cms_estimate_kernel<<<blocks_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(table), depth, width,
        static_cast<const int32_t*>(ids), n,
        static_cast<const int32_t*>(total), static_cast<int32_t*>(est),
        static_cast<float*>(prob));
  }
  return static_cast<int>(cudaGetLastError());
}
