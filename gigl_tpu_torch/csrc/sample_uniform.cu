// K1 sample_uniform — replaces gigl_tpu/sampling/neighbor_sampler.py
// counter_rng_uniform + uniform_offsets (:51-93) and sample_neighbors
// (:176-218, method="uniform").
//
// Bound: bytes. Per (node, slot) it reads two indptr words (shared by the
// node's slots, served from L1/L2) and one random 4-byte CSR index, and
// writes 9 bytes; the hash is ~20 integer ops. Design: one thread per
// (node, slot), consecutive threads on consecutive output slots so the
// three outputs are written coalesced; the hash runs in native uint32 and
// the random index read is the only scattered access.
//
// Row-offset mode (a template flag; the plain mode's launches are
// unchanged) — the owner-side draw of gigl_tpu/parallel/feature_lookup.py
// routed_sample_neighbors (:241-249): the frontier holds GLOBAL ids, the
// CSR is one shard's row block, and node v reads local row
// clip(v - row_offset, 0, n_rows - 1) while the hash stays keyed by v, so
// the draw is the replicated sampler's.
//
// K1b uniform_ids — replaces the batch-shared random-negative draw of
// gigl_tpu/training/dataset.py sample_nalp_batch (:291-298):
// out[i] = counter_rng_uniform(i, seed, hop, slot 0) % n, i in [0, count),
// as int32 (n above 2**31 wraps to negative ids, as the reference's
// astype(int32) does).
// Bound: bytes (4 written per id, ~24 integer ops each); at the step's 512
// ids it is all fixed cost: a launch, a block's start, one store. Design:
// it reads no memory, so none of its work depends on the kernel ahead of
// it on the stream, which in the NALP step is K1's draw of the positives.
// It is a programmatic dependent launch (gigl_common.cuh launch_dependent):
// its blocks may start while that kernel runs, and each thread hashes its
// kIdsPerThread ids, the modulo included, into registers before
// griddepcontrol.wait. Only the stores come after the wait: the caching
// allocator may hand K1b memory the kernel ahead still reads or writes.
// Every thread reaches the wait, those past count too, so the grid never
// ends ahead of the kernel before it. Blocks of kIdsThreads, one 16-byte
// store a thread (4 ids); an output off 16 bytes and the ragged tail take
// one store a value in the same kernel. K1 calls
// griddepcontrol.launch_dependents first thing, so K1b's launch and block
// start can overlap the whole of K1, not only its tail.
#include "gigl_common.cuh"

namespace {

constexpr int kIdsThreads = 128;   // K1b: a block's threads
constexpr int kIdsPerThread = 4;   // K1b: ids a thread

__global__ void __launch_bounds__(kIdsThreads)
uniform_ids_kernel(int64_t count, uint32_t seed, uint32_t hop, uint32_t n,
                   int32_t* __restrict__ out) {
  const int64_t i0 =
      (static_cast<int64_t>(blockIdx.x) * kIdsThreads + threadIdx.x) *
      kIdsPerThread;
  int32_t v[kIdsPerThread];
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k)
    v[k] = static_cast<int32_t>(
        gigl::counter_bits(static_cast<uint32_t>(i0 + k), seed, hop, 0u) % n);
  // out may still be read or written by the kernel ahead
  gigl::wait_for_prior_grid();
  if constexpr (kIdsPerThread % 4 == 0) {
    if (i0 + kIdsPerThread <= count &&
        reinterpret_cast<uintptr_t>(out) % 16 == 0) {
#pragma unroll
      for (int k = 0; k < kIdsPerThread; k += 4)
        *reinterpret_cast<int4*>(out + i0 + k) =
            make_int4(v[k], v[k + 1], v[k + 2], v[k + 3]);
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kIdsPerThread; ++k) {
    if (i0 + k < count) out[i0 + k] = v[k];
  }
}

template <bool kOffset>
__global__ void sample_uniform_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, const int32_t* __restrict__ frontier, int64_t m,
    int fanout, uint32_t seed, uint32_t hop, int32_t row_offset,
    int64_t n_rows, int32_t* __restrict__ ids, uint8_t* __restrict__ mask,
    int32_t* __restrict__ slots) {
  // a dependent launch behind this one (K1b) may start its blocks now
  gigl::allow_dependents_to_start();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * fanout) return;
  const int64_t row = i / fanout;
  const int32_t s = static_cast<int32_t>(i - row * fanout);
  const int32_t v = frontier[row];
  int64_t r = v;
  if constexpr (kOffset) {
    r = static_cast<int64_t>(v) - row_offset;
    r = r < 0 ? 0 : (r > n_rows - 1 ? n_rows - 1 : r);
  }
  const int32_t start = __ldg(indptr + r);
  const int32_t deg = __ldg(indptr + r + 1) - start;
  const gigl::UniformDraw d =
      gigl::draw_uniform(start, deg, v, seed, hop, s, fanout, n_edges);
  ids[i] = d.valid ? __ldg(indices + d.edge_slot) : 0;
  mask[i] = d.valid ? 1 : 0;
  slots[i] = d.edge_slot;
}

}  // namespace

extern "C" int gigl_sample_uniform(const void* indptr, const void* indices,
                                   long long n_edges, const void* frontier,
                                   long long m, int fanout, uint32_t seed,
                                   uint32_t hop, int has_offset,
                                   int row_offset, long long n_rows,
                                   void* ids, void* mask, void* slots,
                                   void* stream) {
  const long long total = m * fanout;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    auto kernel = has_offset ? sample_uniform_kernel<true>
                             : sample_uniform_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), threads, 0,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices), n_edges,
        static_cast<const int32_t*>(frontier), m, fanout, seed, hop,
        row_offset, n_rows, static_cast<int32_t*>(ids),
        static_cast<uint8_t*>(mask), static_cast<int32_t*>(slots));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gigl_uniform_ids(long long count, uint32_t seed, uint32_t hop,
                                uint32_t n, void* out, void* stream) {
  if (n == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (count > 0) {
    constexpr long long kIdsPerBlock = kIdsThreads * kIdsPerThread;
    const cudaError_t rc = gigl::launch_dependent(
        uniform_ids_kernel,
        dim3(static_cast<unsigned>((count + kIdsPerBlock - 1) / kIdsPerBlock)),
        dim3(kIdsThreads), static_cast<cudaStream_t>(stream), count, seed,
        hop, n, static_cast<int32_t*>(out));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
