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
// out[i] = counter_rng_uniform(i, seed, hop, slot 0) % n, i in [0, count).
// Bound: bytes (4 written per id, ~20 integer ops each); at 512 ids it is
// launch-bound. One thread per id, the same hash as K1.
#include "gigl_common.cuh"

namespace {

__global__ void uniform_ids_kernel(int64_t count, uint32_t seed, uint32_t hop,
                                   uint32_t n, int32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const uint32_t bits =
      gigl::counter_bits(static_cast<uint32_t>(i), seed, hop, 0u);
  out[i] = static_cast<int32_t>(bits % n);
}

template <bool kOffset>
__global__ void sample_uniform_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, const int32_t* __restrict__ frontier, int64_t m,
    int fanout, uint32_t seed, uint32_t hop, int32_t row_offset,
    int64_t n_rows, int32_t* __restrict__ ids, uint8_t* __restrict__ mask,
    int32_t* __restrict__ slots) {
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
    const int threads = 256;
    const long long blocks = (count + threads - 1) / threads;
    uniform_ids_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        count, seed, hop, n, static_cast<int32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
