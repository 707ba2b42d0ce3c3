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
#include "gigl_common.cuh"

namespace {

__global__ void sample_uniform_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, const int32_t* __restrict__ frontier, int64_t m,
    int fanout, uint32_t seed, uint32_t hop, int32_t* __restrict__ ids,
    uint8_t* __restrict__ mask, int32_t* __restrict__ slots) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * fanout) return;
  const int64_t row = i / fanout;
  const int32_t s = static_cast<int32_t>(i - row * fanout);
  const int32_t v = frontier[row];
  const int32_t start = __ldg(indptr + v);
  const int32_t deg = __ldg(indptr + v + 1) - start;
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
                                   uint32_t hop, void* ids, void* mask,
                                   void* slots, void* stream) {
  const long long total = m * fanout;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    sample_uniform_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(indptr),
        static_cast<const int32_t*>(indices), n_edges,
        static_cast<const int32_t*>(frontier), m, fanout, seed, hop,
        static_cast<int32_t*>(ids), static_cast<uint8_t*>(mask),
        static_cast<int32_t*>(slots));
  }
  return static_cast<int>(cudaGetLastError());
}
