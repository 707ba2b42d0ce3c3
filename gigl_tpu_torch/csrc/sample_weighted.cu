// K19 sample_weighted — replaces gigl_tpu/sampling/neighbor_sampler.py
// weighted_offsets (:96-134) and sample_neighbors (:176-218,
// method="weighted" / "top_k"); with the row-offset flag, the owner-side
// weighted draw of gigl_tpu/parallel/feature_lookup.py
// routed_sample_neighbors (:204-214).
//
// For each frontier node the first `window` CSR slots are scored (see
// gigl_common.cuh weighted_score: log-weight, plus a Gumbel term keyed by
// (node, seed, hop, window slot) for "weighted"; invalid slots -FLT_MAX)
// and the `fanout` best are taken in descending order, ties to the lower
// slot, as lax.top_k takes them. Offsets are clamped to deg - 1, the mask
// is s < min(deg, fanout), and a masked id is 0.
//
// Bound: bytes. Per node it reads two indptr words, min(deg, window)
// weights and `fanout` random CSR indices, and writes 9 bytes a slot; the
// hash and two logf per valid slot are ~60 operations. Design: one warp
// per node; lane l holds window slots l, l + 32, ... (C = window / 32 keys
// in registers, the weights read coalesced); each of the `fanout` rounds is
// a warp arg-max over packed 64-bit keys (order-preserving float bits high,
// window - 1 - j low) by __shfl_xor_sync, and the winner's owner clears
// it. After every 32 rounds each lane writes one output slot, so the
// three outputs are written coalesced. The rows need not be sorted.
//
// Row-offset mode (a template flag, as K1's): the frontier holds GLOBAL
// ids, the CSR and weights are one shard's row block, node v reads local
// row clip(v - row_offset, 0, n_rows - 1) and its draw stays keyed by v.
#include "gigl_common.cuh"

namespace {

template <int C, bool kOffset>
__global__ void sample_weighted_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, const float* __restrict__ weights, int64_t n_weights,
    const int32_t* __restrict__ frontier, int64_t m, int fanout, int window,
    bool gumbel, uint32_t seed, uint32_t hop, int32_t row_offset,
    int64_t n_rows, int32_t* __restrict__ ids, uint8_t* __restrict__ mask,
    int32_t* __restrict__ slots) {
  const int lane = threadIdx.x & 31;
  // One warp per node; blockDim is a multiple of 32, so row is warp-uniform.
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (row >= m) return;
  const int32_t v = frontier[row];
  int64_t r = v;
  if constexpr (kOffset) {
    r = static_cast<int64_t>(v) - row_offset;
    r = r < 0 ? 0 : (r > n_rows - 1 ? n_rows - 1 : r);
  }
  const int32_t start = __ldg(indptr + r);
  const int32_t deg = __ldg(indptr + r + 1) - start;
  gigl::WarpWindow<C> win;
  win.load(weights, n_weights, start, deg, static_cast<uint32_t>(v), seed,
           hop, window, gumbel);
  for (int s0 = 0; s0 < fanout; s0 += 32) {
    const int j = win.pick(s0, fanout);
    const int s = s0 + lane;
    if (s < fanout) {
      const gigl::UniformDraw d =
          gigl::weighted_draw(start, deg, j, s, fanout, n_edges);
      const int64_t o = row * fanout + s;
      ids[o] = d.valid ? __ldg(indices + d.edge_slot) : 0;
      mask[o] = d.valid ? 1 : 0;
      slots[o] = d.edge_slot;
    }
  }
}

template <int C>
void launch_weighted(bool has_offset, unsigned blocks, int threads,
                     cudaStream_t stream, const int32_t* indptr,
                     const int32_t* indices, long long n_edges,
                     const float* weights, long long n_weights,
                     const int32_t* frontier, long long m, int fanout,
                     int window, bool gumbel, uint32_t seed, uint32_t hop,
                     int row_offset, long long n_rows, int32_t* ids,
                     uint8_t* mask, int32_t* slots) {
  auto kernel = has_offset ? sample_weighted_kernel<C, true>
                           : sample_weighted_kernel<C, false>;
  kernel<<<blocks, threads, 0, stream>>>(
      indptr, indices, n_edges, weights, n_weights, frontier, m, fanout,
      window, gumbel, seed, hop, row_offset, n_rows, ids, mask, slots);
}

}  // namespace

// method: 1 = weighted (Gumbel top-k), 2 = top_k. 1 <= fanout <= window
// <= 1024 (the wrapper checks).
extern "C" int gigl_sample_weighted(
    const void* indptr, const void* indices, long long n_edges,
    const void* weights, long long n_weights, const void* frontier,
    long long m, int fanout, int window, int method, uint32_t seed,
    uint32_t hop, int has_offset, int row_offset, long long n_rows,
    void* ids, void* mask, void* slots, void* stream) {
  if (fanout < 1 || fanout > window || window > 1024 ||
      (method != 1 && method != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m > 0) {
    const int threads = 256;  // 8 nodes per block
    const unsigned blocks =
        static_cast<unsigned>((m * 32 + threads - 1) / threads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool offset = has_offset != 0;
    const bool gumbel = method == 1;
    const auto* ip = static_cast<const int32_t*>(indptr);
    const auto* ix = static_cast<const int32_t*>(indices);
    const auto* w = static_cast<const float*>(weights);
    const auto* f = static_cast<const int32_t*>(frontier);
    auto* o_ids = static_cast<int32_t*>(ids);
    auto* o_mask = static_cast<uint8_t*>(mask);
    auto* o_slots = static_cast<int32_t*>(slots);
#define GIGL_WEIGHTED(CC)                                                   \
  launch_weighted<CC>(offset, blocks, threads, s, ip, ix, n_edges, w,       \
                      n_weights, f, m, fanout, window, gumbel, seed, hop,   \
                      row_offset, n_rows, o_ids, o_mask, o_slots)
    if (window <= 32) {
      GIGL_WEIGHTED(1);
    } else if (window <= 64) {
      GIGL_WEIGHTED(2);
    } else if (window <= 128) {
      GIGL_WEIGHTED(4);
    } else if (window <= 256) {
      GIGL_WEIGHTED(8);
    } else if (window <= 512) {
      GIGL_WEIGHTED(16);
    } else {
      GIGL_WEIGHTED(32);
    }
#undef GIGL_WEIGHTED
  }
  return static_cast<int>(cudaGetLastError());
}
