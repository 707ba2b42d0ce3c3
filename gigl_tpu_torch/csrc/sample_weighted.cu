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
// per node; lane l holds window slots l, l + 32, ... as 32-bit
// order-preserving score words, the weights read coalesced. Only the key
// registers that hold a valid slot are scored and searched: L = the least
// power of two >= ceil(min(deg, window) / 32), one kernel body per L (a
// flagship node of ~20 neighbors takes one register where the 128-slot
// window has four). Each of the `fanout` rounds (gigl_common.cuh
// WarpTopK) is a __reduce_max_sync of the lanes' best words and a
// __reduce_min_sync of the lanes' lowest slots holding it, and the owner
// clears its word: no 64-bit shuffle butterfly. Where the window holds no
// NaN, the rounds past the node's valid slots are written in closed form
// (they take invalid slots, all of which give offset deg - 1, mask 0).
// After every 32 rounds each lane writes one output slot, so the three
// outputs are written coalesced. The rows need not be sorted. (Lane groups
// of 16 or 8 a node, several nodes a warp, measured slower at every shape
// but a hub at window 1024: PERF.md §6.)
//
// Row-offset mode (a template flag, as K1's): the frontier holds GLOBAL
// ids, the CSR and weights are one shard's row block, node v reads local
// row clip(v - row_offset, 0, n_rows - 1) and its draw stays keyed by v.
#include "gigl_common.cuh"

namespace {

constexpr int kThreads = 256;  // 8 nodes a block

struct Params {
  const int32_t* __restrict__ indptr;
  const int32_t* __restrict__ indices;
  int64_t n_edges;
  const float* __restrict__ weights;
  int64_t n_weights;
  const int32_t* __restrict__ frontier;
  int64_t m;
  int fanout, window;
  bool gumbel;
  uint32_t seed, hop;
  int32_t row_offset;
  int64_t n_rows;
  int32_t* __restrict__ ids;
  uint8_t* __restrict__ mask;
  int32_t* __restrict__ slots;
};

// The draw of node `row` with L key registers.
template <int L>
__device__ __forceinline__ void draw_node(const Params& p, int64_t row,
                                          int32_t v, int32_t start,
                                          int32_t deg, int valid) {
  gigl::WarpTopK<L> win;
  const bool nan = win.load(p.weights, p.n_weights, start, deg,
                            static_cast<uint32_t>(v), p.seed, p.hop,
                            p.window, p.gumbel);
  // Rounds past the node's valid slots take invalid slots (or NaN ones,
  // which rank below them): offset deg - 1, mask 0 where the window holds
  // no NaN, so those are written without their rounds (slot `valid` >=
  // deg gives them).
  const int rounds =
      __any_sync(0xffffffffu, nan) ? p.fanout : min(p.fanout, valid);
  const int lane = threadIdx.x & 31;
  for (int s0 = 0; s0 < p.fanout; s0 += 32) {
    const int j = win.pick(s0, rounds, valid);
    const int s = s0 + lane;
    if (s < p.fanout) {
      const gigl::UniformDraw d =
          gigl::weighted_draw(start, deg, j, s, p.fanout, p.n_edges);
      const int64_t o = row * p.fanout + s;
      p.ids[o] = d.valid ? __ldg(p.indices + d.edge_slot) : 0;
      p.mask[o] = d.valid ? 1 : 0;
      p.slots[o] = d.edge_slot;
    }
  }
}

// draw_node with the least L in L0, 2 L0, ... C that is >= live
// (warp-uniform).
template <int L0, int C>
__device__ __forceinline__ void draw_live(int live, const Params& p,
                                          int64_t row, int32_t v,
                                          int32_t start, int32_t deg,
                                          int valid) {
  if constexpr (L0 < C) {
    if (live > L0) {
      draw_live<2 * L0, C>(live, p, row, v, start, deg, valid);
      return;
    }
  }
  draw_node<L0>(p, row, v, start, deg, valid);
}

// A warp a node; C = window / 32 key registers at most.
template <int C, bool kOffset>
__global__ void __launch_bounds__(kThreads)
    sample_weighted_kernel(const Params p) {
  // One warp per node; blockDim is a multiple of 32, so row is warp-uniform.
  const int64_t row =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (row >= p.m) return;
  const int32_t v = p.frontier[row];
  int64_t r = v;
  if constexpr (kOffset) {
    r = static_cast<int64_t>(v) - p.row_offset;
    r = r < 0 ? 0 : (r > p.n_rows - 1 ? p.n_rows - 1 : r);
  }
  const int32_t start = __ldg(p.indptr + r);
  const int32_t deg = __ldg(p.indptr + r + 1) - start;
  const int valid = deg < 0 ? 0 : (deg < p.window ? deg : p.window);
  draw_live<1, C>((valid + 31) / 32, p, row, v, start, deg, valid);
}

template <int C>
void launch_weighted(const Params& p, bool has_offset, cudaStream_t stream) {
  const unsigned blocks =
      static_cast<unsigned>((p.m * 32 + kThreads - 1) / kThreads);
  auto kernel = has_offset ? sample_weighted_kernel<C, true>
                           : sample_weighted_kernel<C, false>;
  kernel<<<blocks, kThreads, 0, stream>>>(p);
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
    Params p{};
    p.indptr = static_cast<const int32_t*>(indptr);
    p.indices = static_cast<const int32_t*>(indices);
    p.n_edges = n_edges;
    p.weights = static_cast<const float*>(weights);
    p.n_weights = n_weights;
    p.frontier = static_cast<const int32_t*>(frontier);
    p.m = m;
    p.fanout = fanout;
    p.window = window;
    p.gumbel = method == 1;
    p.seed = seed;
    p.hop = hop;
    p.row_offset = row_offset;
    p.n_rows = n_rows;
    p.ids = static_cast<int32_t*>(ids);
    p.mask = static_cast<uint8_t*>(mask);
    p.slots = static_cast<int32_t*>(slots);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const bool offset = has_offset != 0;
    if (window <= 32) {
      launch_weighted<1>(p, offset, s);
    } else if (window <= 64) {
      launch_weighted<2>(p, offset, s);
    } else if (window <= 128) {
      launch_weighted<4>(p, offset, s);
    } else if (window <= 256) {
      launch_weighted<8>(p, offset, s);
    } else if (window <= 512) {
      launch_weighted<16>(p, offset, s);
    } else {
      launch_weighted<32>(p, offset, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
