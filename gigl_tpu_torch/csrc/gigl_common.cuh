// Device helpers shared by the port's kernels: the counter-based RNG draw
// of gigl_tpu/sampling/neighbor_sampler.py (_mix32, counter_rng_uniform,
// uniform_offsets, and the CSR slot clamp of sample_neighbors), bit-equal
// to it for every (seed, node, hop, slot), the lane-group weighted /
// top-k draw over a node's window (weighted_offsets, :96-134), shared by
// K19 sample_weighted and K2's weighted mode, and the programmatic
// dependent launch of K14 cms_estimate and K1b uniform_ids.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace gigl {

// A programmatic dependent launch (cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization): the kernel's blocks
// may start before the kernel ahead of it on the stream has finished, once
// every block of that kernel has exited or called
// allow_dependents_to_start(). The kernel must call wait_for_prior_grid()
// before it reads what the kernel ahead writes and before it writes
// memory that kernel may still read or write, and every thread must reach
// that wait before it returns, so that the grid never ends ahead of the
// kernel before it.
template <typename... Params, typename... Args>
inline cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid,
                                   dim3 block, cudaStream_t stream,
                                   Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// Waits until the kernel ahead on the stream has finished and its writes
// are visible (a no-op in a kernel launched without the attribute).
__device__ __forceinline__ void wait_for_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Lets a dependent launch behind this kernel start its blocks now, before
// this grid ends (a no-op when the next launch is a plain one). It orders
// no memory: the dependent still waits for this whole grid.
__device__ __forceinline__ void allow_dependents_to_start() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// lowbias32-style integer finalizer on uint32 (neighbor_sampler._mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// counter_rng_uniform: one uniform uint32 per (seed, node, hop, slot).
__device__ __forceinline__ uint32_t counter_bits(uint32_t node, uint32_t seed,
                                                 uint32_t hop, uint32_t slot) {
  const uint32_t base =
      node * 0x9E3779B9u + seed * 0x85EBCA6Bu + hop * 0xC2B2AE35u;
  return mix32(base ^ mix32(slot + 0x27220A95u));
}

struct UniformDraw {
  int32_t edge_slot;  // clamped index into the CSR indices
  bool valid;
};

// uniform_offsets for one (node, slot): nodes with deg <= fanout take all
// their neighbors in slot order; larger degrees draw with replacement.
// The slot is clamped to [0, n_edges - 1] as sample_neighbors does.
__device__ __forceinline__ UniformDraw draw_uniform(
    int32_t start, int32_t deg, int32_t node, uint32_t seed, uint32_t hop,
    int32_t slot, int32_t fanout, int64_t n_edges) {
  int32_t off;
  bool valid;
  if (deg <= fanout) {
    off = min(slot, max(deg - 1, 0));
    valid = slot < deg;
  } else {
    const uint32_t bits =
        counter_bits(static_cast<uint32_t>(node), seed, hop,
                     static_cast<uint32_t>(slot));
    off = static_cast<int32_t>(bits % static_cast<uint32_t>(deg));
    valid = true;
  }
  int64_t es = static_cast<int64_t>(start) + off;
  es = es < 0 ? 0 : (es > n_edges - 1 ? n_edges - 1 : es);
  return {static_cast<int32_t>(es), valid};
}

// weighted_offsets' score of one window slot j of a node with `deg`
// neighbors: invalid slots (j >= deg) score -FLT_MAX (finfo(float32).min);
// a valid slot's log-weight is log(max(w, 1e-30)) with a NaN weight kept
// NaN (jnp.maximum propagates it, fmaxf would not); "weighted" adds the
// Gumbel term -log(-log(u)), u = (float(bits) + 0.5) / 2**32 with the
// reference's order of operations and IEEE logf (never __logf). bits >=
// 2**32 - 128 round u to exactly 1.0, so log(-0.0) = -inf and the score
// is +inf, as in the reference.
__device__ __forceinline__ float weighted_score(float w, bool valid,
                                                uint32_t bits, bool gumbel) {
  if (!valid) return -FLT_MAX;
  const float logw = logf(w != w ? w : fmaxf(w, 1e-30f));
  if (!gumbel) return logw;
  const float u = (__uint2float_rn(bits) + 0.5f) / 4294967296.0f;
  return logw - logf(-logf(u));
}

// The order-preserving 32-bit word of a window slot's score: the float's
// bits with the sign folded (-0.0 as +0.0, so equal scores tie). A NaN
// score (a NaN weight) is 1, below every other slot, invalid ones
// included: lax.top_k orders by the floats' total order and the
// reference's CPU log turns any NaN into a negative NaN. Word 0 is below
// every score (-inf maps to 0x007FFFFF): it marks a slot outside the
// window and a slot already taken.
__device__ __forceinline__ uint32_t score_word(float s) {
  if (s != s) return 1u;
  const uint32_t f = __float_as_uint(s + 0.0f);  // -0.0 + 0.0 = +0.0
  return (f & 0x80000000u) ? ~f : (f | 0x80000000u);
}

// score_word(-FLT_MAX): the word of every invalid window slot (j >= deg).
constexpr uint32_t kInvalidWord = 0x00800000u;

// A node's weighted / top-k window held by one warp: slot j = 32 c + lane
// in key register c < L, one score word each. L (a power of two) covers
// every valid slot of the node: L >= ceil(min(deg, window) / 32). The
// window's slots past 32 L are all invalid and tie at kInvalidWord, so the
// lowest of them not yet taken, `dead`, stands for all of them. A round is
// the warp's best word (one REDUX), then the lowest slot that holds it
// (another), exactly what a max over (word, window - 1 - j) keys takes:
// keys are distinct and the lower slot wins a tie. Every lane of the warp
// calls load() and next() together.
template <int L>
struct WarpTopK {
  uint32_t word[L];
  int dead;    // the lowest window slot past 32 L not yet taken
  int window;

  // Score the window of a node whose CSR row starts at `start` with `deg`
  // neighbors; the draw is keyed by `node` (its global id). Slot j < deg
  // reads weight clip(start + j, 0, n_weights - 1), coalesced across the
  // warp. Returns whether a valid slot of this lane scored NaN.
  __device__ __forceinline__ bool load(const float* __restrict__ weights,
                                       int64_t n_weights, int32_t start,
                                       int32_t deg, uint32_t node,
                                       uint32_t seed, uint32_t hop, int win,
                                       bool gumbel) {
    window = win;
    dead = 32 * L;
    const int lane = threadIdx.x & 31;
    bool nan = false;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      const int j = lane + 32 * c;
      word[c] = j < win ? kInvalidWord : 0u;
      if (j < win && j < deg) {
        int64_t at = static_cast<int64_t>(start) + j;
        at = at < 0 ? 0 : (at > n_weights - 1 ? n_weights - 1 : at);
        const uint32_t bits =
            gumbel ? counter_bits(node, seed, hop, static_cast<uint32_t>(j))
                   : 0u;
        word[c] = score_word(
            weighted_score(__ldg(weights + at), true, bits, gumbel));
        nan |= word[c] == 1u;
      }
    }
    return nan;
  }

  // One round of the top-k: the window slot of the best remaining score,
  // the lowest such slot on a tie (warp-uniform), taken out of the window.
  __device__ __forceinline__ int next() {
    const int lane = threadIdx.x & 31;
    uint32_t best = word[0];
#pragma unroll
    for (int c = 1; c < L; ++c) best = word[c] > best ? word[c] : best;
    best = __reduce_max_sync(0xffffffffu, best);
    int mine = 0x7fffffff;  // this lane's lowest slot holding `best`
#pragma unroll
    for (int c = L - 1; c >= 0; --c) {
      if (word[c] == best) mine = lane + 32 * c;
    }
    const int low = __reduce_min_sync(0xffffffffu, mine);
    // the slots past 32 L are invalid: they rank below a valid slot and a
    // held invalid one (a lower slot), above a NaN and a taken slot
    const bool past = best < kInvalidWord && dead < window;
    const int j = past ? dead : low;
    dead += past;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (lane + 32 * c == j) word[c] = 0u;  // keys are distinct: the owner
    }
    return j;
  }

  // Rounds s0 .. min(s0 + 32, rounds) - 1 of the top-k (call with s0 = 0,
  // 32, 64, ... in order; `rounds` warp-uniform): lane l gets the window
  // slot of round s0 + l, `rest` past the last round.
  __device__ __forceinline__ int pick(int s0, int rounds, int rest = 0) {
    const int lane = threadIdx.x & 31;
    const int nb = min(32, rounds - s0);
    int mine = rest;
    for (int r = 0; r < nb; ++r) {
      const int j = next();
      if (lane == r) mine = j;
    }
    return mine;
  }
};

// weighted_offsets' outputs for round s whose winner is window slot j, as
// sample_neighbors uses them: offset min(j, max(deg - 1, 0)), valid when
// s < min(deg, fanout), the CSR slot clamped to [0, n_edges - 1].
__device__ __forceinline__ UniformDraw weighted_draw(int32_t start,
                                                     int32_t deg, int j,
                                                     int s, int fanout,
                                                     int64_t n_edges) {
  const int32_t off = min(j, max(deg - 1, 0));
  int64_t es = static_cast<int64_t>(start) + off;
  es = es < 0 ? 0 : (es > n_edges - 1 ? n_edges - 1 : es);
  return {static_cast<int32_t>(es), s < min(deg, fanout)};
}

}  // namespace gigl
