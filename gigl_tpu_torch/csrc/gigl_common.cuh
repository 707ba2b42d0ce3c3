// Device helpers shared by the port's kernels: the counter-based RNG draw
// of gigl_tpu/sampling/neighbor_sampler.py (_mix32, counter_rng_uniform,
// uniform_offsets, and the CSR slot clamp of sample_neighbors), bit-equal
// to it for every (seed, node, hop, slot), and the warp-level weighted /
// top-k draw over a node's window (weighted_offsets, :96-134), shared by
// K19 sample_weighted and K2's weighted mode.
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace gigl {

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

// Order-preserving 64-bit key of window slot j's score: the float's
// order-preserving uint32 in the high half (-0.0 as +0.0, so equal scores
// tie) and window - 1 - j in the low half, so the lower slot wins a tie.
// A NaN score (a NaN weight) ranks below every other slot, invalid ones
// included: lax.top_k orders by the floats' total order and the
// reference's CPU log turns any NaN into a negative NaN. Key 0 is below
// every score (-inf maps to 0x007FFFFF..., NaN to 0x00000001...): it marks
// a slot outside the window and a slot already taken.
__device__ __forceinline__ uint64_t score_key(float s, int j, int window) {
  uint32_t b;
  if (s != s) {
    b = 1u;
  } else {
    const uint32_t f = __float_as_uint(s + 0.0f);  // -0.0 + 0.0 = +0.0
    b = (f & 0x80000000u) ? ~f : (f | 0x80000000u);
  }
  return (static_cast<uint64_t>(b) << 32) |
         static_cast<uint32_t>(window - 1 - j);
}

__device__ __forceinline__ uint64_t warp_max_u64(uint64_t k) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const uint64_t other = __shfl_xor_sync(0xffffffffu, k, o);
    k = other > k ? other : k;
  }
  return k;
}

// A node's weighted / top-k window held by one warp: slot j = lane + 32 c
// of the first `window` (<= 32 C) CSR slots, C keys a lane in registers.
// Every lane of the warp must call load() and pick() together.
template <int C>
struct WarpWindow {
  uint64_t key[C];
  int window;

  // Score the window of a node whose CSR row starts at `start` with `deg`
  // neighbors; the draw is keyed by `node` (its global id). Slot j reads
  // weight clip(start + min(j, deg - 1), 0, n_weights - 1), coalesced
  // across the warp.
  __device__ __forceinline__ void load(const float* __restrict__ weights,
                                       int64_t n_weights, int32_t start,
                                       int32_t deg, uint32_t node,
                                       uint32_t seed, uint32_t hop, int win,
                                       bool gumbel) {
    window = win;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = lane + 32 * c;
      key[c] = 0;
      if (j < win) {
        const bool valid = j < deg;
        float w = 0.f;
        if (valid) {
          int64_t at = static_cast<int64_t>(start) + j;
          at = at < 0 ? 0 : (at > n_weights - 1 ? n_weights - 1 : at);
          w = __ldg(weights + at);
        }
        const uint32_t bits =
            gumbel && valid
                ? counter_bits(node, seed, hop, static_cast<uint32_t>(j))
                : 0u;
        key[c] = score_key(weighted_score(w, valid, bits, gumbel), j, win);
      }
    }
  }

  // One round of the top-k: the window slot of the best remaining score
  // (warp-uniform), which is then taken out of the window.
  __device__ __forceinline__ int next() {
    uint64_t best = key[0];
#pragma unroll
    for (int c = 1; c < C; ++c) best = key[c] > best ? key[c] : best;
    best = warp_max_u64(best);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (key[c] == best) key[c] = 0;  // keys are distinct: the owner only
    }
    return window - 1 - static_cast<int>(static_cast<uint32_t>(best));
  }

  // Rounds s0 .. min(s0 + 32, fanout) - 1 of the top-k (call with s0 = 0,
  // 32, 64, ... in order): lane l gets the window slot of round s0 + l
  // (0 past the last round).
  __device__ __forceinline__ int pick(int s0, int fanout) {
    const int lane = threadIdx.x & 31;
    const int nb = min(32, fanout - s0);
    int mine = 0;
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
