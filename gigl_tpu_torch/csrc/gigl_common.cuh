// Device helpers shared by the port's kernels: the counter-based RNG draw
// of gigl_tpu/sampling/neighbor_sampler.py (_mix32, counter_rng_uniform,
// uniform_offsets, and the CSR slot clamp of sample_neighbors), bit-equal
// to it for every (seed, node, hop, slot).
#pragma once

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

}  // namespace gigl
