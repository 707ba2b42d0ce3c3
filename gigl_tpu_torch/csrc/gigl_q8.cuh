// The device decode of a partitioned graph's bit-packed int8 rows, shared
// by K16 unroute_rows' int8 mode (csrc/route.cu) and K12 gather_rows_q8's
// packed-row mode (csrc/gather_rows_q8.cu). It replaces
// gigl_tpu/training/dist_sampled.py PartitionedGraph.decode_rows /
// split_rows (:285-317). A packed row is W bytes:
//   without the cache (Dc = 0): [q D | scale_f | deg]           W = D + 8
//   with the cache:             [q D | qc Dc | scale_f | scale_c | deg]
//                                                             W = D + Dc + 12
// the tail's words fp32, little-endian (XLA's bitcast_convert_type). The
// decode writes features float(q) * scale_f [D], the cache float(qc) *
// scale_c [Dc] and the degree, each product one __fmul_rn (never fused),
// so every value is the reference's q.astype(f32) * tail bit for bit.
//
// Design: a warp a row. The tail's words are assembled from bytes (a row
// is any byte width, so a word may sit at any alignment); lane l takes
// columns l, l + 32, ...: each step of the warp reads 32 consecutive bytes
// and writes 128 consecutive bytes of fp32. A simple form first (PERF.md
// §6 has its time beside its bound).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gigl {

// The little-endian fp32 word at p (any alignment).
__device__ __forceinline__ float packed_word(const int8_t* p) {
  const uint8_t* b = reinterpret_cast<const uint8_t*>(p);
  const uint32_t u = static_cast<uint32_t>(__ldg(b)) |
                     (static_cast<uint32_t>(__ldg(b + 1)) << 8) |
                     (static_cast<uint32_t>(__ldg(b + 2)) << 16) |
                     (static_cast<uint32_t>(__ldg(b + 3)) << 24);
  return __uint_as_float(u);
}

// Row r's outputs from its packed row (nullptr: a request that overflowed,
// whose outputs are the reference's zero-filled row decoded: all 0), by
// the warp's lane ``lane``. cache is nullptr when dc == 0.
__device__ __forceinline__ void decode_packed_row(
    const int8_t* __restrict__ row, int d, int dc, int lane, int64_t r,
    float* __restrict__ feat, float* __restrict__ cache,
    float* __restrict__ deg) {
  float* f = feat + r * d;
  float* c = cache == nullptr ? nullptr : cache + r * dc;
  if (row == nullptr) {
    for (int k = lane; k < d; k += 32) f[k] = 0.0f;
    for (int k = lane; k < dc; k += 32) c[k] = 0.0f;
    if (lane == 0) deg[r] = 0.0f;
    return;
  }
  const int8_t* tail = row + d + dc;
  const float sf = packed_word(tail);
  const float sc = dc > 0 ? packed_word(tail + 4) : 0.0f;
  for (int k = lane; k < d; k += 32)
    f[k] = __fmul_rn(static_cast<float>(__ldg(row + k)), sf);
  for (int k = lane; k < dc; k += 32)
    c[k] = __fmul_rn(static_cast<float>(__ldg(row + d + k)), sc);
  if (lane == 0) deg[r] = packed_word(tail + (dc > 0 ? 8 : 4));
}

}  // namespace gigl
