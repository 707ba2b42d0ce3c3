// The segment walk shared by K9 segment_softmax and K9b
// segment_softmax_bwd: both walk the destination SegmentIndex (order, ptr)
// of ops/segment.py over per-edge [E, H] rows (H heads, fp32 or bf16).
//
// A group of G lanes takes a segment (kGroupLanes for up to 4 heads, a warp
// above), 32 / G segments a warp; lane l of a group takes the segment's
// slots j = lo + l + G k. Each slot's [H] rows are loaded whole, in words of
// up to 16 bytes when the rows are aligned, and kept in registers: a lane
// holds up to slots_per_lane<H>() slots, and a warp whose segments all fit
// stays in registers (each row read once, one row store). A warp with a
// longer segment takes the re-reading form (walk_rows): a pass reads each
// slot's rows once, U slots at a time.
//
// The bits are those of a first version that gave lane L of a warp the
// slots lo + L + 32u, summed in slot order and reduced the lanes by an xor
// butterfly (16, 8, 4, 2, 1). A lane of a G-lane group stands for the
// 32 / G first-version lanes l + G t: it keeps one partial sum for each
// (slot k adds to partial k mod 32 / G), and group_sum combines them in the
// butterfly's first levels' order before it shuffles the rest. So every
// group width and both forms give the first version's sums, bit for bit,
// and the same result on every run.
#pragma once

#include "gigl_pieces.cuh"

namespace gigl {
namespace softmax {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
// Most slots a lane keeps in registers; wide heads keep fewer, so that a
// lane holds at most 16 values of each table.
constexpr int kSlotsPerLane = 4;
// Heads a pass of the re-reading form keeps per lane, for head counts that
// are not 1, 2, 4, 8 or 16 (or rows that are not aligned).
constexpr int kChunk = 16;
// Lanes a segment for heads up to 4 (groups of 8, 16 and 32 give the same
// bits; 16 measured fastest or tied at every path shape for K9, PERF.md §6).
constexpr int kGroupLanes = 16;

// A value read once: with STREAM an evict-first load (ld.global.cs), which
// keeps the L2 for the rows being written. Rows narrower than a 32-byte
// sector are written a part of a sector at a time, in random order: while
// their sector stays in the L2 it is written back whole, once evicted each
// part costs the DRAM a read and a write. The wrappers stream rows
// narrower than a sector when their working set passes three quarters of
// the L2 (ops/segment.py _softmax_streams; PERF.md §6).
template <bool STREAM, typename V>
__device__ __forceinline__ V load_once(const V* p) {
  if constexpr (STREAM) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

template <int H>
__host__ __device__ constexpr int slots_per_lane() {
  const int k = H >= 16 ? 1 : 16 / H;
  return k < kSlotsPerLane ? k : kSlotsPerLane;
}

// Lanes a segment for H heads (0: any other count, a warp).
template <int H>
__host__ __device__ constexpr int group_lanes() {
  return H > 0 && H <= 4 ? kGroupLanes : kWarp;
}

template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(w);
  } else {
    const float2 f = unpack_bf16(w);
    v[0] = f.x;
    v[1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack_word(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v[0]);
  } else {
    return pack_bf16(v[0], v[1]);
  }
}

// The [H] row at p as fp32: whole words of 4, 8 or 16 bytes (p aligned to
// the row's bytes, or to 16 above them), or one value at a time below 4.
template <typename T, int H, bool STREAM>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float* v) {
  constexpr int kBytes = H * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));  // values a word
  if constexpr (kBytes < 4) {
#pragma unroll
    for (int h = 0; h < H; ++h) v[h] = to_float(p[h]);
  } else {
    constexpr int kWords = kBytes / 4;
    uint32_t w[kWords];
    if constexpr (kWords == 1) {
      w[0] = load_once<STREAM>(reinterpret_cast<const unsigned int*>(p));
    } else if constexpr (kWords == 2) {
      const uint2 r = load_once<STREAM>(reinterpret_cast<const uint2*>(p));
      w[0] = r.x;
      w[1] = r.y;
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 r =
            load_once<STREAM>(reinterpret_cast<const uint4*>(p) + i);
        w[4 * i] = r.x;
        w[4 * i + 1] = r.y;
        w[4 * i + 2] = r.z;
        w[4 * i + 3] = r.w;
      }
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) unpack_word<T>(w[i], v + i * kPer);
  }
}

template <typename T, int H>
__device__ __forceinline__ void store_row(T* __restrict__ p, const float* v) {
  constexpr int kBytes = H * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));
  if constexpr (kBytes < 4) {
#pragma unroll
    for (int h = 0; h < H; ++h) p[h] = from_float<T>(v[h]);
  } else {
    constexpr int kWords = kBytes / 4;
    uint32_t w[kWords];
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = pack_word<T>(v + i * kPer);
    if constexpr (kWords == 1) {
      *reinterpret_cast<unsigned int*>(p) = w[0];
    } else if constexpr (kWords == 2) {
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i)
        reinterpret_cast<uint4*>(p)[i] =
            make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
    }
  }
}

// Heads h0 .. h0 + NH of edge e's row in a table of `heads` values a row
// into v: the whole [H] row as words (H > 0), or value by value (H == 0:
// nh of them, zeros after).
template <typename T, int H, int NH, bool STREAM>
__device__ __forceinline__ void load_heads(const T* __restrict__ table,
                                           int64_t e, int heads, int h0,
                                           int nh, float* v) {
  if constexpr (H > 0) {
    load_row<T, H, STREAM>(table + e * H, v);
  } else {
#pragma unroll
    for (int h = 0; h < NH; ++h)
      v[h] = h < nh ? to_float(table[e * heads + h0 + h]) : 0.f;
  }
}

template <typename T, int H, int NH>
__device__ __forceinline__ void store_heads(T* __restrict__ table, int64_t e,
                                            int heads, int h0, int nh,
                                            const float* v) {
  if constexpr (H > 0) {
    store_row<T, H>(table + e * H, v);
  } else {
#pragma unroll
    for (int h = 0; h < NH; ++h)
      if (h < nh) table[e * heads + h0 + h] = from_float<T>(v[h]);
  }
}

// The in-register form's loads: lane l's K slots j = lo + l + G k of the
// segment [lo, hi) (e[k] = -1 past it), then each slot's [H] rows of the N
// tables, v[k][n].
template <typename T, int H, int G, int K, int N, bool STREAM>
__device__ __forceinline__ void load_slots(const T* const (&tables)[N],
                                           const int32_t* __restrict__ order,
                                           int32_t lo, int32_t hi, int l,
                                           int64_t* e, float (*v)[N][H]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int32_t j = lo + l + G * k;
    e[k] = j < hi ? load_once<STREAM>(order + j) : -1;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (e[k] < 0) continue;
#pragma unroll
    for (int n = 0; n < N; ++n)
      load_row<T, H, STREAM>(tables[n] + e[k] * H, v[k][n]);
  }
}

// The re-reading form's pass over lane l's slots of [lo, hi): U slots at a
// time (a whole number of partials), their edge ids loaded, then their rows
// of the N tables (heads h0 .. h0 + nh, see load_heads), then use(k, e, v)
// in slot order, v[n] the slot's row of table n.
template <typename T, int H, int G, int NH, int N, bool STREAM, typename Use>
__device__ __forceinline__ void walk_rows(const T* const (&tables)[N],
                                          const int32_t* __restrict__ order,
                                          int32_t lo, int32_t hi, int l,
                                          int heads, int h0, int nh,
                                          Use&& use) {
  constexpr int kT = kWarp / G;
  constexpr int U = kT >= 4 / N ? kT : 4 / N;
  for (int32_t k0 = 0; lo + l + G * k0 < hi; k0 += U) {
    int64_t e[U];
    float v[U][N][NH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int32_t j = lo + l + G * (k0 + u);
      e[u] = j < hi ? load_once<STREAM>(order + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e[u] < 0) continue;
#pragma unroll
      for (int n = 0; n < N; ++n)
        load_heads<T, H, NH, STREAM>(tables[n], e[u], heads, h0, nh,
                                     v[u][n]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e[u] >= 0) use(k0 + u, e[u], v[u]);
  }
}

// The group's maximum of m (each lane's own over its slots), 0 where it
// is not finite.
template <int G, int NH>
__device__ __forceinline__ void group_max(float* m) {
#pragma unroll
  for (int h = 0; h < NH; ++h) {
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      m[h] = fmaxf(m[h], __shfl_xor_sync(kFull, m[h], off));
    if (!isfinite(m[h])) m[h] = 0.f;
  }
}

// The group's sum of the partials x[t] (t: the first version's lane l +
// G t), in its butterfly's order: first the levels inside the lane (lanes
// 16, 8, ... apart there), then the shuffles. Every lane of the group ends
// with the same bits.
template <int G, int NH>
__device__ __forceinline__ void group_sum(float (*x)[NH], float* sum) {
  constexpr int kT = kWarp / G;
#pragma unroll
  for (int half = kT / 2; half > 0; half >>= 1) {
#pragma unroll
    for (int t = 0; t < half; ++t) {
#pragma unroll
      for (int h = 0; h < NH; ++h) x[t][h] += x[t + half][h];
    }
  }
#pragma unroll
  for (int h = 0; h < NH; ++h) {
    float s = x[0][h];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      s += __shfl_xor_sync(kFull, s, off);
    sum[h] = s;
  }
}

// The segment [lo, hi) of lane `lane`'s group (empty past the last), for
// the warp of thread `tid` with 32 / G segments.
template <int G>
__device__ __forceinline__ bool group_segment(const int32_t* __restrict__ ptr,
                                              int64_t s, int& l, int32_t& lo,
                                              int32_t& hi) {
  constexpr int kT = kWarp / G;
  const int lane = threadIdx.x & (kWarp - 1);
  l = lane & (G - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (warp * kT >= s) return false;  // uniform across the warp
  const int64_t seg = warp * kT + lane / G;
  lo = hi = 0;
  if (seg < s) {
    lo = __ldg(ptr + seg);
    hi = __ldg(ptr + seg + 1);
  }
  return true;
}

// Blocks of `threads` for s segments, 32 / G a warp.
template <int G>
inline unsigned group_blocks(long long s, int threads) {
  const long long warps = (s + kWarp / G - 1) / (kWarp / G);
  return static_cast<unsigned>((warps * kWarp + threads - 1) / threads);
}

}  // namespace softmax
}  // namespace gigl
