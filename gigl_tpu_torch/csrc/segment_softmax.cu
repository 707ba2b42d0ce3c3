// K9 segment_softmax — replaces gigl_tpu/ops/segment.py segment_softmax
// (:51-61): the softmax of per-edge logits within each destination segment
// (attention over an in-neighborhood on the COO path).
//
// logits [E, H] (H = 1 for [E]) -> alpha [E, H] in the original edge order:
//   m     = max_{e in seg} logits[e, h]      (0 where it is not finite)
//   alpha = exp(logits[e, h] - m) / max(sum_{e in seg} exp(... - m), 1e-16)
// (a NaN sum kept, as jnp.maximum keeps it: a segment with a NaN logit is
// NaN throughout), walking the SegmentIndex (order, ptr) of ops/segment.py.
// Every edge lies in one segment, so each output is written once; fp32
// arithmetic, one rounding to the logits' type.
//
// Bound: bytes — the logits and the index read once, alpha written once.
// In random edge order each slot's row is a random 16-byte read (H = 4
// fp32) and a random write: 32-byte sectors, the floor for this order.
//
// Design: a group of G lanes per segment (kGroupLanes for up to 4 heads, a
// warp above), 32 / G segments a warp; lane l of a group takes the segment's
// slots l, l + G, l + 2G, ... The first version walked each segment once
// per head and three times per head (max, sum, write), reading
// logits[e * H + h] through order[j] 3H times an edge; here a lane loads
// each of its slots' whole [H] rows once, in words of up to 16 bytes, and
// keeps them in registers for the max, the exps, the sum and the write,
// which stores the [H] alpha row at once. A segment longer than G * K
// slots (K = kSlotsPerLane, fewer for wide heads) puts its warp on the
// re-reading form of the same kernel: three passes (max, sum, write),
// each reading the row once, in chunks of 16 heads for other head counts.
// Over a working set past the L2, narrow rows are read evict-first
// (STREAM: load_once in gigl_softmax.cuh).
//
// The bits are the first version's (its warp gave lane L the slots L +
// 32u, summed each lane's exps in slot order and reduced the lanes by an
// xor butterfly): every group width and both forms give them, as
// gigl_softmax.cuh describes (the max is the same in any order), where the
// sum is not NaN (the first version clamped a NaN sum to 1e-16), and the
// same result on every run.
#include "gigl_softmax.cuh"

namespace {

using namespace gigl::softmax;

constexpr int kThreads = 256;

// The group's sum of the exps, clamped at 1e-16 (a NaN sum kept).
template <int G, int NH>
__device__ __forceinline__ void group_denom(float (*x)[NH], float* denom) {
  group_sum<G, NH>(x, denom);
#pragma unroll
  for (int h = 0; h < NH; ++h)
    denom[h] = denom[h] != denom[h] ? denom[h] : fmaxf(denom[h], 1e-16f);
}

// The re-reading form for one segment [lo, hi) of lane l's group: a pass
// for the max, one for the sum, one for the write, each reading the slot's
// row once; heads in chunks of NH (H > 0: all H at once, rows read as
// words; H == 0: `heads` values, one at a time).
template <typename T, int H, int G, bool STREAM>
__device__ void softmax_passes(const T* __restrict__ logits,
                               const int32_t* __restrict__ order,
                               T* __restrict__ out, int32_t lo, int32_t hi,
                               int l, int heads) {
  constexpr int NH = H > 0 ? H : kChunk;
  constexpr int kT = kWarp / G;
  const T* const tables[1] = {logits};
  const int row = H > 0 ? H : heads;
  for (int h0 = 0; h0 < row; h0 += NH) {
    const int nh = H > 0 ? H : min(NH, heads - h0);
    auto pass = [&](auto&& use) {
      walk_rows<T, H, G, NH, 1, STREAM>(tables, order, lo, hi, l, heads, h0,
                                        nh, use);
    };
    float m[NH], x[kT][NH], denom[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) m[h] = -__int_as_float(0x7f800000);
    pass([&](int, int64_t, const float (*v)[NH]) {
#pragma unroll
      for (int h = 0; h < NH; ++h) m[h] = fmaxf(m[h], v[0][h]);
    });
    group_max<G, NH>(m);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
#pragma unroll
      for (int h = 0; h < NH; ++h) x[t][h] = 0.f;
    }
    pass([&](int k, int64_t, const float (*v)[NH]) {
#pragma unroll
      for (int h = 0; h < NH; ++h) x[k % kT][h] += expf(v[0][h] - m[h]);
    });
    group_denom<G, NH>(x, denom);
    pass([&](int, int64_t e, const float (*v)[NH]) {
      float a[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) a[h] = expf(v[0][h] - m[h]) / denom[h];
      store_heads<T, H, NH>(out, e, heads, h0, nh, a);
    });
  }
}

// One group of G lanes per segment, 32 / G segments a warp. H: the heads
// (1, 2, 4, 8 or 16; rows aligned), or 0 for any other count (`heads`),
// which takes the re-reading form alone.
template <typename T, int H, int G, bool STREAM>
__global__ void segment_softmax_kernel(const T* __restrict__ logits,
                                       const int32_t* __restrict__ order,
                                       const int32_t* __restrict__ ptr,
                                       T* __restrict__ out, int64_t s,
                                       int heads) {
  constexpr int kT = kWarp / G;
  int l;
  int32_t lo, hi;
  if (!group_segment<G>(ptr, s, l, lo, hi)) return;
  if constexpr (H > 0) {
    constexpr int K = slots_per_lane<H>();
    if (__all_sync(kFull, hi - lo <= G * K)) {
      // every segment of the warp fits: its rows stay in registers
      const T* const tables[1] = {logits};
      int64_t e[K];
      float v[K][1][H], m[H], x[kT][H], denom[H];
      load_slots<T, H, G, K, 1, STREAM>(tables, order, lo, hi, l, e, v);
#pragma unroll
      for (int h = 0; h < H; ++h) m[h] = -__int_as_float(0x7f800000);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h) m[h] = fmaxf(m[h], v[k][0][h]);
      }
      group_max<G, H>(m);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
#pragma unroll
        for (int h = 0; h < H; ++h) x[t][h] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h) {
          v[k][0][h] = expf(v[k][0][h] - m[h]);
          x[k % kT][h] += v[k][0][h];
        }
      }
      group_denom<G, H>(x, denom);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h) v[k][0][h] /= denom[h];
        store_row<T, H>(out + e[k] * H, v[k][0]);
      }
      return;
    }
  }
  softmax_passes<T, H, G, STREAM>(logits, order, out, lo, hi, l, heads);
}

template <typename T, int H, int G, bool STREAM>
void launch_form(const void* logits, const int32_t* order,
                 const int32_t* ptr, void* out, long long s, int heads,
                 cudaStream_t st) {
  segment_softmax_kernel<T, H, G, STREAM>
      <<<group_blocks<G>(s, kThreads), kThreads, 0, st>>>(
          static_cast<const T*>(logits), order, ptr, static_cast<T*>(out), s,
          heads);
}

// Heads above 4 hold too much for groups narrower than a warp; rows of a
// whole sector and more are written whole, and never stream.
template <typename T, int H>
void launch_heads(const void* logits, const int32_t* order,
                  const int32_t* ptr, void* out, long long s, int stream,
                  cudaStream_t st) {
  constexpr int G = group_lanes<H>();
  if constexpr (H * sizeof(T) < 32) {
    if (stream) {
      launch_form<T, H, G, true>(logits, order, ptr, out, s, H, st);
      return;
    }
  }
  launch_form<T, H, G, false>(logits, order, ptr, out, s, H, st);
}

template <typename T>
void launch(const void* logits, const int32_t* order, const int32_t* ptr,
            void* out, long long s, int heads, int vec, int stream,
            cudaStream_t st) {
  switch (vec ? heads : 0) {  // unaligned rows: one value at a time
    case 1: launch_heads<T, 1>(logits, order, ptr, out, s, stream, st); break;
    case 2: launch_heads<T, 2>(logits, order, ptr, out, s, stream, st); break;
    case 4: launch_heads<T, 4>(logits, order, ptr, out, s, stream, st); break;
    case 8: launch_heads<T, 8>(logits, order, ptr, out, s, stream, st); break;
    case 16:
      launch_heads<T, 16>(logits, order, ptr, out, s, stream, st);
      break;
    default:
      launch_form<T, 0, kWarp, false>(logits, order, ptr, out, s, heads, st);
  }
}

}  // namespace

// logits and out [E, heads] (fp32: dtype 0, bf16: 1), order [E] and ptr
// [S + 1] int32 (the SegmentIndex); vec: 1 when logits and out are 16-byte
// aligned; stream: 1 to read the logits and order with evict-first loads
// (rows narrower than 32 bytes only).
extern "C" int gigl_segment_softmax(const void* logits, const void* order,
                                    const void* ptr, void* out, long long s,
                                    int heads, int dtype, int vec,
                                    int stream_loads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 0) return 0;
  if (heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  if (dtype == 0) {
    launch<float>(logits, ov, pv, out, s, heads, vec, stream_loads, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(logits, ov, pv, out, s, heads, vec, stream_loads,
                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
