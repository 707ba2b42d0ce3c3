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
// (STREAM, below).
//
// The bits are the first version's: its warp gave lane L the slots L +
// 32u, summed each lane's exps in slot order and reduced the lanes by an
// xor butterfly. A lane of a G-lane group stands for the 32 / G lanes l +
// G t of that warp: it keeps one partial sum for each (slot k adds to
// partial k mod 32 / G), combines them in the butterfly's first levels'
// order and shuffles the rest; the max is the same in any order. So every
// group width and both forms give the first version's alpha, bit for bit,
// where the sum is not NaN (the first version clamped a NaN sum to 1e-16),
// and the same result on every run.
#include "gigl_pieces.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;
// Most slots a lane keeps in registers (logits rows, then their exps);
// wide heads keep fewer, so that a lane holds at most 16 values.
constexpr int kSlotsPerLane = 4;
// Heads a pass of the re-reading form keeps per lane, for head counts
// that are not 1, 2, 4, 8 or 16 (or rows that are not aligned).
constexpr int kChunk = 16;
// Lanes a segment for heads up to 4 (groups of 8, 16 and 32 give the same
// bits; 16 measured fastest or tied at every path shape, PERF.md §6).
constexpr int kGroupLanes = 16;

// A value read once: with STREAM an evict-first load (ld.global.cs), which
// keeps the L2 for the alpha rows being written. Rows narrower than a
// 32-byte sector are written a part of a sector at a time, in random
// order: while their sector stays in the L2 it is written back whole, once
// evicted each part costs the DRAM a read and a write. The wrapper streams
// rows narrower than a sector when the logits and alpha pass three
// quarters of the L2 (ops/segment.py _softmax_streams; PERF.md §6).
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

template <typename T>
__device__ __forceinline__ void unpack_word(uint32_t w, float* v) {
  if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(w);
  } else {
    const float2 f = gigl::unpack_bf16(w);
    v[0] = f.x;
    v[1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ uint32_t pack_word(const float* v) {
  if constexpr (sizeof(T) == 4) {
    return __float_as_uint(v[0]);
  } else {
    return gigl::pack_bf16(v[0], v[1]);
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
    for (int h = 0; h < H; ++h) v[h] = gigl::to_float(p[h]);
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
    for (int h = 0; h < H; ++h) p[h] = gigl::from_float<T>(v[h]);
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
// 16, 8, ... apart there), then the shuffles; the denominator clamped at
// 1e-16, a NaN sum kept.
template <int G, int NH>
__device__ __forceinline__ void group_sum(float (*x)[NH], float* denom) {
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
    float sum = x[0][h];
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    denom[h] = sum != sum ? sum : fmaxf(sum, 1e-16f);
  }
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
  // slots a lane loads before it uses them: a whole number of partials
  constexpr int U = kT >= 4 ? kT : 4;
  const int row = H > 0 ? H : heads;
  for (int h0 = 0; h0 < row; h0 += NH) {
    const int nh = H > 0 ? H : min(NH, heads - h0);
    auto load = [&](int64_t e, float* v) {
      if constexpr (H > 0) {
        load_row<T, H, STREAM>(logits + e * H, v);
      } else {
#pragma unroll
        for (int h = 0; h < NH; ++h)
          v[h] = h < nh ? gigl::to_float(logits[e * heads + h0 + h]) : 0.f;
      }
    };
    // each pass: U slots of the lane (j = lo + l + G k) loaded, then used
    // in slot order
    auto pass = [&](auto&& use) {
      for (int32_t k0 = 0; lo + l + G * k0 < hi; k0 += U) {
        int64_t e[U];
        float v[U][NH];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int32_t j = lo + l + G * (k0 + u);
          e[u] = j < hi ? load_once<STREAM>(order + j) : -1;
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (e[u] >= 0) load(e[u], v[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (e[u] >= 0) use(u, e[u], v[u]);
      }
    };
    float m[NH], x[kT][NH], denom[NH];
#pragma unroll
    for (int h = 0; h < NH; ++h) m[h] = -__int_as_float(0x7f800000);
    pass([&](int, int64_t, const float* v) {
#pragma unroll
      for (int h = 0; h < NH; ++h) m[h] = fmaxf(m[h], v[h]);
    });
    group_max<G, NH>(m);
#pragma unroll
    for (int t = 0; t < kT; ++t) {
#pragma unroll
      for (int h = 0; h < NH; ++h) x[t][h] = 0.f;
    }
    pass([&](int u, int64_t, const float* v) {
#pragma unroll
      for (int h = 0; h < NH; ++h) x[u % kT][h] += expf(v[h] - m[h]);
    });
    group_sum<G, NH>(x, denom);
    pass([&](int, int64_t e, const float* v) {
      float a[NH];
#pragma unroll
      for (int h = 0; h < NH; ++h) a[h] = expf(v[h] - m[h]) / denom[h];
      if constexpr (H > 0) {
        store_row<T, H>(out + e * H, a);
      } else {
#pragma unroll
        for (int h = 0; h < NH; ++h)
          if (h < nh) out[e * heads + h0 + h] = gigl::from_float<T>(a[h]);
      }
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
  const int lane = threadIdx.x & (kWarp - 1);
  const int l = lane & (G - 1);
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / kWarp;
  if (warp * kT >= s) return;  // uniform across the warp
  const int64_t seg = warp * kT + lane / G;
  int32_t lo = 0, hi = 0;  // a segment past the last is empty
  if (seg < s) {
    lo = __ldg(ptr + seg);
    hi = __ldg(ptr + seg + 1);
  }
  if constexpr (H > 0) {
    constexpr int K = slots_per_lane<H>();
    if (__all_sync(kFull, hi - lo <= G * K)) {
      // every segment of the warp fits: its rows stay in registers
      int64_t e[K];
      float v[K][H], m[H], x[kT][H], denom[H];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int32_t j = lo + l + G * k;
        e[k] = j < hi ? load_once<STREAM>(order + j) : -1;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (e[k] >= 0) load_row<T, H, STREAM>(logits + e[k] * H, v[k]);
#pragma unroll
      for (int h = 0; h < H; ++h) m[h] = -__int_as_float(0x7f800000);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h) m[h] = fmaxf(m[h], v[k][h]);
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
          v[k][h] = expf(v[k][h] - m[h]);
          x[k % kT][h] += v[k][h];
        }
      }
      group_sum<G, H>(x, denom);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h) v[k][h] /= denom[h];
        store_row<T, H>(out + e[k] * H, v[k]);
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
  const int threads = 256;
  const long long warps = (s + kWarp / G - 1) / (kWarp / G);
  const unsigned blocks =
      static_cast<unsigned>((warps * kWarp + threads - 1) / threads);
  segment_softmax_kernel<T, H, G, STREAM><<<blocks, threads, 0, st>>>(
      static_cast<const T*>(logits), order, ptr, static_cast<T*>(out), s,
      heads);
}

// Heads above 4 hold too much for groups narrower than a warp; rows of a
// whole sector and more are written whole, and never stream.
template <typename T, int H>
void launch_heads(const void* logits, const int32_t* order,
                  const int32_t* ptr, void* out, long long s, int stream,
                  cudaStream_t st) {
  constexpr int G = H > 4 ? kWarp : kGroupLanes;
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
