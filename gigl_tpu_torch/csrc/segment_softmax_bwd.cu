// K9b segment_softmax_bwd — replaces the backward that jax's autodiff gives
// gigl_tpu/ops/segment.py segment_softmax (:51-61): from the saved softmax
// alpha [E, H] and the cotangent g [E, H] of alpha,
//   dlogits[e, h] = alpha[e, h] * (g[e, h] - sum_{e' in seg(e)} alpha[e', h] * g[e', h])
// per head, walking the destination SegmentIndex (order, ptr) of the forward.
// (The reference's segment max is not under a stop-gradient, but its terms
// cancel: d alpha / d max = 0.) Every edge lies in one segment, so each
// output is written once; fp32 arithmetic, one rounding to the type.
//
// Bound: bytes — alpha, g and the index read once, dlogits written once.
// In random edge order each slot's rows are random reads (16 bytes each at
// H = 4 fp32) and its output a random write: 32-byte sectors.
//
// Design: K9's walk (csrc/gigl_softmax.cuh): a group of G lanes per segment
// (16 for up to 4 heads, a warp above), lane l taking the slots lo + l +
// G k. A lane loads each of its slots' whole alpha and g rows once, in
// words of up to 16 bytes, keeps them in registers, adds the per-head
// products alpha * g with fmaf into its partials, reduces them within its
// group, and writes each dlogits row with one store. A segment longer
// than the group's registers hold puts its warp on two passes (the sums,
// then the writes), each reading the slot's rows once; head counts other
// than 1, 2, 4, 8 and 16 and unaligned rows take those passes a value at a
// time. Over a working set past the L2 the narrow rows are read
// evict-first (ops/segment.py _softmax_streams).
//
// The bits are the first version's (a warp a segment, lane L the slots lo
// + L + 32u, fmaf in slot order, an xor butterfly 16, 8, 4, 2, 1): every
// group width and both forms give them, as gigl_softmax.cuh describes, and
// the same result on every run. At most kMaxHeads heads, held in registers.
#include "gigl_softmax.cuh"

namespace {

using namespace gigl::softmax;

constexpr int kMaxHeads = 16;
constexpr int kThreads = 256;

// The two-pass form for one segment [lo, hi) of lane l's group: the sums
// of alpha * g, then the writes, each pass reading the slot's alpha and g
// rows once (H > 0: the [H] rows as words; H == 0: `heads` values, one at
// a time).
template <typename T, int H, int G, bool STREAM>
__device__ void softmax_bwd_passes(const T* __restrict__ alpha,
                                   const T* __restrict__ g,
                                   const int32_t* __restrict__ order,
                                   T* __restrict__ out, int32_t lo,
                                   int32_t hi, int l, int heads) {
  constexpr int NH = H > 0 ? H : kMaxHeads;
  constexpr int kT = kWarp / G;
  const T* const tables[2] = {alpha, g};
  const int nh = H > 0 ? H : heads;
  float x[kT][NH], dot[NH];
#pragma unroll
  for (int t = 0; t < kT; ++t) {
#pragma unroll
    for (int h = 0; h < NH; ++h) x[t][h] = 0.f;
  }
  walk_rows<T, H, G, NH, 2, STREAM>(
      tables, order, lo, hi, l, heads, 0, nh,
      [&](int k, int64_t, const float (*v)[NH]) {
#pragma unroll
        for (int h = 0; h < NH; ++h)
          x[k % kT][h] = fmaf(v[0][h], v[1][h], x[k % kT][h]);
      });
  group_sum<G, NH>(x, dot);
  walk_rows<T, H, G, NH, 2, STREAM>(
      tables, order, lo, hi, l, heads, 0, nh,
      [&](int, int64_t e, const float (*v)[NH]) {
        float d[NH];
#pragma unroll
        for (int h = 0; h < NH; ++h) d[h] = v[0][h] * (v[1][h] - dot[h]);
        store_heads<T, H, NH>(out, e, heads, 0, nh, d);
      });
}

// One group of G lanes per segment, 32 / G segments a warp. H: the heads
// (1, 2, 4, 8 or 16; rows aligned), or 0 for any other count (`heads`),
// which takes the two-pass form alone.
template <typename T, int H, int G, bool STREAM>
__global__ void segment_softmax_bwd_kernel(const T* __restrict__ alpha,
                                           const T* __restrict__ g,
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
      const T* const tables[2] = {alpha, g};
      int64_t e[K];
      float v[K][2][H], x[kT][H], dot[H];
      load_slots<T, H, G, K, 2, STREAM>(tables, order, lo, hi, l, e, v);
#pragma unroll
      for (int t = 0; t < kT; ++t) {
#pragma unroll
        for (int h = 0; h < H; ++h) x[t][h] = 0.f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h)
          x[k % kT][h] = fmaf(v[k][0][h], v[k][1][h], x[k % kT][h]);
      }
      group_sum<G, H>(x, dot);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (e[k] < 0) continue;
#pragma unroll
        for (int h = 0; h < H; ++h)
          v[k][0][h] = v[k][0][h] * (v[k][1][h] - dot[h]);
        store_row<T, H>(out + e[k] * H, v[k][0]);
      }
      return;
    }
  }
  softmax_bwd_passes<T, H, G, STREAM>(alpha, g, order, out, lo, hi, l,
                                      heads);
}

template <typename T, int H, int G, bool STREAM>
void launch_form(const void* alpha, const void* g, const int32_t* order,
                 const int32_t* ptr, void* out, long long s, int heads,
                 cudaStream_t st) {
  segment_softmax_bwd_kernel<T, H, G, STREAM>
      <<<group_blocks<G>(s, kThreads), kThreads, 0, st>>>(
          static_cast<const T*>(alpha), static_cast<const T*>(g), order, ptr,
          static_cast<T*>(out), s, heads);
}

// Rows of a whole sector and more are written whole, and never stream.
template <typename T, int H>
void launch_heads(const void* alpha, const void* g, const int32_t* order,
                  const int32_t* ptr, void* out, long long s, int stream,
                  cudaStream_t st) {
  constexpr int G = group_lanes<H>();
  if constexpr (H * sizeof(T) < 32) {
    if (stream) {
      launch_form<T, H, G, true>(alpha, g, order, ptr, out, s, H, st);
      return;
    }
  }
  launch_form<T, H, G, false>(alpha, g, order, ptr, out, s, H, st);
}

template <typename T>
void launch(const void* alpha, const void* g, const int32_t* order,
            const int32_t* ptr, void* out, long long s, int heads, int vec,
            int stream, cudaStream_t st) {
  switch (vec ? heads : 0) {  // unaligned rows: one value at a time
    case 1:
      launch_heads<T, 1>(alpha, g, order, ptr, out, s, stream, st);
      break;
    case 2:
      launch_heads<T, 2>(alpha, g, order, ptr, out, s, stream, st);
      break;
    case 4:
      launch_heads<T, 4>(alpha, g, order, ptr, out, s, stream, st);
      break;
    case 8:
      launch_heads<T, 8>(alpha, g, order, ptr, out, s, stream, st);
      break;
    case 16:
      launch_heads<T, 16>(alpha, g, order, ptr, out, s, stream, st);
      break;
    default:
      launch_form<T, 0, kWarp, false>(alpha, g, order, ptr, out, s, heads,
                                      st);
  }
}

}  // namespace

// alpha, g and out [E, heads] (fp32: dtype 0, bf16: 1), order [E] and ptr
// [S + 1] int32 (the destination SegmentIndex); 1 <= heads <= 16; vec: 1
// when alpha, g and out are 16-byte aligned; stream: 1 to read alpha, g
// and order with evict-first loads (rows narrower than 32 bytes only).
extern "C" int gigl_segment_softmax_bwd(const void* alpha, const void* g,
                                        const void* order, const void* ptr,
                                        void* out, long long s, int heads,
                                        int dtype, int vec, int stream_loads,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || heads > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return 0;
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  if (dtype == 0) {
    launch<float>(alpha, g, ov, pv, out, s, heads, vec, stream_loads, st);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(alpha, g, ov, pv, out, s, heads, vec, stream_loads,
                          st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
