// K10 sddmm — replaces gigl_tpu/ops/segment.py sddmm (:90-103): the
// sampled dense-dense product, one score per edge and head:
//   out[e, h] = scale[h] * <q[dst[e], h, :], k[src[e], h, :]>
// q [N_dst, H * dk], k [N_src, H * dk] (fp32 or bf16, head-major rows),
// src and dst [E] int32, scale fp32 [H] or NULL (1): HGT's prior / sqrt(dk)
// per head rides along. fp32 arithmetic, one rounding to q's type.
//
// Bound: bytes — each distinct q and k row the edges read once, the ids
// once, [E, H] written. The edges come in any order (the COO graphs' are
// random), so an edge-order pass gathers two random rows an edge, 2 E
// rows from tables larger than the L2. Design, by row width:
//   - rows of kWalkRowBytes and more: a walk of the destination
//     SegmentIndex (order, ptr) by walk_segments of gigl_segment.cuh, a
//     slot group of lanes per destination segment (a warp from 4 heads x
//     32 fp32 up), which loads q[s] into registers once, by the lane map
//     of gigl_attention.cuh, and gathers only k[src[e]] for each of its
//     edges (E rows, half the bytes), the next edges' pieces issued ahead
//     of the current dot products; the head's first lane writes scale[h]
//     times the head's sum to out[e, h], e = order[j], so the output stays
//     in the caller's edge order: a scattered write of H values an edge;
//   - narrower rows: a slot group of lanes an edge in the edges' own order
//     (8 edges a warp at 4 heads x 4 fp32; persistent warps), both rows
//     gathered and the scores written in order. There the tables sit in
//     the L2, so the walk's halved gathers buy nothing, while its
//     scattered writes and random src[e] reads cost 3x the edge-order
//     pass at 4 x 4 fp32, and a hub segment serialises on one group
//     (PERF.md has the crossover, measured between 256 and 512 bytes).
// A head's sum is an xor butterfly inside its lanes (a fixed order) in
// both forms. Shapes without a lane map (heads whose bytes are not a
// multiple of 4, tables not 4-byte aligned, rows wider than 128 virtual
// lanes) take the first version's scalar code, a thread per (edge, head)
// in edge order. The launcher chooses by shape.
#include "gigl_segment.cuh"

namespace {

using namespace gigl::seg;

// Rows of at least this many bytes take the walk; narrower ones the edge
// order (see the note above).
constexpr int kWalkRowBytes = 512;

// The walk's per-segment work: q[s] into registers at begin, each edge's
// per-head dot products with its k row, scaled, written to out[e, h].
template <typename T, int PW, int K>
struct ScoreBody {
  static constexpr int V = PW / sizeof(T);
  const T* __restrict__ q;
  T* __restrict__ out;
  const LaneMap& m;
  const LanePieces<V, K>& lp;
  float sc[K];
  float qv[K][V];

  __device__ __forceinline__ ScoreBody(const T* q_, const float* scale,
                                       T* out_, const LaneMap& m_,
                                       const LanePieces<V, K>& lp_)
      : q(q_), out(out_), m(m_), lp(lp_) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      sc[kk] = scale != nullptr && lp.live[kk] ? __ldg(scale + lp.h[kk])
                                               : 1.f;
  }

  __device__ __forceinline__ void begin(int64_t s, Bounds b) {
    if (b.lo == b.hi) return;  // the same in the group's lanes
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      if (lp.live[kk]) {
        load_vals<T, PW>(q + s * m.hd + lp.e0[kk], qv[kk]);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) qv[kk][u] = 0.f;
      }
    }
  }

  template <int D>
  __device__ __forceinline__ void edges(const EdgeBatch<D, K, PW / 4>& b) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        float kv[V];
        unpack<T, PW>(b.xr[d][kk], kv);
        a[kk] = 0.f;
#pragma unroll
        for (int u = 0; u < V; ++u) a[kk] = fmaf(qv[kk][u], kv[u], a[kk]);
      }
      head_sum<K>(a, m.sp);
      if (!b.ok[d]) continue;
      const int64_t e = b.e[d];
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
        if (lp.lead[kk])
          out[e * m.heads + lp.h[kk]] = gigl::from_float<T>(a[kk] * sc[kk]);
    }
  }

  __device__ __forceinline__ void end(int64_t, Bounds) {}
};

template <typename T, int PW, int K>
__global__ void __launch_bounds__(kThreads) sddmm_walk(
    const T* __restrict__ q, const T* __restrict__ k,
    const int32_t* __restrict__ src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ ptr, const float* __restrict__ scale,
    T* __restrict__ out, int64_t segments, LaneMap m) {
  const LanePieces<PW / sizeof(T), K> lp(m, threadIdx.x & 31);
  ScoreBody<T, PW, K> body(q, scale, out, m, lp);
  constexpr int D = kSegDepth / K > 0 ? kSegDepth / K : 1;
  walk_segments<T, PW, K, D>(order, src, ptr, segments, m, lp, k, body);
}

template <typename T>
__global__ void sddmm_scalar_kernel(const T* __restrict__ q,
                                    const T* __restrict__ k,
                                    const int32_t* __restrict__ src,
                                    const int32_t* __restrict__ dst,
                                    const float* __restrict__ scale,
                                    T* __restrict__ out, int64_t e, int c,
                                    int heads) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= e * heads) return;
  const int64_t edge = i / heads;
  const int h = static_cast<int>(i - edge * heads);
  const int dk = c / heads;
  const T* qr = q + static_cast<int64_t>(__ldg(dst + edge)) * c + h * dk;
  const T* kr = k + static_cast<int64_t>(__ldg(src + edge)) * c + h * dk;
  float acc = 0.f;
  for (int t = 0; t < dk; ++t)
    acc = fmaf(gigl::to_float(qr[t]), gigl::to_float(kr[t]), acc);
  if (scale != nullptr) acc *= __ldg(scale + h);
  out[i] = gigl::from_float<T>(acc);
}

// Rows narrower than kWalkRowBytes: a slot group of m.ls lanes an edge, in
// the edges' own order, both rows gathered (see the note above).
template <typename T, int PW, int K>
__global__ void __launch_bounds__(kThreads) sddmm_edges(
    const T* __restrict__ q, const T* __restrict__ k,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst,
    const float* __restrict__ scale, T* __restrict__ out, int64_t e,
    LaneMap m) {
  constexpr int V = PW / sizeof(T);
  const int lane = threadIdx.x & 31;
  const LanePieces<V, K> lp(m, lane);
  float sc[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk)
    sc[kk] = scale != nullptr && lp.live[kk] ? __ldg(scale + lp.h[kk])
                                             : 1.f;
  const int epw = 32 / m.ls;  // edges a warp
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t e0 = warp0 * epw; e0 < e; e0 += nwarps * epw) {
    const int64_t i = e0 + lane / m.ls;
    const bool ok = i < e;  // every lane takes part in the head sums
    const int64_t qi = ok ? __ldg(dst + i) : 0;
    const int64_t ki = ok ? __ldg(src + i) : 0;
    float a[K];
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      a[kk] = 0.f;
      if (!ok || !lp.live[kk]) continue;
      float qv[V], kv[V];
      load_vals<T, PW>(q + qi * m.hd + lp.e0[kk], qv);
      load_vals<T, PW>(k + ki * m.hd + lp.e0[kk], kv);
#pragma unroll
      for (int u = 0; u < V; ++u) a[kk] = fmaf(qv[u], kv[u], a[kk]);
    }
    head_sum<K>(a, m.sp);
    if (!ok) continue;
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      if (lp.lead[kk])
        out[i * m.heads + lp.h[kk]] = gigl::from_float<T>(a[kk] * sc[kk]);
  }
}

template <typename T>
struct Args {
  const T *q, *k;
  const int32_t *src, *dst, *order, *ptr;
  const float* scale;
  T* out;
  long long e, segments;
};

template <typename T, int PW, int K>
void launch_form(const Args<T>& a, const LaneMap& m, bool walk,
                 cudaStream_t stream) {
  if (walk) {
    auto kernel = sddmm_walk<T, PW, K>;
    kernel<<<walk_grid(kernel, a.segments, m), kThreads, 0, stream>>>(
        a.q, a.k, a.src, a.order, a.ptr, a.scale, a.out, a.segments, m);
  } else {
    auto kernel = sddmm_edges<T, PW, K>;
    kernel<<<walk_grid(kernel, a.e, m), kThreads, 0, stream>>>(
        a.q, a.k, a.src, a.dst, a.scale, a.out, a.e, m);
  }
}

template <typename T, int PW>
void launch_pw(int kk, const Args<T>& a, const LaneMap& m, bool walk,
               cudaStream_t stream) {
  if (kk == 1)
    launch_form<T, PW, 1>(a, m, walk, stream);
  else if (kk == 2)
    launch_form<T, PW, 2>(a, m, walk, stream);
  else
    launch_form<T, PW, 4>(a, m, walk, stream);
}

template <typename T>
int launch(const Args<T>& a, int c, int heads, cudaStream_t stream) {
  // a lane map's forms wherever one exists (the shape decides): the walk
  // for rows of kWalkRowBytes and more, the edge order below
  const int dk = c / heads;
  LaneMap m;
  const int pw = piece_bytes(dk * static_cast<int>(sizeof(T)), {a.q, a.k});
  const int kk =
      dk > 0 ? make_lane_map(heads, dk, sizeof(T), pw, 1, &m) : 0;
  if (kk != 0) {
    const bool walk = c * static_cast<int>(sizeof(T)) >= kWalkRowBytes;
    if (walk && (a.order == nullptr || a.ptr == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    if (walk && a.segments == 0) return 0;
    if (pw == 16)
      launch_pw<T, 16>(kk, a, m, walk, stream);
    else if (pw == 8)
      launch_pw<T, 8>(kk, a, m, walk, stream);
    else
      launch_pw<T, 4>(kk, a, m, walk, stream);
    return 0;
  }
  const int threads = 256;
  const long long total = a.e * heads;
  const unsigned blocks =
      static_cast<unsigned>((total + threads - 1) / threads);
  sddmm_scalar_kernel<T><<<blocks, threads, 0, stream>>>(
      a.q, a.k, a.src, a.dst, a.scale, a.out, a.e, c, heads);
  return 0;
}

}  // namespace

// q [segments, C], k [N_src, C], src / dst [E] int32, order [E] and ptr
// [segments + 1] int32 (the SegmentIndex of dst over q's rows: the walk
// reads the destinations from it alone, never from dst) or NULL where the
// row width takes no walk (C * the element size below kWalkRowBytes),
// scale fp32 [heads] or NULL, out [E, heads]; C = heads * dk. dtype: 0 =
// fp32, 1 = bf16.
extern "C" int gigl_sddmm(const void* q, const void* k, const void* src,
                          const void* dst, const void* order, const void* ptr,
                          const void* scale, void* out, long long e,
                          long long segments, int c, int heads, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || c % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  const int32_t* i32[4] = {static_cast<const int32_t*>(src),
                           static_cast<const int32_t*>(dst),
                           static_cast<const int32_t*>(order),
                           static_cast<const int32_t*>(ptr)};
  const float* sc = static_cast<const float*>(scale);
  int rc;
  if (dtype == 0) {
    const Args<float> a{static_cast<const float*>(q),
                        static_cast<const float*>(k), i32[0], i32[1], i32[2],
                        i32[3], sc, static_cast<float*>(out), e, segments};
    rc = launch<float>(a, c, heads, st);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    const Args<B> a{static_cast<const B*>(q), static_cast<const B*>(k),
                    i32[0], i32[1], i32[2], i32[3], sc, static_cast<B*>(out),
                    e, segments};
    rc = launch<B>(a, c, heads, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
