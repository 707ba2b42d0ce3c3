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
//
// Two modes for the COO per-edge terms, both over the destination index:
//   addend  out[e, h] = scale[h] * <q[s, h, :], k[src e, h, :] + ea[e, h, :]>
//           (the Transformer's key with its edge row, ea [E, C] of q's
//           type read at e = order[j]: in sequence when the graph's edges
//           are in walk order, as encode_coo puts them);
//   gatv2   out[e, h] = sum_d att[h, d] * leaky(k[src e, h, d] + q[s, h, d])
//           (GATv2's logits: q = hd, k = hs, att fp32 [C], the slope;
//           leaky(z) = z at z >= 0, else slope * z);
//   gatv2 with edge rows: the same with leaky((k[src e, h, d] + ea[e, h,
//           d]) + q[s, h, d]) (GATv2 with use_edge_attr, convs.py:312-328:
//           the edge row joins the source row before the gate), ea read
//           as the addend's.
// Rows of kWalkRowBytes and more with a lane map take the walk above: q[s]
// in registers once a segment (and att's pieces once a lane, gatv2), the
// edge rows of a batch of D edges loaded before its arithmetic (addend).
// Other shapes take a thread per (destination segment, head) that reads
// the head's values in pieces of 16 bytes where they fit (else one at a
// time), each slot's row from gathered[j] (the index's composed src)
// where given, else src[order[j]].
#include "gigl_segment.cuh"

namespace {

using namespace gigl::seg;

// Rows of at least this many bytes take the walk; narrower ones the edge
// order (see the note above).
constexpr int kWalkRowBytes = 512;

// The walk's modes: the scores, the key addend, GATv2's scores.
constexpr int kScores = 0;
constexpr int kAddend = 1;
constexpr int kGatv2 = 2;
constexpr int kGatv2Edge = 3;

// The walk's per-segment work: q[s] into registers at begin, each edge's
// per-head dot products with its k row (plus its edge row; GATv2: att's
// dot with the leaky sum of the two rows), scaled, written to out[e, h].
template <typename T, int PW, int K, int MODE>
struct ScoreBody {
  static constexpr int V = PW / sizeof(T);
  const T* __restrict__ q;
  const T* __restrict__ ea;
  T* __restrict__ out;
  const LaneMap& m;
  const LanePieces<V, K>& lp;
  float slope;
  float sc[K];
  float qv[K][V];
  static constexpr bool kAtt = MODE == kGatv2 || MODE == kGatv2Edge;
  static constexpr bool kEdge = MODE == kAddend || MODE == kGatv2Edge;
  float av[kAtt ? K : 1][V];

  __device__ __forceinline__ ScoreBody(const T* q_, const float* scale,
                                       const T* ea_, const float* att,
                                       float slope_, T* out_,
                                       const LaneMap& m_,
                                       const LanePieces<V, K>& lp_)
      : q(q_), ea(ea_), out(out_), m(m_), lp(lp_), slope(slope_) {
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
      sc[kk] = scale != nullptr && lp.live[kk] ? __ldg(scale + lp.h[kk])
                                               : 1.f;
    if constexpr (kAtt) {
#pragma unroll
      for (int kk = 0; kk < K; ++kk)
#pragma unroll
        for (int u = 0; u < V; ++u)
          av[kk][u] = lp.live[kk] ? __ldg(att + lp.e0[kk] + u) : 0.f;
    }
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
    // the addend: the batch's edge rows, every load issued before the
    // first product
    uint32_t er[kEdge ? D : 1][K][PW / 4];
    if constexpr (kEdge) {
#pragma unroll
      for (int d = 0; d < D; ++d)
#pragma unroll
        for (int kk = 0; kk < K; ++kk) {
#pragma unroll
          for (int u = 0; u < PW / 4; ++u) er[d][kk][u] = 0u;
          if (b.ok[d] && lp.live[kk])
            load_raw<PW>(ea + static_cast<int64_t>(b.e[d]) * m.hd +
                             lp.e0[kk],
                         er[d][kk]);
        }
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float a[K];
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        float kv[V];
        unpack<T, PW>(b.xr[d][kk], kv);
        a[kk] = 0.f;
        if constexpr (MODE == kAddend) {
          float ev[V];
          unpack<T, PW>(er[d][kk], ev);
#pragma unroll
          for (int u = 0; u < V; ++u)
            a[kk] = fmaf(qv[kk][u], kv[u] + ev[u], a[kk]);
        } else if constexpr (MODE == kGatv2) {
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const float z = kv[u] + qv[kk][u];
            a[kk] = fmaf(av[kk][u], z >= 0.f ? z : slope * z, a[kk]);
          }
        } else if constexpr (MODE == kGatv2Edge) {
          float ev[V];
          unpack<T, PW>(er[d][kk], ev);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const float z = (kv[u] + ev[u]) + qv[kk][u];
            a[kk] = fmaf(av[kk][u], z >= 0.f ? z : slope * z, a[kk]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u) a[kk] = fmaf(qv[kk][u], kv[u], a[kk]);
        }
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

template <typename T, int PW, int K, int MODE>
__global__ void __launch_bounds__(kThreads) sddmm_walk(
    const T* __restrict__ q, const T* __restrict__ k,
    const int32_t* __restrict__ src, const int32_t* __restrict__ order,
    const int32_t* __restrict__ ptr, const float* __restrict__ scale,
    const T* __restrict__ ea, const float* __restrict__ att, float slope,
    T* __restrict__ out, int64_t segments, LaneMap m) {
  const LanePieces<PW / sizeof(T), K> lp(m, threadIdx.x & 31);
  ScoreBody<T, PW, K, MODE> body(q, scale, ea, att, slope, out, m, lp);
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

template <typename T, int P, int MODE>
__global__ void sddmm_seg_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ order,
                                 const int32_t* __restrict__ gathered,
                                 const int32_t* __restrict__ ptr,
                                 const float* __restrict__ scale,
                                 const T* __restrict__ ea,
                                 const float* __restrict__ att, float slope,
                                 T* __restrict__ out, int64_t segments, int c,
                                 int heads) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= segments * heads) return;
  const int64_t s = i / heads;
  const int h = static_cast<int>(i - s * heads);
  const int dk = c / heads;
  const int64_t c0 = static_cast<int64_t>(h) * dk;
  const float sc = scale != nullptr ? __ldg(scale + h) : 1.f;
  const int32_t lo = __ldg(ptr + s);
  const int32_t hi = __ldg(ptr + s + 1);
  for (int32_t j = lo; j < hi; ++j) {
    const int64_t e = __ldg(order + j);
    const int64_t r =
        gathered != nullptr ? __ldg(gathered + j) : __ldg(src + e);
    float acc = 0.f;
    for (int t = 0; t < dk; t += P) {
      float qv[P], kv[P];
      gigl::load_piece<T, P>(q + s * c + c0 + t, qv);
      gigl::load_piece<T, P>(k + r * c + c0 + t, kv);
      if constexpr (MODE == kAddend) {
        float ev[P];
        gigl::load_piece<T, P>(ea + e * c + c0 + t, ev);
#pragma unroll
        for (int u = 0; u < P; ++u) acc = fmaf(qv[u], kv[u] + ev[u], acc);
      } else if constexpr (MODE == kGatv2Edge) {
        float ev[P];
        gigl::load_piece<T, P>(ea + e * c + c0 + t, ev);
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float z = (kv[u] + ev[u]) + qv[u];
          acc = fmaf(__ldg(att + c0 + t + u), z >= 0.f ? z : slope * z, acc);
        }
      } else {
#pragma unroll
        for (int u = 0; u < P; ++u) {
          const float z = kv[u] + qv[u];
          acc = fmaf(__ldg(att + c0 + t + u), z >= 0.f ? z : slope * z, acc);
        }
      }
    }
    out[e * heads + h] = gigl::from_float<T>(acc * sc);
  }
}

template <typename T>
struct Args {
  const T *q, *k;
  const int32_t *src, *dst, *order, *ptr;
  const float* scale;
  T* out;
  long long e, segments;
  int mode;       // kScores, kAddend, kGatv2 or kGatv2Edge
  const T* ea;
  const float* att;
  float slope;
};

template <typename T, int PW, int K, int MODE>
void launch_walk(const Args<T>& a, const LaneMap& m, cudaStream_t stream) {
  auto kernel = sddmm_walk<T, PW, K, MODE>;
  kernel<<<walk_grid(kernel, a.segments, m), kThreads, 0, stream>>>(
      a.q, a.k, a.src, a.order, a.ptr, a.scale, a.ea, a.att, a.slope, a.out,
      a.segments, m);
}

template <typename T, int PW, int K>
void launch_form(const Args<T>& a, const LaneMap& m, bool walk,
                 cudaStream_t stream) {
  if (walk) {
    if (a.mode == kAddend)
      launch_walk<T, PW, K, kAddend>(a, m, stream);
    else if (a.mode == kGatv2)
      launch_walk<T, PW, K, kGatv2>(a, m, stream);
    else if (a.mode == kGatv2Edge)
      launch_walk<T, PW, K, kGatv2Edge>(a, m, stream);
    else
      launch_walk<T, PW, K, kScores>(a, m, stream);
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

// The walk for a mode's shapes, or false where it takes none (the modes
// beside the scores then take sddmm_seg_kernel).
template <typename T>
bool launch_mode_walk(const Args<T>& a, int c, int heads,
                      cudaStream_t stream) {
  const int dk = c / heads;
  LaneMap m;
  const int pw = piece_bytes(dk * static_cast<int>(sizeof(T)),
                             {a.q, a.k, a.ea});
  const int kk =
      dk > 0 ? make_lane_map(heads, dk, sizeof(T), pw, 1, &m) : 0;
  if (kk == 0 || c * static_cast<int>(sizeof(T)) < kWalkRowBytes ||
      a.src == nullptr)
    return false;
  if (pw == 16)
    launch_pw<T, 16>(kk, a, m, true, stream);
  else if (pw == 8)
    launch_pw<T, 8>(kk, a, m, true, stream);
  else
    launch_pw<T, 4>(kk, a, m, true, stream);
  return true;
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
// fp32, 1 = bf16. mode: 0 the scores above; 1 addend (ea [E, C] of q's
// type), 2 gatv2 (att fp32 [C], slope; no scale) and 3 gatv2 with edge
// rows (ea, att, slope) need order and ptr at
// every width: the walk (src read through order) where it holds the rows,
// else a thread per (segment, head) reading each slot's row from gathered
// [E] (the index's src[order]) where given, else src; vec: 1 when dk *
// sizeof(T) is a multiple of 16 and q, k and ea are 16-byte aligned (that
// thread's pieces).
extern "C" int gigl_sddmm(const void* q, const void* k, const void* src,
                          const void* dst, const void* order, const void* ptr,
                          const void* scale, void* out, long long e,
                          long long segments, int c, int heads, int dtype,
                          int mode, const void* gathered, const void* ea,
                          const void* att, float slope, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || c % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  if (mode != 0) {
    if (order == nullptr || ptr == nullptr ||
        ((mode == 1 || mode == 3) && ea == nullptr) ||
        ((mode == 2 || mode == 3) && att == nullptr) || mode < 1 ||
        mode > 3 ||
        (gathered == nullptr && src == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long total = segments * heads;
    if (total == 0) return 0;
    using B = __nv_bfloat16;
    const int32_t* ix[4] = {static_cast<const int32_t*>(src),
                            static_cast<const int32_t*>(dst),
                            static_cast<const int32_t*>(order),
                            static_cast<const int32_t*>(ptr)};
    const float* fs = static_cast<const float*>(scale);
    const float* fa = static_cast<const float*>(att);
    bool walked = false;
    if (dtype == 0) {
      const Args<float> a{static_cast<const float*>(q),
                          static_cast<const float*>(k), ix[0], ix[1], ix[2],
                          ix[3], fs, static_cast<float*>(out), e, segments,
                          mode, static_cast<const float*>(ea), fa, slope};
      walked = launch_mode_walk<float>(a, c, heads, st);
    } else if (dtype == 1) {
      const Args<B> a{static_cast<const B*>(q), static_cast<const B*>(k),
                      ix[0], ix[1], ix[2], ix[3], fs, static_cast<B*>(out),
                      e, segments, mode, static_cast<const B*>(ea), fa,
                      slope};
      walked = launch_mode_walk<B>(a, c, heads, st);
    }
    if (walked) return static_cast<int>(cudaGetLastError());
    const int threads = 256;
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    auto run = [&](auto kernel, auto t) {
      using T = decltype(t);
      kernel<<<blocks, threads, 0, st>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const int32_t*>(src),
          static_cast<const int32_t*>(order),
          static_cast<const int32_t*>(gathered),
          static_cast<const int32_t*>(ptr), static_cast<const float*>(scale),
          static_cast<const T*>(ea), static_cast<const float*>(att), slope,
          static_cast<T*>(out), segments, c, heads);
    };
    if (dtype == 0 && mode == 1)
      vec ? run(sddmm_seg_kernel<float, 4, 1>, 0.f)
          : run(sddmm_seg_kernel<float, 1, 1>, 0.f);
    else if (dtype == 0 && mode == 2)
      vec ? run(sddmm_seg_kernel<float, 4, 2>, 0.f)
          : run(sddmm_seg_kernel<float, 1, 2>, 0.f);
    else if (dtype == 0)
      vec ? run(sddmm_seg_kernel<float, 4, 3>, 0.f)
          : run(sddmm_seg_kernel<float, 1, 3>, 0.f);
    else if (dtype == 1 && mode == 1)
      vec ? run(sddmm_seg_kernel<B, 8, 1>, B())
          : run(sddmm_seg_kernel<B, 1, 1>, B());
    else if (dtype == 1 && mode == 2)
      vec ? run(sddmm_seg_kernel<B, 8, 2>, B())
          : run(sddmm_seg_kernel<B, 1, 2>, B());
    else if (dtype == 1)
      vec ? run(sddmm_seg_kernel<B, 8, 3>, B())
          : run(sddmm_seg_kernel<B, 1, 3>, B());
    else
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
  }
  const int32_t* i32[4] = {static_cast<const int32_t*>(src),
                           static_cast<const int32_t*>(dst),
                           static_cast<const int32_t*>(order),
                           static_cast<const int32_t*>(ptr)};
  const float* sc = static_cast<const float*>(scale);
  int rc;
  if (dtype == 0) {
    const Args<float> a{static_cast<const float*>(q),
                        static_cast<const float*>(k), i32[0], i32[1], i32[2],
                        i32[3], sc, static_cast<float*>(out), e, segments,
                        kScores, nullptr, nullptr, 0.f};
    rc = launch<float>(a, c, heads, st);
  } else if (dtype == 1) {
    using B = __nv_bfloat16;
    const Args<B> a{static_cast<const B*>(q), static_cast<const B*>(k),
                    i32[0], i32[1], i32[2], i32[3], sc, static_cast<B*>(out),
                    e, segments, kScores, nullptr, nullptr, 0.f};
    rc = launch<B>(a, c, heads, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
