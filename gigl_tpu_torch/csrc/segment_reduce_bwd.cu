// K8b segment_reduce_bwd — replaces the backward that jax's autodiff gives
// gigl_tpu/ops/segment.py segment_sum, segment_mean and segment_max
// (:20-48) and coo_spmm (:64-87): the cotangent of the reduced table x.
//
// For out[s] = reduce_{e: dst[e] = s} w(e, j) * row(e)[j] (K8), with row(e)
// = x[src[e]] (coo_spmm) or x[e] (the segment_* functions):
//   dx[r, j] = sum_{e: row(e) = r} w(e, j) * c(e, j) * g[dst[e], j]
// where c = 1 (sum), 1 / count(dst[e]) (mean: the forward's count, rounded
// to the data's type, at least 1) or, for max, the tie share: 1 / ties
// when w(e, j) * x[r, j] equals the segment's maximum, else 0 (jax.vjp of
// jax.ops.segment_max shares the cotangent among ties; a segment whose
// maximum is not finite, such as an empty one, passes nothing).
//
// A gather (coo_spmm) walks a source-sorted SegmentIndex (ops/segment.py:
// the same stable sort applied to src): order[ptr[r]:ptr[r + 1]] are the
// edges that read row r, and each output row is the sum of the cotangent
// rows of their destinations — a K8-style gather-reduce over the transpose,
// so each output row is written once, with no atomics and the same bits on
// every run. Without a gather, output row r is edge r's own row: dx[e] =
// w * c * g[dst[e]], a row gather. For max, a first launch walks the
// destination index (the forward's): per (segment, value) it takes the
// maximum again, counts the ties and writes the maximum and the shared
// cotangent g / ties (0 where the maximum is not finite) as fp32 tables.
//
// Bound: bytes — each output row written once, the cotangent rows read once
// per edge (a gather: rows of the destinations, L2-resident at the flagship
// size), the index, dst ids and weights once. Design: as K8, one thread per
// 16-byte piece of an output row (4 fp32 or 8 bf16 values), consecutive
// threads across the row, so the gathered cotangent rows are read as
// coalesced 16-byte loads and an edge's ids and weight are broadcast loads
// for the row's threads; rows that are not 16-byte multiples take the same
// loop one element per thread. A hub source is walked by its row's threads
// alone. fp32 accumulation, one rounding to the output type.
//
// The destination a slot reads is known once the graph is: the first
// version read order[j], then dst[e] (a random 4-byte read from the [E]
// ids) and only then the cotangent row, three dependent loads a slot (the
// mean two more, dst_ptr[d] and dst_ptr[d + 1]). A source index built with
// the destination ids as its gather (SegmentIndex.from_ids(src, n,
// gather=dst)) holds gathered = dst[order], composed on the host in walk
// order, and the composed mode (COMPOSED, the wrapper's choice when the
// segment ids are the tensor the index was built from) reads gathered[j],
// a sequential id, then the row, and the mean's pointers beside it; the
// weights are still read through order[j], but the row load no longer
// waits on them. The chained mode (any other ids) is the same kernel with
// the first version's chain. Each thread of the composed mode keeps
// kSlotsInFlight slots in flight: their ids, rows, counts and weights are
// loaded before any is added, and they are added in slot order, so the
// sums round as the first version's, bit for bit; the chained mode keeps
// one, as K8's does. The sum and the weighted sum no longer divide each
// value by the count 1 (x / 1 is x, but the compiler kept the division,
// PERF.md §6); the mean keeps its division, the rounding both the first
// version and the reference take.
//
// Two modes for the COO per-edge terms (sum, over a source walk):
//   gine   dx[r, j] = sum_e w * 1[x[r, j] + ea[e, j] > 0] * g[dst[e], j]
//          (GINEConv.coo's relu(x[src] + ea) gate, strict: jax.nn.relu's
//          derivative is 0 at 0); x is the forward's [R, C] rows, ea the
//          [E, C] edge rows read at each slot's edge id e = order[j]
//          (a random read: the source walk visits the edges out of order);
//   gatv2  dhs[r, j] = sum_e leaky'(hs[r, j] + hd[dst[e], j]) * w(e, j) *
//          att[j] (the backward of GATv2's logits att . leaky(hs[src] +
//          hd[dst]) into the source table: x = hs, g = hd, w = the logits'
//          cotangent [E, heads], leaky'(z) = 1 at z >= 0, else the slope).
// Both read the source row x[r] once, before the walk.
#include <type_traits>

#include "gigl_pieces.cuh"

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kMax = 2;
// modes beside the reduces' (the COO per-edge terms)
constexpr int kModeReduce = 0;
constexpr int kModeGine = 1;
constexpr int kModeGatv2 = 2;
// Slots a thread of the composed mode keeps in flight.
constexpr int kSlotsInFlight = 4;

template <typename T, int P, int OP, bool COMPOSED>
__global__ void segment_reduce_bwd_kernel(
    const T* __restrict__ g, const float* __restrict__ gs,
    const float* __restrict__ mref, const T* __restrict__ x,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ order,
    const int32_t* __restrict__ gathered, const int32_t* __restrict__ ptr,
    const int32_t* __restrict__ dst_ptr, const float* __restrict__ w,
    T* __restrict__ out, int64_t rows, int c, int wc, int w_cols) {
  constexpr int K = COMPOSED ? kSlotsInFlight : 1;
  const int pieces = c / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * pieces) return;
  const int64_t r = i / pieces;
  const int col = static_cast<int>(i - r * pieces) * P;
  const int wcol = col / wc;
  float acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k) acc[k] = 0.f;
  float xr[P];
  if (OP == kMax) gigl::load_piece<T, P>(x + r * c + col, xr);
  // source walk, or the row's own edge when there is no gather
  const int32_t lo =
      order != nullptr ? __ldg(ptr + r) : static_cast<int32_t>(r);
  const int32_t hi = order != nullptr ? __ldg(ptr + r + 1) : lo + 1;
  // slot j's destination and, with weights, its edge id
  auto dst_of = [&](int32_t j, int64_t& e) -> int64_t {
    if constexpr (COMPOSED) {
      if (w != nullptr) e = __ldg(order + j);
      return __ldg(gathered + j);
    } else {
      e = order != nullptr ? __ldg(order + j) : j;
      return __ldg(dst + e);
    }
  };
  // the forward's count of destination d, in T, at least 1
  auto count_of = [&](int64_t d) -> float {
    const int32_t cnt = __ldg(dst_ptr + d + 1) - __ldg(dst_ptr + d);
    return gigl::to_float(
        gigl::from_float<T>(static_cast<float>(cnt > 1 ? cnt : 1)));
  };
  // K slots' loads (destinations, then rows, counts and weights), then
  // their sums in slot order
  auto slots = [&](int32_t j, auto k_slots) {
    constexpr int KS = decltype(k_slots)::value;
    int64_t e[KS] = {}, d[KS];
    float v[KS][P], m[KS][P], cn[KS], wt[KS];
#pragma unroll
    for (int q = 0; q < KS; ++q) d[q] = dst_of(j + q, e[q]);
#pragma unroll
    for (int q = 0; q < KS; ++q) {
      const int64_t o = d[q] * c + col;
      if (OP == kMax) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          m[q][k] = __ldg(mref + o + k);
          v[q][k] = __ldg(gs + o + k);
        }
      } else {
        gigl::load_piece<T, P>(g + o, v[q]);
      }
      if (OP == kMean) cn[q] = count_of(d[q]);
    }
#pragma unroll
    for (int q = 0; q < KS; ++q)
      wt[q] = w != nullptr ? __ldg(w + e[q] * w_cols + wcol) : 1.f;
#pragma unroll
    for (int q = 0; q < KS; ++q) {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (OP == kMax) {
          if (xr[k] * wt[q] == m[q][k]) acc[k] += v[q][k] * wt[q];
        } else if (OP == kMean) {
          acc[k] += v[q][k] / cn[q] * wt[q];
        } else {  // the first version's v / 1 * wt, without the division
          acc[k] += v[q][k] * wt[q];
        }
      }
    }
  };
  int32_t j = lo;
  for (; j + K <= hi; j += K) slots(j, std::integral_constant<int, K>{});
  for (; j < hi; ++j) slots(j, std::integral_constant<int, 1>{});
  gigl::store_piece<T, P>(out + r * c + col, acc);
}

// The gine and gatv2 modes (see the note above): a source walk, the row's
// x piece read once, one slot at a time.
template <typename T, int P, int MODE, bool COMPOSED>
__global__ void segment_edge_bwd_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ order,
    const int32_t* __restrict__ gathered, const int32_t* __restrict__ ptr,
    const float* __restrict__ w, const T* __restrict__ ea,
    const float* __restrict__ att, float slope, T* __restrict__ out,
    int64_t rows, int c, int wc, int w_cols) {
  const int pieces = c / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= rows * pieces) return;
  const int64_t r = i / pieces;
  const int col = static_cast<int>(i - r * pieces) * P;
  const int wcol = col / wc;
  float xr[P], at[P], acc[P];
  gigl::load_piece<T, P>(x + r * c + col, xr);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    acc[k] = 0.f;
    at[k] = MODE == kModeGatv2 ? __ldg(att + col + k) : 1.f;
  }
  const int32_t lo = __ldg(ptr + r);
  const int32_t hi = __ldg(ptr + r + 1);
  for (int32_t j = lo; j < hi; ++j) {
    const int64_t e = __ldg(order + j);
    const int64_t d = COMPOSED ? __ldg(gathered + j) : __ldg(dst + e);
    float v[P];
    gigl::load_piece<T, P>(g + d * c + col, v);
    const float wt = w != nullptr ? __ldg(w + e * w_cols + wcol) : 1.f;
    if constexpr (MODE == kModeGine) {
      float ev[P];
      gigl::load_piece<T, P>(ea + e * c + col, ev);
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (xr[k] + ev[k] > 0.f) acc[k] += v[k] * wt;
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float dz = wt * at[k];
        acc[k] += xr[k] + v[k] >= 0.f ? dz : slope * dz;
      }
    }
  }
  gigl::store_piece<T, P>(out + r * c + col, acc);
}

template <typename T, int P>
int launch_edge_bwd(const void* g, const void* x, const void* dst,
                    const void* order, const void* gathered, const void* ptr,
                    const void* w, const void* ea, const void* att,
                    float slope, void* out, long long rows, int c, int wc,
                    int w_cols, int mode, cudaStream_t stream) {
  if (x == nullptr || order == nullptr || ptr == nullptr ||
      (gathered == nullptr && dst == nullptr) ||
      (mode == kModeGine && ea == nullptr) ||
      (mode == kModeGatv2 && (att == nullptr || w == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = rows * (c / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  auto run = [&](auto kernel) {
    kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x),
        static_cast<const int32_t*>(dst), static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(gathered),
        static_cast<const int32_t*>(ptr), static_cast<const float*>(w),
        static_cast<const T*>(ea), static_cast<const float*>(att), slope,
        static_cast<T*>(out), rows, c, wc, w_cols);
  };
  const bool composed = gathered != nullptr;
  if (mode == kModeGine) {
    if (composed) run(segment_edge_bwd_kernel<T, P, kModeGine, true>);
    else run(segment_edge_bwd_kernel<T, P, kModeGine, false>);
  } else if (mode == kModeGatv2) {
    if (composed) run(segment_edge_bwd_kernel<T, P, kModeGatv2, true>);
    else run(segment_edge_bwd_kernel<T, P, kModeGatv2, false>);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// Per (segment, value): the maximum of w * row over the segment's edges
// (fp32, as K8 takes it), the number of edges that reach it, and the
// cotangent's share g / ties (0 where the maximum is not finite).
template <typename T, int P>
__global__ void segment_max_ties_kernel(
    const T* __restrict__ g, const T* __restrict__ x,
    const int32_t* __restrict__ gather, const int32_t* __restrict__ order,
    const int32_t* __restrict__ ptr, const float* __restrict__ w,
    float* __restrict__ mref, float* __restrict__ gs, int64_t s, int c,
    int wc, int w_cols) {
  const int pieces = c / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s * pieces) return;
  const int64_t seg = i / pieces;
  const int col = static_cast<int>(i - seg * pieces) * P;
  const int wcol = col / wc;
  const int32_t lo = __ldg(ptr + seg);
  const int32_t hi = __ldg(ptr + seg + 1);
  float m[P], cnt[P], v[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    m[k] = -__int_as_float(0x7f800000);
    cnt[k] = 0.f;
  }
  for (int pass = 0; pass < 2; ++pass) {
    for (int32_t j = lo; j < hi; ++j) {
      const int64_t e = __ldg(order + j);
      const int64_t r = gather != nullptr ? __ldg(gather + e) : e;
      gigl::load_piece<T, P>(x + r * c + col, v);
      const float wt = w != nullptr ? __ldg(w + e * w_cols + wcol) : 1.f;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float val = v[k] * wt;
        if (pass == 0) m[k] = fmaxf(m[k], val);
        else if (val == m[k]) cnt[k] += 1.f;
      }
    }
  }
  float gv[P];
  gigl::load_piece<T, P>(g + seg * c + col, gv);
#pragma unroll
  for (int k = 0; k < P; ++k) {
    mref[seg * c + col + k] = m[k];
    gs[seg * c + col + k] = isfinite(m[k]) ? gv[k] / cnt[k] : 0.f;
  }
}

template <typename T, int P, bool COMPOSED>
int launch_bwd_mode(const void* g, const void* gs, const void* mref,
                    const void* x, const void* dst, const void* order,
                    const void* gathered, const void* ptr,
                    const void* dst_ptr, const void* w, void* out,
                    long long rows, int c, int wc, int w_cols, int op,
                    cudaStream_t stream) {
  const long long total = rows * (c / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* gv = static_cast<const T*>(g);
  const float* gsv = static_cast<const float*>(gs);
  const float* mv = static_cast<const float*>(mref);
  const T* xv = static_cast<const T*>(x);
  const int32_t* dv = static_cast<const int32_t*>(dst);
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* cv = static_cast<const int32_t*>(gathered);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  const int32_t* dpv = static_cast<const int32_t*>(dst_ptr);
  const float* wv = static_cast<const float*>(w);
  T* outv = static_cast<T*>(out);
  switch (op) {
    case kSum:
      segment_reduce_bwd_kernel<T, P, kSum, COMPOSED>
          <<<blocks, threads, 0, stream>>>(gv, gsv, mv, xv, dv, ov, cv, pv,
                                           dpv, wv, outv, rows, c, wc,
                                           w_cols);
      break;
    case kMean:
      segment_reduce_bwd_kernel<T, P, kMean, COMPOSED>
          <<<blocks, threads, 0, stream>>>(gv, gsv, mv, xv, dv, ov, cv, pv,
                                           dpv, wv, outv, rows, c, wc,
                                           w_cols);
      break;
    case kMax:
      segment_reduce_bwd_kernel<T, P, kMax, COMPOSED>
          <<<blocks, threads, 0, stream>>>(gv, gsv, mv, xv, dv, ov, cv, pv,
                                           dpv, wv, outv, rows, c, wc,
                                           w_cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T, int P>
int launch_bwd(const void* g, const void* gs, const void* mref,
               const void* x, const void* dst, const void* order,
               const void* gathered, const void* ptr, const void* dst_ptr,
               const void* w, void* out, long long rows, int c, int wc,
               int w_cols, int op, cudaStream_t stream) {
  return gathered != nullptr
             ? launch_bwd_mode<T, P, true>(g, gs, mref, x, dst, order,
                                           gathered, ptr, dst_ptr, w, out,
                                           rows, c, wc, w_cols, op, stream)
             : launch_bwd_mode<T, P, false>(g, gs, mref, x, dst, order,
                                            gathered, ptr, dst_ptr, w, out,
                                            rows, c, wc, w_cols, op, stream);
}

template <typename T, int P>
int launch_ties(const void* g, const void* x, const void* gather,
                const void* order, const void* ptr, const void* w,
                void* mref, void* gs, long long s, int c, int wc, int w_cols,
                cudaStream_t stream) {
  const long long total = s * (c / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  segment_max_ties_kernel<T, P><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(x),
      static_cast<const int32_t*>(gather), static_cast<const int32_t*>(order),
      static_cast<const int32_t*>(ptr), static_cast<const float*>(w),
      static_cast<float*>(mref), static_cast<float*>(gs), s, c, wc, w_cols);
  return 0;
}

}  // namespace

// g [S, C] (the cotangent of K8's output, fp32: dtype 0, bf16: 1), gs and
// mref fp32 [S, C] (max only, from gigl_segment_max_ties), x [R, C] (max
// only: the forward's rows, R = the output rows), dst [E] int32, order and
// ptr (the source-sorted SegmentIndex: ptr [R + 1]; both NULL when output
// row r is edge r, R = E), gathered [E] int32 (the source index's
// dst[order]: the composed mode, dst unread) or NULL, dst_ptr [S + 1] (mean
// only: the destination index's pointers), w fp32 [E, w_cols] or NULL, out
// [R, C]. op: 0 = sum, 1 = mean, 2 = max; vec: 1 when C * sizeof(T) and wc
// * sizeof(T) are multiples of 16 and g, x and out are 16-byte aligned
// (and ea). mode: 0 the reduces; 1 gine (op sum, x [R, C] the forward's
// rows, ea [E, C] of g's type); 2 gatv2 (op sum, x = hs [R, C], g = hd
// [S, C], w = the logits' cotangent [E, heads] with wc = dh, att fp32
// [C], slope). Modes 1 and 2 need the source walk.
extern "C" int gigl_segment_reduce_bwd(const void* g, const void* gs,
                                       const void* mref, const void* x,
                                       const void* dst, const void* order,
                                       const void* gathered, const void* ptr,
                                       const void* dst_ptr, const void* w,
                                       void* out, long long rows, int c,
                                       int wc, int w_cols, int dtype, int op,
                                       int vec, int mode, const void* ea,
                                       const void* att, float slope,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wc <= 0 || c % wc != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (gathered != nullptr && order == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kModeReduce && op != kSum)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (mode != kModeReduce) {
    if (dtype == 0) {
      rc = vec ? launch_edge_bwd<float, 4>(g, x, dst, order, gathered, ptr, w,
                                           ea, att, slope, out, rows, c, wc,
                                           w_cols, mode, st)
               : launch_edge_bwd<float, 1>(g, x, dst, order, gathered, ptr, w,
                                           ea, att, slope, out, rows, c, wc,
                                           w_cols, mode, st);
    } else if (dtype == 1) {
      rc = vec ? launch_edge_bwd<__nv_bfloat16, 8>(g, x, dst, order, gathered,
                                                   ptr, w, ea, att, slope,
                                                   out, rows, c, wc, w_cols,
                                                   mode, st)
               : launch_edge_bwd<__nv_bfloat16, 1>(g, x, dst, order, gathered,
                                                   ptr, w, ea, att, slope,
                                                   out, rows, c, wc, w_cols,
                                                   mode, st);
    } else {
      rc = static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (dtype == 0) {
    rc = vec ? launch_bwd<float, 4>(g, gs, mref, x, dst, order, gathered,
                                    ptr, dst_ptr, w, out, rows, c, wc,
                                    w_cols, op, st)
             : launch_bwd<float, 1>(g, gs, mref, x, dst, order, gathered,
                                    ptr, dst_ptr, w, out, rows, c, wc,
                                    w_cols, op, st);
  } else if (dtype == 1) {
    rc = vec ? launch_bwd<__nv_bfloat16, 8>(g, gs, mref, x, dst, order,
                                            gathered, ptr, dst_ptr, w, out,
                                            rows, c, wc, w_cols, op, st)
             : launch_bwd<__nv_bfloat16, 1>(g, gs, mref, x, dst, order,
                                            gathered, ptr, dst_ptr, w, out,
                                            rows, c, wc, w_cols, op, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The max mode's first pass over the destination index (order, ptr [S + 1])
// of K8's forward: g [S, C], x [M, C], gather [E] int32 or NULL, w fp32
// [E, w_cols] or NULL -> mref and gs fp32 [S, C]. vec as above (g and x).
extern "C" int gigl_segment_max_ties(const void* g, const void* x,
                                     const void* gather, const void* order,
                                     const void* ptr, const void* w,
                                     void* mref, void* gs, long long s, int c,
                                     int wc, int w_cols, int dtype, int vec,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wc <= 0 || c % wc != 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == 0) {
    rc = vec ? launch_ties<float, 4>(g, x, gather, order, ptr, w, mref, gs, s,
                                     c, wc, w_cols, st)
             : launch_ties<float, 1>(g, x, gather, order, ptr, w, mref, gs, s,
                                     c, wc, w_cols, st);
  } else if (dtype == 1) {
    rc = vec ? launch_ties<__nv_bfloat16, 8>(g, x, gather, order, ptr, w, mref,
                                             gs, s, c, wc, w_cols, st)
             : launch_ties<__nv_bfloat16, 1>(g, x, gather, order, ptr, w, mref,
                                             gs, s, c, wc, w_cols, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
