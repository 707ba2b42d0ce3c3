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
// coalesced 16-byte loads and an edge's id, dst and weight are broadcast
// loads for the row's threads; rows that are not 16-byte multiples take
// the same loop one element per thread. A hub source is walked by its row's
// threads alone. fp32 accumulation, one rounding to the output type.
#include "gigl_pieces.cuh"

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kMax = 2;

template <typename T, int P, int OP>
__global__ void segment_reduce_bwd_kernel(
    const T* __restrict__ g, const float* __restrict__ gs,
    const float* __restrict__ mref, const T* __restrict__ x,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ order,
    const int32_t* __restrict__ ptr, const int32_t* __restrict__ dst_ptr,
    const float* __restrict__ w, T* __restrict__ out, int64_t rows, int c,
    int wc, int w_cols) {
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
  const int64_t lo = order != nullptr ? __ldg(ptr + r) : r;
  const int64_t hi = order != nullptr ? __ldg(ptr + r + 1) : r + 1;
  for (int64_t j = lo; j < hi; ++j) {
    const int64_t e = order != nullptr ? __ldg(order + j) : j;
    const int64_t d = __ldg(dst + e);
    const float wt = w != nullptr ? __ldg(w + e * w_cols + wcol) : 1.f;
    if (OP == kMax) {
      const int64_t o = d * c + col;
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (xr[k] * wt == __ldg(mref + o + k)) acc[k] += __ldg(gs + o + k) * wt;
    } else {
      float gv[P];
      gigl::load_piece<T, P>(g + d * c + col, gv);
      float cn = 1.f;
      if (OP == kMean) {
        const int32_t cnt = __ldg(dst_ptr + d + 1) - __ldg(dst_ptr + d);
        cn = gigl::to_float(gigl::from_float<T>(
            static_cast<float>(cnt > 1 ? cnt : 1)));  // the forward's count
      }
#pragma unroll
      for (int k = 0; k < P; ++k) acc[k] += gv[k] / cn * wt;
    }
  }
  gigl::store_piece<T, P>(out + r * c + col, acc);
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

template <typename T, int P>
int launch_bwd(const void* g, const void* gs, const void* mref,
               const void* x, const void* dst, const void* order,
               const void* ptr, const void* dst_ptr, const void* w,
               void* out, long long rows, int c, int wc, int w_cols, int op,
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
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  const int32_t* dpv = static_cast<const int32_t*>(dst_ptr);
  const float* wv = static_cast<const float*>(w);
  T* outv = static_cast<T*>(out);
  switch (op) {
    case kSum:
      segment_reduce_bwd_kernel<T, P, kSum><<<blocks, threads, 0, stream>>>(
          gv, gsv, mv, xv, dv, ov, pv, dpv, wv, outv, rows, c, wc, w_cols);
      break;
    case kMean:
      segment_reduce_bwd_kernel<T, P, kMean><<<blocks, threads, 0, stream>>>(
          gv, gsv, mv, xv, dv, ov, pv, dpv, wv, outv, rows, c, wc, w_cols);
      break;
    case kMax:
      segment_reduce_bwd_kernel<T, P, kMax><<<blocks, threads, 0, stream>>>(
          gv, gsv, mv, xv, dv, ov, pv, dpv, wv, outv, rows, c, wc, w_cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
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
// row r is edge r, R = E), dst_ptr [S + 1] (mean only: the destination
// index's pointers), w fp32 [E, w_cols] or NULL, out [R, C]. op: 0 = sum,
// 1 = mean, 2 = max; vec: 1 when C * sizeof(T) and wc * sizeof(T) are
// multiples of 16 and g, x and out are 16-byte aligned.
extern "C" int gigl_segment_reduce_bwd(const void* g, const void* gs,
                                       const void* mref, const void* x,
                                       const void* dst, const void* order,
                                       const void* ptr, const void* dst_ptr,
                                       const void* w, void* out,
                                       long long rows, int c, int wc,
                                       int w_cols, int dtype, int op, int vec,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wc <= 0 || c % wc != 0) return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (dtype == 0) {
    rc = vec ? launch_bwd<float, 4>(g, gs, mref, x, dst, order, ptr, dst_ptr,
                                    w, out, rows, c, wc, w_cols, op, st)
             : launch_bwd<float, 1>(g, gs, mref, x, dst, order, ptr, dst_ptr,
                                    w, out, rows, c, wc, w_cols, op, st);
  } else if (dtype == 1) {
    rc = vec ? launch_bwd<__nv_bfloat16, 8>(g, gs, mref, x, dst, order, ptr,
                                            dst_ptr, w, out, rows, c, wc,
                                            w_cols, op, st)
             : launch_bwd<__nv_bfloat16, 1>(g, gs, mref, x, dst, order, ptr,
                                            dst_ptr, w, out, rows, c, wc,
                                            w_cols, op, st);
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
