// K8 segment_reduce — replaces gigl_tpu/ops/segment.py segment_sum,
// segment_mean and segment_max (:20-48) and coo_spmm (:64-87): the gather
// of source rows and their reduce into destination segments.
//
// A SegmentIndex (ops/segment.py, built once per graph on the host) lists
// the edges sorted by segment: order[ptr[s]:ptr[s+1]] are segment s's edge
// ids, in their original order. For every segment s and value column j:
//   out[s, j] = reduce_{e in seg(s)} w(e, j) * row(e)[j]
// with row(e) = x[gather[e]] (coo_spmm) or x[e] (the segment_* functions),
// w absent, [E] or [E, W] (W weight columns, each covering C / W adjacent
// values: per head over an [H * dk] row), and reduce = sum, mean (divided
// by the edge count, rounded to the data's type first as the reference
// counts in it, at least 1) or max (a non-finite result, such as an empty
// segment's, becomes 0). fp32 accumulation in the segment's edge order,
// one rounding to the output type; an empty segment gives 0. Every output
// row is written once: no atomics, the same bits on every run.
//
// Bound: bytes — each distinct row the segments read, the index and the
// weights once, [S, C] written once; the [E, C] message block the reference
// materialises is never written. Design: one thread per 16-byte piece of an
// output row (4 fp32 or 8 bf16 values), consecutive threads across the row,
// so every gathered row is read as coalesced 16-byte loads, and an edge's
// ids and weight are one broadcast load for the row's threads. Rows that
// are not 16-byte multiples (or pieces that would straddle two weight
// columns) take the same loop one element per thread.
//
// The row a slot reads is known once the graph is: with a gather, the first
// version read order[j], then gather[e] (a random 4-byte read) and only then
// the row, three dependent loads an edge. An index built with its gather
// (SegmentIndex.from_ids(..., gather=src)) holds gathered = gather[order],
// composed on the host in walk order, and the composed mode (COMPOSED, the
// wrapper's choice when src is the tensor the index was built from) reads
// gathered[j], a sequential id, then the row; weights are still read
// through order[j], but the row load no longer waits on them. The chained
// mode (any other src) is the same kernel with the first version's chain.
// Each thread of the composed mode keeps kSlotsInFlight (4) slots in
// flight: their ids, rows and weights are loaded before any is added, and
// they are added in edge order, so the sums round as the first version's,
// bit for bit; the chained mode keeps one (two measured 4% slower at 1 KB
// rows). A hub segment (degree 10^3-10^4) is walked by its row's threads
// alone. A walk of the destination segments as K10's (gigl_segment.cuh: a
// slot group of lanes a segment) lost 4-7% to this design at every row
// width the paths run (PERF.md §6).
//
// Edge-row modes (the COO per-edge terms of gigl_tpu/models/convs.py):
// an [E, C] table ea of x's type, read at each slot's edge id e = order[j]
// (sequential when the graph's edges are in walk order, as encode_coo puts
// them), joins the gathered row before the weight: add (EM_ADD), row(e) =
// x[gather[e]] + ea[e] (EdgeAttrGAT's and the Transformer's values, and
// the Transformer's dq); gine (EM_GINE), row(e) = relu(x[gather[e]] +
// ea[e]) (GINEConv.coo). Sum only.
//
// The GATv2 destination walk (mode 3, the backward of GATv2's logits
// z = att . leaky(hs[src] + hd[dst]) per head): for every destination s,
//   dhd[s, c] = sum_{e in seg(s)} leaky'(hs[src e, c] + hd[s, c]) *
//               gl[e, h] * att[c]          (h = c / dh, leaky'(0) = 1)
// and d att[c] = sum_e gl[e, h] * leaky(hs[src e, c] + hd[s, c]). Each
// thread keeps one column piece for a fixed stride of destinations (a
// grid of `rows` x pieces threads, rows = min(S, partial_rows)) and sums
// its d att partial in its own order; a second launch adds the rows'
// partials column by column in row order, so the bits are the same on
// every run (no atomics). With edge rows ea [E, C] (GATv2 with
// use_edge_attr) every z above is (hs[src e, c] + ea[e, c]) + hd[s, c],
// the edge row read at e = order[j], as the add mode reads it.
#include "gigl_pieces.cuh"

namespace {

constexpr int kSum = 0;
constexpr int kMean = 1;
constexpr int kMax = 2;
// edge-row modes
constexpr int kEmNone = 0;
constexpr int kEmAdd = 1;
constexpr int kEmGine = 2;
constexpr int kEmGatv2Dst = 3;
// Slots a thread of the composed mode keeps in flight (4 measured 1-6%
// faster than 2 at every path shape; the chained mode keeps one, which
// measured faster than two at 1 KB rows: PERF.md §6).
constexpr int kSlotsInFlight = 4;

// One slot's row piece and weight, loaded; folded into acc in slot order.
template <int P, int OP>
__device__ __forceinline__ void fold(float* acc, const float* v, float wt) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const float m = v[k] * wt;
    acc[k] = OP == kMax ? fmaxf(acc[k], m) : acc[k] + m;
  }
}

template <typename T, int P, int OP, bool COMPOSED, int EM>
__global__ void segment_reduce_kernel(const T* __restrict__ x,
                                      const int32_t* __restrict__ gather,
                                      const int32_t* __restrict__ order,
                                      const int32_t* __restrict__ gathered,
                                      const int32_t* __restrict__ ptr,
                                      const float* __restrict__ w,
                                      const T* __restrict__ ea,
                                      T* __restrict__ out, int64_t s, int c,
                                      int wc, int w_cols) {
  constexpr int K = COMPOSED ? kSlotsInFlight : 1;
  const int pieces = c / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= s * pieces) return;
  const int64_t seg = i / pieces;
  const int col = static_cast<int>(i - seg * pieces) * P;
  const int wcol = col / wc;  // this piece's weight column
  float acc[P];
#pragma unroll
  for (int k = 0; k < P; ++k)
    acc[k] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  const int32_t lo = __ldg(ptr + seg);
  const int32_t hi = __ldg(ptr + seg + 1);
  // slot j's row and, with weights, its edge id
  auto row_of = [&](int32_t j, int64_t& e) -> int64_t {
    if constexpr (COMPOSED) {
      if (EM != kEmNone || w != nullptr) e = __ldg(order + j);
      return __ldg(gathered + j);
    } else {
      e = __ldg(order + j);
      return gather != nullptr ? __ldg(gather + e) : e;
    }
  };
  auto weight_of = [&](int64_t e) -> float {
    return w != nullptr ? __ldg(w + e * w_cols + wcol) : 1.f;
  };
  // the edge row joins the gathered row piece
  auto with_edge = [&](int64_t e, float* v) {
    if constexpr (EM != kEmNone) {
      float ev[P];
      gigl::load_piece<T, P>(ea + e * c + col, ev);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        v[k] += ev[k];
        if (EM == kEmGine) v[k] = v[k] < 0.f ? 0.f : v[k];
      }
    }
  };
  int32_t j = lo;
  for (; j + K <= hi; j += K) {  // K slots' loads before their sums
    int64_t e[K] = {}, r[K];
    float v[K][P], wt[K];
#pragma unroll
    for (int q = 0; q < K; ++q) r[q] = row_of(j + q, e[q]);
#pragma unroll
    for (int q = 0; q < K; ++q)
      gigl::load_piece<T, P>(x + r[q] * c + col, v[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) wt[q] = weight_of(e[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) with_edge(e[q], v[q]);
#pragma unroll
    for (int q = 0; q < K; ++q) fold<P, OP>(acc, v[q], wt[q]);
  }
  for (; j < hi; ++j) {  // the last hi - lo mod K slots
    int64_t e = 0;
    const int64_t r = row_of(j, e);
    float v[P];
    gigl::load_piece<T, P>(x + r * c + col, v);
    with_edge(e, v);
    fold<P, OP>(acc, v, weight_of(e));
  }
  if (OP == kMax) {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (!isfinite(acc[k])) acc[k] = 0.f;
  }
  if (OP == kMean) {
    float cn = static_cast<float>(hi - lo > 1 ? hi - lo : 1);
    cn = gigl::to_float(gigl::from_float<T>(cn));  // the count in T
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] /= cn;
  }
  gigl::store_piece<T, P>(out + seg * c + col, acc);
}

template <typename T, int P, bool COMPOSED, int EM>
int launch_mode(const void* x, const void* gather, const void* order,
                const void* gathered, const void* ptr, const void* w,
                const void* ea, void* out, long long s, int c, int wc,
                int w_cols, int op, cudaStream_t stream) {
  const long long total = s * (c / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* xv = static_cast<const T*>(x);
  const int32_t* gv = static_cast<const int32_t*>(gather);
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* cv = static_cast<const int32_t*>(gathered);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  const float* wv = static_cast<const float*>(w);
  const T* ev = static_cast<const T*>(ea);
  T* outv = static_cast<T*>(out);
  if constexpr (EM != kEmNone) {  // the edge rows join a sum only
    if (op != kSum || ev == nullptr || ov == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    segment_reduce_kernel<T, P, kSum, COMPOSED, EM>
        <<<blocks, threads, 0, stream>>>(xv, gv, ov, cv, pv, wv, ev, outv, s,
                                         c, wc, w_cols);
    return 0;
  }
  switch (op) {
    case kSum:
      segment_reduce_kernel<T, P, kSum, COMPOSED, kEmNone>
          <<<blocks, threads, 0, stream>>>(xv, gv, ov, cv, pv, wv, ev, outv, s,
                                           c, wc, w_cols);
      break;
    case kMean:
      segment_reduce_kernel<T, P, kMean, COMPOSED, kEmNone>
          <<<blocks, threads, 0, stream>>>(xv, gv, ov, cv, pv, wv, ev, outv, s,
                                           c, wc, w_cols);
      break;
    case kMax:
      segment_reduce_kernel<T, P, kMax, COMPOSED, kEmNone>
          <<<blocks, threads, 0, stream>>>(xv, gv, ov, cv, pv, wv, ev, outv, s,
                                           c, wc, w_cols);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The GATv2 destination walk (see the note above): thread t holds column
// piece t % pieces of destinations t / pieces, t / pieces + rows, ...
template <typename T, int P, bool COMPOSED, bool EDGE>
__global__ void gatv2_dst_kernel(const T* __restrict__ hs,
                                 const int32_t* __restrict__ gather,
                                 const int32_t* __restrict__ order,
                                 const int32_t* __restrict__ gathered,
                                 const int32_t* __restrict__ ptr,
                                 const float* __restrict__ gl,
                                 const T* __restrict__ hd,
                                 const T* __restrict__ ea,
                                 const float* __restrict__ att, float slope,
                                 T* __restrict__ out,
                                 float* __restrict__ partial, int64_t s,
                                 int64_t rows, int c, int dh, int heads) {
  const int pieces = c / P;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= rows * pieces) return;
  const int64_t r0 = t / pieces;
  const int col = static_cast<int>(t - r0 * pieces) * P;
  const int h = col / dh;  // a piece never straddles two heads
  float at[P], datt[P];
#pragma unroll
  for (int k = 0; k < P; ++k) {
    at[k] = __ldg(att + col + k);
    datt[k] = 0.f;
  }
  for (int64_t seg = r0; seg < s; seg += rows) {
    float q[P], acc[P];
    gigl::load_piece<T, P>(hd + seg * c + col, q);
#pragma unroll
    for (int k = 0; k < P; ++k) acc[k] = 0.f;
    const int32_t lo = __ldg(ptr + seg);
    const int32_t hi = __ldg(ptr + seg + 1);
    for (int32_t j = lo; j < hi; ++j) {
      const int64_t e = __ldg(order + j);
      const int64_t r = COMPOSED ? __ldg(gathered + j) : __ldg(gather + e);
      float v[P];
      gigl::load_piece<T, P>(hs + r * c + col, v);
      if constexpr (EDGE) {
        float ev[P];
        gigl::load_piece<T, P>(ea + e * c + col, ev);
#pragma unroll
        for (int k = 0; k < P; ++k) v[k] += ev[k];
      }
      const float gv = __ldg(gl + e * heads + h);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float z = v[k] + q[k];
        const float dz = gv * at[k];
        acc[k] += z >= 0.f ? dz : slope * dz;
        datt[k] += gv * (z >= 0.f ? z : slope * z);
      }
    }
    gigl::store_piece<T, P>(out + seg * c + col, acc);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) partial[r0 * c + col + k] = datt[k];
}

// d att[col] = the rows' partials of column col added in row order.
__global__ void gatv2_att_sum_kernel(const float* __restrict__ partial,
                                     float* __restrict__ datt, int64_t rows,
                                     int c) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= c) return;
  float acc = 0.f;
  for (int64_t r = 0; r < rows; ++r) acc += __ldg(partial + r * c + col);
  datt[col] = acc;
}

template <typename T, int P>
int launch_gatv2_dst(const void* hs, const void* gather, const void* order,
                     const void* gathered, const void* ptr, const void* gl,
                     const void* hd, const void* ea, const void* att,
                     float slope, void* out, void* datt, void* partial,
                     long long s,
                     long long partial_rows, int c, int wc, int w_cols,
                     cudaStream_t stream) {
  if (gl == nullptr || hd == nullptr || att == nullptr || datt == nullptr ||
      partial == nullptr || order == nullptr || wc * w_cols != c ||
      (gathered == nullptr && gather == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = s < partial_rows ? s : partial_rows;
  const int threads = 256;
  if (rows > 0) {
    const long long total = rows * (c / P);
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    auto args = [&](auto kernel) {
      kernel<<<blocks, threads, 0, stream>>>(
          static_cast<const T*>(hs), static_cast<const int32_t*>(gather),
          static_cast<const int32_t*>(order),
          static_cast<const int32_t*>(gathered),
          static_cast<const int32_t*>(ptr), static_cast<const float*>(gl),
          static_cast<const T*>(hd), static_cast<const T*>(ea),
          static_cast<const float*>(att), slope,
          static_cast<T*>(out), static_cast<float*>(partial), s, rows, c, wc,
          w_cols);
    };
    if (gathered != nullptr && ea != nullptr)
      args(gatv2_dst_kernel<T, P, true, true>);
    else if (gathered != nullptr)
      args(gatv2_dst_kernel<T, P, true, false>);
    else if (ea != nullptr)
      args(gatv2_dst_kernel<T, P, false, true>);
    else
      args(gatv2_dst_kernel<T, P, false, false>);
  }
  gatv2_att_sum_kernel<<<(c + threads - 1) / threads, threads, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(datt), rows, c);
  return 0;
}

template <typename T, int P, int EM>
int launch_em(const void* x, const void* gather, const void* order,
              const void* gathered, const void* ptr, const void* w,
              const void* ea, void* out, long long s, int c, int wc,
              int w_cols, int op, cudaStream_t stream) {
  return gathered != nullptr
             ? launch_mode<T, P, true, EM>(x, gather, order, gathered, ptr, w,
                                           ea, out, s, c, wc, w_cols, op,
                                           stream)
             : launch_mode<T, P, false, EM>(x, gather, order, gathered, ptr,
                                            w, ea, out, s, c, wc, w_cols, op,
                                            stream);
}

struct EdgeArgs {  // the edge-row modes' operands (see the entry's note)
  const void *ea, *xd, *att;
  float slope;
  void *datt, *partial;
  long long partial_rows;
};

template <typename T, int P>
int launch(const void* x, const void* gather, const void* order,
           const void* gathered, const void* ptr, const void* w, void* out,
           long long s, int c, int wc, int w_cols, int op, int em,
           const EdgeArgs& ex, cudaStream_t stream) {
  switch (em) {
    case kEmNone:
      return launch_em<T, P, kEmNone>(x, gather, order, gathered, ptr, w,
                                      ex.ea, out, s, c, wc, w_cols, op,
                                      stream);
    case kEmAdd:
      return launch_em<T, P, kEmAdd>(x, gather, order, gathered, ptr, w,
                                     ex.ea, out, s, c, wc, w_cols, op, stream);
    case kEmGine:
      return launch_em<T, P, kEmGine>(x, gather, order, gathered, ptr, w,
                                      ex.ea, out, s, c, wc, w_cols, op,
                                      stream);
    case kEmGatv2Dst:
      return launch_gatv2_dst<T, P>(x, gather, order, gathered, ptr, w, ex.xd,
                                    ex.ea, ex.att, ex.slope, out, ex.datt,
                                    ex.partial, s, ex.partial_rows, c, wc,
                                    w_cols, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x [M, C] (M = E without a gather), gather [E] int32 or NULL, order [E]
// and ptr [S + 1] int32 (the SegmentIndex), gathered [E] int32 (the
// index's gather[order]: the composed mode, gather unread) or NULL, w fp32
// [E, w_cols] or NULL (wc = C / w_cols values per weight column), out
// [S, C]. dtype: 0 = fp32, 1 = bf16; op: 0 = sum, 1 = mean, 2 = max; vec:
// 1 when C * sizeof(T) and wc * sizeof(T) are multiples of 16 and x and out
// are 16-byte aligned (and ea, xd with them in the edge-row modes).
// em (edge-row mode): 0 none; 1 add, 2 gine: ea [E, C] of x's type (op
// sum); 3 the GATv2 destination walk: x = hs [M, C], w = gl fp32 [E,
// heads] (wc = dh), xd = hd [S, C] of x's type, att fp32 [C], slope, out =
// dhd [S, C], datt fp32 [C], partial fp32 [partial_rows, C] (scratch);
// ea [E, C] of x's type or NULL: the edge rows added to hs's (GATv2 with
// edge rows).
extern "C" int gigl_segment_reduce(const void* x, const void* gather,
                                   const void* order, const void* gathered,
                                   const void* ptr, const void* w, void* out,
                                   long long s, int c, int wc, int w_cols,
                                   int dtype, int op, int vec, const void* ea,
                                   int em, const void* xd, const void* att,
                                   float slope, void* datt, void* partial,
                                   long long partial_rows, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wc <= 0 || c % wc != 0) return static_cast<int>(cudaErrorInvalidValue);
  const EdgeArgs ex{ea, xd, att, slope, datt, partial, partial_rows};
  int rc;
  if (dtype == 0) {
    rc = vec ? launch<float, 4>(x, gather, order, gathered, ptr, w, out, s,
                                c, wc, w_cols, op, em, ex, st)
             : launch<float, 1>(x, gather, order, gathered, ptr, w, out, s,
                                c, wc, w_cols, op, em, ex, st);
  } else if (dtype == 1) {
    rc = vec ? launch<__nv_bfloat16, 8>(x, gather, order, gathered, ptr, w,
                                        out, s, c, wc, w_cols, op, em, ex, st)
             : launch<__nv_bfloat16, 1>(x, gather, order, gathered, ptr, w,
                                        out, s, c, wc, w_cols, op, em, ex,
                                        st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
