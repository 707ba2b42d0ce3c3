// K6 ell_aggregate — replaces gigl_tpu/ops/ell.py ell_gather (:237-247)
// together with the masked reduce that each conv's block applies to its
// result in ell_layer (:319-346): masked_mean / masked_sum / masked_max of
// gigl_tpu/ops/fanout.py (:34-53) for SAGE and GIN, and GCNConv.block's
// degree-weighted sum (gigl_tpu/models/convs.py:107-112).
//
// One launch covers a whole layer: every degree bucket of an EllGraph
// (ops/ell.py), or the rows [lo, hi) of it. The graph's entries are its
// buckets' padded slots flattened: row r of bucket b owns the entries
// ent_off[b] + (r - boundaries[b]) * W_b + j, j < W_b, and its valid slots
// are exactly the first deg[r] of them (EllGraph.from_csr checks that every
// mask is such a left-packed prefix). For every row r and value column:
//   out[r - lo] = reduce_{j < deg[r]} w_rj * x[ent_src[e_rj]]
// with reduce = mean, sum or max (w = 1), or sum with the GCN weight
// w_rj = 1/sqrt(deg[r] + 1) * 1/sqrt(deg[src] + 1), or GINE's sum
//   out[r - lo] = sum_{j < deg[r]} relu(x[ent_src[e]] + ea[ent_edge[e]])
// (GINEConv.block, gigl_tpu/models/convs.py:217-223, fused with the
// forward of ell_gather_edges, gigl_tpu/ops/ell.py:289-316: the [n, W, D]
// edge block is never written; ea NULL adds nothing). The add and the relu
// are in fp32 before the one rounding. Sums accumulate in fp32 in slot
// order and round once; a row with no valid slot gives 0, and the mean
// divides by max(deg, 1). W is not bounded (hub buckets reach 8192 and
// more).
//
// Bound: bytes — each distinct neighbor row of x is needed once, each
// valid slot's id once, [n, D] written once; the [n, W, D] block the
// reference materialises is never written. Design: one thread per 16-byte
// piece of an output row (8 bf16 or 4 fp32 values), consecutive threads
// across D, so every gathered row is read as coalesced 16-byte loads and a
// slot's id is one broadcast load for the row's threads. Rows that are not
// 16-byte multiples (or unaligned tables) take the same walk one element
// per thread. At the flagship's layer the rows come mostly from the L2
// (PERF.md §6), so what limits the walk is the rows it keeps in flight and
// the share of the L2 the table keeps. The first version launched once per
// bucket and walked every one of a row's W slots, each a dependent chain of
// mask byte, id, row. This one:
// - walks the rows of up to kMaxSegments buckets in one launch, the
//   widest bucket's first, so that hub rows do not form the tail (a small
//   table of segments, passed by value; ops/ell_aggregate.py launches a
//   graph with more non-empty buckets once per kMaxSegments of them);
// - walks a row's deg[r] valid slots and reads no mask;
// - reads the slot ids four at a time, one 16-byte word (ids4: every row's
//   entries 16-byte aligned, which widths that are multiples of 4 give),
//   else one at a time;
// - keeps kSlotsInFlight slots' rows in flight (loaded before any is
//   added, held as loaded: 16-byte words) and adds them in slot order, so
//   every mode rounds as the first version's did, bit for bit; the next
//   group's ids are loaded while a group is added;
// - reads the id tables and stores the output with the default cache
//   policy: evict-first id loads with streaming stores measured 0.5-4%
//   slower, and a persisting L2 window over x neutral to 6% slower but
//   for gine with edge rows (PERF.md §6).
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kMax = 2;
constexpr int kGcn = 3;
constexpr int kGine = 4;
// Slots whose rows a thread keeps in flight (PERF.md §6).
constexpr int kSlotsInFlight = 4;
// Segments (non-empty buckets, or their parts in [lo, hi)) one launch
// takes: ops/ell_aggregate.py MAX_SEGMENTS.
constexpr int kMaxSegments = 48;

// The rows one launch walks, in launch order: segment k holds the virtual
// rows [vstart[k], vstart[k + 1]), graph rows row0[k] + i, whose entries
// start at ent0[k] + i * width[k].
struct Segments {
  int count;
  int width[kMaxSegments];
  long long vstart[kMaxSegments + 1];
  long long row0[kMaxSegments];
  long long ent0[kMaxSegments];
};

// The K ids at p, of which the first n (< K on a row's last group) are
// valid. IDS4: p is 16-byte aligned and the row's entries run on to a
// multiple of 4, so its ids come as 16-byte words (K = 2: one 8-byte word),
// and a word holding no valid id is not read.
template <int K, bool IDS4>
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ p, int n,
                                         int32_t* s) {
  if constexpr (IDS4 && K % 4 == 0) {
#pragma unroll
    for (int q = 0; q < K / 4; ++q) {
      int4 w = make_int4(0, 0, 0, 0);
      if (4 * q < n) w = __ldg(reinterpret_cast<const int4*>(p) + q);
      s[4 * q] = w.x;
      s[4 * q + 1] = w.y;
      s[4 * q + 2] = w.z;
      s[4 * q + 3] = w.w;
    }
  } else if constexpr (IDS4 && K == 2) {
    int2 w = make_int2(0, 0);
    if (n > 0) w = __ldg(reinterpret_cast<const int2*>(p));
    s[0] = w.x;
    s[1] = w.y;
  } else {
#pragma unroll
    for (int q = 0; q < K; ++q) s[q] = q < n ? __ldg(p + q) : 0;
  }
}

template <typename T, int P, int OP, bool IDS4>
__global__ void ell_aggregate_kernel(const T* __restrict__ x,
                                     const int32_t* __restrict__ ent_src,
                                     const int32_t* __restrict__ ent_edge,
                                     const float* __restrict__ deg,
                                     const T* __restrict__ ea,
                                     T* __restrict__ out,
                                     const __grid_constant__ Segments seg,
                                     int64_t lo, int d) {
  constexpr int K = kSlotsInFlight;
  const int pieces = d / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= seg.vstart[seg.count] * pieces) return;
  const int64_t v = i / pieces;
  const int c = static_cast<int>(i - v * pieces) * P;
  int k = 0;
  while (v >= seg.vstart[k + 1]) ++k;
  const int64_t local = v - seg.vstart[k];
  const int64_t r = seg.row0[k] + local;
  const int w = seg.width[k];
  const bool edges = OP == kGine && ea != nullptr;
  const int32_t* src_row = ent_src + seg.ent0[k] + local * w;
  const int32_t* edge_row = edges ? ent_edge + seg.ent0[k] + local * w
                                  : nullptr;
  const float dr = __ldg(deg + r);
  int cnt = static_cast<int>(dr);
  cnt = cnt < 0 ? 0 : cnt < w ? cnt : w;
  float acc[P];
#pragma unroll
  for (int e = 0; e < P; ++e)
    acc[e] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  float w_dst = 0.f;
  if (OP == kGcn) w_dst = 1.f / sqrtf(dr + 1.f);
  // a group's ids are loaded while the group before it is being added
  int32_t s[K], eid[K];
  load_ids<K, IDS4>(src_row, cnt, s);
  if (edges) load_ids<K, IDS4>(edge_row, cnt, eid);
  for (int j = 0; j < cnt; j += K) {  // K slots' loads before their sums
    const int n = cnt - j < K ? cnt - j : K;
    HeldPiece<T, P> val[K], ev[K];
    float dg[K];
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (q < n) val[q] = load_held<T, P>(x + static_cast<int64_t>(s[q]) * d
                                         + c);
    if (OP == kGcn) {
#pragma unroll
      for (int q = 0; q < K; ++q) dg[q] = q < n ? __ldg(deg + s[q]) : 0.f;
    }
    if (edges) {
#pragma unroll
      for (int q = 0; q < K; ++q)
        if (q < n) ev[q] = load_held<T, P>(ea + static_cast<int64_t>(eid[q])
                                          * d + c);
    }
    load_ids<K, IDS4>(src_row + j + K, cnt - j - K, s);
    if (edges) load_ids<K, IDS4>(edge_row + j + K, cnt - j - K, eid);
#pragma unroll
    for (int q = 0; q < K; ++q) {
      if (q >= n) continue;
      float vq[P];
      widen<T, P>(val[q], vq);
      if (OP == kGcn) {
        const float wt = w_dst * (1.f / sqrtf(dg[q] + 1.f));
#pragma unroll
        for (int e = 0; e < P; ++e) acc[e] += vq[e] * wt;
      } else if (OP == kGine) {
        float eq[P];
#pragma unroll
        for (int e = 0; e < P; ++e) eq[e] = 0.f;
        if (edges) widen<T, P>(ev[q], eq);
#pragma unroll
        for (int e = 0; e < P; ++e) acc[e] += fmaxf(vq[e] + eq[e], 0.f);
      } else {
#pragma unroll
        for (int e = 0; e < P; ++e)
          acc[e] = OP == kMax ? fmaxf(acc[e], vq[e]) : acc[e] + vq[e];
      }
    }
  }
  if (OP == kMax && cnt == 0) {
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] = 0.f;
  }
  if (OP == kMean) {
    const float cn = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] /= cn;
  }
  store_piece<T, P>(out + (r - lo) * d + c, acc);
}

template <typename T, int P, int OP>
void launch_op(const void* x, const void* ent_src, const void* ent_edge,
               const void* deg, const void* ea, void* out,
               const Segments& seg, long long lo, int d, int ids4,
               cudaStream_t stream) {
  const long long total = seg.vstart[seg.count] * (d / P);
  if (total == 0) return;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* xv = static_cast<const T*>(x);
  const int32_t* sv = static_cast<const int32_t*>(ent_src);
  const int32_t* ev = static_cast<const int32_t*>(ent_edge);
  const float* dv = static_cast<const float*>(deg);
  const T* av = static_cast<const T*>(ea);
  T* ov = static_cast<T*>(out);
  if (ids4)
    ell_aggregate_kernel<T, P, OP, true><<<blocks, threads, 0, stream>>>(
        xv, sv, ev, dv, av, ov, seg, lo, d);
  else
    ell_aggregate_kernel<T, P, OP, false><<<blocks, threads, 0, stream>>>(
        xv, sv, ev, dv, av, ov, seg, lo, d);
}

template <typename T, int P>
int launch(const void* x, const void* ent_src, const void* ent_edge,
           const void* deg, const void* ea, void* out, const Segments& seg,
           long long lo, int d, int op, int ids4, cudaStream_t stream) {
  switch (op) {
    case kMean:
      launch_op<T, P, kMean>(x, ent_src, ent_edge, deg, ea, out, seg, lo, d,
                             ids4, stream);
      break;
    case kSum:
      launch_op<T, P, kSum>(x, ent_src, ent_edge, deg, ea, out, seg, lo, d,
                            ids4, stream);
      break;
    case kMax:
      launch_op<T, P, kMax>(x, ent_src, ent_edge, deg, ea, out, seg, lo, d,
                            ids4, stream);
      break;
    case kGcn:
      launch_op<T, P, kGcn>(x, ent_src, ent_edge, deg, ea, out, seg, lo, d,
                            ids4, stream);
      break;
    case kGine:
      if (ea != nullptr && ent_edge == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      launch_op<T, P, kGine>(x, ent_src, ent_edge, deg, ea, out, seg, lo, d,
                             ids4, stream);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// x [M, D] (fp32 or bf16); ent_src [P] int32 (each flat entry's row of x)
// and ent_edge [P] int32 (its row of ea) or NULL; deg [N] fp32 (each graph
// row's count of valid slots, its in-degree); ea [E, D] of x's type or NULL
// (gine only); out [hi - lo, D]. segs: count (1 to kMaxSegments) segments
// in launch order, four int64 each (first graph row, rows, first entry,
// width), all walked in one launch; lo the graph row of out's row 0.
// dtype: 0 = fp32, 1 = bf16; op: 0 = mean, 1 = sum, 2 = max, 3 = GCN
// weighted sum, 4 = GINE; vec: 1 when D * sizeof(T) is a
// multiple of 16 and x, ea and out are 16-byte aligned; ids4: 1 when
// ent_src (and ent_edge) are 16-byte aligned and every segment's first
// entry and width are multiples of 4.
extern "C" int gigl_ell_aggregate(const void* x, const void* ent_src,
                                  const void* ent_edge, const void* deg,
                                  const void* ea, void* out,
                                  const void* segs, int count, long long lo,
                                  int d, int dtype, int op, int vec, int ids4,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (count < 1 || count > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* table = static_cast<const long long*>(segs);
  Segments seg;
  seg.count = count;
  seg.vstart[0] = 0;
  for (int k = 0; k < count; ++k) {
    const long long* row = table + 4 * k;
    seg.row0[k] = row[0];
    seg.vstart[k + 1] = seg.vstart[k] + row[1];
    seg.ent0[k] = row[2];
    seg.width[k] = static_cast<int>(row[3]);
  }
  int rc;
  if (dtype == 0) {
    rc = vec ? launch<float, 4>(x, ent_src, ent_edge, deg, ea, out, seg, lo,
                                d, op, ids4, s)
             : launch<float, 1>(x, ent_src, ent_edge, deg, ea, out, seg, lo,
                                d, op, ids4, s);
  } else {
    rc = vec ? launch<__nv_bfloat16, 8>(x, ent_src, ent_edge, deg, ea, out,
                                        seg, lo, d, op, ids4, s)
             : launch<__nv_bfloat16, 1>(x, ent_src, ent_edge, deg, ea, out,
                                        seg, lo, d, op, ids4, s);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
