// K6b ell_transpose_aggregate — replaces gigl_tpu/ops/ell.py _ell_gather_bwd
// (:255-283), the scatter-free custom VJP of ell_gather, fused with the
// backward of the masked reduce that follows the gather in each conv.
//
// The forward entries of an ELL graph are the padded slots of its degree
// buckets, flattened: entry p = off_b + i * W_b + j is slot j of row
// boundaries[b] + i (ent_row[p], a derived [P] int32 table) and reads the
// x_p row nbr[b][i, j]. The transpose tables list, per x_p row v, the entry
// positions that read it: t-row t_rank[v] of a transpose bucket holds them
// in t_nbr under t_mask, and t_row = ent_row[t_nbr] under t_mask, -1
// elsewhere (EllGraph.from_csr composes it). This kernel walks one
// transpose bucket:
//   out[v] = sum_{j < Wt, t_row[i, j] >= 0} w(p) * rows[t_row[i, j]]
//            (+ vec * sum_j w2(p), per head)          with p = t_nbr[i, j]
// for each t-row i of the bucket, v = t_perm[i] (the inverse of t_rank), so
// the result lands in x_p order and no gather follows. w(p) by mode:
//   mean      1 / max(deg[row], 1)            (masked_mean's cotangent)
//   sum       1
//   gcn       rsqrt(deg[row] + 1) * rsqrt(deg[v] + 1)
//   weighted  wt[p, h] for the output value's head h (K7b's alpha for the
//             values, its logit cotangent for the keys); with wt2 and vec,
//             also vec[e] * sum_j wt2[p, h] (GAT: att_src * the summed
//             pre-activation cotangents);
//   max       g[row] / cnt[row] where x[v] equals the forward's max out[row]
//             (jnp.max's VJP shares the cotangent among ties; cnt counts
//             them, from tie_count_kernel over the forward tables);
//   gatv2     wt[p, h] * g[row] + wt2[p, h] * att[e] * leaky'(key[v] +
//             query[row]) per value (GATv2's value and key gradients from
//             K7b's alpha and logit cotangent: the key term depends on the
//             pair, so this mode also reads the query row and its own key).
//   gine      g[row] * 1[x[v] + ea[ent_edge[p]] > 0] per value (GINE's
//             sum of relu(x_j + e_ij), gigl_tpu/models/convs.py:217-223:
//             the relu's gate recomputed from the source's own row and the
//             entry's edge row, ent_edge the flat entry -> COO edge table;
//             ea NULL gates on x[v] alone).
// deg is the in-degree table in permuted order (the valid count of each
// row). fp32 accumulation in slot order, one rounding to the output type.
// Every row of the bucket is written once, rows with no valid slot (sources
// without out-edges) with 0: no atomics, no [P, D] block.
//
// Bound: bytes — each distinct cotangent row is needed once, the transpose
// tables and the entry tables once, [N, D] written once. Design: one thread
// per 16-byte piece of an output row (4 fp32 or 8 bf16 values), consecutive
// threads across D, so every gathered cotangent row is read as coalesced
// 16-byte loads, and a slot's ids are one broadcast load per thread group.
// Rows that are not 16-byte multiples (or unaligned tables) take the same
// loop one element per thread. The first version read, per slot, the mask
// byte, then p = t_nbr, then ent_row[p] (a random read of a [P] table of
// ~2M entries), then the row: four dependent loads. Reading t_row, the row
// load waits on one sequential id; the modes that need p (weighted, gatv2,
// gine with edge rows) read t_nbr beside it, not before it. Each thread
// keeps up to four slots in flight (their ids, rows and the modes' second
// rows loaded before any is added; kSlotsOf, measured per mode) and
// adds them in slot order, so the sums round as the first version's, bit
// for bit. A masked slot of a group reads row 0 and is not added. A
// hub source (a wide transpose bucket) is walked by its row's threads
// alone.
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kMax = 2;
constexpr int kGcn = 3;
constexpr int kWeighted = 4;
constexpr int kGatV2 = 5;
constexpr int kGine = 6;
// Slots a thread keeps in flight (their ids and rows loaded before any is
// added), by mode: kSlotsInFlight for most; 2 for mean and weighted, 1 for
// max, where more measured slower on an H100 (their registers cost
// occupancy; PERF.md §6).
constexpr int kSlotsInFlight = 4;
template <int OP>
constexpr int kSlotsOf =
    OP == kMax ? 1 : OP == kMean || OP == kWeighted ? 2 : kSlotsInFlight;

// What one slot reads: its cotangent row piece x, the second row piece x2
// (max: the forward's max; gatv2: the query; gine: the edge row), and its
// destination row's degree (mean, gcn).
template <int P>
struct Slot {
  float x[P];
  float x2[P];
  float dg;
};

// The tables every mode may read, by the mode's need.
template <typename T>
struct TransposeArgs {
  const T* rows;
  const int32_t* t_nbr;
  const float* deg;
  const float* wt;
  const float* wt2;
  const float* vec;
  const T* rows2;
  const float* cnt;
  const T* ea;
  const int32_t* ent_edge;
  int d;
  int heads;
};

template <typename T, int P, int OP>
__device__ __forceinline__ void load_slot(const TransposeArgs<T>& a,
                                          int64_t row, int64_t p, int c,
                                          Slot<P>& s) {
  load_piece<T, P>(a.rows + row * a.d + c, s.x);
  if constexpr (OP == kMean || OP == kGcn) s.dg = __ldg(a.deg + row);
  if constexpr (OP == kMax || OP == kGatV2)
    load_piece<T, P>(a.rows2 + row * a.d + c, s.x2);
  if constexpr (OP == kGine) {
#pragma unroll
    for (int e = 0; e < P; ++e) s.x2[e] = 0.f;
    if (a.ea != nullptr)
      load_piece<T, P>(
          a.ea + static_cast<int64_t>(__ldg(a.ent_edge + p)) * a.d + c, s.x2);
  }
}

template <typename T, int P, int OP>
__device__ __forceinline__ void add_slot(const TransposeArgs<T>& a,
                                         const Slot<P>& s, int64_t row,
                                         int64_t p, int c, const int* hu,
                                         const float* own, float w_src,
                                         float slope, float* acc,
                                         float* acc2) {
  if (OP == kMean) {
    const float cn = fmaxf(s.dg, 1.f);
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += s.x[e] / cn;
  } else if (OP == kSum) {
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += s.x[e];
  } else if (OP == kGcn) {
    const float wp = (1.f / sqrtf(s.dg + 1.f)) * w_src;
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += s.x[e] * wp;
  } else if (OP == kMax) {
    // the share of the destination's cotangent that jnp.max's VJP gives
    // each slot equal to the max: g / the number of such slots
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (own[e] == s.x2[e])
        acc[e] += s.x[e] / __ldg(a.cnt + row * a.d + c + e);
  } else if (OP == kGine) {
#pragma unroll
    for (int e = 0; e < P; ++e)
      if (own[e] + s.x2[e] > 0.f) acc[e] += s.x[e];
  } else if (OP == kGatV2) {
    const float* wp = a.wt + p * a.heads;
    const float* wp2 = a.wt2 + p * a.heads;
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const float z = own[e] + s.x2[e];
      acc[e] += __ldg(wp + hu[e]) * s.x[e] +
                __ldg(wp2 + hu[e]) * __ldg(a.vec + c + e) *
                    (z >= 0.f ? 1.f : slope);
    }
  } else {
    const float* wp = a.wt + p * a.heads;
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += __ldg(wp + hu[e]) * s.x[e];
    if (a.wt2 != nullptr) {
      const float* wp2 = a.wt2 + p * a.heads;
#pragma unroll
      for (int e = 0; e < P; ++e) acc2[e] += __ldg(wp2 + hu[e]);
    }
  }
}

template <typename T, int P, int OP>
__global__ void ell_transpose_kernel(TransposeArgs<T> a,
                                     const int32_t* __restrict__ t_row,
                                     const int32_t* __restrict__ t_perm,
                                     const T* __restrict__ table,
                                     T* __restrict__ out, int64_t m, int w,
                                     int dh, float slope) {
  constexpr int K = kSlotsOf<OP>;
  const int d = a.d;
  const int pieces = d / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * pieces) return;
  const int64_t r = i / pieces;
  const int c = static_cast<int>(i - r * pieces) * P;
  const int64_t v = __ldg(t_perm + r);
  // the modes that read the flat entry p beside the row
  const bool need_p = OP == kWeighted || OP == kGatV2 ||
                      (OP == kGine && a.ea != nullptr);
  float acc[P], acc2[P];
  int hu[P];
#pragma unroll
  for (int e = 0; e < P; ++e) {
    acc[e] = 0.f;
    acc2[e] = 0.f;
    hu[e] = OP == kWeighted || OP == kGatV2 ? (c + e) / dh : 0;
  }
  float own[P];  // GATv2: this row of the key table; max, GINE: of the input
  if constexpr (OP == kGatV2 || OP == kMax || OP == kGine)
    load_piece<T, P>(table + v * d + c, own);
  float w_src = 0.f;
  if (OP == kGcn) w_src = 1.f / sqrtf(__ldg(a.deg + v) + 1.f);
  const int32_t* rrow = t_row + r * w;
  const int32_t* prow = a.t_nbr + r * w;
  for (int j = 0; j < w; j += K) {  // K slots' loads before their sums
    int32_t rr[K];
    bool any = false;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      rr[q] = j + q < w ? __ldg(rrow + j + q) : -1;
      any = any || rr[q] >= 0;
    }
    if (!any) continue;
    int64_t row[K], p[K];
    Slot<P> sl[K];
#pragma unroll
    for (int q = 0; q < K; ++q) {
      row[q] = rr[q] < 0 ? 0 : rr[q];  // a masked slot reads row 0, unused
      p[q] = need_p && j + q < w ? __ldg(prow + j + q) : 0;
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
      load_slot<T, P, OP>(a, row[q], p[q], c, sl[q]);
#pragma unroll
    for (int q = 0; q < K; ++q)
      if (rr[q] >= 0)
        add_slot<T, P, OP>(a, sl[q], row[q], p[q], c, hu, own, w_src, slope,
                           acc, acc2);
  }
  if (OP == kWeighted && a.wt2 != nullptr) {
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += __ldg(a.vec + c + e) * acc2[e];
  }
  store_piece<T, P>(out + v * d + c, acc);
}

template <typename T, int P, int OP>
void launch_op(const TransposeArgs<T>& a, const void* t_row,
               const void* t_perm, const void* table, void* out, long long m,
               int w, int dh, float slope, unsigned blocks, int threads,
               cudaStream_t stream) {
  ell_transpose_kernel<T, P, OP><<<blocks, threads, 0, stream>>>(
      a, static_cast<const int32_t*>(t_row),
      static_cast<const int32_t*>(t_perm), static_cast<const T*>(table),
      static_cast<T*>(out), m, w, dh, slope);
}

template <typename T>
TransposeArgs<T> args_of(const void* rows, const void* t_nbr,
                         const void* deg, const void* wt, const void* wt2,
                         const void* vec, const void* rows2, const void* cnt,
                         const void* ea, const void* ent_edge, int d,
                         int heads) {
  return {static_cast<const T*>(rows),
          static_cast<const int32_t*>(t_nbr),
          static_cast<const float*>(deg),
          static_cast<const float*>(wt),
          static_cast<const float*>(wt2),
          static_cast<const float*>(vec),
          static_cast<const T*>(rows2),
          static_cast<const float*>(cnt),
          static_cast<const T*>(ea),
          static_cast<const int32_t*>(ent_edge),
          d,
          heads};
}

template <typename T, int P>
int launch(const void* rows, const void* t_nbr, const void* t_row,
           const void* t_perm, const void* deg, const void* wt,
           const void* wt2, const void* vec, const void* rows2,
           const void* table, const void* cnt, const void* ea,
           const void* ent_edge, void* out, long long m, int w, int d,
           int heads, int dh, int op, float slope, cudaStream_t stream) {
  const long long total = m * (d / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
#define GIGL_K6B(OPV)                                                       \
  launch_op<T, P, OPV>(args_of<T>(rows, t_nbr, deg, wt, wt2, vec, rows2, cnt, \
                                  ea, ent_edge, d, heads),                    \
                       t_row, t_perm, table, out, m, w, dh, slope, blocks,   \
                       threads, stream)
  switch (op) {
    case kMean:
      if (deg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kMean);
      break;
    case kSum:
      GIGL_K6B(kSum);
      break;
    case kGcn:
      if (deg == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kGcn);
      break;
    case kWeighted:
      if (wt == nullptr || t_nbr == nullptr || heads < 1 || dh < 1 ||
          heads * dh != d || ((wt2 == nullptr) != (vec == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kWeighted);
      break;
    case kMax:
      if (rows2 == nullptr || table == nullptr || cnt == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kMax);
      break;
    case kGatV2:
      if (wt == nullptr || wt2 == nullptr || vec == nullptr ||
          rows2 == nullptr || table == nullptr || t_nbr == nullptr ||
          heads < 1 || dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kGatV2);
      break;
    case kGine:
      if (table == nullptr ||
          (ea != nullptr && (ent_edge == nullptr || t_nbr == nullptr)))
        return static_cast<int>(cudaErrorInvalidValue);
      GIGL_K6B(kGine);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GIGL_K6B
  return 0;
}

// The forward's tie counts for the max backward: cnt[i, c] = the number of
// valid slots j of row i whose x[nbr[i, j], c] equals ref[i, c] (the max
// K6 wrote), in fp32. One thread per piece of a row, as K6.
template <typename T, int P>
__global__ void tie_count_kernel(const T* __restrict__ x,
                                 const int32_t* __restrict__ nbr,
                                 const uint8_t* __restrict__ mask,
                                 const T* __restrict__ ref,
                                 float* __restrict__ cnt, int64_t n, int w,
                                 int d) {
  const int pieces = d / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * pieces) return;
  const int64_t r = i / pieces;
  const int c = static_cast<int>(i - r * pieces) * P;
  float mx[P], acc[P];
  load_piece<T, P>(ref + r * d + c, mx);
#pragma unroll
  for (int e = 0; e < P; ++e) acc[e] = 0.f;
  for (int j = 0; j < w; ++j) {
    if (!__ldg(mask + r * w + j)) continue;
    float v[P];
    load_piece<T, P>(x + static_cast<int64_t>(__ldg(nbr + r * w + j)) * d + c,
                     v);
#pragma unroll
    for (int e = 0; e < P; ++e) acc[e] += v[e] == mx[e] ? 1.f : 0.f;
  }
#pragma unroll
  for (int e = 0; e < P; ++e) cnt[r * d + c + e] = acc[e];
}

template <typename T, int P>
int launch_ties(const void* x, const void* nbr, const void* mask,
                const void* ref, void* cnt, long long n, int w, int d,
                cudaStream_t stream) {
  const long long total = n * (d / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  tie_count_kernel<T, P><<<blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const uint8_t*>(mask), static_cast<const T*>(ref),
      static_cast<float*>(cnt), n, w, d);
  return 0;
}

}  // namespace

// One transpose bucket: t_row [m, w] (each slot's destination row, -1 where
// masked), t_nbr [m, w] (flat entry positions: read by the weighted and
// gatv2 modes and by gine with edge rows, else may be NULL), t_perm [m]
// (x_p row of each t-row), rows [R, d] and out [N, d] of one dtype (0 =
// fp32, 1 = bf16); deg [N] fp32 (mean, gcn), wt / wt2 [P, heads] fp32 and
// vec [d] fp32 (weighted; GATv2), rows2 [R, d] and table [N, d] of rows'
// type (GATv2: the query rows by destination row and the key table; max:
// the forward's output by destination row and its input table), cnt [N, d]
// fp32 (max: the tie counts), ea [E, d] of rows' type and ent_edge [P]
// int32 (GINE's edge rows, or both NULL). op: 0 mean, 1 sum, 2 max (g /
// cnt where the source equals the max), 3 gcn, 4 weighted, 5 GATv2
// (alpha * g + coef * att * leaky'(key + query), leaky' = 1 at >= 0, else
// slope), 6 GINE (g where table[v] + ea[ent_edge[p]] > 0). vec_path: 1
// when d * sizeof(T) is a multiple of 16 and the row tables and out are
// 16-byte aligned.
extern "C" int gigl_ell_transpose_aggregate(
    const void* rows, const void* t_nbr, const void* t_row,
    const void* t_perm, const void* deg, const void* wt, const void* wt2,
    const void* vec, const void* rows2, const void* table, const void* cnt,
    const void* ea, const void* ent_edge, void* out, long long m, int w,
    int d, int heads, int dh, int dtype, int op, int vec_path, float slope,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = vec_path ? launch<float, 4>(rows, t_nbr, t_row, t_perm, deg, wt,
                                     wt2, vec, rows2, table, cnt, ea,
                                     ent_edge, out, m, w, d, heads, dh, op,
                                     slope, s)
                  : launch<float, 1>(rows, t_nbr, t_row, t_perm, deg, wt,
                                     wt2, vec, rows2, table, cnt, ea,
                                     ent_edge, out, m, w, d, heads, dh, op,
                                     slope, s);
  } else if (dtype == 1) {
    rc = vec_path ? launch<__nv_bfloat16, 8>(rows, t_nbr, t_row, t_perm,
                                             deg, wt, wt2, vec, rows2, table,
                                             cnt, ea, ent_edge, out, m, w, d,
                                             heads, dh, op, slope, s)
                  : launch<__nv_bfloat16, 1>(rows, t_nbr, t_row, t_perm,
                                             deg, wt, wt2, vec, rows2, table,
                                             cnt, ea, ent_edge, out, m, w, d,
                                             heads, dh, op, slope, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// One forward bucket's tie counts: x [M, d], nbr / mask [n, w], ref [n, d]
// of one dtype (0 = fp32, 1 = bf16), cnt [n, d] fp32. vec_path as above.
extern "C" int gigl_ell_tie_count(const void* x, const void* nbr,
                                  const void* mask, const void* ref,
                                  void* cnt, long long n, int w, int d,
                                  int dtype, int vec_path, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = vec_path ? launch_ties<float, 4>(x, nbr, mask, ref, cnt, n, w, d, s)
                  : launch_ties<float, 1>(x, nbr, mask, ref, cnt, n, w, d, s);
  } else if (dtype == 1) {
    rc = vec_path
             ? launch_ties<__nv_bfloat16, 8>(x, nbr, mask, ref, cnt, n, w, d, s)
             : launch_ties<__nv_bfloat16, 1>(x, nbr, mask, ref, cnt, n, w, d,
                                             s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
