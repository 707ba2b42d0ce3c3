// K11 ell_edge_grad — replaces gigl_tpu/ops/ell.py _ell_ge_bwd (:303-313),
// the custom VJP of ell_gather_edges (:289-316), fused with the backward of
// the operation each edge conv applies to the gathered edge block. Every
// COO edge e occupies exactly one valid forward entry p = edge_pos[e] of
// the ELL graph (slot j of row i = ent_row[p], e = ent_edge[p]), so the
// edge table's gradient is a permutation of per-entry terms: each valid
// entry writes d_ea[ent_edge[p]] once, with no scatter, no atomics and no
// [P, D] flat cotangent (the reference builds that block, masks it and
// gathers it by edge_pos). Per mode, for value c of head h = c / dh:
//   gine         g[i, c] * 1[x[ent_src[p], c] + ea[e, c] > 0]
//                (GINEConv's sum of relu(x_j + e_ij): the relu's gate
//                recomputed from the entry's source row and its edge row);
//   gat          alpha[p, h] * g[i, c] + coef[p, h] * vec[c]
//                (EdgeAttrGAT: the edge row is added to the source row,
//                which is both the value and, through att_src = vec, the
//                logit: K7b's alpha and pre-activation cotangent);
//   transformer  alpha[p, h] * g[i, c] + coef[p, h] * xd[i, c]
//                (the edge row added to the key and the value: K7b's alpha
//                and its logit cotangent, already divided by sqrt(Dh));
//   gatv2        alpha[p, h] * g[i, c] + coef[p, h] * vec[c] *
//                leaky'((x[ent_src[p], c] + ea[e, c]) + xd[i, c])
//                (GATv2 with edge rows, gigl_tpu/models/convs.py:292-328:
//                the edge row joins the source row, which is the value and
//                sits inside the gate att . leaky(hs + he + hd); vec = att,
//                x the source (key) table, xd the destination rows, coef
//                the logit cotangent, leaky'(z) = 1 at z >= 0, else the
//                slope, as JAX's). The source table's gradient is this
//                table summed along the source walk (K6b's sum over
//                EllGraph.t_edge, K8b's over the source index's order):
//                ks[src] and he[e] enter the layer identically.
// fp32 arithmetic, one rounding to the output type.
//
// Bound: bytes — [E, D] written once, each destination's row of g (and xd)
// read once, alpha and coef (and ent_src, x and ea rows for gine) per
// entry. At the flagship (E = 2M, [E, 256] fp32) g is 102 MB, twice the
// 50 MB L2, so a walk in edge order, which reads g[ent_row[edge_pos[e]]]
// in random row order, sends most of its 2M row reads to HBM. Design: the
// walk goes over the flat entries in destination order instead (entries
// are row-major within each bucket): a thread owns one 16-byte piece
// column c of the row (4 fp32 or 8 bf16 values; consecutive threads across
// D, so every row is read and written as coalesced 16-byte accesses) and a
// chunk of kChunk consecutive entries. It keeps g[i, c] (and xd[i, c]) in
// registers while the entries stay on row i, loading them once per row and
// chunk, and its heads h and vec[c] for the whole chunk; alpha, coef and
// the index tables stream through in order. A wide bucket's row (a hub,
// up to the max in-degree) spans many chunks, so no row is one group's
// serial loop. Padding entries are skipped by the flat validity table
// ent_mask [P], built once with the EllGraph (testing edge_pos[ent_edge[p]]
// == p instead puts a dependent random read at the head of every entry's
// chain: 24% slower on the H100 at the flagship). Rows
// that are not 16-byte multiples (or unaligned tables) take the same loop
// one element per thread.
//
// The COO form (the coo forms of GINEConv, EdgeAttrGAT and TransformerConv
// in gigl_tpu/models/convs.py: the same three terms for an [E, d] edge
// table beside COO edges) walks the destination SegmentIndex instead of
// the ELL rows: a thread per (destination i, 16-byte piece), g[i] (and
// xd[i]) loaded once, then each slot j of the segment, its edge e =
// order[j] and source row gathered[j] (the index's src[order]), writing
// d_ea[e] once (in sequence when the edges are in walk order, as
// encode_coo puts them). alpha and coef are [E, heads] by edge id; in the
// gat mode coef may be NULL (the edge rows feed the values alone: alpha *
// g). No padding, no mask.
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kGine = 0;
constexpr int kGat = 1;
constexpr int kTransformer = 2;
constexpr int kGatV2 = 3;
constexpr int kChunk = 32;    // entries per thread
constexpr int kThreads = 256;

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(kThreads) ell_edge_grad_kernel(
    const T* __restrict__ g, const uint8_t* __restrict__ ent_mask,
    const int32_t* __restrict__ ent_row, const int32_t* __restrict__ ent_src,
    const int32_t* __restrict__ ent_edge, const T* __restrict__ x,
    const T* __restrict__ ea, const float* __restrict__ alpha,
    const float* __restrict__ coef, const float* __restrict__ vec,
    const T* __restrict__ xd, T* __restrict__ out, int64_t num_entries,
    int d, int heads, int dh, float slope) {
  const int pieces = d / P;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t q = t / pieces;
  const int c = static_cast<int>(t - q * pieces) * P;
  const int64_t p0 = q * kChunk;
  if (p0 >= num_entries) return;
  const int64_t p1 =
      p0 + kChunk < num_entries ? p0 + kChunk : num_entries;
  int hd[P];
  float other[P], gv[P], qd[P];
  if constexpr (MODE != kGine) {
#pragma unroll
    for (int u = 0; u < P; ++u) hd[u] = (c + u) / dh;
  }
  if constexpr (MODE == kGat || MODE == kGatV2) {
#pragma unroll
    for (int u = 0; u < P; ++u) other[u] = __ldg(vec + c + u);
  }
  int64_t row = -1;
  for (int64_t p = p0; p < p1; ++p) {
    if (!__ldg(ent_mask + p)) continue;
    const int64_t e = __ldg(ent_edge + p);
    const int64_t i = __ldg(ent_row + p);
    if (i != row) {
      row = i;
      load_piece<T, P>(g + i * d + c, gv);
      if constexpr (MODE == kTransformer)
        load_piece<T, P>(xd + i * d + c, other);
      if constexpr (MODE == kGatV2) load_piece<T, P>(xd + i * d + c, qd);
    }
    float res[P];
    if constexpr (MODE == kGine) {
      float xv[P], ev[P];
      load_piece<T, P>(x + static_cast<int64_t>(__ldg(ent_src + p)) * d + c,
                       xv);
      load_piece<T, P>(ea + e * d + c, ev);
#pragma unroll
      for (int u = 0; u < P; ++u) res[u] = xv[u] + ev[u] > 0.f ? gv[u] : 0.f;
    } else if constexpr (MODE == kGatV2) {
      float xv[P], ev[P];
      load_piece<T, P>(x + static_cast<int64_t>(__ldg(ent_src + p)) * d + c,
                       xv);
      load_piece<T, P>(ea + e * d + c, ev);
      const float* al = alpha + p * heads;
      const float* cf = coef + p * heads;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float z = (xv[u] + ev[u]) + qd[u];
        res[u] = __ldg(al + hd[u]) * gv[u] +
                 __ldg(cf + hd[u]) * other[u] * (z >= 0.f ? 1.f : slope);
      }
    } else {
      const float* al = alpha + p * heads;
      const float* cf = coef + p * heads;
#pragma unroll
      for (int u = 0; u < P; ++u)
        res[u] = __ldg(al + hd[u]) * gv[u] + __ldg(cf + hd[u]) * other[u];
    }
    store_piece<T, P>(out + e * d + c, res);
  }
}

template <typename T, int P, int MODE>
__global__ void __launch_bounds__(kThreads) coo_edge_grad_kernel(
    const T* __restrict__ g, const int32_t* __restrict__ ptr,
    const int32_t* __restrict__ order, const int32_t* __restrict__ gathered,
    const T* __restrict__ x, const T* __restrict__ ea,
    const float* __restrict__ alpha, const float* __restrict__ coef,
    const float* __restrict__ vec, const T* __restrict__ xd,
    T* __restrict__ out, int64_t segments, int d, int heads, int dh,
    float slope) {
  const int pieces = d / P;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= segments * pieces) return;
  const int64_t i = t / pieces;
  const int c = static_cast<int>(t - i * pieces) * P;
  float gv[P], other[P], qd[P];
  load_piece<T, P>(g + i * d + c, gv);
  int hd[P];
  if constexpr (MODE != kGine) {
#pragma unroll
    for (int u = 0; u < P; ++u) hd[u] = (c + u) / dh;
  }
  if constexpr (MODE == kGat) {
#pragma unroll
    for (int u = 0; u < P; ++u) other[u] = coef != nullptr ? __ldg(vec + c + u)
                                                           : 0.f;
  }
  if constexpr (MODE == kTransformer) load_piece<T, P>(xd + i * d + c, other);
  if constexpr (MODE == kGatV2) {
#pragma unroll
    for (int u = 0; u < P; ++u) other[u] = __ldg(vec + c + u);
    load_piece<T, P>(xd + i * d + c, qd);
  }
  const int32_t lo = __ldg(ptr + i);
  const int32_t hi = __ldg(ptr + i + 1);
  for (int32_t j = lo; j < hi; ++j) {
    const int64_t e = __ldg(order + j);
    float res[P];
    if constexpr (MODE == kGine) {
      float xv[P], ev[P];
      load_piece<T, P>(x + static_cast<int64_t>(__ldg(gathered + j)) * d + c,
                       xv);
      load_piece<T, P>(ea + e * d + c, ev);
#pragma unroll
      for (int u = 0; u < P; ++u) res[u] = xv[u] + ev[u] > 0.f ? gv[u] : 0.f;
    } else if constexpr (MODE == kGatV2) {
      float xv[P], ev[P];
      load_piece<T, P>(x + static_cast<int64_t>(__ldg(gathered + j)) * d + c,
                       xv);
      load_piece<T, P>(ea + e * d + c, ev);
      const float* al = alpha + e * heads;
      const float* cf = coef + e * heads;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float z = (xv[u] + ev[u]) + qd[u];
        res[u] = __ldg(al + hd[u]) * gv[u] +
                 __ldg(cf + hd[u]) * other[u] * (z >= 0.f ? 1.f : slope);
      }
    } else {
      const float* al = alpha + e * heads;
#pragma unroll
      for (int u = 0; u < P; ++u) {
        const float cf = coef != nullptr ? __ldg(coef + e * heads + hd[u])
                                         : 0.f;
        res[u] = __ldg(al + hd[u]) * gv[u] + cf * other[u];
      }
    }
    store_piece<T, P>(out + e * d + c, res);
  }
}

template <typename T, int P>
int launch_coo(const void* g, const void* ptr, const void* order,
               const void* gathered, const void* x, const void* ea,
               const void* alpha, const void* coef, const void* vec,
               const void* xd, void* out, long long segments, int d,
               int heads, int dh, int mode, float slope,
               cudaStream_t stream) {
  if (order == nullptr || (mode != kGine && (alpha == nullptr || heads < 1 ||
                                             dh < 1 || heads * dh != d)) ||
      ((mode == kGine || mode == kGatV2) &&
       (gathered == nullptr || x == nullptr || ea == nullptr)) ||
      (mode == kGatV2 && (coef == nullptr || vec == nullptr ||
                          xd == nullptr)) ||
      (mode == kGat && coef != nullptr && vec == nullptr) ||
      (mode == kTransformer && (coef == nullptr || xd == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = segments * (d / P);
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  auto run = [&](auto kernel) {
    kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const int32_t*>(ptr),
        static_cast<const int32_t*>(order),
        static_cast<const int32_t*>(gathered), static_cast<const T*>(x),
        static_cast<const T*>(ea), static_cast<const float*>(alpha),
        static_cast<const float*>(coef), static_cast<const float*>(vec),
        static_cast<const T*>(xd), static_cast<T*>(out), segments, d, heads,
        dh, slope);
  };
  switch (mode) {
    case kGine: run(coo_edge_grad_kernel<T, P, kGine>); break;
    case kGat: run(coo_edge_grad_kernel<T, P, kGat>); break;
    case kTransformer: run(coo_edge_grad_kernel<T, P, kTransformer>); break;
    case kGatV2: run(coo_edge_grad_kernel<T, P, kGatV2>); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T, int P>
int launch(const void* g, const void* ent_mask, const void* ent_row,
           const void* ent_src, const void* ent_edge, const void* x,
           const void* ea, const void* alpha, const void* coef,
           const void* vec, const void* xd, void* out, long long num_entries,
           int d, int heads, int dh, int mode, float slope,
           cudaStream_t stream) {
  const long long pieces = d / P;
  const long long total = (num_entries + kChunk - 1) / kChunk * pieces;
  if (total == 0) return 0;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  const T* gv = static_cast<const T*>(g);
  const uint8_t* vl = static_cast<const uint8_t*>(ent_mask);
  const int32_t* er = static_cast<const int32_t*>(ent_row);
  const int32_t* es = static_cast<const int32_t*>(ent_src);
  const int32_t* ee = static_cast<const int32_t*>(ent_edge);
  const T* xv = static_cast<const T*>(x);
  const T* ev = static_cast<const T*>(ea);
  const float* al = static_cast<const float*>(alpha);
  const float* cf = static_cast<const float*>(coef);
  const float* vc = static_cast<const float*>(vec);
  const T* qv = static_cast<const T*>(xd);
  T* ov = static_cast<T*>(out);
  if (vl == nullptr || er == nullptr || ee == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kGine:
      // ea is read at valid entries only: NULL (empty) on an edgeless graph
      if (es == nullptr || xv == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kGine><<<blocks, kThreads, 0, stream>>>(
          gv, vl, er, es, ee, xv, ev, al, cf, vc, qv, ov, num_entries, d,
          heads, dh, slope);
      break;
    case kGat:
      if (al == nullptr || cf == nullptr || vc == nullptr || heads < 1 ||
          dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kGat><<<blocks, kThreads, 0, stream>>>(
          gv, vl, er, es, ee, xv, ev, al, cf, vc, qv, ov, num_entries, d,
          heads, dh, slope);
      break;
    case kTransformer:
      if (al == nullptr || cf == nullptr || qv == nullptr || heads < 1 ||
          dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kTransformer><<<blocks, kThreads, 0,
                                                 stream>>>(
          gv, vl, er, es, ee, xv, ev, al, cf, vc, qv, ov, num_entries, d,
          heads, dh, slope);
      break;
    case kGatV2:
      if (es == nullptr || xv == nullptr || ev == nullptr || al == nullptr ||
          cf == nullptr || vc == nullptr || qv == nullptr || heads < 1 ||
          dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kGatV2><<<blocks, kThreads, 0, stream>>>(
          gv, vl, er, es, ee, xv, ev, al, cf, vc, qv, ov, num_entries, d,
          heads, dh, slope);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// g [N, d] (the layer's output cotangent by destination row, permuted
// order); ent_mask [P] bool, ent_row, ent_src, ent_edge [P] int32; gine:
// x [N, d] (the layer's input) and ea [E, d] of g's type; gat: alpha, coef
// [P, heads] fp32 and vec [d] fp32 (att_src); transformer: alpha, coef and
// xd [N, d] of g's type (the query rows); gatv2: x [N, d] (the key table),
// ea [E, d], alpha, coef, vec (att) and xd, leaky's slope. out [E, d] of
// g's type: every row is written when every edge has its valid entry.
// dtype: 0 = fp32, 1 = bf16; mode: 0 gine, 1 gat, 2 transformer, 3 gatv2.
// vec_path: 1 when d * sizeof(T) is a multiple of 16 and every row table
// is 16-byte aligned. An edgeless
// graph's entries are all padding: the kernel runs and writes nothing.
// The COO form, when ptr [segments + 1] is given (the destination
// SegmentIndex's pointers): ent_edge is its order [E] (each slot's edge
// id), ent_src its gathered [E] (each slot's source row; gine), g and xd
// [segments, d], alpha and coef [E, heads] by edge id (gat: coef NULL for
// alpha * g alone), out [E, d] by edge id; ent_mask and ent_row unread;
// gine and gatv2 read x at gathered (ent_src) rows.
extern "C" int gigl_ell_edge_grad(const void* g, const void* ent_mask,
                                  const void* ent_row, const void* ent_src,
                                  const void* ent_edge, const void* x,
                                  const void* ea, const void* alpha,
                                  const void* coef, const void* vec,
                                  const void* xd, void* out,
                                  long long num_entries, int d, int heads,
                                  int dh, int dtype, int mode, int vec_path,
                                  const void* ptr, long long segments,
                                  float slope, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (ptr != nullptr) {
    using B = __nv_bfloat16;
    if (dtype == 0)
      rc = vec_path ? launch_coo<float, 4>(g, ptr, ent_edge, ent_src, x, ea,
                                           alpha, coef, vec, xd, out,
                                           segments, d, heads, dh, mode,
                                           slope, s)
                    : launch_coo<float, 1>(g, ptr, ent_edge, ent_src, x, ea,
                                           alpha, coef, vec, xd, out,
                                           segments, d, heads, dh, mode,
                                           slope, s);
    else if (dtype == 1)
      rc = vec_path ? launch_coo<B, 8>(g, ptr, ent_edge, ent_src, x, ea,
                                       alpha, coef, vec, xd, out, segments,
                                       d, heads, dh, mode, slope, s)
                    : launch_coo<B, 1>(g, ptr, ent_edge, ent_src, x, ea,
                                       alpha, coef, vec, xd, out, segments,
                                       d, heads, dh, mode, slope, s);
    else
      rc = static_cast<int>(cudaErrorInvalidValue);
    if (rc != 0) return rc;
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) {
    rc = vec_path
             ? launch<float, 4>(g, ent_mask, ent_row, ent_src, ent_edge, x,
                                ea, alpha, coef, vec, xd, out, num_entries, d,
                                heads, dh, mode, slope, s)
             : launch<float, 1>(g, ent_mask, ent_row, ent_src, ent_edge, x,
                                ea, alpha, coef, vec, xd, out, num_entries, d,
                                heads, dh, mode, slope, s);
  } else if (dtype == 1) {
    rc = vec_path
             ? launch<__nv_bfloat16, 8>(g, ent_mask, ent_row, ent_src,
                                        ent_edge, x, ea, alpha, coef, vec,
                                        xd, out, num_entries, d, heads, dh,
                                        mode, slope, s)
             : launch<__nv_bfloat16, 1>(g, ent_mask, ent_row, ent_src,
                                        ent_edge, x, ea, alpha, coef, vec,
                                        xd, out, num_entries, d, heads, dh,
                                        mode, slope, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
