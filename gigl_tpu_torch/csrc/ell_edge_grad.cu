// K11 ell_edge_grad — replaces gigl_tpu/ops/ell.py _ell_ge_bwd (:303-313),
// the custom VJP of ell_gather_edges (:289-316), fused with the backward of
// the operation each edge conv applies to the gathered edge block. Every
// COO edge e occupies exactly one forward entry p = edge_pos[e] of the ELL
// graph (slot j of row i = ent_row[p]), so the edge table's gradient is a
// permutation of per-entry terms: one thread group per edge writes
// d_ea[e] once, in edge order, with no scatter, no atomics and no [P, D]
// flat cotangent (the reference builds that block, masks it and gathers it
// by edge_pos). Per mode, for value c of head h = c / dh:
//   gine         g[i, c] * 1[x[ent_src[p], c] + ea[e, c] > 0]
//                (GINEConv's sum of relu(x_j + e_ij): the relu's gate
//                recomputed from the entry's source row and its edge row);
//   gat          alpha[p, h] * g[i, c] + coef[p, h] * vec[c]
//                (EdgeAttrGAT: the edge row is added to the source row,
//                which is both the value and, through att_src = vec, the
//                logit: K7b's alpha and pre-activation cotangent);
//   transformer  alpha[p, h] * g[i, c] + coef[p, h] * xd[i, c]
//                (the edge row added to the key and the value: K7b's alpha
//                and its logit cotangent, already divided by sqrt(Dh)).
// fp32 arithmetic, one rounding to the output type.
//
// Bound: bytes — edge_pos, ent_row (and ent_src) read once per edge, one
// row of g (and of x or xd, and ea) read per edge, [E, D] written once
// (the reads of g rows repeat per destination: the L2 holds them). Design:
// one thread per 16-byte piece of an output row (4 fp32 or 8 bf16 values),
// consecutive threads across D, so every row is read and written as
// coalesced 16-byte accesses; rows that are not 16-byte multiples (or
// unaligned tables) take the same loop one element per thread.
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kGine = 0;
constexpr int kGat = 1;
constexpr int kTransformer = 2;

template <typename T, int P, int MODE>
__global__ void ell_edge_grad_kernel(
    const T* __restrict__ g, const int32_t* __restrict__ edge_pos,
    const int32_t* __restrict__ ent_row, const int32_t* __restrict__ ent_src,
    const T* __restrict__ x, const T* __restrict__ ea,
    const float* __restrict__ alpha, const float* __restrict__ coef,
    const float* __restrict__ vec, const T* __restrict__ xd,
    T* __restrict__ out, int64_t num_edges, int d, int heads, int dh) {
  const int pieces = d / P;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= num_edges * pieces) return;
  const int64_t e = t / pieces;
  const int c = static_cast<int>(t - e * pieces) * P;
  const int64_t p = __ldg(edge_pos + e);
  const int64_t i = __ldg(ent_row + p);
  float gv[P], res[P];
  load_piece<T, P>(g + i * d + c, gv);
  if constexpr (MODE == kGine) {
    float xv[P], ev[P];
    load_piece<T, P>(x + static_cast<int64_t>(__ldg(ent_src + p)) * d + c, xv);
    load_piece<T, P>(ea + e * d + c, ev);
#pragma unroll
    for (int u = 0; u < P; ++u) res[u] = xv[u] + ev[u] > 0.f ? gv[u] : 0.f;
  } else {
    float other[P];
    if constexpr (MODE == kTransformer) {
      load_piece<T, P>(xd + i * d + c, other);
    } else {
#pragma unroll
      for (int u = 0; u < P; ++u) other[u] = __ldg(vec + c + u);
    }
#pragma unroll
    for (int u = 0; u < P; ++u) {
      const int h = (c + u) / dh;
      res[u] = __ldg(alpha + p * heads + h) * gv[u] +
               __ldg(coef + p * heads + h) * other[u];
    }
  }
  store_piece<T, P>(out + e * d + c, res);
}

template <typename T, int P>
int launch(const void* g, const void* edge_pos, const void* ent_row,
           const void* ent_src, const void* x, const void* ea,
           const void* alpha, const void* coef, const void* vec,
           const void* xd, void* out, long long num_edges, int d, int heads,
           int dh, int mode, cudaStream_t stream) {
  const long long total = num_edges * (d / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* gv = static_cast<const T*>(g);
  const int32_t* ep = static_cast<const int32_t*>(edge_pos);
  const int32_t* er = static_cast<const int32_t*>(ent_row);
  const int32_t* es = static_cast<const int32_t*>(ent_src);
  const T* xv = static_cast<const T*>(x);
  const T* ev = static_cast<const T*>(ea);
  const float* al = static_cast<const float*>(alpha);
  const float* cf = static_cast<const float*>(coef);
  const float* vc = static_cast<const float*>(vec);
  const T* qv = static_cast<const T*>(xd);
  T* ov = static_cast<T*>(out);
  switch (mode) {
    case kGine:
      if (es == nullptr || xv == nullptr || ev == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kGine><<<blocks, threads, 0, stream>>>(
          gv, ep, er, es, xv, ev, al, cf, vc, qv, ov, num_edges, d, heads, dh);
      break;
    case kGat:
      if (al == nullptr || cf == nullptr || vc == nullptr || heads < 1 ||
          dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kGat><<<blocks, threads, 0, stream>>>(
          gv, ep, er, es, xv, ev, al, cf, vc, qv, ov, num_edges, d, heads, dh);
      break;
    case kTransformer:
      if (al == nullptr || cf == nullptr || qv == nullptr || heads < 1 ||
          dh < 1 || heads * dh != d)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_edge_grad_kernel<T, P, kTransformer><<<blocks, threads, 0, stream>>>(
          gv, ep, er, es, xv, ev, al, cf, vc, qv, ov, num_edges, d, heads, dh);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// g [N, d] (the layer's output cotangent by destination row, permuted
// order), edge_pos [E], ent_row [P], ent_src [P] int32; gine: x [N, d]
// (the layer's input) and ea [E, d] of g's type; gat: alpha, coef [P,
// heads] fp32 and vec [d] fp32 (att_src); transformer: alpha, coef and xd
// [N, d] of g's type (the query rows). out [E, d] of g's type. dtype: 0 =
// fp32, 1 = bf16; mode: 0 gine, 1 gat, 2 transformer. vec_path: 1 when d *
// sizeof(T) is a multiple of 16 and every row table is 16-byte aligned.
extern "C" int gigl_ell_edge_grad(const void* g, const void* edge_pos,
                                  const void* ent_row, const void* ent_src,
                                  const void* x, const void* ea,
                                  const void* alpha, const void* coef,
                                  const void* vec, const void* xd, void* out,
                                  long long num_edges, int d, int heads,
                                  int dh, int dtype, int mode, int vec_path,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = vec_path ? launch<float, 4>(g, edge_pos, ent_row, ent_src, x, ea,
                                     alpha, coef, vec, xd, out, num_edges, d,
                                     heads, dh, mode, s)
                  : launch<float, 1>(g, edge_pos, ent_row, ent_src, x, ea,
                                     alpha, coef, vec, xd, out, num_edges, d,
                                     heads, dh, mode, s);
  } else if (dtype == 1) {
    rc = vec_path ? launch<__nv_bfloat16, 8>(g, edge_pos, ent_row, ent_src, x,
                                             ea, alpha, coef, vec, xd, out,
                                             num_edges, d, heads, dh, mode, s)
                  : launch<__nv_bfloat16, 1>(g, edge_pos, ent_row, ent_src, x,
                                             ea, alpha, coef, vec, xd, out,
                                             num_edges, d, heads, dh, mode, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
