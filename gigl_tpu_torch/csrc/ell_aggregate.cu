// K6 ell_aggregate — replaces gigl_tpu/ops/ell.py ell_gather (:237-247)
// together with the masked reduce that each conv's block applies to its
// result in ell_layer (:319-346): masked_mean / masked_sum / masked_max of
// gigl_tpu/ops/fanout.py (:34-53) for SAGE and GIN, and GCNConv.block's
// degree-weighted sum (gigl_tpu/models/convs.py:107-112).
//
// x [M, D] (fp32 or bf16), nbr [n, W] int32 rows of x, mask [n, W] ->
// out [n, D] in x's type:
//   out[i] = reduce_{j < W, mask[i, j]} w_ij * x[nbr[i, j]]
// with reduce = mean, sum or max (w = 1), or sum with the GCN weight
// w_ij = 1/sqrt(deg_dst[i] + 1) * 1/sqrt(deg_tab[nbr[i, j]] + 1) computed
// here from the degree tables (no [n, W] weight tensor), or GINE's sum
//   out[i] = sum_{j, mask[i, j]} relu(x[nbr[i, j]] + ea[eslot[i, j]])
// (GINEConv.block, gigl_tpu/models/convs.py:217-223, fused with the
// forward of ell_gather_edges, gigl_tpu/ops/ell.py:289-316: the edge
// table ea [E, D] is read through the bucket's edge slots, and the
// [n, W, D] edge block is never written; ea NULL adds nothing). The add
// and the relu are in fp32 before the one rounding. Sums accumulate in
// fp32 in slot order and round once; a row with no valid slot gives 0, and
// the mean divides by max(count, 1). Masked slots point at row 0 of x; the
// mask decides, never the index. W is not bounded (hub buckets reach 8192
// and more): every thread loops over all W slots of its row.
//
// Bound: bytes — each distinct neighbor row of x is needed once and [n, D]
// is written once; the [n, W, D] block the reference materialises is never
// written. Design: one thread per 16-byte piece of an output row (8 bf16
// or 4 fp32 values), consecutive threads across D, so every gathered row is
// read as coalesced 16-byte loads; the mask byte and the index of a slot
// are the same address for all threads of a row (one broadcast load).
// Rows that are not 16-byte multiples (or unaligned tables) take the same
// loop one element per thread.
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kMax = 2;
constexpr int kGcn = 3;
constexpr int kGine = 4;

template <typename T, int P, int OP>
__global__ void ell_aggregate_kernel(const T* __restrict__ x,
                                     const int32_t* __restrict__ nbr,
                                     const uint8_t* __restrict__ mask,
                                     const float* __restrict__ deg_dst,
                                     const float* __restrict__ deg_tab,
                                     const T* __restrict__ ea,
                                     const int32_t* __restrict__ eslot,
                                     T* __restrict__ out, int64_t n, int w,
                                     int d) {
  const int pieces = d / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n * pieces) return;
  const int64_t r = i / pieces;
  const int c = static_cast<int>(i - r * pieces) * P;
  float acc[P];
#pragma unroll
  for (int e = 0; e < P; ++e)
    acc[e] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  float w_dst = 0.f;
  if (OP == kGcn) w_dst = 1.f / sqrtf(__ldg(deg_dst + r) + 1.f);
  const int32_t* nrow = nbr + r * w;
  const uint8_t* mrow = mask + r * w;
  int cnt = 0;
  for (int j = 0; j < w; ++j) {
    if (!__ldg(mrow + j)) continue;
    const int64_t s = __ldg(nrow + j);
    ++cnt;
    float v[P];
    load_piece<T, P>(x + s * d + c, v);
    if (OP == kGcn) {
      const float wt = w_dst * (1.f / sqrtf(__ldg(deg_tab + s) + 1.f));
#pragma unroll
      for (int e = 0; e < P; ++e) acc[e] += v[e] * wt;
    } else if (OP == kGine) {
      float ev[P];
#pragma unroll
      for (int e = 0; e < P; ++e) ev[e] = 0.f;
      if (ea != nullptr)
        load_piece<T, P>(ea + static_cast<int64_t>(__ldg(eslot + r * w + j)) *
                                  d + c, ev);
#pragma unroll
      for (int e = 0; e < P; ++e) acc[e] += fmaxf(v[e] + ev[e], 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < P; ++e)
        acc[e] = OP == kMax ? fmaxf(acc[e], v[e]) : acc[e] + v[e];
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
  store_piece<T, P>(out + r * d + c, acc);
}

template <typename T, int P>
int launch(const void* x, const void* nbr, const void* mask,
           const void* deg_dst, const void* deg_tab, const void* ea,
           const void* eslot, void* out, long long n, int w, int d, int op,
           cudaStream_t stream) {
  const long long total = n * (d / P);
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const T* xv = static_cast<const T*>(x);
  const int32_t* nv = static_cast<const int32_t*>(nbr);
  const uint8_t* mv = static_cast<const uint8_t*>(mask);
  const float* dd = static_cast<const float*>(deg_dst);
  const float* dt = static_cast<const float*>(deg_tab);
  const T* ev = static_cast<const T*>(ea);
  const int32_t* es = static_cast<const int32_t*>(eslot);
  T* ov = static_cast<T*>(out);
  switch (op) {
    case kMean:
      ell_aggregate_kernel<T, P, kMean><<<blocks, threads, 0, stream>>>(
          xv, nv, mv, dd, dt, ev, es, ov, n, w, d);
      break;
    case kSum:
      ell_aggregate_kernel<T, P, kSum><<<blocks, threads, 0, stream>>>(
          xv, nv, mv, dd, dt, ev, es, ov, n, w, d);
      break;
    case kMax:
      ell_aggregate_kernel<T, P, kMax><<<blocks, threads, 0, stream>>>(
          xv, nv, mv, dd, dt, ev, es, ov, n, w, d);
      break;
    case kGcn:
      if (deg_dst == nullptr || deg_tab == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_aggregate_kernel<T, P, kGcn><<<blocks, threads, 0, stream>>>(
          xv, nv, mv, dd, dt, ev, es, ov, n, w, d);
      break;
    case kGine:
      if (ea != nullptr && eslot == nullptr)
        return static_cast<int>(cudaErrorInvalidValue);
      ell_aggregate_kernel<T, P, kGine><<<blocks, threads, 0, stream>>>(
          xv, nv, mv, dd, dt, ev, es, ov, n, w, d);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; op: 0 = mean, 1 = sum, 2 = max, 3 = GCN
// weighted sum (deg_dst [n] and deg_tab [M] fp32, NULL otherwise), 4 =
// GINE (ea [E, D] of x's type and eslot [n, W] int32, or both NULL); vec:
// 1 when D * sizeof(T) is a multiple of 16 and x, ea and out are 16-byte
// aligned.
extern "C" int gigl_ell_aggregate(const void* x, const void* nbr,
                                  const void* mask, const void* deg_dst,
                                  const void* deg_tab, const void* ea,
                                  const void* eslot, void* out, long long n,
                                  int w, int d, int dtype, int op, int vec,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = vec ? launch<float, 4>(x, nbr, mask, deg_dst, deg_tab, ea, eslot,
                                out, n, w, d, op, s)
             : launch<float, 1>(x, nbr, mask, deg_dst, deg_tab, ea, eslot,
                                out, n, w, d, op, s);
  } else if (dtype == 1) {
    rc = vec ? launch<__nv_bfloat16, 8>(x, nbr, mask, deg_dst, deg_tab, ea,
                                        eslot, out, n, w, d, op, s)
             : launch<__nv_bfloat16, 1>(x, nbr, mask, deg_dst, deg_tab, ea,
                                        eslot, out, n, w, d, op, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
