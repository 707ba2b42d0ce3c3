// K10 sddmm — replaces gigl_tpu/ops/segment.py sddmm (:90-103): the
// sampled dense-dense product, one score per edge and head:
//   out[e, h] = scale[h] * <q[dst[e], h, :], k[src[e], h, :]>
// q [N_dst, H * dk], k [N_src, H * dk] (fp32 or bf16, head-major rows),
// src and dst [E] int32, scale fp32 [H] or NULL (1): HGT's prior / sqrt(dk)
// per head rides along. fp32 arithmetic, one rounding to q's type.
//
// Bound: bytes — each distinct q and k row the edges read once, the ids
// once, [E, H] written. Design: one thread per 16-byte piece of an edge's
// rows (4 fp32 or 8 bf16 values; 32 threads per edge at H * dk = 128 fp32),
// so both rows are read as coalesced 16-byte loads; each thread's partial
// dot product is summed over its head's dk / P threads by an xor butterfly
// (a fixed order), and the head's first thread writes the score. Heads
// whose dk / P is not a power of two of at most 32, rows that are not
// 16-byte multiples or unaligned tables take a thread per (edge, head).
#include "gigl_pieces.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T, int P>
__global__ void sddmm_piece_kernel(const T* __restrict__ q,
                                   const T* __restrict__ k,
                                   const int32_t* __restrict__ src,
                                   const int32_t* __restrict__ dst,
                                   const float* __restrict__ scale,
                                   T* __restrict__ out, int64_t e, int c,
                                   int heads, int tph) {
  const int pieces = c / P;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = i < e * pieces;  // every lane takes part in the shuffles
  int64_t edge = 0;
  int piece = 0;
  float part = 0.f;
  if (valid) {
    edge = i / pieces;
    piece = static_cast<int>(i - edge * pieces);
    const int col = piece * P;
    float a[P], b[P];
    gigl::load_piece<T, P>(q + static_cast<int64_t>(__ldg(dst + edge)) * c + col,
                           a);
    gigl::load_piece<T, P>(k + static_cast<int64_t>(__ldg(src + edge)) * c + col,
                           b);
#pragma unroll
    for (int t = 0; t < P; ++t) part = fmaf(a[t], b[t], part);
  }
  for (int off = tph >> 1; off > 0; off >>= 1)
    part += __shfl_xor_sync(kFull, part, off);
  if (valid && piece % tph == 0) {
    const int h = piece / tph;
    if (scale != nullptr) part *= __ldg(scale + h);
    out[edge * heads + h] = gigl::from_float<T>(part);
  }
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

template <typename T, int P>
int launch(const void* q, const void* k, const void* src, const void* dst,
           const void* scale, void* out, long long e, int c, int heads,
           int vec, cudaStream_t stream) {
  const int threads = 256;
  const T* qv = static_cast<const T*>(q);
  const T* kv = static_cast<const T*>(k);
  const int32_t* sv = static_cast<const int32_t*>(src);
  const int32_t* dv = static_cast<const int32_t*>(dst);
  const float* scv = static_cast<const float*>(scale);
  T* ov = static_cast<T*>(out);
  const int tph = c / heads / P;
  if (vec && tph >= 1 && tph <= 32 && (tph & (tph - 1)) == 0) {
    const long long total = e * (c / P);
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    sddmm_piece_kernel<T, P><<<blocks, threads, 0, stream>>>(
        qv, kv, sv, dv, scv, ov, e, c, heads, tph);
  } else {
    const long long total = e * heads;
    const unsigned blocks =
        static_cast<unsigned>((total + threads - 1) / threads);
    sddmm_scalar_kernel<T><<<blocks, threads, 0, stream>>>(
        qv, kv, sv, dv, scv, ov, e, c, heads);
  }
  return 0;
}

}  // namespace

// q [N_dst, C], k [N_src, C], src / dst [E] int32, scale fp32 [heads] or
// NULL, out [E, heads]; C = heads * dk. dtype: 0 = fp32, 1 = bf16; vec: 1
// when dk * sizeof(T) is a multiple of 16 and q and k are 16-byte aligned.
extern "C" int gigl_sddmm(const void* q, const void* k, const void* src,
                          const void* dst, const void* scale, void* out,
                          long long e, int c, int heads, int dtype, int vec,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || c % heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  int rc;
  if (dtype == 0) {
    rc = launch<float, 4>(q, k, src, dst, scale, out, e, c, heads, vec, st);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16, 8>(q, k, src, dst, scale, out, e, c, heads,
                                  vec, st);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
