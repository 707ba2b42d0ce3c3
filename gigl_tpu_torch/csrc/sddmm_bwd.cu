// K10b sddmm_bwd — the per-edge pass of the backward that jax's autodiff
// gives gigl_tpu/ops/segment.py sddmm (:90-103), with the port's per-head
// scale (out[e, h] = scale[h] * raw[e, h], raw = <q[dst_e, h], k[src_e, h]>):
//   coef[e, h] = g[e, h] * scale[h]                    (fp32, every edge)
//   dscale[h]  = sum_e g[e, h] * raw[e, h]              (when scale trains)
// coef weighs the two gathers of the rest of the backward, which are other
// kernels' forwards over the two indexes (ops/segment.py SDDMM.backward):
// dq[d] = sum_{e: dst_e = d} coef[e] * k[src_e] is K8 over the destination
// index, dk[s] = sum_{e: src_e = s} coef[e] * q[dst_e] is K8b's walk of the
// source-sorted index.
//
// dscale is a reduction over all E edges, done in two deterministic stages
// without atomics: gigl_sddmm_bwd_coef gives each of G blocks a fixed
// stride of edges and writes one fp32 partial sum per (block, head), summed
// in the block by a shared-memory tree in a fixed order; gigl_sddmm_bwd_scale
// then sums the G partials of each head in one block, in a fixed order. The
// same bits on every run.
//
// Bound: bytes — g (and raw) read once, coef written once, the partials
// (G * H fp32) negligible. Design: one thread per edge (its H heads in a
// loop), a grid of at most 1,024 blocks striding over the edges.
#include "gigl_pieces.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHeads = 16;

template <typename T>
__global__ void sddmm_bwd_coef_kernel(const T* __restrict__ g,
                                      const float* __restrict__ scale,
                                      const T* __restrict__ raw,
                                      float* __restrict__ coef,
                                      float* __restrict__ partial, int64_t e,
                                      int heads) {
  __shared__ float red[kThreads];
  float acc[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < e; i += stride) {
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        const float gv = gigl::to_float(g[i * heads + h]);
        coef[i * heads + h] = scale != nullptr ? gv * __ldg(scale + h) : gv;
        if (raw != nullptr)
          acc[h] = fmaf(gv, gigl::to_float(raw[i * heads + h]), acc[h]);
      }
    }
  }
  if (raw == nullptr) return;  // uniform: no dscale wanted
  for (int h = 0; h < heads; ++h) {
    float a = 0.f;
#pragma unroll
    for (int hh = 0; hh < kMaxHeads; ++hh)
      if (hh == h) a = acc[hh];
    red[threadIdx.x] = a;
    __syncthreads();
    for (int off = kThreads / 2; off > 0; off >>= 1) {
      if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
      __syncthreads();
    }
    if (threadIdx.x == 0) partial[static_cast<int64_t>(blockIdx.x) * heads + h] = red[0];
    __syncthreads();
  }
}

__global__ void sddmm_bwd_scale_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dscale, int blocks,
                                       int heads) {
  __shared__ float red[kThreads];
  const int h = blockIdx.x;
  float a = 0.f;
  for (int b = threadIdx.x; b < blocks; b += kThreads)
    a += __ldg(partial + static_cast<int64_t>(b) * heads + h);
  red[threadIdx.x] = a;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off) red[threadIdx.x] += red[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) dscale[h] = red[0];
}

}  // namespace

// g [E, heads] (fp32: dtype 0, bf16: 1), scale fp32 [heads] or NULL (1),
// raw [E, heads] of g's type or NULL (no dscale), coef fp32 [E, heads],
// partial fp32 [blocks, heads] (unused without raw), blocks = the grid
// (the caller's min(max(ceil(E / 256), 1), 1024): a function of E alone).
// heads <= 16.
extern "C" int gigl_sddmm_bwd_coef(const void* g, const void* scale,
                                   const void* raw, void* coef, void* partial,
                                   long long e, int heads, int blocks,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || heads > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0) return 0;
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const float* sv = static_cast<const float*>(scale);
  float* cv = static_cast<float*>(coef);
  float* pv = static_cast<float*>(partial);
  if (dtype == 0) {
    sddmm_bwd_coef_kernel<float><<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(g), sv, static_cast<const float*>(raw), cv,
        pv, e, heads);
  } else if (dtype == 1) {
    sddmm_bwd_coef_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), sv,
        static_cast<const __nv_bfloat16*>(raw), cv, pv, e, heads);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// partial fp32 [blocks, heads] -> dscale fp32 [heads] (one block per head).
extern "C" int gigl_sddmm_bwd_scale(const void* partial, void* dscale,
                                    int blocks, int heads, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  sddmm_bwd_scale_kernel<<<heads, kThreads, 0, st>>>(
      static_cast<const float*>(partial), static_cast<float*>(dscale), blocks,
      heads);
  return static_cast<int>(cudaGetLastError());
}
