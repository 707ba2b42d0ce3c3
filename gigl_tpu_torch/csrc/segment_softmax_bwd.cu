// K9b segment_softmax_bwd — replaces the backward that jax's autodiff gives
// gigl_tpu/ops/segment.py segment_softmax (:51-61): from the saved softmax
// alpha [E, H] and the cotangent g [E, H] of alpha,
//   dlogits[e, h] = alpha[e, h] * (g[e, h] - sum_{e' in seg(e)} alpha[e', h] * g[e', h])
// per head, walking the destination SegmentIndex (order, ptr) of the forward.
// (The reference's segment max is not under a stop-gradient, but its terms
// cancel: d alpha / d max = 0.) Every edge lies in one segment, so each
// output is written once; fp32 arithmetic, one rounding to the type.
//
// Bound: bytes — alpha, g and the index read once, dlogits written once.
// Design: as K9, one warp per segment; one pass for the per-head sums of
// alpha * g (an edge's H values are one contiguous row, read together),
// lanes striding over the segment's edges, each head's sum reduced across
// the warp by an xor butterfly (every lane ends with the same bits, in a
// fixed order: the same result on every run), then a pass that writes
// dlogits. At most kMaxHeads heads, held in registers.
#include "gigl_pieces.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxHeads = 16;

template <typename T>
__global__ void segment_softmax_bwd_kernel(const T* __restrict__ alpha,
                                           const T* __restrict__ g,
                                           const int32_t* __restrict__ order,
                                           const int32_t* __restrict__ ptr,
                                           T* __restrict__ out, int64_t s,
                                           int heads) {
  const int lane = threadIdx.x & 31;
  const int64_t seg =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (seg >= s) return;  // uniform across the warp
  const int32_t lo = __ldg(ptr + seg);
  const int32_t hi = __ldg(ptr + seg + 1);
  float dot[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) dot[h] = 0.f;
  for (int32_t j = lo + lane; j < hi; j += 32) {
    const int64_t o = static_cast<int64_t>(__ldg(order + j)) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads)
        dot[h] = fmaf(gigl::to_float(alpha[o + h]), gigl::to_float(g[o + h]),
                      dot[h]);
  }
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) {
    if (h < heads) {  // uniform across the warp
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot[h] += __shfl_xor_sync(kFull, dot[h], off);
    }
  }
  for (int32_t j = lo + lane; j < hi; j += 32) {
    const int64_t o = static_cast<int64_t>(__ldg(order + j)) * heads;
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      if (h < heads) {
        const float a = gigl::to_float(alpha[o + h]);
        out[o + h] =
            gigl::from_float<T>(a * (gigl::to_float(g[o + h]) - dot[h]));
      }
    }
  }
}

}  // namespace

// alpha, g and out [E, heads] (fp32: dtype 0, bf16: 1), order [E] and ptr
// [S + 1] int32 (the destination SegmentIndex); 1 <= heads <= 16.
extern "C" int gigl_segment_softmax_bwd(const void* alpha, const void* g,
                                        const void* order, const void* ptr,
                                        void* out, long long s, int heads,
                                        int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (heads <= 0 || heads > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return 0;
  const int threads = 256;  // 8 segments per block
  const unsigned blocks = static_cast<unsigned>((s * 32 + threads - 1) / threads);
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  if (dtype == 0) {
    segment_softmax_bwd_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(alpha), static_cast<const float*>(g), ov,
        pv, static_cast<float*>(out), s, heads);
  } else if (dtype == 1) {
    segment_softmax_bwd_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(alpha),
        static_cast<const __nv_bfloat16*>(g), ov, pv,
        static_cast<__nv_bfloat16*>(out), s, heads);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
