// K9 segment_softmax — replaces gigl_tpu/ops/segment.py segment_softmax
// (:51-61): the softmax of per-edge logits within each destination segment
// (attention over an in-neighborhood on the COO path).
//
// logits [E, H] (H = 1 for [E]) -> alpha [E, H] in the original edge order:
//   m     = max_{e in seg} logits[e, h]      (0 where it is not finite)
//   alpha = exp(logits[e, h] - m) / max(sum_{e in seg} exp(... - m), 1e-16)
// walking the SegmentIndex (order, ptr) of ops/segment.py. Every edge lies
// in one segment, so each output is written once; fp32 arithmetic, one
// rounding to the logits' type.
//
// Bound: bytes — the logits and the index read once, alpha written once.
// Design: one warp per segment; for each head, one pass for the max and
// one for the sum of exp over the segment's edges, lanes striding over
// them, each reduced across the warp by an xor butterfly (every lane ends
// with the same bits, and the association order is fixed: the same result
// on every run), then a pass that writes alpha. Low-degree segments leave
// most lanes idle; a hub segment is walked by one warp.
#include "gigl_pieces.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void segment_softmax_kernel(const T* __restrict__ logits,
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
  for (int h = 0; h < heads; ++h) {
    float m = -__int_as_float(0x7f800000);
    for (int32_t j = lo + lane; j < hi; j += 32) {
      const int64_t e = __ldg(order + j);
      m = fmaxf(m, gigl::to_float(logits[e * heads + h]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (!isfinite(m)) m = 0.f;
    float sum = 0.f;
    for (int32_t j = lo + lane; j < hi; j += 32) {
      const int64_t e = __ldg(order + j);
      sum += expf(gigl::to_float(logits[e * heads + h]) - m);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    const float denom = fmaxf(sum, 1e-16f);
    for (int32_t j = lo + lane; j < hi; j += 32) {
      const int64_t e = __ldg(order + j);
      const float a = expf(gigl::to_float(logits[e * heads + h]) - m) / denom;
      out[e * heads + h] = gigl::from_float<T>(a);
    }
  }
}

}  // namespace

// logits and out [E, heads] (fp32: dtype 0, bf16: 1), order [E] and ptr
// [S + 1] int32 (the SegmentIndex).
extern "C" int gigl_segment_softmax(const void* logits, const void* order,
                                    const void* ptr, void* out, long long s,
                                    int heads, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s == 0) return 0;
  const int threads = 256;  // 8 segments per block
  const unsigned blocks = static_cast<unsigned>((s * 32 + threads - 1) / threads);
  const int32_t* ov = static_cast<const int32_t*>(order);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  if (dtype == 0) {
    segment_softmax_kernel<float><<<blocks, threads, 0, st>>>(
        static_cast<const float*>(logits), ov, pv, static_cast<float*>(out),
        s, heads);
  } else if (dtype == 1) {
    segment_softmax_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(logits), ov, pv,
        static_cast<__nv_bfloat16*>(out), s, heads);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
