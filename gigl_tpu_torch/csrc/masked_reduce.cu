// K4 masked_reduce — replaces gigl_tpu/ops/fanout.py masked_mean,
// masked_sum, masked_max (:34-53), the reduce of fanout_aggregate (:56-80).
//
// x [M, K, D] (fp32 or bf16) and mask [M, K] -> out [M, D] in x's type:
// the mean, sum or max over the valid slots of each row. Sums accumulate
// in fp32 in slot order and round once; the max of a row with no valid
// slot is 0 (fanout.py:51-53), and so is its mean and sum.
//
// Bound: bytes — the [M, K, D] block is read once (layer 2 of the
// flagship encoder: 512 x 15 x 256 bf16, 3.9 MB) and [M, D] written once.
// Design: one thread per 16-byte piece of an output row (8 bf16 or 4 fp32
// values), consecutive threads across D, so each of the K slot rows is read
// as coalesced 16-byte loads; the mask byte of a slot is shared by the
// row's threads and skips the load of an invalid slot entirely.
#include <cuda_bf16.h>

#include <cstring>

#include "gigl_common.cuh"

namespace {

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kMax = 2;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ void load(const uint4& raw, float* v) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  static __device__ uint4 store(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ float2 unpack(uint32_t w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, sizeof(h));
    return __bfloat1622float2(h);
  }
  static __device__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    uint32_t w;
    memcpy(&w, &h, sizeof(w));
    return w;
  }
  static __device__ void load(const uint4& raw, float* v) {
    float2 p;
    p = unpack(raw.x); v[0] = p.x; v[1] = p.y;
    p = unpack(raw.y); v[2] = p.x; v[3] = p.y;
    p = unpack(raw.z); v[4] = p.x; v[5] = p.y;
    p = unpack(raw.w); v[6] = p.x; v[7] = p.y;
  }
  static __device__ uint4 store(const float* v) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                      pack(v[6], v[7]));
  }
};

template <typename T, int OP>
__global__ void masked_reduce_kernel(const uint4* __restrict__ x,
                                     const uint8_t* __restrict__ mask,
                                     uint4* __restrict__ out, int64_t m, int k,
                                     int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    acc[e] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  int cnt = 0;
  for (int j = 0; j < k; ++j) {
    if (!__ldg(mask + r * k + j)) continue;
    ++cnt;
    float v[N];
    Vec<T>::load(__ldg(x + (r * k + j) * dv + c), v);
#pragma unroll
    for (int e = 0; e < N; ++e)
      acc[e] = OP == kMax ? fmaxf(acc[e], v[e]) : acc[e] + v[e];
  }
  if (OP == kMax && cnt == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
  }
  if (OP == kMean) {
    const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] /= n;
  }
  out[i] = Vec<T>::store(acc);
}

// K4b masked_reduce_bwd — the backward of K4 (JAX differentiates
// masked_mean / masked_sum / masked_max by autodiff):
//   grad_x[r, j] = mask[r, j] * g[r] / max(cnt_r, 1)   (mean)
//   grad_x[r, j] = mask[r, j] * g[r]                   (sum)
//   grad_x[r, j, e] = g[r, e] / ties[r, e] where x[r, j, e] == out[r, e]
//                     among valid slots, else 0         (max)
// — the max rule of jax.vjp(jnp.max): the cotangent is shared equally among
// the valid slots equal to the max; a row with no valid slot gets 0.
// Bound: bytes — [M, K, D] written once (plus x read once for max). Same
// layout as the forward: one thread per 16-byte piece of a row, looping over
// the K slots, so every slot row is written (and read) coalesced.
template <typename T, int OP>
__global__ void masked_reduce_bwd_kernel(const uint4* __restrict__ grad_out,
                                         const uint8_t* __restrict__ mask,
                                         const uint4* __restrict__ x,
                                         const uint4* __restrict__ out,
                                         uint4* __restrict__ grad_x, int64_t m,
                                         int k, int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  const uint8_t* mrow = mask + r * k;
  float g[N];
  Vec<T>::load(__ldg(grad_out + i), g);
  float zero[N];
#pragma unroll
  for (int e = 0; e < N; ++e) zero[e] = 0.f;
  const uint4 zero_v = Vec<T>::store(zero);
  if (OP == kMax) {
    float o[N];
    Vec<T>::load(__ldg(out + i), o);
    float ties[N];
#pragma unroll
    for (int e = 0; e < N; ++e) ties[e] = 0.f;
    for (int j = 0; j < k; ++j) {
      if (!__ldg(mrow + j)) continue;
      float v[N];
      Vec<T>::load(__ldg(x + (r * k + j) * dv + c), v);
#pragma unroll
      for (int e = 0; e < N; ++e) ties[e] += v[e] == o[e] ? 1.f : 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const int64_t at = (r * k + j) * dv + c;
      if (!__ldg(mrow + j)) {
        grad_x[at] = zero_v;
        continue;
      }
      float v[N];
      Vec<T>::load(__ldg(x + at), v);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = v[e] == o[e] ? g[e] / ties[e] : 0.f;
      grad_x[at] = Vec<T>::store(v);
    }
    return;
  }
  if (OP == kMean) {
    int cnt = 0;
    for (int j = 0; j < k; ++j) cnt += __ldg(mrow + j) ? 1 : 0;
    const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] /= n;
  }
  const uint4 g_v = Vec<T>::store(g);
  for (int j = 0; j < k; ++j)
    grad_x[(r * k + j) * dv + c] = __ldg(mrow + j) ? g_v : zero_v;
}

template <typename T>
int launch_bwd(const void* grad_out, const void* mask, const void* x,
               const void* out, void* grad_x, long long m, int k, int d, int op,
               cudaStream_t stream) {
  const int dv = d / Vec<T>::N;
  const long long total = m * dv;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const uint4* gv = static_cast<const uint4*>(grad_out);
  const uint8_t* mv = static_cast<const uint8_t*>(mask);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* ov = static_cast<const uint4*>(out);
  uint4* gx = static_cast<uint4*>(grad_x);
  if (op == kMean) {
    masked_reduce_bwd_kernel<T, kMean><<<blocks, threads, 0, stream>>>(
        gv, mv, xv, ov, gx, m, k, dv);
  } else if (op == kSum) {
    masked_reduce_bwd_kernel<T, kSum><<<blocks, threads, 0, stream>>>(
        gv, mv, xv, ov, gx, m, k, dv);
  } else if (op == kMax) {
    if (x == nullptr || out == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    masked_reduce_bwd_kernel<T, kMax><<<blocks, threads, 0, stream>>>(
        gv, mv, xv, ov, gx, m, k, dv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch(const void* x, const void* mask, void* out, long long m, int k,
           int d, int op, cudaStream_t stream) {
  const int dv = d / Vec<T>::N;
  const long long total = m * dv;
  if (total == 0) return 0;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint8_t* mv = static_cast<const uint8_t*>(mask);
  uint4* ov = static_cast<uint4*>(out);
  if (op == kMean) {
    masked_reduce_kernel<T, kMean><<<blocks, threads, 0, stream>>>(xv, mv, ov, m, k, dv);
  } else if (op == kSum) {
    masked_reduce_kernel<T, kSum><<<blocks, threads, 0, stream>>>(xv, mv, ov, m, k, dv);
  } else if (op == kMax) {
    masked_reduce_kernel<T, kMax><<<blocks, threads, 0, stream>>>(xv, mv, ov, m, k, dv);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; op: 0 = mean, 1 = sum, 2 = max.
extern "C" int gigl_masked_reduce(const void* x, const void* mask, void* out,
                                  long long m, int k, int d, int dtype, int op,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(x, mask, out, m, k, d, op, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(x, mask, out, m, k, d, op, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// grad_out [M, D] and grad_x [M, K, D] in x's type; x and out (the forward's
// input and result) are read only for op 2 (max) and may be NULL otherwise.
extern "C" int gigl_masked_reduce_bwd(const void* grad_out, const void* mask,
                                      const void* x, const void* out,
                                      void* grad_x, long long m, int k, int d,
                                      int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch_bwd<float>(grad_out, mask, x, out, grad_x, m, k, d, op, s);
  } else if (dtype == 1) {
    rc = launch_bwd<__nv_bfloat16>(grad_out, mask, x, out, grad_x, m, k, d,
                                   op, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
