// K12 gather_rows_q8 — replaces gigl_tpu/ops/quantized.py
// QuantizedTable.__getitem__ (:98-109) with _unpack_int32_rows (:38-44),
// the work the deleted Pallas gather_rows_int8 did: a gather of rows of a
// per-row symmetric int8 table [N, D] with their fp32 scales [N], each value
// dequantized as the reference does it, (float(q) * scale) rounded once to
// the output type (fp32 or bf16); optionally a per-row fp32 scalar (the
// degree) gathered alongside, as K3's rows mode does.
//
// Bound: bytes — each gathered int8 row (D bytes) and its scale read once,
// the [M, D] output written once (4 or 2 bytes a value, so the writes are
// 2-4x the reads). Design: the table stays int8 [N, D] (the reference's
// int32 packing was a workaround for the TPU's gather). Each thread stores
// 16 bytes of an output row: 4 fp32 or 8 bf16 values, from a 4- or 8-byte
// load of int8 values (4 values where only D % 4 == 0; one value a thread
// where D % 4 != 0); consecutive threads on consecutive pieces of a row, so
// a warp reads and writes whole rows in full transactions. (A first
// version loaded 16 int8 values a thread and stored 64 bytes in four
// strided stores: 1.6x K3's time over the fp32 rows on an H100.) The
// multiply is __fmul_rn (never fused into an FMA), so the rounding is the
// reference's.
// Ids are clamped into [0, N - 1] as XLA's gather clamps them.
#include <cuda_bf16.h>

#include <cstdint>

#include "gigl_common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int VEC>
__device__ __forceinline__ void load_q(const int8_t* p, int8_t (&v)[VEC]) {
  if constexpr (VEC == 8) {
    *reinterpret_cast<int2*>(v) = __ldg(reinterpret_cast<const int2*>(p));
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<int*>(v) = __ldg(reinterpret_cast<const int*>(p));
  } else {
    v[0] = p[0];
  }
}

// Store VEC values of type T in 16-, 8-byte or scalar pieces.
template <typename T, int VEC>
__device__ __forceinline__ void store_out(T* p, const T (&o)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k)
      reinterpret_cast<uint4*>(p)[k] = reinterpret_cast<const uint4*>(o)[k];
  } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
    for (int k = 0; k < kBytes / 8; ++k)
      reinterpret_cast<uint2*>(p)[k] = reinterpret_cast<const uint2*>(o)[k];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = o[k];
  }
}

template <typename T, int VEC>
__global__ void gather_rows_q8_kernel(
    const int8_t* __restrict__ q, const float* __restrict__ scale,
    int64_t n_rows, int dim, const int32_t* __restrict__ ids, int64_t m,
    T* __restrict__ out, const float* __restrict__ row_vals,
    float* __restrict__ out_vals) {
  const int row_vecs = dim / VEC;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * row_vecs) return;
  const int64_t r = i / row_vecs;
  const int c = static_cast<int>(i - r * row_vecs);
  int64_t src = ids[r];
  src = src < 0 ? 0 : (src > n_rows - 1 ? n_rows - 1 : src);
  const float s = __ldg(scale + src);
  alignas(16) int8_t v[VEC];
  load_q<VEC>(q + src * dim + static_cast<int64_t>(c) * VEC, v);
  alignas(16) T o[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    o[k] = to_out<T>(__fmul_rn(static_cast<float>(v[k]), s));
  store_out<T, VEC>(out + r * dim + static_cast<int64_t>(c) * VEC, o);
  if (row_vals != nullptr && c == 0) out_vals[r] = __ldg(row_vals + src);
}

template <typename T, int VEC>
void launch(const void* q, const void* scale, long long n_rows, int dim,
            const void* ids, long long m, void* out, const void* row_vals,
            void* out_vals, cudaStream_t stream) {
  const long long total = m * (dim / VEC);
  if (total == 0) return;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_rows_q8_kernel<T, VEC>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scale),
          n_rows, dim, static_cast<const int32_t*>(ids), m,
          static_cast<T*>(out), static_cast<const float*>(row_vals),
          static_cast<float*>(out_vals));
}

// 16-byte stores: 4 fp32 or 8 bf16 values a thread where D and the bases
// allow it; 4 values (bf16: 8-byte stores) where D % 4 == 0; else one.
template <typename T>
void dispatch(const void* q, const void* scale, long long n_rows, int dim,
              const void* ids, long long m, void* out, const void* row_vals,
              void* out_vals, cudaStream_t s) {
  constexpr int kWide = 16 / static_cast<int>(sizeof(T));
  const uintptr_t qa = reinterpret_cast<uintptr_t>(q);
  const uintptr_t oa = reinterpret_cast<uintptr_t>(out);
  if (dim % kWide == 0 && qa % kWide == 0 && oa % 16 == 0) {
    launch<T, kWide>(q, scale, n_rows, dim, ids, m, out, row_vals, out_vals,
                     s);
  } else if (dim % 4 == 0 && qa % 4 == 0 && oa % 16 == 0) {
    launch<T, 4>(q, scale, n_rows, dim, ids, m, out, row_vals, out_vals, s);
  } else {
    launch<T, 1>(q, scale, n_rows, dim, ids, m, out, row_vals, out_vals, s);
  }
}

}  // namespace

// q: [n_rows, dim] int8 (rows contiguous), scale: [n_rows] fp32, ids: [m]
// int32; out: [m, dim], out_dtype 0 = fp32, 1 = bf16; row_vals [n_rows]
// fp32 and out_vals [m] fp32, or both NULL.
extern "C" int gigl_gather_rows_q8(const void* q, const void* scale,
                                   long long n_rows, int dim, const void* ids,
                                   long long m, int out_dtype, void* out,
                                   const void* row_vals, void* out_vals,
                                   void* stream) {
  if (n_rows <= 0 || dim <= 0 || (out_dtype != 0 && out_dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 0) {
    dispatch<float>(q, scale, n_rows, dim, ids, m, out, row_vals, out_vals, s);
  } else {
    dispatch<__nv_bfloat16>(q, scale, n_rows, dim, ids, m, out, row_vals,
                            out_vals, s);
  }
  return static_cast<int>(cudaGetLastError());
}
