// Row-piece helpers shared by the segment kernels (K8, K9, K10) and the
// ELL kernels (K6, K6b): fp32 or bf16 values converted to fp32 and back,
// and one 16-byte piece of a row (4 fp32 or 8 bf16 values) loaded or
// stored at once; a piece can be held as loaded (HeldPiece) and widened
// later, which halves a bf16 piece's registers. P == 1 is the
// one-element path for rows that are not 16-byte multiples or tables that
// are not 16-byte aligned.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>
#include <type_traits>

namespace gigl {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t w) {
  __nv_bfloat162 h;
  memcpy(&h, &w, sizeof(h));
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  uint32_t w;
  memcpy(&w, &h, sizeof(w));
  return w;
}

// One piece of a row as loaded: P values of type T at p, P == 1 (any
// alignment) or one 16-byte piece (P = 16 / sizeof(T), p 16-byte aligned),
// held as a 16-byte word until widen() converts it.
template <typename T, int P>
using HeldPiece = std::conditional_t<P == 1, T, uint4>;

template <typename T, int P>
__device__ __forceinline__ HeldPiece<T, P> load_held(const T* __restrict__ p) {
  if constexpr (P == 1) {
    return *p;
  } else {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
}

template <typename T, int P>
__device__ __forceinline__ void widen(const HeldPiece<T, P>& raw, float* v) {
  if constexpr (P == 1) {
    v[0] = to_float(raw);
  } else if constexpr (sizeof(T) == 4) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  } else {
    float2 f;
    f = unpack_bf16(raw.x); v[0] = f.x; v[1] = f.y;
    f = unpack_bf16(raw.y); v[2] = f.x; v[3] = f.y;
    f = unpack_bf16(raw.z); v[4] = f.x; v[5] = f.y;
    f = unpack_bf16(raw.w); v[6] = f.x; v[7] = f.y;
  }
}

// The P values of the piece at p, in fp32.
template <typename T, int P>
__device__ __forceinline__ void load_piece(const T* __restrict__ p, float* v) {
  widen<T, P>(load_held<T, P>(p), v);
}

template <typename T, int P>
__device__ __forceinline__ void store_piece(T* __restrict__ p, const float* v) {
  if constexpr (P == 1) {
    *p = from_float<T>(v[0]);
  } else if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                   __float_as_uint(v[2]), __float_as_uint(v[3]));
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

}  // namespace gigl
