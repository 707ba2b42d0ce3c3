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
//
// One launch takes up to kMaxSegments gathers (segments), each its own
// table, ids, output type and row values: a sampled batch's every tree
// level from both int8 tables (the features with their degrees, and the
// neighbor cache) is one launch, where one launch a level and table cost
// a small grid's fixed time each (PERF.md §6). The segments go by value
// in the kernel's parameters (a __grid_constant__ struct, safe to capture
// in a CUDA graph), with each segment's first block; a block finds its
// segment from those prefixes, then gathers in that segment's piece form
// (the widest its D and bases allow). Where every non-empty segment takes
// the same form, the launch's kernel is that form's alone (a switch on
// each segment's form measured 6.5% slower on an H100, PERF.md §6); a
// lone gather is one segment of the same kernel.
// Ids are clamped into [0, N - 1] as XLA's gather clamps them.
//
// Packed-row mode — replaces gigl_tpu/training/dist_sampled.py
// PartitionedGraph.split_rows (:285-317) over one shard's closed form of
// the routed gather (feat_deg_l[ids], :791-812): rows of a quantized
// partitioned graph's bit-packed [N, D + 8] / [N, D + Dc + 12] int8 table
// gathered by id and decoded in the same pass (gigl_q8.cuh, a warp a row)
// into fp32 features, cache and degrees. Its own launch, not a segment: a
// packed row carries its scales in its own tail and decodes into three
// outputs, so it shares no piece form with the plain segments, and its
// path gathers one id vector (a batch's union) a call. Bound: bytes (each
// distinct gathered row's W bytes read once, 4 (D + Dc) + 4 bytes written
// a row).
#include <cuda_bf16.h>

#include <cstdint>

#include "gigl_common.cuh"
#include "gigl_q8.cuh"

namespace {

// Segments one launch takes: ops/quantized.py MAX_SEGMENTS.
constexpr int kMaxSegments = 8;
constexpr int kThreads = 256;

// Piece forms: (output type, values a thread).
constexpr int kF32x4 = 0;   // 16-byte stores of 4 fp32, 4-byte int8 loads
constexpr int kF32x1 = 1;
constexpr int kBf16x8 = 2;  // 16-byte stores of 8 bf16, 8-byte int8 loads
constexpr int kBf16x4 = 3;  // 8-byte stores of 4 bf16
constexpr int kBf16x1 = 4;
constexpr int kAnyForm = -1;

struct Segment {
  const int8_t* q;
  const float* scale;
  int64_t n_rows;
  const int32_t* ids;
  int64_t m;
  void* out;
  const float* row_vals;  // and out_vals: both or neither
  float* out_vals;
  int dim;
  int form;
};

struct Segments {
  int count;
  unsigned block0[kMaxSegments + 1];  // segment k: blocks [block0[k], [k+1])
  Segment seg[kMaxSegments];
};

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

// Piece i of segment g (row i / (dim / VEC), its piece i % (dim / VEC)).
template <typename T, int VEC>
__device__ __forceinline__ void gather_piece(const Segment& g, int64_t i) {
  const int row_vecs = g.dim / VEC;
  if (i >= g.m * row_vecs) return;
  const int64_t r = i / row_vecs;
  const int c = static_cast<int>(i - r * row_vecs);
  int64_t src = g.ids[r];
  src = src < 0 ? 0 : (src > g.n_rows - 1 ? g.n_rows - 1 : src);
  const float s = __ldg(g.scale + src);
  alignas(16) int8_t v[VEC];
  load_q<VEC>(g.q + src * g.dim + static_cast<int64_t>(c) * VEC, v);
  alignas(16) T o[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    o[k] = to_out<T>(__fmul_rn(static_cast<float>(v[k]), s));
  store_out<T, VEC>(static_cast<T*>(g.out) + r * g.dim +
                        static_cast<int64_t>(c) * VEC,
                    o);
  if (g.row_vals != nullptr && c == 0) g.out_vals[r] = __ldg(g.row_vals + src);
}

template <int FORM>
__device__ __forceinline__ void gather_form(const Segment& g, int64_t i) {
  if constexpr (FORM == kF32x4) gather_piece<float, 4>(g, i);
  if constexpr (FORM == kF32x1) gather_piece<float, 1>(g, i);
  if constexpr (FORM == kBf16x8) gather_piece<__nv_bfloat16, 8>(g, i);
  if constexpr (FORM == kBf16x4) gather_piece<__nv_bfloat16, 4>(g, i);
  if constexpr (FORM == kBf16x1) gather_piece<__nv_bfloat16, 1>(g, i);
}

// FORM: every segment's piece form, or kAnyForm (each segment's own).
template <int FORM>
__global__ void __launch_bounds__(kThreads)
    gather_rows_q8_kernel(const __grid_constant__ Segments s) {
  int k = 0;
  while (blockIdx.x >= s.block0[k + 1]) ++k;
  const Segment& g = s.seg[k];
  const int64_t i =
      static_cast<int64_t>(blockIdx.x - s.block0[k]) * kThreads + threadIdx.x;
  if constexpr (FORM != kAnyForm) {
    gather_form<FORM>(g, i);
  } else {
    switch (g.form) {
      case kF32x4: gather_form<kF32x4>(g, i); break;
      case kF32x1: gather_form<kF32x1>(g, i); break;
      case kBf16x8: gather_form<kBf16x8>(g, i); break;
      case kBf16x4: gather_form<kBf16x4>(g, i); break;
      default: gather_form<kBf16x1>(g, i); break;
    }
  }
}

// The widest piece form D and the bases allow: 16-byte stores of 4 fp32
// or 8 bf16 values; 4 values (bf16: 8-byte stores) where D % 4 == 0; else
// one.
int piece_form(int out_dtype, int dim, uintptr_t qa, uintptr_t oa) {
  const int wide = out_dtype == 0 ? 4 : 8;
  if (dim % wide == 0 && qa % wide == 0 && oa % 16 == 0)
    return out_dtype == 0 ? kF32x4 : kBf16x8;
  if (dim % 4 == 0 && qa % 4 == 0 && oa % 16 == 0)
    return out_dtype == 0 ? kF32x4 : kBf16x4;
  return out_dtype == 0 ? kF32x1 : kBf16x1;
}

int form_values(int form) {
  return form == kBf16x8 ? 8 : (form == kF32x4 || form == kBf16x4) ? 4 : 1;
}

__global__ void gather_packed_q8_kernel(const int8_t* __restrict__ table,
                                        int64_t n_rows, int row_bytes, int d,
                                        int dc,
                                        const int32_t* __restrict__ ids,
                                        int64_t m, float* __restrict__ feat,
                                        float* __restrict__ cache,
                                        float* __restrict__ deg) {
  const int64_t r =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (r >= m) return;
  int64_t src = ids[r];
  src = src < 0 ? 0 : (src > n_rows - 1 ? n_rows - 1 : src);
  gigl::decode_packed_row(table + src * row_bytes, d, dc, threadIdx.x & 31,
                          r, feat, cache, deg);
}

}  // namespace

// segs: count (1 to kMaxSegments) segments, ten int64 each: q ([n_rows,
// dim] int8, rows contiguous), scale ([n_rows] fp32), n_rows, dim, ids
// ([m] int32), m, out_dtype (0 = fp32, 1 = bf16), out ([m, dim]),
// row_vals ([n_rows] fp32) and out_vals ([m] fp32), or both 0. All
// gathered in one launch (none where every m is 0).
extern "C" int gigl_gather_rows_q8_many(const void* segs, int count,
                                        void* stream) {
  if (count < 1 || count > kMaxSegments)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* table = static_cast<const long long*>(segs);
  Segments s{};
  s.count = count;
  s.block0[0] = 0;
  int shared = -3;  // the non-empty segments' form (-3: none yet, -2: mixed)
  for (int k = 0; k < count; ++k) {
    const long long* row = table + 10 * k;
    Segment& g = s.seg[k];
    const int out_dtype = static_cast<int>(row[6]);
    g.q = reinterpret_cast<const int8_t*>(row[0]);
    g.scale = reinterpret_cast<const float*>(row[1]);
    g.n_rows = row[2];
    g.dim = static_cast<int>(row[3]);
    g.ids = reinterpret_cast<const int32_t*>(row[4]);
    g.m = row[5];
    g.out = reinterpret_cast<void*>(row[7]);
    g.row_vals = reinterpret_cast<const float*>(row[8]);
    g.out_vals = reinterpret_cast<float*>(row[9]);
    if (g.n_rows <= 0 || g.dim <= 0 || g.m < 0 ||
        (out_dtype != 0 && out_dtype != 1))
      return static_cast<int>(cudaErrorInvalidValue);
    g.form = piece_form(out_dtype, g.dim, reinterpret_cast<uintptr_t>(g.q),
                        reinterpret_cast<uintptr_t>(g.out));
    const long long pieces = g.m * (g.dim / form_values(g.form));
    s.block0[k + 1] =
        s.block0[k] + static_cast<unsigned>((pieces + kThreads - 1) / kThreads);
    if (pieces > 0) shared = shared == -3 || shared == g.form ? g.form : -2;
  }
  for (int k = count + 1; k <= kMaxSegments; ++k) s.block0[k] = s.block0[count];
  const unsigned blocks = s.block0[count];
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (shared >= 0 ? shared : kAnyForm) {
    case kF32x4:
      gather_rows_q8_kernel<kF32x4><<<blocks, kThreads, 0, st>>>(s);
      break;
    case kF32x1:
      gather_rows_q8_kernel<kF32x1><<<blocks, kThreads, 0, st>>>(s);
      break;
    case kBf16x8:
      gather_rows_q8_kernel<kBf16x8><<<blocks, kThreads, 0, st>>>(s);
      break;
    case kBf16x4:
      gather_rows_q8_kernel<kBf16x4><<<blocks, kThreads, 0, st>>>(s);
      break;
    case kBf16x1:
      gather_rows_q8_kernel<kBf16x1><<<blocks, kThreads, 0, st>>>(s);
      break;
    default:
      gather_rows_q8_kernel<kAnyForm><<<blocks, kThreads, 0, st>>>(s);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

// Packed-row mode: table [n_rows, row_bytes] int8 (row_bytes = d + 8, or
// d + dc + 12 with the cache), ids [m] int32; feat [m, d], cache [m, dc]
// (nullptr when dc == 0) and deg [m] fp32 written.
extern "C" int gigl_gather_packed_q8(const void* table, long long n_rows,
                                     int row_bytes, int d, int dc,
                                     const void* ids, long long m,
                                     void* feat, void* cache, void* deg,
                                     void* stream) {
  if (n_rows < 1 || d < 1 || dc < 0 || m < 0 ||
      row_bytes != d + dc + (dc > 0 ? 12 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  // an empty output's pointer may be null
  if (m == 0) return static_cast<int>(cudaGetLastError());
  if ((dc > 0) != (cache != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (m * 32 + kThreads - 1) / kThreads;
  gather_packed_q8_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(table), n_rows, row_bytes, d, dc,
      static_cast<const int32_t*>(ids), m, static_cast<float*>(feat),
      static_cast<float*>(cache), static_cast<float*>(deg));
  return static_cast<int>(cudaGetLastError());
}
