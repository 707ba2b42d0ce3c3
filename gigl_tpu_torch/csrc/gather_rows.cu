// K3 gather_rows — replaces gigl_tpu/training/dataset.py
// sample_hop_blocks_tabularized (:387-417) and hydrate_fused (:419-434)
// (the row gather that the deleted Pallas gather_rows kernel did).
//
// One kernel, two modes:
//   expand  (parent != null): gather [M, k] int32 rows of a packed sample
//           table (-1 = no neighbor) and emit mask = row >= 0 & parent,
//           nbr = mask ? row : 0;
//   rows    (parent == null): gather rows of 32-bit words (the fused
//           [x | agg] f32 rows, or any row of 4-byte-multiple width) and,
//           when row_vals is given, the per-row scalar (degrees) alongside.
// Ids are clamped into [0, n_rows - 1] as XLA's gather clamps.
//
// Bound: bytes — every gathered row is read once and written once. Design:
// one thread per 16-byte piece of an output row (4-byte pieces when the
// row width or stride is not a multiple of 16 bytes), consecutive threads
// on consecutive pieces, so each row is one or more fully coalesced
// 128-byte transactions and the random access is per row, not per element.
//
// Byte mode (gigl_gather_rows_bytes): rows of any byte width and stride —
// the owner side of a routed gather over a quantized partitioned graph's
// bit-packed int8 rows (dist_sampled.py :206-218), whose width D + 8 or D +
// Dc + 12 need not be a multiple of 4 — a thread a byte, consecutive
// threads on consecutive bytes of a row.
#include "gigl_common.cuh"

namespace {

template <bool EXPAND, int VEC>
__global__ void gather_rows_kernel(
    const uint32_t* __restrict__ table, int64_t n_rows, int64_t stride_words,
    int row_vecs, const int32_t* __restrict__ ids, int64_t m,
    const uint8_t* __restrict__ parent, uint32_t* __restrict__ out,
    uint8_t* __restrict__ out_mask, const float* __restrict__ row_vals,
    float* __restrict__ out_vals) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * row_vecs) return;
  const int64_t r = i / row_vecs;
  const int c = static_cast<int>(i - r * row_vecs);
  int64_t src = ids[r];
  src = src < 0 ? 0 : (src > n_rows - 1 ? n_rows - 1 : src);
  const uint32_t* row = table + src * stride_words;
  if constexpr (EXPAND) {
    const int32_t val = static_cast<int32_t>(__ldg(row + c));
    const bool ok = val >= 0 && parent[r] != 0;
    out[i] = static_cast<uint32_t>(ok ? val : 0);
    out_mask[i] = ok ? 1 : 0;
  } else {
    if constexpr (VEC == 4) {
      reinterpret_cast<uint4*>(out)[i] =
          __ldg(reinterpret_cast<const uint4*>(row) + c);
    } else {
      out[i] = __ldg(row + c);
    }
    if (row_vals != nullptr && c == 0) out_vals[r] = __ldg(row_vals + src);
  }
}

template <bool EXPAND, int VEC>
void launch(const void* table, long long n_rows, long long stride_words,
            int row_words, const void* ids, long long m, const void* parent,
            void* out, void* out_mask, const void* row_vals, void* out_vals,
            cudaStream_t stream) {
  const int row_vecs = row_words / VEC;
  const long long total = m * row_vecs;
  if (total == 0) return;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  gather_rows_kernel<EXPAND, VEC>
      <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
          static_cast<const uint32_t*>(table), n_rows, stride_words, row_vecs,
          static_cast<const int32_t*>(ids), m,
          static_cast<const uint8_t*>(parent), static_cast<uint32_t*>(out),
          static_cast<uint8_t*>(out_mask), static_cast<const float*>(row_vals),
          static_cast<float*>(out_vals));
}

__global__ void gather_row_bytes_kernel(const uint8_t* __restrict__ table,
                                        int64_t n_rows, int64_t stride,
                                        int row_bytes,
                                        const int32_t* __restrict__ ids,
                                        int64_t m,
                                        uint8_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * row_bytes) return;
  const int64_t r = i / row_bytes;
  int64_t src = ids[r];
  src = src < 0 ? 0 : (src > n_rows - 1 ? n_rows - 1 : src);
  out[i] = __ldg(table + src * stride + (i - r * row_bytes));
}

}  // namespace

// Byte mode: table [n_rows] rows of row_bytes bytes, stride bytes apart;
// ids [m] int32; out [m, row_bytes].
extern "C" int gigl_gather_rows_bytes(const void* table, long long n_rows,
                                      long long stride, int row_bytes,
                                      const void* ids, long long m, void* out,
                                      void* stream) {
  if (n_rows < 1 || row_bytes < 1 || stride < row_bytes || m < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = m * row_bytes;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  gather_row_bytes_kernel<<<static_cast<unsigned>((total + threads - 1) /
                                                  threads),
                            threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(table), n_rows, stride, row_bytes,
      static_cast<const int32_t*>(ids), m, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gigl_gather_rows(const void* table, long long n_rows,
                                long long stride_words, int row_words,
                                const void* ids, long long m,
                                const void* parent, void* out, void* out_mask,
                                const void* row_vals, void* out_vals,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = row_words % 4 == 0 && stride_words % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (parent != nullptr) {
    launch<true, 1>(table, n_rows, stride_words, row_words, ids, m, parent,
                    out, out_mask, nullptr, nullptr, s);
  } else if (vec4) {
    launch<false, 4>(table, n_rows, stride_words, row_words, ids, m, nullptr,
                     out, nullptr, row_vals, out_vals, s);
  } else {
    launch<false, 1>(table, n_rows, stride_words, row_words, ids, m, nullptr,
                     out, nullptr, row_vals, out_vals, s);
  }
  return static_cast<int>(cudaGetLastError());
}
