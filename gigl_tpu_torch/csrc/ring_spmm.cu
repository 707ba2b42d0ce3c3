// K18 ring_spmm — replaces gigl_tpu/parallel/halo.py ring_spmm (:143-193;
// its use in ring_sharded_aggregate, :196-227): the local work of one ring
// step, acc[d_t] += blk[s_t] * w_t over the bucket of (shard, step),
// which the reference runs as a gather and a scatter-add per step.
//
// One launch applies one bucket. Its real edges are sorted stably by one
// endpoint (the row) with row pointers ptr[rows + 1]; for every row r
//   acc[r, :] += sum_{j in [ptr[r], ptr[r + 1])} w[j] * x[col[j], :]
// summed in fp32 in the index's order, then added to acc[r] once. Forward:
// rows are the shard's destinations, col the sources in the block it holds
// (x = the block, acc = the shard's output rows). Backward (the transposed
// product): the same kernel over the bucket sorted by source, rows the
// block's sources, col the destinations (x = the shard's cotangent rows,
// acc = the gradient of the block held at that step). The mean reduce
// folds 1/deg into w on the host, so there is one mode. A row without
// edges in the bucket is not touched (rows with no in-edges stay 0).
//
// Bound: bytes — the bucket's index (ptr, col, w) and each distinct x row
// it reads once, each touched acc row read and written once. Design: one
// warp per row; the warp loads 32 edges' (col, w) at a time, one per lane,
// and broadcasts them with shuffles, so each edge costs one coalesced row
// read: lanes across D, 16-byte loads (4 fp32) where D % 4 == 0 and the
// bases are 16-byte aligned, 4-byte loads otherwise. Rows wider than a
// warp's 32 pieces take more passes over the row's edges. Each row has one
// owner in a launch and the launches of a ring run in order on one stream,
// so there are no atomics and the result has the same bits on every run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;  // warps per block

template <int V>
__global__ void __launch_bounds__(kWarps * 32)
ring_spmm_kernel(const float* __restrict__ x, const int32_t* __restrict__ ptr,
                 const int32_t* __restrict__ col, const float* __restrict__ w,
                 float* __restrict__ acc, int rows, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kWarps
                    + (threadIdx.x >> 5);
  if (r >= rows) return;  // the whole warp leaves together
  const int32_t lo = __ldg(ptr + r);
  const int32_t hi = __ldg(ptr + r + 1);
  if (lo >= hi) return;
  for (int base_c = 0; base_c < d; base_c += 32 * V) {
    const int c = base_c + lane * V;
    const bool active = c < d;
    float s[V];
#pragma unroll
    for (int k = 0; k < V; ++k) s[k] = 0.f;
    for (int32_t base = lo; base < hi; base += 32) {
      const int32_t j = base + lane;
      const int32_t my_col = j < hi ? __ldg(col + j) : 0;
      const float my_w = j < hi ? __ldg(w + j) : 0.f;
      const int n = min(32, hi - base);
      for (int t = 0; t < n; ++t) {
        const int64_t src = __shfl_sync(0xffffffffu, my_col, t);
        const float wt = __shfl_sync(0xffffffffu, my_w, t);
        if (!active) continue;
        const float* xr = x + src * d + c;
        if constexpr (V == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(xr));
          s[0] += wt * v.x;
          s[1] += wt * v.y;
          s[2] += wt * v.z;
          s[3] += wt * v.w;
        } else {
          s[0] += wt * __ldg(xr);
        }
      }
    }
    if (!active) continue;
    float* ar = acc + r * d + c;
    if constexpr (V == 4) {
      float4 a = *reinterpret_cast<float4*>(ar);
      a.x += s[0];
      a.y += s[1];
      a.z += s[2];
      a.w += s[3];
      *reinterpret_cast<float4*>(ar) = a;
    } else {
      ar[0] += s[0];
    }
  }
}

}  // namespace

// x [M, d] fp32 (the rows the edges read), ptr [rows + 1] int32 (each
// row's edges, relative to col / w), col [E] int32 (rows of x), w [E]
// fp32, acc [rows, d] fp32 (added to in place). vec: 1 when d % 4 == 0 and
// x and acc are 16-byte aligned (16-byte loads), else 0.
extern "C" int gigl_ring_spmm(const void* x, const void* ptr, const void* col,
                              const void* w, void* acc, int rows, int d,
                              int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows < 0 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (rows == 0 || d == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((rows + kWarps - 1) / kWarps);
  const float* xv = static_cast<const float*>(x);
  const int32_t* pv = static_cast<const int32_t*>(ptr);
  const int32_t* cv = static_cast<const int32_t*>(col);
  const float* wv = static_cast<const float*>(w);
  float* av = static_cast<float*>(acc);
  if (vec) {
    if (d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
    ring_spmm_kernel<4><<<blocks, kWarps * 32, 0, st>>>(xv, pv, cv, wv, av,
                                                        rows, d);
  } else {
    ring_spmm_kernel<1><<<blocks, kWarps * 32, 0, st>>>(xv, pv, cv, wv, av,
                                                        rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
