// K2 build_neighbor_cache — replaces gigl_tpu/ops/hopcache.py
// build_neighbor_cache (:51-93): a K1 draw of `fanout` neighbors per node,
// a gather of their feature rows, and a masked mean / sum / gcn-weighted sum.
//
// Bound: bytes. At the flagship shape (N=100k, fanout 10, D=128 fp32) it
// must read ~N*10*512 B of neighbor rows and write N*512 B: ~0.56 GB, about
// 0.17 ms at 3.35 TB/s. The JAX version materialises the [chunk, k, D]
// gathered block; here one warp owns one node: lanes draw the slots with
// K1's device function (so no [N, k, D] tensor ever exists), the ids are
// broadcast with shuffles, and each lane gathers 16-byte pieces of every
// neighbor row, accumulating in fp32 in slot order. The result is written
// through a row stride, straight into the right half of the fused
// [N, D + D] table (training/dataset.py:378-383 concatenates instead).
#include "gigl_common.cuh"

namespace {

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kGcn = 2;

template <int AGG>
__global__ void neighbor_cache_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, int64_t n_nodes, const float4* __restrict__ features,
    int d4, const float* __restrict__ degrees, int fanout, uint32_t seed,
    uint32_t hop, float* __restrict__ out, int64_t out_stride) {
  const int lane = threadIdx.x & 31;
  // One warp per node; blockDim is a multiple of 32, so v is warp-uniform.
  const int64_t v =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (v >= n_nodes) return;
  const int32_t start = __ldg(indptr + v);
  const int32_t deg = __ldg(indptr + v + 1) - start;
  const int cnt = deg <= fanout ? deg : fanout;  // valid slots
  float4* dst = reinterpret_cast<float4*>(out + v * out_stride);
  for (int c0 = 0; c0 < d4; c0 += 32) {
    const int c = c0 + lane;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < fanout; s0 += 32) {
      const int s = s0 + lane;
      int32_t nbr = 0;
      int valid = 0;
      float w = 1.f;
      if (s < fanout) {
        const gigl::UniformDraw d = gigl::draw_uniform(
            start, deg, static_cast<int32_t>(v), seed, hop, s, fanout,
            n_edges);
        if (d.valid) {
          valid = 1;
          nbr = __ldg(indices + d.edge_slot);
          if (AGG == kGcn) w = rsqrtf(__ldg(degrees + nbr) + 1.f);
        }
      }
      const int nb = min(32, fanout - s0);
      for (int j = 0; j < nb; ++j) {
        const int32_t u = __shfl_sync(0xffffffffu, nbr, j);
        const int ok = __shfl_sync(0xffffffffu, valid, j);
        const float wj = __shfl_sync(0xffffffffu, w, j);
        if (ok && c < d4) {
          const float4 x = __ldg(features + static_cast<int64_t>(u) * d4 + c);
          if (AGG == kGcn) {
            acc.x += x.x * wj;
            acc.y += x.y * wj;
            acc.z += x.z * wj;
            acc.w += x.w * wj;
          } else {
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
          }
        }
      }
    }
    if (c < d4) {
      if (AGG == kMean) {
        const float n = static_cast<float>(cnt > 1 ? cnt : 1);
        acc.x /= n;
        acc.y /= n;
        acc.z /= n;
        acc.w /= n;
      }
      dst[c] = acc;
    }
  }
}

}  // namespace

extern "C" int gigl_build_neighbor_cache(
    const void* indptr, const void* indices, long long n_edges,
    long long n_nodes, const void* features, int dim, const void* degrees,
    int fanout, uint32_t seed, uint32_t hop, int agg, void* out,
    long long out_stride, void* stream) {
  if (n_nodes > 0) {
    const int threads = 256;  // 8 nodes per block
    const long long blocks = (n_nodes * 32 + threads - 1) / threads;
    const int d4 = dim / 4;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GIGL_LAUNCH_CACHE(AGG)                                               \
  neighbor_cache_kernel<AGG><<<static_cast<unsigned>(blocks), threads, 0, s>>>( \
      static_cast<const int32_t*>(indptr),                                   \
      static_cast<const int32_t*>(indices), n_edges, n_nodes,                \
      static_cast<const float4*>(features), d4,                              \
      static_cast<const float*>(degrees), fanout, seed, hop,                 \
      static_cast<float*>(out), out_stride)
    if (agg == kMean) {
      GIGL_LAUNCH_CACHE(kMean);
    } else if (agg == kSum) {
      GIGL_LAUNCH_CACHE(kSum);
    } else if (agg == kGcn) {
      GIGL_LAUNCH_CACHE(kGcn);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
#undef GIGL_LAUNCH_CACHE
  }
  return static_cast<int>(cudaGetLastError());
}
