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
//
// int8 mode (`scale` given): the features are a per-row symmetric int8
// table [N, D] (ops/quantized.py's QuantizedTable) and each lane reads 4
// int8 values of a neighbor row (4 bytes, a quarter of the fp32 row's
// bytes) and that row's scale, dequantizing each value as the reference's
// gather does, float(q) * scale rounded once to fp32 (__fmul_rn, never fused
// into the accumulation), before the same fp32 accumulation in slot order.
//
// Weighted mode (`weights` given; a template flag, so the uniform launches
// are unchanged): the draw is K19's, weighted_offsets' Gumbel top-k (or
// plain top-k) over the node's first 128 CSR slots (the reference's
// default weight_window), by the same warp arg-max device code
// (gigl_common.cuh WarpWindow, 4 keys a lane); the gather and the reduce
// are unchanged.
#include "gigl_common.cuh"

namespace {

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kGcn = 2;

// Four values of row u (pieces of 4 from c): fp32, or int8 times the row's
// scale s.
template <bool Q8>
__device__ __forceinline__ float4 row_piece(const void* features, int d4,
                                            int32_t u, int c, float s) {
  const int64_t at = static_cast<int64_t>(u) * d4 + c;
  if constexpr (Q8) {
    const char4 b = __ldg(static_cast<const char4*>(features) + at);
    return make_float4(__fmul_rn(static_cast<float>(b.x), s),
                       __fmul_rn(static_cast<float>(b.y), s),
                       __fmul_rn(static_cast<float>(b.z), s),
                       __fmul_rn(static_cast<float>(b.w), s));
  } else {
    return __ldg(static_cast<const float4*>(features) + at);
  }
}

constexpr int kCacheWindow = 128;  // sample_neighbors' weight_window

template <int AGG, bool Q8, bool W>
__global__ void neighbor_cache_kernel(
    const int32_t* __restrict__ indptr, const int32_t* __restrict__ indices,
    int64_t n_edges, int64_t n_nodes, const void* __restrict__ features,
    const float* __restrict__ scale, int d4,
    const float* __restrict__ degrees, const float* __restrict__ weights,
    int64_t n_weights, bool gumbel, int fanout, uint32_t seed,
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
    gigl::WarpWindow<kCacheWindow / 32> win;
    if (W) {
      win.load(weights, n_weights, start, deg, static_cast<uint32_t>(v),
               seed, hop, kCacheWindow, gumbel);
    }
    for (int s0 = 0; s0 < fanout; s0 += 32) {
      const int s = s0 + lane;
      const int j = W ? win.pick(s0, fanout) : 0;
      int32_t nbr = 0;
      int valid = 0;
      float w = 1.f;
      float sc = 1.f;
      if (s < fanout) {
        const gigl::UniformDraw d =
            W ? gigl::weighted_draw(start, deg, j, s, fanout, n_edges)
              : gigl::draw_uniform(start, deg, static_cast<int32_t>(v), seed,
                                   hop, s, fanout, n_edges);
        if (d.valid) {
          valid = 1;
          nbr = __ldg(indices + d.edge_slot);
          if (AGG == kGcn) w = rsqrtf(__ldg(degrees + nbr) + 1.f);
          if (Q8) sc = __ldg(scale + nbr);
        }
      }
      const int nb = min(32, fanout - s0);
      for (int j = 0; j < nb; ++j) {
        const int32_t u = __shfl_sync(0xffffffffu, nbr, j);
        const int ok = __shfl_sync(0xffffffffu, valid, j);
        const float wj = __shfl_sync(0xffffffffu, w, j);
        const float sj = __shfl_sync(0xffffffffu, sc, j);
        if (ok && c < d4) {
          const float4 x = row_piece<Q8>(features, d4, u, c, sj);
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

// The draw's operands: the sampling weights (null for the uniform draw),
// their count and whether the weighted draw adds the Gumbel term.
struct Draw {
  const float* weights;
  long long n_weights;
  bool gumbel;
};

template <int AGG, bool Q8, bool W>
void launch_cache(const void* indptr, const void* indices, long long n_edges,
                  long long n_nodes, const void* features, const void* scale,
                  int d4, const void* degrees, Draw draw, int fanout,
                  uint32_t seed, uint32_t hop, void* out,
                  long long out_stride, cudaStream_t s) {
  const int threads = 256;  // 8 nodes per block
  const long long blocks = (n_nodes * 32 + threads - 1) / threads;
  neighbor_cache_kernel<AGG, Q8, W><<<static_cast<unsigned>(blocks), threads,
                                      0, s>>>(
      static_cast<const int32_t*>(indptr),
      static_cast<const int32_t*>(indices), n_edges, n_nodes, features,
      static_cast<const float*>(scale), d4,
      static_cast<const float*>(degrees), draw.weights, draw.n_weights,
      draw.gumbel, fanout, seed, hop, static_cast<float*>(out), out_stride);
}

template <int AGG, bool Q8>
void launch_draw(const void* indptr, const void* indices, long long n_edges,
                 long long n_nodes, const void* features, const void* scale,
                 int d4, const void* degrees, Draw draw, int fanout,
                 uint32_t seed, uint32_t hop, void* out,
                 long long out_stride, cudaStream_t s) {
  if (draw.weights != nullptr) {
    launch_cache<AGG, Q8, true>(indptr, indices, n_edges, n_nodes, features,
                                scale, d4, degrees, draw, fanout, seed, hop,
                                out, out_stride, s);
  } else {
    launch_cache<AGG, Q8, false>(indptr, indices, n_edges, n_nodes, features,
                                 scale, d4, degrees, draw, fanout, seed, hop,
                                 out, out_stride, s);
  }
}

template <int AGG>
void launch_agg(const void* indptr, const void* indices, long long n_edges,
                long long n_nodes, const void* features, const void* scale,
                int d4, const void* degrees, Draw draw, int fanout,
                uint32_t seed, uint32_t hop, void* out, long long out_stride,
                cudaStream_t s) {
  if (scale != nullptr) {
    launch_draw<AGG, true>(indptr, indices, n_edges, n_nodes, features,
                           scale, d4, degrees, draw, fanout, seed, hop, out,
                           out_stride, s);
  } else {
    launch_draw<AGG, false>(indptr, indices, n_edges, n_nodes, features,
                            scale, d4, degrees, draw, fanout, seed, hop, out,
                            out_stride, s);
  }
}

}  // namespace

// features: [n_nodes, dim] fp32, or int8 when scale ([n_nodes] fp32) is
// given; dim % 4 == 0. out: [n_nodes, dim] fp32 rows at out_stride floats.
// method: 0 = uniform (weights null), 1 = weighted, 2 = top_k (weights
// [n_weights] fp32 in CSR slot order; fanout <= 128).
extern "C" int gigl_build_neighbor_cache(
    const void* indptr, const void* indices, long long n_edges,
    long long n_nodes, const void* features, const void* scale, int dim,
    const void* degrees, const void* weights, long long n_weights,
    int method, int fanout, uint32_t seed, uint32_t hop, int agg, void* out,
    long long out_stride, void* stream) {
  if (method < 0 || method > 2 || (method == 0) != (weights == nullptr) ||
      (method != 0 && fanout > kCacheWindow)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Draw draw{static_cast<const float*>(weights), n_weights, method == 1};
  if (n_nodes > 0) {
    const int d4 = dim / 4;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (agg == kMean) {
      launch_agg<kMean>(indptr, indices, n_edges, n_nodes, features, scale,
                        d4, degrees, draw, fanout, seed, hop, out, out_stride,
                        s);
    } else if (agg == kSum) {
      launch_agg<kSum>(indptr, indices, n_edges, n_nodes, features, scale,
                       d4, degrees, draw, fanout, seed, hop, out, out_stride,
                       s);
    } else if (agg == kGcn) {
      launch_agg<kGcn>(indptr, indices, n_edges, n_nodes, features, scale,
                       d4, degrees, draw, fanout, seed, hop, out, out_stride,
                       s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
