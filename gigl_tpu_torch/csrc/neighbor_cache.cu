// K2 build_neighbor_cache — replaces gigl_tpu/ops/hopcache.py
// build_neighbor_cache (:51-93): a K1 draw of `fanout` neighbors per node,
// a gather of their feature rows, and a masked mean / sum / gcn-weighted sum.
//
// Bound: bytes. At the flagship shape (N=100k, fanout 10, D=128 fp32) it
// reads each drawn row once (~100k distinct rows of 512 B), the drawn CSR
// slots and indptr, and writes N*512 B: ~0.106 GB, 0.0316 ms at 3.35 TB/s.
// The gather itself moves ~1M rows (0.51 GB) at random from a 51 MB table
// that does not fit the 50 MB L2: the misses' DRAM traffic bounds it
// there (2 to 16 rows held in flight a lane never beat one at a time;
// PERF.md §6). The JAX version materialises the [chunk, k, D]
// gathered block; here no [N, k, D] tensor ever exists, and a node's
// slots are drawn once, with K1's device function, whatever D is. Two
// forms, chosen by measurement:
//
// - The warp form (fp32 rows, and every weighted draw): a warp a node at
//   full occupancy. Lane l draws slot s0 + l (32 slots a draw); then, for
//   each column chunk of 32 pieces, one slot's row at a time, its id
//   broadcast by a shuffle, added in slot order in fp32. The weighted draw
//   is K19's, weighted_offsets' Gumbel top-k (or plain top-k) over the
//   node's first 128 CSR slots (the reference's default weight_window), by
//   the same device code (gigl_common.cuh WarpTopK: the key registers
//   that hold a valid slot, 32-bit words, two warp reduces a round); its
//   rounds stop at the node's valid slots.
// - The group form (int8 rows, uniform draw): a group of lanes a node,
//   sized so that each lane loads a 16-byte piece of a row (8 lanes for
//   int8 D 128: 4 nodes a warp; 4-byte pieces where the row is not a
//   multiple of 16 bytes). The group draws into shared memory (the ids and
//   int8 scales, and gcn weights), then each lane issues the row loads of
//   a chunk of kSlotChunk slots before their adds, holding the loaded words
//   as they are. The chunk is small on purpose: rows held in registers cost
//   resident warps.
//
// Both add in slot order in fp32, as the first version did: the same
// bits. With more than one draw of 32 slots (fanout > 32), a column
// chunk's partial sum waits in the output row (fp32, so exact) for the
// next draw (the group form keeps it in registers where the row is one
// column chunk). The output rows are stored evict-first, so that they
// pass through the L2 without evicting the feature rows the gather reads
// (2-8% faster, PERF.md §6), and through a row stride, straight into
// the right half of the fused [N, D + D] table (training/dataset.py:378-383
// concatenates instead).
//
// int8 mode (`scale` given): the features are a per-row symmetric int8
// table [N, D] (ops/quantized.py's QuantizedTable). Each value is
// dequantized as the reference's gather does, float(q) * scale rounded
// once to fp32 (__fmul_rn, never fused into the accumulation), before the
// same fp32 accumulation. float(q) is exact as (2^23 + q + 128) -
// (2^23 + 128) from a byte permute, which spares the integer-to-float
// conversion its low issue rate.
#include "gigl_common.cuh"

namespace {

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kGcn = 2;

constexpr int kF32 = 0;  // a piece: 4 fp32 values, one 16-byte word
constexpr int kQ16 = 1;  // 16 int8 values, one 16-byte word
constexpr int kQ4 = 2;   // 4 int8 values, one 4-byte word (rows of 4k bytes)

constexpr int kCacheWindow = 128;  // sample_neighbors' weight_window
constexpr int kDrawSlots = 32;     // slots a node's draw takes at once
constexpr int kMinGroup = 4;       // the group form: lanes a node, at least
constexpr int kSlotChunk = 2;      // the group form: slot rows in flight
// the warp form: its slot loop unrolled (2 and 4 measured slower)
constexpr int kWarpUnroll = 1;
// The warp form's resident blocks an SM, at least (its launch bound): 8
// keeps the uniform draw's forms at 32 registers, full occupancy (34 cost
// the flagship 9%); the weighted draw's window needs more.
constexpr int kWarpMinBlocks = 8;
constexpr int kWeightedMinBlocks = 6;
constexpr int kCacheThreads = 256;

// float(q) of the signed byte `sel` of w (w's bytes XORed with 0x80: the
// byte q + 128), exactly: 2^23 + q + 128 as a float's bits, less
// 2^23 + 128, both integers a float holds.
__device__ __forceinline__ float byte_value(uint32_t biased, uint32_t sel) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, sel)) - 8388736.f;
}

template <int PIECE>
struct Piece;

template <>
struct Piece<kF32> {
  using Word = uint4;
  static constexpr int V = 4;
  static __device__ __forceinline__ void values(const Word& w, float,
                                                float* v) {
    v[0] = __uint_as_float(w.x);
    v[1] = __uint_as_float(w.y);
    v[2] = __uint_as_float(w.z);
    v[3] = __uint_as_float(w.w);
  }
};

// Four int8 values of one 32-bit word times the row's scale s.
__device__ __forceinline__ void int8_values(uint32_t w, float s, float* v) {
  const uint32_t b = w ^ 0x80808080u;
  // selectors: byte e of b at bits 0-7, bytes 5, 6, 7 of the pair (the
  // constant's 0x00, 0x00, 0x4B) above it
  v[0] = __fmul_rn(byte_value(b, 0x7650u), s);
  v[1] = __fmul_rn(byte_value(b, 0x7651u), s);
  v[2] = __fmul_rn(byte_value(b, 0x7652u), s);
  v[3] = __fmul_rn(byte_value(b, 0x7653u), s);
}

template <>
struct Piece<kQ16> {
  using Word = uint4;
  static constexpr int V = 16;
  static __device__ __forceinline__ void values(const Word& w, float s,
                                                float* v) {
    int8_values(w.x, s, v);
    int8_values(w.y, s, v + 4);
    int8_values(w.z, s, v + 8);
    int8_values(w.w, s, v + 12);
  }
};

template <>
struct Piece<kQ4> {
  using Word = uint32_t;
  static constexpr int V = 4;
  static __device__ __forceinline__ void values(const Word& w, float s,
                                                float* v) {
    int8_values(w, s, v);
  }
};

struct Params {
  const int32_t* __restrict__ indptr;
  const int32_t* __restrict__ indices;
  int64_t n_edges, n_nodes;
  const void* __restrict__ features;
  const float* __restrict__ scale;
  const float* __restrict__ degrees;
  const float* __restrict__ weights;
  int64_t n_weights;
  bool gumbel;
  int fanout;
  uint32_t seed, hop;
  float* __restrict__ out;
  int64_t out_stride;
  int pieces, group;
};

// One lane's piece of an output row, stored evict-first (st.global.cs).
template <int V>
__device__ __forceinline__ void store_piece(float* dst, int c, const float* acc) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    __stcs(reinterpret_cast<float4*>(dst) + c * (V / 4) + q,
           make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]));
  }
}

template <int V>
__device__ __forceinline__ void load_piece(const float* dst, int c,
                                           float* acc) {
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
    const float4 a = reinterpret_cast<const float4*>(dst)[c * (V / 4) + q];
    acc[4 * q] = a.x;
    acc[4 * q + 1] = a.y;
    acc[4 * q + 2] = a.z;
    acc[4 * q + 3] = a.w;
  }
}

// acc += x (sum, mean) or x * w (gcn), value by value.
template <int AGG, int V>
__device__ __forceinline__ void add_row(float* acc, const float* x, float w) {
#pragma unroll
  for (int e = 0; e < V; ++e)
    acc[e] = AGG == kGcn ? __fmaf_rn(x[e], w, acc[e]) : acc[e] + x[e];
}

// The warp form's node v (warp-uniform): a warp a node; PIECE kF32 or
// kQ4 (4 values a lane). W: the weighted draw, its window in L key
// registers a lane (WarpTopK, L covering min(deg, 128) slots).
template <int AGG, int PIECE, bool W, int L>
__device__ __forceinline__ void warp_node(const Params& p, int64_t v,
                                          int32_t start, int32_t deg) {
  using P = Piece<PIECE>;
  constexpr int V = P::V;
  constexpr bool Q8 = PIECE != kF32;
  const int lane = threadIdx.x & 31;
  const int cnt = deg <= p.fanout ? deg : p.fanout;  // valid slots: [0, cnt)
  float* dst = p.out + v * p.out_stride;
  const int pieces = p.pieces;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (cnt == 0) {
    for (int c = lane; c < pieces; c += 32) store_piece<V>(dst, c, acc);
    return;
  }
  gigl::WarpTopK<L> win;
  if (W) {
    win.load(p.weights, p.n_weights, start, deg, static_cast<uint32_t>(v),
             p.seed, p.hop, kCacheWindow, p.gumbel);
  }
  for (int s0 = 0; s0 < cnt; s0 += kDrawSlots) {
    const int nb = cnt - s0 < kDrawSlots ? cnt - s0 : kDrawSlots;
    // The draw of slots [s0, s0 + nb), lane l slot s0 + l (the rounds past
    // cnt are invalid, so K19's top-k stops there).
    const int j = W ? win.pick(s0, s0 + nb) : 0;
    int32_t nbr = 0;
    float w = 1.f, sc = 1.f;
    if (lane < nb) {
      const gigl::UniformDraw d =
          W ? gigl::weighted_draw(start, deg, j, s0 + lane, p.fanout,
                                  p.n_edges)
            : gigl::draw_uniform(start, deg, static_cast<int32_t>(v), p.seed,
                                 p.hop, s0 + lane, p.fanout, p.n_edges);
      nbr = __ldg(p.indices + d.edge_slot);
      if (AGG == kGcn) w = rsqrtf(__ldg(p.degrees + nbr) + 1.f);
      if (Q8) sc = __ldg(p.scale + nbr);
    }
    const bool last = s0 + nb >= cnt;
    for (int c0 = 0; c0 < pieces; c0 += 32) {
      const int c = c0 + lane;
      if (s0 == 0) {
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
      } else if (c < pieces) {  // this column chunk's partial sum
        load_piece<V>(dst, c, acc);
      }
#pragma unroll (kWarpUnroll)
      for (int b = 0; b < nb; ++b) {
        const int32_t u = __shfl_sync(0xffffffffu, nbr, b);
        const float wb = AGG == kGcn ? __shfl_sync(0xffffffffu, w, b) : 1.f;
        const float sb = Q8 ? __shfl_sync(0xffffffffu, sc, b) : 1.f;
        if (c < pieces) {
          float x[V];
          P::values(__ldg(static_cast<const typename P::Word*>(p.features) +
                          static_cast<int64_t>(u) * pieces + c),
                    sb, x);
          add_row<AGG, V>(acc, x, wb);
        }
      }
      if (c < pieces) {
        if (last && AGG == kMean) {
          const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] /= n;
        }
        store_piece<V>(dst, c, acc);
      }
    }
  }
}

// The warp form: a warp a node. The weighted draw's body is chosen by the
// node's live key registers, ceil(min(deg, 128) / 32) rounded up to 1, 2
// or 4 (warp-uniform).
template <int AGG, int PIECE, bool W>
__global__ void __launch_bounds__(kCacheThreads,
                                  W ? kWeightedMinBlocks : kWarpMinBlocks)
    neighbor_cache_warp_kernel(const Params p) {
  // One warp per node; blockDim is a multiple of 32, so v is warp-uniform.
  const int64_t v =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (v >= p.n_nodes) return;
  const int32_t start = __ldg(p.indptr + v);
  const int32_t deg = __ldg(p.indptr + v + 1) - start;
  constexpr int kKeys = kCacheWindow / 32;
  if constexpr (!W) {
    warp_node<AGG, PIECE, W, 1>(p, v, start, deg);
  } else {
    const int valid = deg < 0 ? 0 : (deg < kCacheWindow ? deg : kCacheWindow);
    if (valid <= 32) {
      warp_node<AGG, PIECE, W, 1>(p, v, start, deg);
    } else if (valid <= 64) {
      warp_node<AGG, PIECE, W, 2>(p, v, start, deg);
    } else {
      warp_node<AGG, PIECE, W, kKeys>(p, v, start, deg);
    }
  }
}

// The group form: a group of p.group lanes (a power of two) a node over
// int8 rows; PIECE kQ16 or kQ4.
template <int AGG, int PIECE>
__global__ void __launch_bounds__(kCacheThreads)
    neighbor_cache_group_kernel(const Params p) {
  using P = Piece<PIECE>;
  using Word = typename P::Word;
  constexpr int V = P::V;
  // the shared words of a drawn slot: its neighbor, gcn weight, scale
  constexpr int kWords = 2 + (AGG == kGcn);
  extern __shared__ int32_t drawn[];
  // blockDim is a multiple of 32, so v is uniform across the group.
  const int group = p.group;
  const int lane = threadIdx.x & 31;
  const int gl = lane & (group - 1);
  const int64_t v =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) / group;
  if (v >= p.n_nodes) return;
  const unsigned gmask = group == 32
                             ? 0xffffffffu
                             : ((1u << group) - 1u) << (lane & ~(group - 1));
  int32_t* ids = drawn + (threadIdx.x / group) * kDrawSlots * kWords;
  float* wts = reinterpret_cast<float*>(ids + kDrawSlots);
  float* scs = reinterpret_cast<float*>(ids + kDrawSlots * (kWords - 1));
  const int32_t start = __ldg(p.indptr + v);
  const int32_t deg = __ldg(p.indptr + v + 1) - start;
  const int cnt = deg <= p.fanout ? deg : p.fanout;  // valid slots: [0, cnt)
  float* dst = p.out + v * p.out_stride;
  const int pieces = p.pieces;
  const bool one_col = pieces <= group;
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if (cnt == 0) {
    for (int c = gl; c < pieces; c += group) store_piece<V>(dst, c, acc);
    return;
  }
  for (int s0 = 0; s0 < cnt; s0 += kDrawSlots) {
    const int nb = cnt - s0 < kDrawSlots ? cnt - s0 : kDrawSlots;
    // The draw: lane gl slots gl, gl + G, ... of [s0, s0 + nb).
    for (int b = gl; b < nb; b += group) {
      const gigl::UniformDraw d =
          gigl::draw_uniform(start, deg, static_cast<int32_t>(v), p.seed,
                             p.hop, s0 + b, p.fanout, p.n_edges);
      const int32_t nbr = __ldg(p.indices + d.edge_slot);
      ids[b] = nbr;
      if (AGG == kGcn) wts[b] = rsqrtf(__ldg(p.degrees + nbr) + 1.f);
      scs[b] = __ldg(p.scale + nbr);
    }
    __syncwarp(gmask);
    const bool last = s0 + nb >= cnt;
    for (int c0 = 0; c0 < pieces; c0 += group) {
      const int c = c0 + gl;
      if (c < pieces) {
        if (s0 == 0) {
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] = 0.f;
        } else if (!one_col) {  // this column chunk's partial sum
          load_piece<V>(dst, c, acc);
        }
        for (int j0 = 0; j0 < nb; j0 += kSlotChunk) {
          const int nv = nb - j0 < kSlotChunk ? nb - j0 : kSlotChunk;
          Word held[kSlotChunk];
#pragma unroll
          for (int s = 0; s < kSlotChunk; ++s) {
            if (s < nv) {
              held[s] = __ldg(static_cast<const Word*>(p.features) +
                              static_cast<int64_t>(ids[j0 + s]) * pieces + c);
            }
          }
#pragma unroll
          for (int s = 0; s < kSlotChunk; ++s) {
            if (s < nv) {
              float x[V];
              P::values(held[s], scs[j0 + s], x);
              add_row<AGG, V>(acc, x, AGG == kGcn ? wts[j0 + s] : 1.f);
            }
          }
        }
        if (last && AGG == kMean) {
          const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
          for (int e = 0; e < V; ++e) acc[e] /= n;
        }
        if (last || !one_col) store_piece<V>(dst, c, acc);
      }
    }
    __syncwarp(gmask);  // the group's reads of this draw before the next
  }
}

// fp32 rows and the weighted draw take the warp form (int8 rows in 4-byte
// pieces there); uniform int8 rows the group form, a group the least power
// of two (4 to 32) that covers the row's pieces of 16 bytes (of 4 where the
// row is not a multiple of 16 bytes; the table is 16-byte aligned).
template <int AGG>
void launch_agg(Params p, int dim, cudaStream_t s) {
  const bool q8 = p.scale != nullptr;
  if (!q8 || p.weights != nullptr) {
    p.pieces = dim / 4;
    p.group = 32;
    const unsigned blocks = static_cast<unsigned>(
        (p.n_nodes * 32 + kCacheThreads - 1) / kCacheThreads);
    if (p.weights != nullptr) {
      if (q8) {
        neighbor_cache_warp_kernel<AGG, kQ4, true>
            <<<blocks, kCacheThreads, 0, s>>>(p);
      } else {
        neighbor_cache_warp_kernel<AGG, kF32, true>
            <<<blocks, kCacheThreads, 0, s>>>(p);
      }
    } else {
      neighbor_cache_warp_kernel<AGG, kF32, false>
          <<<blocks, kCacheThreads, 0, s>>>(p);
    }
    return;
  }
  const bool q16 = dim % 16 == 0;
  p.pieces = dim / (q16 ? 16 : 4);
  p.group = kMinGroup;
  while (p.group < 32 && p.group < p.pieces) p.group *= 2;
  const unsigned blocks = static_cast<unsigned>(
      (p.n_nodes * p.group + kCacheThreads - 1) / kCacheThreads);
  const size_t smem = static_cast<size_t>(kCacheThreads / p.group) *
                      kDrawSlots * (2 + (AGG == kGcn)) * sizeof(int32_t);
  if (q16) {
    neighbor_cache_group_kernel<AGG, kQ16>
        <<<blocks, kCacheThreads, smem, s>>>(p);
  } else {
    neighbor_cache_group_kernel<AGG, kQ4>
        <<<blocks, kCacheThreads, smem, s>>>(p);
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
  Params p{};
  p.indptr = static_cast<const int32_t*>(indptr);
  p.indices = static_cast<const int32_t*>(indices);
  p.n_edges = n_edges;
  p.n_nodes = n_nodes;
  p.features = features;
  p.scale = static_cast<const float*>(scale);
  p.degrees = static_cast<const float*>(degrees);
  p.weights = static_cast<const float*>(weights);
  p.n_weights = n_weights;
  p.gumbel = method == 1;
  p.fanout = fanout;
  p.seed = seed;
  p.hop = hop;
  p.out = static_cast<float*>(out);
  p.out_stride = out_stride;
  if (n_nodes > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (agg == kMean) {
      launch_agg<kMean>(p, dim, s);
    } else if (agg == kSum) {
      launch_agg<kSum>(p, dim, s);
    } else if (agg == kGcn) {
      launch_agg<kGcn>(p, dim, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
