// K15 route_requests — replaces gigl_tpu/parallel/feature_lookup.py
// _route_requests (:48-80): the counting-sort bucketing of a routed
// lookup's int32 global ids by owner shard, for S request vectors of G ids
// at once ([S, G]: every shard's vector of one lookup).
//   owner = clip(id // rows, 0, P - 1)   (floor; negative ids -> shard 0)
//   pos   = the number of EARLIER requests of the vector with that owner
//   ok    = pos < C
//   req[s, owner, pos] = id where ok; every other req cell 0.
// Bound: bytes (S G ids read, 9 bytes per id and S P C ids written; a few
// integer ops per id).
//
// Design: a grid of S x ceil(G / kRouteTile) tiles, a block each (the first
// version ran one block of 32 warps for one vector: one SM). A tile's 8
// warps take contiguous chunks of its ids, 32 at a time, each lane keeping
// its kIdsPerLane ids and owners in registers; within a step the lanes with
// the same owner find each other with __match_any_sync and a lane's rank
// is the popcount of its lower peers plus its warp's running count (kept
// per owner in shared memory, added to by the lowest peer: no atomics);
// the warps' counts are then scanned per owner. So "earlier" is (earlier
// tile) or (earlier warp) or (earlier in the warp's walk) or (lower lane),
// the reference's first come, first served, and the result is bit-equal
// for any ids (duplicates, ids past P * rows, overflow); no value depends
// on the order in which two blocks run. Each id's pos is its tile's prefix
// (the vector's requests with that owner in earlier tiles) plus its rank.
// A count launch writes every tile's counts per owner; the write launch
// then sums the earlier tiles' counts (and all of them, the totals) in each
// block. The unused cells [min(total, C), C) of each owner's row are
// zeroed a slice of ceil(C / tiles) cells a tile.
// P <= kMaxShards (32).
//
// K16 unroute_rows — replaces feature_lookup.py _unroute (:83-90):
// out[i] = ok[i] ? back[owner[i], min(pos[i], C - 1)] : 0 for rows of any
// width and 2- or 4-byte type ([P, C, W] fp32 / int32 / bf16 answers).
// Bound: bytes (each answered row read once, each output row written
// once). Design: one warp per output row copying whole words: 16-byte
// words when the row is a multiple of 16 bytes (and the bases aligned),
// 4-byte words when it is a multiple of 4 (the flagship's [D + 1] = 129
// fp32 rows), 2-byte words otherwise (odd bf16 widths); the wrapper picks.
//
// K16's int8 mode — replaces dist_sampled.py PartitionedGraph.split_rows
// (:285-317) after the routed gather of a quantized partitioned graph's
// bit-packed [D + 8] / [D + Dc + 12] int8 rows: each request's answer row
// back[owner, min(pos, C - 1)] decoded in the same pass (gigl_q8.cuh: a
// warp a row) into features [G, D], the cache [G, Dc] and degrees [G], all
// fp32; zeros where the request overflowed. The packed [G, W] rows are
// never written. Bound: bytes (each answered row's W bytes read once, 4 (D
// + Dc) + 4 bytes written a row).
#include <cstdint>
#include <cuda_runtime.h>

#include "gigl_q8.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxShards = 32;
constexpr int kRouteThreads = 256;
constexpr int kRouteWarps = kRouteThreads / 32;
// Ids a tile (a block), a multiple of kRouteThreads (512, 1024, 2048 and
// 4096 measured: 512 fastest at the partitioned step's shape, PERF.md §6).
constexpr int kRouteTile = 512;
constexpr int kIdsPerLane = kRouteTile / kRouteThreads;
constexpr int kWarpIds = kRouteTile / kRouteWarps;

struct TileCounts {
  int32_t warp[kMaxShards][kRouteWarps];  // per owner: each warp's count,
                                          // then its prefix in the tile
  int32_t tile[kMaxShards];    // per owner: the tile's requests
  int32_t before[kMaxShards];  // per owner: the vector's earlier requests
  int32_t total[kMaxShards];   // per owner: the vector's requests
};

__device__ __forceinline__ int32_t owner_of(int32_t id, int32_t rows,
                                            int32_t p) {
  // floor division (the reference's //); any negative id clips to 0
  const int32_t o = id >= 0 ? id / rows : -1;
  return o < 0 ? 0 : (o > p - 1 ? p - 1 : o);
}

// The tile of a vector's ids [base, base + kRouteTile) (ids: the vector,
// g long): each thread's ids v, owners o (p past the vector) and ranks r
// among the tile's earlier requests with the same owner; sh.tile.
__device__ __forceinline__ void rank_tile(const int32_t* __restrict__ ids,
                                          int64_t g, int64_t base,
                                          int32_t rows, int32_t p,
                                          int32_t (&v)[kIdsPerLane],
                                          int32_t (&o)[kIdsPerLane],
                                          int32_t (&r)[kIdsPerLane],
                                          TileCounts& sh) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const uint32_t lower = (1u << lane) - 1u;
  for (int c = t; c < kMaxShards * kRouteWarps; c += kRouteThreads)
    sh.warp[c / kRouteWarps][c % kRouteWarps] = 0;
  const int64_t first = base + warp * kWarpIds + lane;
#pragma unroll
  for (int u = 0; u < kIdsPerLane; ++u) {
    const int64_t i = first + u * 32;
    v[u] = i < g ? ids[i] : 0;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kIdsPerLane; ++u) {
    const bool valid = first + u * 32 < g;
    o[u] = valid ? owner_of(v[u], rows, p) : p;
    const uint32_t peers = __match_any_sync(kFull, o[u]);
    r[u] = valid ? sh.warp[o[u]][warp] + __popc(peers & lower) : 0;
    __syncwarp();
    if (valid && (peers & lower) == 0) sh.warp[o[u]][warp] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  if (t < p) {  // each owner's warp counts -> prefixes over the warps
    int32_t run = 0;
    for (int w = 0; w < kRouteWarps; ++w) {
      const int32_t c = sh.warp[t][w];
      sh.warp[t][w] = run;
      run += c;
    }
    sh.tile[t] = run;
  }
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kIdsPerLane; ++u)
    if (o[u] < p) r[u] += sh.warp[o[u]][warp];
}

// The tile's requests written: owner, pos = sh.before[owner] + rank, ok,
// and req where ok (the vector's outputs: req [P, C], the others [G]).
__device__ __forceinline__ void write_tile(
    int64_t base, int32_t p, int32_t cap, const int32_t (&v)[kIdsPerLane],
    const int32_t (&o)[kIdsPerLane], const int32_t (&r)[kIdsPerLane],
    const TileCounts& sh, int32_t* __restrict__ req,
    int32_t* __restrict__ owner, int32_t* __restrict__ pos,
    uint8_t* __restrict__ ok) {
  const int t = threadIdx.x;
  const int64_t first = base + (t >> 5) * kWarpIds + (t & 31);
#pragma unroll
  for (int u = 0; u < kIdsPerLane; ++u) {
    if (o[u] >= p) continue;  // past the vector
    const int64_t i = first + u * 32;
    const int32_t k = sh.before[o[u]] + r[u];
    owner[i] = o[u];
    pos[i] = k;
    ok[i] = k < cap ? 1 : 0;
    if (k < cap) req[static_cast<int64_t>(o[u]) * cap + k] = v[u];
  }
}

// Cells [c0, c1) of each owner's req row that no request takes (from
// min(total, C)) set to 0.
__device__ __forceinline__ void zero_unused(int32_t* __restrict__ req,
                                            int32_t p, int32_t cap,
                                            int64_t c0, int64_t c1,
                                            const TileCounts& sh) {
  for (int o = 0; o < p; ++o) {
    const int64_t from = max(c0, static_cast<int64_t>(min(sh.total[o], cap)));
    for (int64_t c = from + threadIdx.x; c < c1; c += kRouteThreads)
      req[static_cast<int64_t>(o) * cap + c] = 0;
  }
}

// Count launch: counts[s, b, o] = tile b of vector s's requests for owner o.
__global__ void __launch_bounds__(kRouteThreads)
route_requests_count_kernel(const int32_t* __restrict__ ids, int64_t g,
                            int32_t rows, int32_t p, int64_t tiles,
                            int32_t* __restrict__ counts) {
  __shared__ TileCounts sh;
  const int64_t s = blockIdx.x / tiles, b = blockIdx.x % tiles;
  int32_t v[kIdsPerLane], o[kIdsPerLane], r[kIdsPerLane];
  rank_tile(ids + s * g, g, b * kRouteTile, rows, p, v, o, r, sh);
  if (threadIdx.x < p)
    counts[blockIdx.x * static_cast<int64_t>(p) + threadIdx.x] =
        sh.tile[threadIdx.x];
}

// Write launch after the count launch: the prefix and the totals from the
// counts (a warp an owner, its lanes over the tiles), the tile's requests,
// and its slice of the unused cells.
__global__ void __launch_bounds__(kRouteThreads)
route_requests_write_kernel(const int32_t* __restrict__ ids, int64_t g,
                            int32_t rows, int32_t p, int32_t cap,
                            int64_t tiles, const int32_t* __restrict__ counts,
                            int32_t* __restrict__ req,
                            int32_t* __restrict__ owner,
                            int32_t* __restrict__ pos,
                            uint8_t* __restrict__ ok) {
  __shared__ TileCounts sh;
  const int64_t s = blockIdx.x / tiles, b = blockIdx.x % tiles;
  int32_t v[kIdsPerLane], o[kIdsPerLane], r[kIdsPerLane];
  rank_tile(ids + s * g, g, b * kRouteTile, rows, p, v, o, r, sh);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int q = warp; q < p; q += kRouteWarps) {
    int32_t before = 0, total = 0;
    for (int64_t k = lane; k < tiles; k += 32) {
      const int32_t c = counts[(s * tiles + k) * p + q];
      total += c;
      if (k < b) before += c;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      before += __shfl_xor_sync(kFull, before, off);
      total += __shfl_xor_sync(kFull, total, off);
    }
    if (lane == 0) {
      sh.before[q] = before;
      sh.total[q] = total;
    }
  }
  __syncthreads();
  write_tile(b * kRouteTile, p, cap, v, o, r, sh,
             req + s * p * static_cast<int64_t>(cap), owner + s * g,
             pos + s * g, ok + s * g);
  const int64_t share = (cap + tiles - 1) / tiles;
  zero_unused(req + s * p * static_cast<int64_t>(cap), p, cap, b * share,
              min(static_cast<int64_t>(cap), (b + 1) * share), sh);
}

template <typename Word>
__global__ void unroute_rows_kernel(const Word* __restrict__ back,
                                    int32_t cap, int row_words,
                                    const int32_t* __restrict__ owner,
                                    const int32_t* __restrict__ pos,
                                    const uint8_t* __restrict__ ok, int64_t g,
                                    Word* __restrict__ out) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= g) return;
  Word* dst = out + r * row_words;
  if (!ok[r]) {
    for (int c = lane; c < row_words; c += 32) dst[c] = Word{};
    return;
  }
  const int64_t src_row =
      static_cast<int64_t>(owner[r]) * cap + min(pos[r], cap - 1);
  const Word* src = back + src_row * row_words;
  for (int c = lane; c < row_words; c += 32) dst[c] = __ldg(src + c);
}

__global__ void unroute_rows_q8_kernel(const int8_t* __restrict__ back,
                                       int32_t cap, int row_bytes, int d,
                                       int dc,
                                       const int32_t* __restrict__ owner,
                                       const int32_t* __restrict__ pos,
                                       const uint8_t* __restrict__ ok,
                                       int64_t g, float* __restrict__ feat,
                                       float* __restrict__ cache,
                                       float* __restrict__ deg) {
  const int64_t r = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) >> 5;
  if (r >= g) return;
  const int8_t* row = nullptr;
  if (ok[r]) {
    const int64_t src_row =
        static_cast<int64_t>(owner[r]) * cap + min(pos[r], cap - 1);
    row = back + src_row * row_bytes;
  }
  gigl::decode_packed_row(row, d, dc, threadIdx.x & 31, r, feat, cache, deg);
}

}  // namespace

// The tiles of a vector of g ids (at least one: an empty vector's req is
// zeroed by its tile); the wrapper sizes the scratch by it.
extern "C" int gigl_route_tiles(long long g) {
  return static_cast<int>(g > 0 ? (g + kRouteTile - 1) / kRouteTile : 1);
}

// ids [s, g] int32; req [s, p, cap], owner and pos [s, g] int32, ok [s, g]
// bool; scratch: s * gigl_route_tiles(g) * p int32 (the tiles' counts).
extern "C" int gigl_route_requests(const void* ids, long long s, long long g,
                                   int rows, int p, int cap, void* req,
                                   void* owner, void* pos, void* ok,
                                   void* scratch, void* stream) {
  if (p < 1 || p > kMaxShards || rows < 1 || cap < 1 || s < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (s == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long tiles = gigl_route_tiles(g);
  const unsigned blocks = static_cast<unsigned>(s * tiles);
  const auto* iv = static_cast<const int32_t*>(ids);
  auto* rq = static_cast<int32_t*>(req);
  auto* ow = static_cast<int32_t*>(owner);
  auto* ps = static_cast<int32_t*>(pos);
  auto* k = static_cast<uint8_t*>(ok);
  auto* counts = static_cast<int32_t*>(scratch);
  route_requests_count_kernel<<<blocks, kRouteThreads, 0, st>>>(
      iv, g, rows, p, tiles, counts);
  route_requests_write_kernel<<<blocks, kRouteThreads, 0, st>>>(
      iv, g, rows, p, cap, tiles, counts, rq, ow, ps, k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gigl_unroute_rows(const void* back, int cap, int row_bytes,
                                 int word_bytes, const void* owner,
                                 const void* pos, const void* ok, long long g,
                                 void* out, void* stream) {
  if (g == 0 || row_bytes == 0) return static_cast<int>(cudaGetLastError());
  const int threads = 256;
  const long long blocks = (g * 32 + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* o = static_cast<const int32_t*>(owner);
  const auto* ps = static_cast<const int32_t*>(pos);
  const auto* k = static_cast<const uint8_t*>(ok);
  if (word_bytes == 16) {
    unroute_rows_kernel<uint4><<<static_cast<unsigned>(blocks), threads, 0,
                                 s>>>(static_cast<const uint4*>(back), cap,
                                      row_bytes / 16, o, ps, k, g,
                                      static_cast<uint4*>(out));
  } else if (word_bytes == 4) {
    unroute_rows_kernel<uint32_t><<<static_cast<unsigned>(blocks), threads,
                                    0, s>>>(
        static_cast<const uint32_t*>(back), cap, row_bytes / 4, o, ps, k, g,
        static_cast<uint32_t*>(out));
  } else if (word_bytes == 2) {
    unroute_rows_kernel<uint16_t><<<static_cast<unsigned>(blocks), threads,
                                    0, s>>>(
        static_cast<const uint16_t*>(back), cap, row_bytes / 2, o, ps, k, g,
        static_cast<uint16_t*>(out));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K16's int8 mode: back [P, cap, row_bytes] int8 packed rows (row_bytes = d
// + 8, or d + dc + 12 with the cache); feat [g, d], cache [g, dc] (nullptr
// when dc == 0) and deg [g] fp32 written.
extern "C" int gigl_unroute_rows_q8(const void* back, int cap, int row_bytes,
                                    int d, int dc, const void* owner,
                                    const void* pos, const void* ok,
                                    long long g, void* feat, void* cache,
                                    void* deg, void* stream) {
  if (d < 1 || dc < 0 || cap < 1 ||
      row_bytes != d + dc + (dc > 0 ? 12 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  // an empty output's pointer may be null
  if (g == 0) return static_cast<int>(cudaGetLastError());
  if ((dc > 0) != (cache != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (g * 32 + threads - 1) / threads;
  unroute_rows_q8_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(back), cap, row_bytes, d, dc,
      static_cast<const int32_t*>(owner), static_cast<const int32_t*>(pos),
      static_cast<const uint8_t*>(ok), g, static_cast<float*>(feat),
      static_cast<float*>(cache), static_cast<float*>(deg));
  return static_cast<int>(cudaGetLastError());
}
