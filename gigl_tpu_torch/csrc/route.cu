// K15 route_requests — replaces gigl_tpu/parallel/feature_lookup.py
// _route_requests (:48-80): the counting-sort bucketing of a routed
// lookup's [G] int32 global ids by owner shard.
//   owner = clip(id // rows, 0, P - 1)   (floor; negative ids -> shard 0)
//   pos   = the number of EARLIER requests with the same owner
//   ok    = pos < C
//   req[owner, pos] = id where ok; every other req cell 0.
// Bound: bytes (G ids read, 9 bytes per id and P * C ids written; a few
// integer ops per id). Design: one block of 32 warps per request vector
// (one shard's lookup). Warp w owns the contiguous chunk [w * chunk,
// (w + 1) * chunk) of the ids and walks it 32 ids at a time (coalesced
// loads and stores, four loads in flight), so "earlier" is (earlier warp)
// or (earlier in the warp's walk) or (lower lane). Within a step the lanes
// with the same owner find each other with __match_any_sync; a lane's rank
// among them is the popcount of its lower peers. Pass 1 counts each
// warp's ids per owner into a [P][32] table in shared memory (the lowest
// peer adds the group's size: no atomics); warp o scans owner o's row
// over the warps (an exclusive prefix with shuffles); pass 2 walks the
// chunk again, each id's pos being its warp's running count plus its rank,
// and writes owner / pos / ok / req; then the block zero-fills each owner's
// unused cells [min(count, C), C). The order is the reference's first
// come, first served, so the result is bit-equal for any ids (duplicates,
// ids past P * rows, overflow). P <= kMaxShards (32): one warp per owner.
//
// K16 unroute_rows — replaces feature_lookup.py _unroute (:83-90):
// out[i] = ok[i] ? back[owner[i], min(pos[i], C - 1)] : 0 for rows of any
// width and 2- or 4-byte type ([P, C, W] fp32 / int32 / bf16 answers).
// Bound: bytes (each answered row read once, each output row written
// once). Design: one warp per output row copying whole words: 16-byte
// words when the row is a multiple of 16 bytes (and the bases aligned),
// 4-byte words when it is a multiple of 4 (the flagship's [D + 1] = 129
// fp32 rows), 2-byte words otherwise (odd bf16 widths); the wrapper picks.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxShards = 32;
constexpr int kWarps = 32;
constexpr int kRouteThreads = kWarps * 32;
constexpr int kUnroll = 4;  // ids loaded ahead per lane

__device__ __forceinline__ int32_t owner_of(int32_t id, int32_t rows,
                                            int32_t p) {
  // floor division (the reference's //); any negative id clips to 0
  const int32_t o = id >= 0 ? id / rows : -1;
  return o < 0 ? 0 : (o > p - 1 ? p - 1 : o);
}

__global__ void __launch_bounds__(kRouteThreads)
route_requests_kernel(const int32_t* __restrict__ ids, int64_t g,
                      int32_t rows, int32_t p, int32_t cap,
                      int32_t* __restrict__ req, int32_t* __restrict__ owner,
                      int32_t* __restrict__ pos, uint8_t* __restrict__ ok) {
  __shared__ int32_t cnt[kMaxShards][kWarps];  // per owner, per warp
  __shared__ int32_t total[kMaxShards];
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const uint32_t lower = (1u << lane) - 1u;
  constexpr int64_t kStep = 32 * kUnroll;
  const int64_t chunk = (g + kWarps * kStep - 1) / (kWarps * kStep) * kStep;
  const int64_t lo = min(g, warp * chunk), hi = min(g, lo + chunk);
  for (int o = t; o < kMaxShards * kWarps; o += kRouteThreads)
    cnt[o / kWarps][o % kWarps] = 0;
  __syncthreads();

  for (int pass = 0; pass < 2; ++pass) {
    for (int64_t base = lo; base < hi; base += kStep) {
      int32_t v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + k * 32 + lane;
        v[k] = i < hi ? ids[i] : 0;
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int64_t i = base + k * 32 + lane;
        const bool valid = i < hi;
        const int32_t o = valid ? owner_of(v[k], rows, p) : p;  // p: none
        const uint32_t peers = __match_any_sync(0xffffffffu, o);
        const bool first = (peers & lower) == 0;
        if (pass == 0) {
          if (valid && first) cnt[o][warp] += __popc(peers);
          __syncwarp();
          continue;
        }
        int32_t k_pos = 0;
        if (valid) {
          k_pos = cnt[o][warp] + __popc(peers & lower);
          owner[i] = o;
          pos[i] = k_pos;
          ok[i] = k_pos < cap ? 1 : 0;
          if (k_pos < cap) req[static_cast<int64_t>(o) * cap + k_pos] = v[k];
        }
        __syncwarp();
        if (valid && first) cnt[o][warp] += __popc(peers);
        __syncwarp();
      }
    }
    if (pass == 1) break;
    __syncthreads();
    // exclusive scan of owner w's row over the warps, by warp w
    if (warp < p) {
      const int32_t x = cnt[warp][lane];
      int32_t incl = x;
      for (int d = 1; d < 32; d <<= 1) {
        const int32_t y = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += y;
      }
      cnt[warp][lane] = incl - x;
      if (lane == 31) total[warp] = incl;
    }
    __syncthreads();
  }
  for (int o = 0; o < p; ++o) {
    for (int64_t c = min(total[o], cap) + t; c < cap; c += kRouteThreads)
      req[static_cast<int64_t>(o) * cap + c] = 0;
  }
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

}  // namespace

extern "C" int gigl_route_requests(const void* ids, long long g, int rows,
                                   int p, int cap, void* req, void* owner,
                                   void* pos, void* ok, void* stream) {
  if (p < 1 || p > kMaxShards || rows < 1 || cap < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  route_requests_kernel<<<1, kRouteThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(ids), g, rows, p, cap,
      static_cast<int32_t*>(req), static_cast<int32_t*>(owner),
      static_cast<int32_t*>(pos), static_cast<uint8_t*>(ok));
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
