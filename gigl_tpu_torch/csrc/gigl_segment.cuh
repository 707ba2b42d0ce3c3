// The per-segment edge walk of K10 sddmm (see its note for what it
// computes and for the row widths that take it).
//
// A SegmentIndex lists the edges by destination segment: order[ptr[s] ..
// ptr[s + 1]) are segment s's edge ids, in their original order. Rows are
// cut by the lane map of gigl_attention.cuh: pieces of 16, 8 or 4 bytes, a
// head's pieces on a segment of sp lanes, a row on ls lanes (K = 2 or 4
// pieces a lane for rows wider than 32 pieces). A slot group of ls lanes
// takes one destination segment and walks its edges in order, one edge an
// iteration, so a warp holds 32 / ls segments at once (one from 4 heads x
// 32 fp32 up, the rows K10 walks). A group reads its segment's edge ids ls
// at a time, one lane each (e = order[j0 + l], then its gathered source
// row r = rows[e]), and shares them by
// __shfl_sync inside the group; the next chunk's ids are read before the
// current chunk's rows are used, and the row pieces of the next D edges
// (a kernel's choice, from kSegDepth) are issued before the current ones'
// arithmetic. Persistent warps walk the segments in a grid-stride loop.
#pragma once

#include "gigl_attention.cuh"

namespace gigl {
namespace seg {

using namespace gigl::attn;

// Edges whose row pieces a group issues ahead of the current ones'
// arithmetic (K10 takes kSegDepth / K of them at K pieces a lane, at least
// one: its q row in registers costs the rest).
constexpr int kSegDepth = 2;

// A segment's edge positions [lo, hi) in order (empty past the last
// segment).
struct Bounds {
  int32_t lo, hi;
};

__device__ __forceinline__ Bounds bounds(const int32_t* __restrict__ ptr,
                                         int64_t s, int64_t segments) {
  if (s >= segments) return {0, 0};
  return {__ldg(ptr + s), __ldg(ptr + s + 1)};
}

// A group's next lr edges from j0 (of those before hi), a lane each: the
// edge id and its row; nv of them (the same in the group's lanes).
struct EdgeChunk {
  int e, r, nv;
};

// The chunk's ids alone (the first of two dependent reads).
__device__ __forceinline__ int chunk_ids(const int32_t* __restrict__ order,
                                         int32_t j0, int32_t hi, int lg) {
  return lg < hi - j0 ? __ldg(order + j0 + lg) : 0;
}

// The chunk from its ids: their rows read.
__device__ __forceinline__ EdgeChunk chunk_rows(
    int e, const int32_t* __restrict__ rows, int32_t j0, int32_t hi, int lg,
    int lr) {
  EdgeChunk c;
  const int32_t left = hi - j0;
  c.nv = left < lr ? (left > 0 ? left : 0) : lr;
  c.e = e;
  c.r = lg < c.nv ? __ldg(rows + e) : 0;
  return c;
}

// The raw row pieces of D edges a lane loads ahead of their arithmetic,
// each edge's id and whether it exists.
template <int D, int K, int NW>
struct EdgeBatch {
  uint32_t xr[D][K][NW];
  int e[D];
  bool ok[D];
};

// Issues the loads of iterations it .. it + D - 1 of a chunk: the group
// (lanes rbase ..) takes its chunk's edge it + d, and each of the lane's
// live pieces of that edge's row of x ([*, hd] of T). Every lane of the
// warp calls it.
template <typename T, int PW, int K, int D, int V>
__device__ __forceinline__ void load_edges(
    EdgeBatch<D, K, PW / 4>& b, const EdgeChunk& c, int it, int rbase,
    const LanePieces<V, K>& lp, int hd, const T* __restrict__ x) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    b.ok[d] = it + d < c.nv;
    const int from = rbase + (b.ok[d] ? it + d : 0);
    const int64_t r = __shfl_sync(kFull, c.r, from);
    const int64_t e = __shfl_sync(kFull, c.e, from);
    b.e[d] = static_cast<int>(e);
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int u = 0; u < PW / 4; ++u) b.xr[d][k][u] = 0u;
      if (!b.ok[d] || !lp.live[k]) continue;
      load_raw<PW>(x + r * hd + lp.e0[k], b.xr[d][k]);
    }
  }
}

// The segments a warp holds at once: one a group of m.ls lanes.
__device__ __host__ __forceinline__ int segments_per_warp(const LaneMap& m) {
  return 32 / m.ls;
}

// Walks the warp's segments with the groups of the note above, calling the
// body's begin(s, bounds) before a segment's edges, edges(batch) for each
// batch of D edges (every lane calls it: a body may shuffle inside its
// group) and end(s, bounds) after them; s runs past the last segment in
// the warp's last groups (bounds empty). x [*, m.hd] of T holds the rows.
template <typename T, int PW, int K, int D, typename Body>
__device__ __forceinline__ void walk_segments(
    const int32_t* __restrict__ order, const int32_t* __restrict__ rows,
    const int32_t* __restrict__ ptr, int64_t segments, const LaneMap& m,
    const LanePieces<PW / sizeof(T), K>& lp, const T* __restrict__ x,
    Body& body) {
  constexpr int V = PW / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int lr = m.ls;  // lanes a segment
  const int lg = lane % lr;
  const int rbase = lane - lg;
  const int spw = segments_per_warp(m);
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t s0 = warp0 * spw; s0 < segments; s0 += nwarps * spw) {
    const int64_t s = s0 + lane / lr;
    const Bounds b = bounds(ptr, s, segments);
    body.begin(s, b);
    const int chunks = static_cast<int>(__reduce_max_sync(
        kFull, static_cast<unsigned>((b.hi - b.lo + lr - 1) / lr)));
    EdgeChunk c = chunk_rows(chunk_ids(order, b.lo, b.hi, lg), rows, b.lo,
                             b.hi, lg, lr);
    EdgeBatch<D, K, PW / 4> nxt;
    load_edges<T, PW, K, D, V>(nxt, c, 0, rbase, lp, m.hd, x);
    for (int ci = 0; ci < chunks; ++ci) {
      const int32_t j1 = b.lo + (ci + 1) * lr;  // the next chunk
      const int ids = chunk_ids(order, j1, b.hi, lg);
      const int nit = static_cast<int>(
          __reduce_max_sync(kFull, static_cast<unsigned>(c.nv)));
      for (int it = 0; it < nit; it += D) {
        const EdgeBatch<D, K, PW / 4> cur = nxt;
        if (it + D < nit)
          load_edges<T, PW, K, D, V>(nxt, c, it + D, rbase, lp, m.hd, x);
        body.edges(cur);
      }
      if (ci + 1 < chunks) {
        c = chunk_rows(ids, rows, j1, b.hi, lg, lr);
        load_edges<T, PW, K, D, V>(nxt, c, 0, rbase, lp, m.hd, x);
      }
    }
    body.end(s, b);
  }
}

// Blocks of kThreads for the warps that n items need at segments_per_warp
// a warp: at most as many as are resident on the card at once (each warp
// then walks several groups).
template <typename F>
unsigned walk_grid(F kernel, long long n, const LaneMap& m) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int spw = segments_per_warp(m);
  const long long warps = (n + spw - 1) / spw;
  const long long need = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(need < cap ? need : cap);
}

}  // namespace seg
}  // namespace gigl
