// K13 cms_add and K14 cms_estimate — replace gigl_tpu/losses/
// count_min_sketch.py _cms_hash (:38-47), cms_add (:50-58), cms_estimate
// (:61-66) and cms_sampling_probability (:69-77): the count-min sketch that
// estimates each retrieval candidate's sampling probability for the logQ
// correction.
//
// Hash of id into row r (all uint32 arithmetic, wrapping):
//   h_r(id) = mix32(uint32(id) + r * 0x9E3779B9) % width
// with mix32 the sampler's finalizer (gigl_common.cuh; the reference's
// _cms_hash applies the same steps).
//   K13: new_table[r, h_r(id)] = table[r, h_r(id)] + (count of id), for every
//        id and row, masked candidate columns included (the reference counts
//        them all); new_total = total + n (int32, wrapping). The input sketch
//        is never written: cms_add is functional, as the reference's is.
//   K14: est[i] = min_r table[r, h_r(ids[i])] (int32) and, when asked,
//        prob[i] = float(est[i]) / max(float(total), 1) (IEEE division).
//
// Bound: latency. At the flagship (n = 1024 candidate ids, depth 5, width
// 2048: a 40 KB table) each kernel moves ~50 KB, ~0.015 us of HBM time, and
// does ~10^5 integer operations: both are a launch's latency, so the design
// keeps the chain of dependent memory round trips short. K13 is one kernel
// for every sketch size: block (t, r) of a depth x ceil(width / T) grid owns
// cells [t*T, (t+1)*T) of row r. It first starts its tile's loads of the old
// table (16-byte loads where the width is a multiple of 4) into registers,
// so their latency overlaps the hashing, and zeroes a count tile in shared
// memory; each thread then hashes its share of the n ids for row r alone
// and, where the bucket falls in the tile, adds 1 with a shared integer
// atomic (integer adds commute, so every order gives the same table); after
// one __syncthreads the block writes table + count with 16-byte stores.
// Block (0, 0) writes total + n. Two global round trips remain. T grows
// with the width (1024, 2048, 4096, then 8192 cells: 32 KB of counts), so a
// sketch up to 8192 wide is one tile a row and a wider one takes
// ceil(width / 8192) tiles, each hashing every id: at 8 x 65536 and n =
// 65536 that is 4.2M hashes over 64 blocks. total is read and written on
// the device, so a training step needs no host synchronisation and can be
// captured in a CUDA graph.
// K14 always runs right behind K13 (or behind the op that makes its
// candidate ids) and moves ~50 KB at the flagship: its whole time is a
// launch's ramp and one chain of dependent round trips. It is launched as
// a programmatic dependent launch (cudaLaunchKernelEx with
// cudaLaunchAttributeProgrammaticStreamSerialization): its blocks may start
// while the kernel before it on the stream finishes, and wait at
// griddepcontrol.wait, before their first read, for that kernel's writes
// (K13 writes the table and total, the op before writes the ids). After
// the wait, one thread an id loads the id and total together, hashes, and
// issues every row's load before the min (unrolled for depth <= 8, a loop
// beyond).
#include <climits>
#include <cstdint>

#include "gigl_common.cuh"

namespace {

constexpr int kAddThreads = 256;   // K13: a block's threads
constexpr int kMaxPieces = 8;      // K13: T = kAddThreads * 4 * pieces
constexpr int kEstThreads = 128;   // K14: a block's threads
constexpr int kMaxUnrolled = 8;    // K14: depths unrolled by template

__device__ __forceinline__ uint32_t bucket(int32_t id, uint32_t row,
                                           uint32_t width) {
  const uint32_t x = static_cast<uint32_t>(id) + row * 0x9E3779B9u;
  return gigl::mix32(x) % width;
}

// Block (t, r): cells [t * kTile, (t + 1) * kTile) of row r. Each thread
// owns PIECES pieces of 4 consecutive cells (16-byte accesses when VEC:
// width % 4 == 0 and both tables 16-byte aligned), piece k at cell
// 4 * (threadIdx.x + k * kAddThreads) of the tile; without VEC, cell
// threadIdx.x + j * kAddThreads for j < 4 * PIECES.
template <int PIECES, bool VEC>
__global__ void __launch_bounds__(kAddThreads)
cms_add_kernel(const int32_t* __restrict__ table, int width,
               const int32_t* __restrict__ ids, long long n,
               const int32_t* __restrict__ total, int32_t* __restrict__ out,
               int32_t* __restrict__ out_total) {
  constexpr int kCells = 4 * PIECES;  // per thread
  constexpr int kTile = kAddThreads * kCells;
  __shared__ __align__(16) int32_t counts[kTile];
  const uint32_t r = blockIdx.y;
  const long long lo = static_cast<long long>(blockIdx.x) * kTile;
  const long long row = static_cast<long long>(r) * width + lo;
  const uint32_t cells = static_cast<uint32_t>(
      min(static_cast<long long>(kTile), width - lo));
  const int tid = threadIdx.x;
  int32_t old[kCells];
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    if constexpr (VEC) {
      const uint32_t c = 4u * (tid + k * kAddThreads);
      if (c < cells) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(table + row + c));
        old[4 * k] = v.x;
        old[4 * k + 1] = v.y;
        old[4 * k + 2] = v.z;
        old[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t c = tid + (4 * k + u) * kAddThreads;
        if (c < cells) old[4 * k + u] = __ldg(table + row + c);
      }
    }
    reinterpret_cast<int4*>(counts)[tid + k * kAddThreads] =
        make_int4(0, 0, 0, 0);
  }
  __syncthreads();
  for (long long i = tid; i < n; i += kAddThreads) {
    const uint32_t b =
        bucket(__ldg(ids + i), r, static_cast<uint32_t>(width)) -
        static_cast<uint32_t>(lo);
    if (b < cells) atomicAdd(counts + b, 1);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    if constexpr (VEC) {
      const uint32_t c = 4u * (tid + k * kAddThreads);
      if (c < cells) {
        const int4 add = reinterpret_cast<const int4*>(counts)[c / 4];
        // int32 sums wrap as the reference's do: add as uint32
        *reinterpret_cast<int4*>(out + row + c) = make_int4(
            static_cast<int32_t>(static_cast<uint32_t>(old[4 * k]) + add.x),
            static_cast<int32_t>(static_cast<uint32_t>(old[4 * k + 1]) +
                                 add.y),
            static_cast<int32_t>(static_cast<uint32_t>(old[4 * k + 2]) +
                                 add.z),
            static_cast<int32_t>(static_cast<uint32_t>(old[4 * k + 3]) +
                                 add.w));
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const uint32_t c = tid + (4 * k + u) * kAddThreads;
        if (c < cells)
          out[row + c] = static_cast<int32_t>(
              static_cast<uint32_t>(old[4 * k + u]) + counts[c]);
      }
    }
  }
  if (blockIdx.x == 0 && r == 0 && tid == 0)
    *out_total = static_cast<int32_t>(static_cast<uint32_t>(*total) +
                                      static_cast<uint32_t>(n));
}

template <int PIECES>
void launch_add(bool vec, dim3 grid, cudaStream_t s, const int32_t* t,
                int width, const int32_t* id, long long n,
                const int32_t* tot, int32_t* o, int32_t* ot) {
  if (vec)
    cms_add_kernel<PIECES, true><<<grid, kAddThreads, 0, s>>>(
        t, width, id, n, tot, o, ot);
  else
    cms_add_kernel<PIECES, false><<<grid, kAddThreads, 0, s>>>(
        t, width, id, n, tot, o, ot);
}

// DEPTH rows unrolled (1 to kMaxUnrolled), or 0: a loop over `depth`
// rows, unrolled by 8.
template <int DEPTH>
__global__ void __launch_bounds__(kEstThreads)
cms_estimate_kernel(const int32_t* __restrict__ table, int depth, int width,
                    const int32_t* __restrict__ ids, long long n,
                    const int32_t* __restrict__ total,
                    int32_t* __restrict__ est, float* __restrict__ prob) {
  // every read below may be of what the kernel before this one wrote
  gigl::wait_for_prior_grid();
  const long long i = static_cast<long long>(blockIdx.x) * kEstThreads +
                      threadIdx.x;
  if (i >= n) return;
  const int32_t id = ids[i];
  const int32_t tot = prob != nullptr ? *total : 0;
  const uint32_t w = static_cast<uint32_t>(width);
  int32_t m;
  if constexpr (DEPTH > 0) {
    int32_t v[DEPTH];
#pragma unroll
    for (int r = 0; r < DEPTH; ++r)
      v[r] = __ldg(table + static_cast<long long>(r) * width +
                   bucket(id, r, w));
    m = v[0];
#pragma unroll
    for (int r = 1; r < DEPTH; ++r) m = min(m, v[r]);
  } else {
    m = INT_MAX;
#pragma unroll 8
    for (int r = 0; r < depth; ++r)
      m = min(m, __ldg(table + static_cast<long long>(r) * width +
                       bucket(id, r, w)));
  }
  if (est != nullptr) est[i] = m;
  if (prob != nullptr)
    prob[i] = __fdiv_rn(static_cast<float>(m),
                        fmaxf(static_cast<float>(tot), 1.f));
}

// K14 as a programmatic dependent launch on `s`.
template <int DEPTH>
cudaError_t launch_estimate(unsigned blocks, cudaStream_t s,
                            const int32_t* table, int depth, int width,
                            const int32_t* ids, long long n,
                            const int32_t* total, int32_t* est, float* prob) {
  return gigl::launch_dependent(cms_estimate_kernel<DEPTH>, dim3(blocks),
                                dim3(kEstThreads), s, table, depth, width,
                                ids, n, total, est, prob);
}

unsigned blocks_for(long long work, int threads) {
  return static_cast<unsigned>((work + threads - 1) / threads);
}

}  // namespace

// table: [depth, width] int32, total: int32 scalar (device); ids: [n]
// int32. Writes out: [depth, width] int32 (a buffer other than table) and
// out_total: int32 scalar. One launch for every size.
extern "C" int gigl_cms_add(const void* table, int depth, int width,
                            const void* ids, long long n, const void* total,
                            void* out, void* out_total, void* stream) {
  if (depth <= 0 || depth > 65535 || width <= 0 || n < 0 || table == out)
    return static_cast<int>(cudaErrorInvalidValue);
  int pieces = 1;
  while (pieces < kMaxPieces && 4LL * kAddThreads * pieces < width)
    pieces *= 2;
  const long long tile = 4LL * kAddThreads * pieces;
  const dim3 grid(static_cast<unsigned>((width + tile - 1) / tile),
                  static_cast<unsigned>(depth));
  const bool vec = width % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(table) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* t = static_cast<const int32_t*>(table);
  const auto* id = static_cast<const int32_t*>(ids);
  const auto* tot = static_cast<const int32_t*>(total);
  auto* o = static_cast<int32_t*>(out);
  auto* ot = static_cast<int32_t*>(out_total);
  switch (pieces) {
    case 1: launch_add<1>(vec, grid, s, t, width, id, n, tot, o, ot); break;
    case 2: launch_add<2>(vec, grid, s, t, width, id, n, tot, o, ot); break;
    case 4: launch_add<4>(vec, grid, s, t, width, id, n, tot, o, ot); break;
    default: launch_add<8>(vec, grid, s, t, width, id, n, tot, o, ot);
  }
  return static_cast<int>(cudaGetLastError());
}

// est: [n] int32 or NULL; prob: [n] fp32 or NULL (needs total).
extern "C" int gigl_cms_estimate(const void* table, int depth, int width,
                                 const void* ids, long long n,
                                 const void* total, void* est, void* prob,
                                 void* stream) {
  if (depth <= 0 || width <= 0 || n < 0 || (prob != nullptr && !total))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const unsigned blocks = blocks_for(n, kEstThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* t = static_cast<const int32_t*>(table);
    const auto* id = static_cast<const int32_t*>(ids);
    const auto* tot = static_cast<const int32_t*>(total);
    auto* e = static_cast<int32_t*>(est);
    auto* p = static_cast<float*>(prob);
    cudaError_t rc;
    switch (depth <= kMaxUnrolled ? depth : 0) {
#define GIGL_CMS_DEPTH(D)                                                   \
  case D:                                                                   \
    rc = launch_estimate<D>(blocks, s, t, depth, width, id, n, tot, e, p); \
    break;
      GIGL_CMS_DEPTH(1) GIGL_CMS_DEPTH(2) GIGL_CMS_DEPTH(3)
      GIGL_CMS_DEPTH(4) GIGL_CMS_DEPTH(5) GIGL_CMS_DEPTH(6)
      GIGL_CMS_DEPTH(7) GIGL_CMS_DEPTH(8)
#undef GIGL_CMS_DEPTH
      default:  // 0
        rc = launch_estimate<0>(blocks, s, t, depth, width, id, n, tot, e, p);
    }
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  return static_cast<int>(cudaGetLastError());
}
