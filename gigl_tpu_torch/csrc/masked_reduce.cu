// K4 masked_reduce — replaces gigl_tpu/ops/fanout.py masked_mean,
// masked_sum, masked_max (:34-53), the reduce of fanout_aggregate (:56-80).
//
// x [M, K, D] (fp32 or bf16) and mask [M, K] -> out [M, D] in x's type:
// the mean, sum or max over the valid slots of each row. Sums accumulate
// in fp32 in slot order and round once; the max of a row with no valid
// slot is 0 (fanout.py:51-53), and so is its mean and sum.
//
// Bound: bytes — the [M, K, D] block is read once (layer 2 of the
// flagship encoder: 512 x 15 x 256 bf16, 3.9 MB) and [M, D] written once.
// Design: one thread per 16-byte piece of an output row (8 bf16 or 4 fp32
// values), consecutive threads across D, so each of the K slot rows is read
// as coalesced 16-byte loads; small blocks (kBlockRows rows of 32 pieces)
// spread the flagship's 16,384 pieces over every SM. A thread reads its
// row's mask once, as the aligned 8-byte words that hold it, and issues the
// row load of every valid slot of a chunk (kSlotChunk slots) before any
// add, holding the loaded 16-byte words as they are (not widened); an
// invalid slot's row is never loaded. The adds then run in slot order, as
// the first version's loop did, so the output is the same bits. Rows in
// flight cost registers: a grid larger than the card holds at once in
// that form walks the slots one at a time (the first version's loop) at
// full occupancy, which measured faster there.
#include <cuda_bf16.h>

#include <cstring>

#include "gigl_common.cuh"

namespace {

constexpr int kMean = 0;
constexpr int kSum = 1;
constexpr int kMax = 2;

template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  static __device__ void load(const uint4& raw, float* v) {
    v[0] = __uint_as_float(raw.x);
    v[1] = __uint_as_float(raw.y);
    v[2] = __uint_as_float(raw.z);
    v[3] = __uint_as_float(raw.w);
  }
  static __device__ uint4 store(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ float2 unpack(uint32_t w) {
    __nv_bfloat162 h;
    memcpy(&h, &w, sizeof(h));
    return __bfloat1622float2(h);
  }
  static __device__ uint32_t pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    uint32_t w;
    memcpy(&w, &h, sizeof(w));
    return w;
  }
  static __device__ void load(const uint4& raw, float* v) {
    float2 p;
    p = unpack(raw.x); v[0] = p.x; v[1] = p.y;
    p = unpack(raw.y); v[2] = p.x; v[3] = p.y;
    p = unpack(raw.z); v[4] = p.x; v[5] = p.y;
    p = unpack(raw.w); v[6] = p.x; v[7] = p.y;
  }
  static __device__ uint4 store(const float* v) {
    return make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                      pack(v[6], v[7]));
  }
};

constexpr int kBlockRows = 2;   // rows in flight: a block of 2 rows of 32 pieces
constexpr int kSlotChunk = 16;  // rows in flight: slot rows a thread
constexpr int kMaskGroup = 56;  // slots whose mask bits one 64-bit word holds
constexpr int kWalkThreads = 256;  // the slot walk: a block

// The valid-slot bits of the n <= kMaskGroup mask bytes at p (bit s: byte
// s nonzero), read as the aligned 8-byte words that hold them. A word may
// reach up to 7 bytes past either end of the mask; it never leaves the
// mask's allocation (allocations are aligned to more than 8 bytes and
// their sizes rounded up past it), and those bytes are shifted away.
__device__ __forceinline__ uint64_t mask_bits(const uint8_t* p, int n) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const unsigned long long* w =
      reinterpret_cast<const unsigned long long*>(at & ~uintptr_t{7});
  const int off = static_cast<int>(at & 7);
  uint64_t bits = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (8 * k >= off + n) break;
    uint64_t b = __ldg(w + k);
    b |= b >> 4;  // bit 0 of each byte: the OR of the byte's bits
    b |= b >> 2;
    b |= b >> 1;
    // gather bit 0 of each byte into the top byte, byte e at bit 56 + e
    b = ((b & 0x0101010101010101ull) * 0x0102040810204080ull) >> 56;
    bits |= b << (8 * k);
  }
  return (bits >> off) & ((1ull << n) - 1ull);
}

template <typename T, int OP>
__device__ __forceinline__ void finish(float* acc, int cnt, uint4* out) {
  constexpr int N = Vec<T>::N;
  if (OP == kMax && cnt == 0) {
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] = 0.f;
  }
  if (OP == kMean) {
    const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[e] /= n;
  }
  *out = Vec<T>::store(acc);
}

// Rows in flight: the row's mask read once, then every valid slot's row
// load of a chunk of kSlotChunk slots issued before the chunk's adds.
template <typename T, int OP>
__global__ void __launch_bounds__(kBlockRows * 32)
    masked_reduce_kernel(const uint4* __restrict__ x,
                         const uint8_t* __restrict__ mask,
                         uint4* __restrict__ out, int64_t m, int k, int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  const uint4* row = x + r * k * dv + c;
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    acc[e] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  int cnt = 0;
  for (int g0 = 0; g0 < k; g0 += kMaskGroup) {  // once for K <= 56
    const int gn = k - g0 < kMaskGroup ? k - g0 : kMaskGroup;
    const uint64_t valid = mask_bits(mask + r * k + g0, gn);
    for (int j0 = 0; j0 < gn; j0 += kSlotChunk) {
      const uint32_t bits = static_cast<uint32_t>(
          (valid >> j0) & ((1ull << kSlotChunk) - 1ull));
      uint4 held[kSlotChunk];
#pragma unroll
      for (int s = 0; s < kSlotChunk; ++s)
        if ((bits >> s) & 1u)
          held[s] = __ldg(row + static_cast<int64_t>(g0 + j0 + s) * dv);
#pragma unroll
      for (int s = 0; s < kSlotChunk; ++s) {
        if (!((bits >> s) & 1u)) continue;
        ++cnt;
        float v[N];
        Vec<T>::load(held[s], v);
#pragma unroll
        for (int e = 0; e < N; ++e)
          acc[e] = OP == kMax ? fmaxf(acc[e], v[e]) : acc[e] + v[e];
      }
    }
  }
  finish<T, OP>(acc, cnt, out + i);
}

// The slot walk (the first version's loop): a slot's mask byte, then its
// row, one slot at a time, at full occupancy.
template <typename T, int OP>
__global__ void __launch_bounds__(kWalkThreads)
    masked_reduce_walk_kernel(const uint4* __restrict__ x,
                              const uint8_t* __restrict__ mask,
                              uint4* __restrict__ out, int64_t m, int k,
                              int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  float acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e)
    acc[e] = OP == kMax ? -__int_as_float(0x7f800000) : 0.f;  // -inf or 0
  int cnt = 0;
  for (int j = 0; j < k; ++j) {
    if (!__ldg(mask + r * k + j)) continue;
    ++cnt;
    float v[N];
    Vec<T>::load(__ldg(x + (r * k + j) * dv + c), v);
#pragma unroll
    for (int e = 0; e < N; ++e)
      acc[e] = OP == kMax ? fmaxf(acc[e], v[e]) : acc[e] + v[e];
  }
  finish<T, OP>(acc, cnt, out + i);
}

// K4b masked_reduce_bwd — the backward of K4 (JAX differentiates
// masked_mean / masked_sum / masked_max by autodiff):
//   grad_x[r, j] = mask[r, j] * g[r] / max(cnt_r, 1)   (mean)
//   grad_x[r, j] = mask[r, j] * g[r]                   (sum)
//   grad_x[r, j, e] = g[r, e] / ties[r, e] where x[r, j, e] == out[r, e]
//                     among valid slots, else 0         (max)
// — the max rule of jax.vjp(jnp.max): the cotangent is shared equally among
// the valid slots equal to the max; a row with no valid slot gets 0.
// Bound: bytes — [M, K, D] written once (plus x read once for max).
// Design: the forward's layout, one thread per 16-byte piece of a row, so
// every slot row is written (and read) coalesced, in small blocks
// (kBwdBlockRows rows of 32 pieces) that spread the flagship's 16,384
// pieces over every SM. A thread reads its row's mask once, as the
// aligned 8-byte words that hold it (mask_bits); the mean's count is the
// popcount of those bits, the same integer as the first version's byte
// count, so the same quotient. Its K slot stores then issue back to back, each the row's g
// word or zero, with no load between them. Max holds the valid slots' x
// words of a chunk of kSlotChunk slots as loaded, counts the ties from them
// and writes from them: x is read once where K <= kSlotChunk (twice past
// it: a counting pass, then a writing pass). Every output is the first
// version's bits. Past what the card holds at once in small blocks, the
// first version's slot walk (a mask byte, then the slot's row and store)
// in blocks of kWalkThreads takes over, which measured faster there.
constexpr int kBwdBlockRows = 2;  // a small block's rows of 32 pieces

// The x words of the valid slots (bits) of one chunk of slots, each at
// its slot's index in held; an invalid slot's row is never loaded.
__device__ __forceinline__ void load_valid(const uint4* __restrict__ xs,
                                           int dv, uint32_t bits,
                                           uint4 (&held)[kSlotChunk]) {
#pragma unroll
  for (int s = 0; s < kSlotChunk; ++s)
    if ((bits >> s) & 1u) held[s] = __ldg(xs + static_cast<int64_t>(s) * dv);
}

template <typename T>
__device__ __forceinline__ void count_ties(const uint4 (&held)[kSlotChunk],
                                           uint32_t bits, const float* o,
                                           float* ties) {
  constexpr int N = Vec<T>::N;
#pragma unroll
  for (int s = 0; s < kSlotChunk; ++s) {
    if (!((bits >> s) & 1u)) continue;
    float v[N];
    Vec<T>::load(held[s], v);
#pragma unroll
    for (int e = 0; e < N; ++e) ties[e] += v[e] == o[e] ? 1.f : 0.f;
  }
}

// The n <= kSlotChunk slot stores of one chunk, back to back: a valid
// slot's share where its value equals the max, else 0.
template <typename T>
__device__ __forceinline__ void write_ties(const uint4 (&held)[kSlotChunk],
                                           uint32_t bits, int n,
                                           const float* o, const float* share,
                                           uint4* __restrict__ dst, int dv) {
  constexpr int N = Vec<T>::N;
#pragma unroll
  for (int s = 0; s < kSlotChunk; ++s) {
    if (s >= n) break;
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if ((bits >> s) & 1u) {
      float v[N];
      Vec<T>::load(held[s], v);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = v[e] == o[e] ? share[e] : 0.f;
      w = Vec<T>::store(v);
    }
    dst[static_cast<int64_t>(s) * dv] = w;
  }
}

template <typename T, int OP>
__global__ void __launch_bounds__(kBwdBlockRows * 32)
    masked_reduce_bwd_kernel(const uint4* __restrict__ grad_out,
                             const uint8_t* __restrict__ mask,
                             const uint4* __restrict__ x,
                             const uint4* __restrict__ out,
                             uint4* __restrict__ grad_x, int64_t m, int k,
                             int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  const uint8_t* mrow = mask + r * k;
  uint4* dst = grad_x + r * k * dv + c;
  // the first kMaskGroup slots' bits (all of them for K <= 56)
  const uint64_t bits0 = mask_bits(mrow, k < kMaskGroup ? k : kMaskGroup);
  float g[N];
  Vec<T>::load(__ldg(grad_out + i), g);
  if (OP == kMax) {
    const uint4* xs = x + r * k * dv + c;
    float o[N], ties[N], share[N];
    Vec<T>::load(__ldg(out + i), o);
#pragma unroll
    for (int e = 0; e < N; ++e) ties[e] = 0.f;
    uint4 held[kSlotChunk];
    if (k <= kSlotChunk) {  // x read once: count and write from held
      const uint32_t bits = static_cast<uint32_t>(bits0);
      load_valid(xs, dv, bits, held);
      count_ties<T>(held, bits, o, ties);
#pragma unroll
      for (int e = 0; e < N; ++e) share[e] = g[e] / ties[e];
      write_ties<T>(held, bits, k, o, share, dst, dv);
      return;
    }
    for (int g0 = 0; g0 < k; g0 += kMaskGroup) {
      const int gn = k - g0 < kMaskGroup ? k - g0 : kMaskGroup;
      const uint64_t valid = g0 == 0 ? bits0 : mask_bits(mrow + g0, gn);
      for (int j0 = 0; j0 < gn; j0 += kSlotChunk) {
        const uint32_t bits = static_cast<uint32_t>(
            (valid >> j0) & ((1ull << kSlotChunk) - 1ull));
        load_valid(xs + static_cast<int64_t>(g0 + j0) * dv, dv, bits, held);
        count_ties<T>(held, bits, o, ties);
      }
    }
#pragma unroll
    for (int e = 0; e < N; ++e) share[e] = g[e] / ties[e];
    for (int g0 = 0; g0 < k; g0 += kMaskGroup) {
      const int gn = k - g0 < kMaskGroup ? k - g0 : kMaskGroup;
      const uint64_t valid = g0 == 0 ? bits0 : mask_bits(mrow + g0, gn);
      for (int j0 = 0; j0 < gn; j0 += kSlotChunk) {
        const uint32_t bits = static_cast<uint32_t>(
            (valid >> j0) & ((1ull << kSlotChunk) - 1ull));
        const int64_t at = static_cast<int64_t>(g0 + j0) * dv;
        load_valid(xs + at, dv, bits, held);
        write_ties<T>(held, bits, gn - j0, o, share, dst + at, dv);
      }
    }
    return;
  }
  if (OP == kMean) {
    int cnt = __popcll(bits0);
    for (int g0 = kMaskGroup; g0 < k; g0 += kMaskGroup)
      cnt += __popcll(mask_bits(
          mrow + g0, k - g0 < kMaskGroup ? k - g0 : kMaskGroup));
    const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] /= n;
  }
  const uint4 g_v = Vec<T>::store(g);
  const uint4 zero_v = make_uint4(0u, 0u, 0u, 0u);
  for (int g0 = 0; g0 < k; g0 += kMaskGroup) {
    const int gn = k - g0 < kMaskGroup ? k - g0 : kMaskGroup;
    const uint64_t valid = g0 == 0 ? bits0 : mask_bits(mrow + g0, gn);
    uint4* p = dst + static_cast<int64_t>(g0) * dv;
#pragma unroll 8
    for (int j = 0; j < gn; ++j)
      p[static_cast<int64_t>(j) * dv] = (valid >> j) & 1ull ? g_v : zero_v;
  }
}

// Past one wave: the first version's slot walk, a slot's mask byte, then
// its row (max) and its store, at full occupancy.
template <typename T, int OP>
__global__ void __launch_bounds__(kWalkThreads)
    masked_reduce_bwd_walk_kernel(const uint4* __restrict__ grad_out,
                                  const uint8_t* __restrict__ mask,
                                  const uint4* __restrict__ x,
                                  const uint4* __restrict__ out,
                                  uint4* __restrict__ grad_x, int64_t m,
                                  int k, int dv) {
  constexpr int N = Vec<T>::N;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= m * dv) return;
  const int64_t r = i / dv;
  const int c = static_cast<int>(i - r * dv);
  const uint8_t* mrow = mask + r * k;
  float g[N];
  Vec<T>::load(__ldg(grad_out + i), g);
  const uint4 zero_v = make_uint4(0u, 0u, 0u, 0u);
  if (OP == kMax) {
    float o[N];
    Vec<T>::load(__ldg(out + i), o);
    float ties[N];
#pragma unroll
    for (int e = 0; e < N; ++e) ties[e] = 0.f;
    for (int j = 0; j < k; ++j) {
      if (!__ldg(mrow + j)) continue;
      float v[N];
      Vec<T>::load(__ldg(x + (r * k + j) * dv + c), v);
#pragma unroll
      for (int e = 0; e < N; ++e) ties[e] += v[e] == o[e] ? 1.f : 0.f;
    }
    for (int j = 0; j < k; ++j) {
      const int64_t at = (r * k + j) * dv + c;
      if (!__ldg(mrow + j)) {
        grad_x[at] = zero_v;
        continue;
      }
      float v[N];
      Vec<T>::load(__ldg(x + at), v);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = v[e] == o[e] ? g[e] / ties[e] : 0.f;
      grad_x[at] = Vec<T>::store(v);
    }
    return;
  }
  if (OP == kMean) {
    int cnt = 0;
    for (int j = 0; j < k; ++j) cnt += __ldg(mrow + j) ? 1 : 0;
    const float n = static_cast<float>(cnt > 1 ? cnt : 1);
#pragma unroll
    for (int e = 0; e < N; ++e) g[e] /= n;
  }
  const uint4 g_v = Vec<T>::store(g);
  for (int j = 0; j < k; ++j)
    grad_x[(r * k + j) * dv + c] = __ldg(mrow + j) ? g_v : zero_v;
}

// The blocks of `threads` threads of `kernel` that the card holds at once.
template <typename K>
long long resident_blocks(K kernel, int threads) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  return static_cast<long long>(per_sm) * sms;
}

// Rows in flight cost registers, and so resident blocks: a grid that the
// card holds at once in that form takes it (the flagship's [512, 15, 256]
// bf16, 256 blocks of 64); a larger one takes the slot walk at full
// occupancy ([8192, 10, 128]: 2,048 or 4,096 blocks of 64), where the
// resident threads keep as many loads in flight. The card's capacity for
// the rows-in-flight form is read once (the first card's).
template <typename T, int OP>
void launch_op(const uint4* x, const uint8_t* mask, uint4* out, long long m,
               int k, int dv, cudaStream_t stream) {
  const long long total = m * dv;
  constexpr int threads = kBlockRows * 32;
  static const long long held =
      resident_blocks(masked_reduce_kernel<T, OP>, threads);
  const long long blocks = (total + threads - 1) / threads;
  if (blocks <= held) {
    masked_reduce_kernel<T, OP>
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
            x, mask, out, m, k, dv);
  } else {
    masked_reduce_walk_kernel<T, OP>
        <<<static_cast<unsigned>((total + kWalkThreads - 1) / kWalkThreads),
           kWalkThreads, 0, stream>>>(x, mask, out, m, k, dv);
  }
}

// K4b: small blocks where the grid's small blocks fit on the card at once
// (the flagship's [512, 15, 256] bf16: 256 blocks of 64); past that
// ([8192, 10, 128]: 4,096 or 2,048 blocks of 64) the slot walk. The card's
// capacity is read once (the first card's).
template <typename T, int OP>
void launch_bwd_op(const uint4* grad_out, const uint8_t* mask, const uint4* x,
                   const uint4* out, uint4* grad_x, long long m, int k, int dv,
                   cudaStream_t stream) {
  const long long total = m * dv;
  constexpr int small = kBwdBlockRows * 32;
  static const long long held =
      resident_blocks(masked_reduce_bwd_kernel<T, OP>, small);
  const long long blocks = (total + small - 1) / small;
  if (blocks <= held) {
    masked_reduce_bwd_kernel<T, OP>
        <<<static_cast<unsigned>(blocks), small, 0, stream>>>(
            grad_out, mask, x, out, grad_x, m, k, dv);
  } else {
    masked_reduce_bwd_walk_kernel<T, OP>
        <<<static_cast<unsigned>((total + kWalkThreads - 1) / kWalkThreads),
           kWalkThreads, 0, stream>>>(grad_out, mask, x, out, grad_x, m, k,
                                      dv);
  }
}

template <typename T>
int launch_bwd(const void* grad_out, const void* mask, const void* x,
               const void* out, void* grad_x, long long m, int k, int d, int op,
               cudaStream_t stream) {
  const int dv = d / Vec<T>::N;
  if (m * dv == 0) return 0;
  const uint4* gv = static_cast<const uint4*>(grad_out);
  const uint8_t* mv = static_cast<const uint8_t*>(mask);
  const uint4* xv = static_cast<const uint4*>(x);
  const uint4* ov = static_cast<const uint4*>(out);
  uint4* gx = static_cast<uint4*>(grad_x);
  if (op == kMean) {
    launch_bwd_op<T, kMean>(gv, mv, xv, ov, gx, m, k, dv, stream);
  } else if (op == kSum) {
    launch_bwd_op<T, kSum>(gv, mv, xv, ov, gx, m, k, dv, stream);
  } else if (op == kMax) {
    if (x == nullptr || out == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    launch_bwd_op<T, kMax>(gv, mv, xv, ov, gx, m, k, dv, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

template <typename T>
int launch(const void* x, const void* mask, void* out, long long m, int k,
           int d, int op, cudaStream_t stream) {
  const int dv = d / Vec<T>::N;
  if (m * dv == 0) return 0;
  const uint4* xv = static_cast<const uint4*>(x);
  const uint8_t* mv = static_cast<const uint8_t*>(mask);
  uint4* ov = static_cast<uint4*>(out);
  if (op == kMean) {
    launch_op<T, kMean>(xv, mv, ov, m, k, dv, stream);
  } else if (op == kSum) {
    launch_op<T, kSum>(xv, mv, ov, m, k, dv, stream);
  } else if (op == kMax) {
    launch_op<T, kMax>(xv, mv, ov, m, k, dv, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; op: 0 = mean, 1 = sum, 2 = max.
extern "C" int gigl_masked_reduce(const void* x, const void* mask, void* out,
                                  long long m, int k, int d, int dtype, int op,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(x, mask, out, m, k, d, op, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(x, mask, out, m, k, d, op, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// grad_out [M, D] and grad_x [M, K, D] in x's type; x and out (the forward's
// input and result) are read only for op 2 (max) and may be NULL otherwise.
extern "C" int gigl_masked_reduce_bwd(const void* grad_out, const void* mask,
                                      const void* x, const void* out,
                                      void* grad_x, long long m, int k, int d,
                                      int dtype, int op, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch_bwd<float>(grad_out, mask, x, out, grad_x, m, k, d, op, s);
  } else if (dtype == 1) {
    rc = launch_bwd<__nv_bfloat16>(grad_out, mask, x, out, grad_x, m, k, d,
                                   op, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
