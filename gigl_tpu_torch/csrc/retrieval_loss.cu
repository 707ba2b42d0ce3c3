// K5 retrieval_loss — replaces gigl_tpu/losses/losses.py retrieval_loss
// (:95-152) and its autodiff backward: the in-batch sampled-softmax loss
// over a score matrix S [Q, C] (fp32 or bf16).
//
// Per row i the masked logit of column j is, computed in fp32 as
// losses.py:126-146 does it:
//   v_ij = S_ij / T + (dup_ij - label_ij) * finfo(dtype).min   (masking on)
//   v_ij = finfo(dtype).min                      where candidate j is masked
// with label_ij = (i == j), dup_ij = (j < Q and qid_j == qid_i) when query
// ids are given, or'ed with (cid_j == cid_i) when accidental hits are
// removed. The label, duplicate and hit masks are rebuilt from the ids on
// the fly, so no [Q, C] mask is ever materialised. The finite minimum (not
// -inf) keeps rows whose diagonal is masked equal to the reference.
// logQ mode (a [C] fp32 candidate sampling probability p, the count-min
// sketch's estimate; losses.py:119-123): S_ij / T becomes
//   S_ij / T - round_dtype(log(max(p_j, 1e-10)))
// before the masks, the log rounded to S's type as the reference's
// .astype(dtype) rounds it; the backward's recomputed v_ij carries the same
// term and no cotangent flows to p. The mode is a template flag, so the
// kernels without it compile no extra load or branch.
//   forward:  lse_i = logsumexp_j v_ij, ce_i = qmask_i ? lse_i - v_ii : 0,
//             loss_sum = sum_i ce_i (fixed order), count = sum_i qmask_i
//   backward: dS_ij = g * qmask_i * (exp(v_ij - lse_i) - label_ij)
//                       * (cmask_j ? 1/T : 0), rounded once to S's type.
//
// Bound: bytes — S read once (forward) or read once and dS written once
// (backward); at the flagship [512, 1024] bf16 that is ~3 MB, about 1 us
// of HBM time, so both are bound by latency, not by the bytes.
// Design: columns go in words of V cells, one 16-byte word of S (8 bf16
// or 4 fp32), word w of a row holding columns [w * V, w * V + V). The
// forward is ONE launch: kRowThreads threads a query row (a block of
// kBlockRows rows), thread t taking words t, t + kRowThreads, ... of the
// row, each with its column terms beside it: cmask as a V-byte word, the
// query / candidate ids and the logQ probabilities as 16-byte words, all
// loaded whatever the masks say (no branch on a cell), and the row's
// constants and qmask loaded with them. Each cell's logit is computed
// once into registers (kLaneValues a thread, kRowThreads * kLaneValues
// columns a chunk); the row max and then the exp-sum come from those
// registers, combined online across chunks when C is wider. The sum of ce
// and the count of qmask are folded into the same launch by a last-block
// ticket: every block writes its rows' lse and ce, fences, and takes a
// ticket from a per-device counter; the block that takes the last one
// sums ce and counts qmask in a fixed order (a repeat run is bit-equal,
// no float atomics) and the ticket's wrap puts the counter back at 0, so
// back-to-back calls on a stream and CUDA-graph replays each find it at
// 0. The backward is a thread per word, a grid row per query row: the
// row's constants (lse, qmask, query id, own id) and g read once a thread
// beside the word of S and its column terms (a masked row's words are
// read too, so nothing waits on qmask), one 16-byte store of dS. Rows
// that are not 16-byte aligned (C not a multiple of V) or terms off a
// 16-byte boundary take the same layout with one load a cell (the scalar
// form).
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "gigl_common.cuh"

namespace {

constexpr int kRowThreads = 128;  // forward: the threads of a query row
constexpr int kBlockRows = 1;     // forward: query rows a block
constexpr int kLaneValues = 8;    // forward: the logits a thread holds at once
constexpr int kRowWarps = kRowThreads / 32;
static_assert(kRowThreads % 32 == 0 && kLaneValues % 8 == 0,
              "a row is whole warps; a thread holds whole bf16 words");
constexpr int kFwdThreads = kBlockRows * kRowThreads;
constexpr int kBwdThreads = 64;   // backward: a thread a word of V cells

// The forward's ticket counter (one per device, 0 when the module loads).
// atomicInc wraps it from gridDim.x - 1 back to 0, so it is 0 between
// forward launches; calls on one device must be ordered on one stream.
__device__ unsigned int g_fwd_ticket = 0;

struct Logits {
  const void* scores;            // [Q, C], fp32 or bf16
  int64_t q, c;
  const int32_t* qids;           // [Q] or NULL
  const int32_t* cids;           // [C] or NULL
  const uint8_t* qmask;          // [Q] or NULL
  const uint8_t* cmask;          // [C] or NULL
  const float* cprob;            // [C] candidate sampling probability (logQ)
  float t;                       // temperature (1 when none)
  float fmin;                    // finfo(S's dtype).min
  bool use_qids;
  bool rah;                      // remove accidental hits
};

// A word of V cells of T: its scalar load and store, its 16-byte load and
// store, and its V cmask bytes as bits.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int V = 4;
  static __device__ __forceinline__ float load1(const void* p, int64_t at) {
    return __ldg(static_cast<const float*>(p) + at);
  }
  static __device__ __forceinline__ void store1(void* p, int64_t at,
                                                float v) {
    static_cast<float*>(p)[at] = v;
  }
  static __device__ __forceinline__ void load(const void* p, int64_t at,
                                              float* v) {
    const float4 r = __ldg(reinterpret_cast<const float4*>(
        static_cast<const float*>(p) + at));
    v[0] = r.x;
    v[1] = r.y;
    v[2] = r.z;
    v[3] = r.w;
  }
  static __device__ __forceinline__ void store(void* p, int64_t at,
                                               const float* v) {
    *reinterpret_cast<float4*>(static_cast<float*>(p) + at) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
  static __device__ __forceinline__ uint32_t mask_bits(const uint8_t* m) {
    const uint32_t w = __ldg(reinterpret_cast<const unsigned int*>(m));
    uint32_t bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) bits |= ((w >> (8 * e)) & 0xffu) ? 1u << e : 0u;
    return bits;
  }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int V = 8;
  static __device__ __forceinline__ float load1(const void* p, int64_t at) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[at]);
  }
  static __device__ __forceinline__ void store1(void* p, int64_t at,
                                                float v) {
    static_cast<__nv_bfloat16*>(p)[at] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void load(const void* p, int64_t at,
                                              float* v) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p) + at));
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // a bf16 is the high half of its fp32
      v[2 * k] = __uint_as_float(w[k] << 16);
      v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    const uint32_t lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
    const uint32_t hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
    return lo | (hi << 16);
  }
  static __device__ __forceinline__ void store(void* p, int64_t at,
                                               const float* v) {
    *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p) + at) =
        make_uint4(pack(v[0], v[1]), pack(v[2], v[3]), pack(v[4], v[5]),
                   pack(v[6], v[7]));
  }
  static __device__ __forceinline__ uint32_t mask_bits(const uint8_t* m) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(m));
    uint32_t bits = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bits |= ((w.x >> (8 * e)) & 0xffu) ? 1u << e : 0u;
      bits |= ((w.y >> (8 * e)) & 0xffu) ? 1u << (e + 4) : 0u;
    }
    return bits;
  }
};

// v rounded to T and back (the reference's .astype(dtype) of the log term).
template <typename T>
__device__ __forceinline__ float round_as(float v);
template <>
__device__ __forceinline__ float round_as<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// N int32 (N a multiple of 4) from a 16-byte-aligned address.
template <int N>
__device__ __forceinline__ void load_ints(const int32_t* p, int32_t* out) {
#pragma unroll
  for (int k = 0; k < N / 4; ++k) {
    const int4 r = __ldg(reinterpret_cast<const int4*>(p) + k);
    out[4 * k] = r.x;
    out[4 * k + 1] = r.y;
    out[4 * k + 2] = r.z;
    out[4 * k + 3] = r.w;
  }
}

struct RowConsts {
  int32_t qid, own;
};

__device__ __forceinline__ RowConsts row_consts(const Logits& a, int64_t i) {
  RowConsts r{0, 0};
  if (a.use_qids) r.qid = __ldg(a.qids + i);
  if (a.rah) r.own = __ldg(a.cids + i);  // i < Q <= C (checked by the wrapper)
  return r;
}

// The masked logits v of row i's cells j0 .. j0 + n - 1 (n <= V) into
// v[0 .. V); cells past C (e >= n) get -inf, which no max or sum sees.
// Returns the cells whose candidate is valid as bits; sets diag to v_ii
// when the word holds column i. kWide: S's word, cmask, the ids and p
// are each one wide load (every term loaded, its mask on or off); else
// one load a cell.
template <typename T, bool kLogQ, bool kWide>
__device__ __forceinline__ uint32_t word_logits(const Logits& a, int64_t i,
                                                int64_t j0, int n,
                                                RowConsts rc, float* v,
                                                float& diag) {
  constexpr int V = Word<T>::V;
  float s[V], p[V];
  int32_t qid[V], cid[V];
  uint32_t on = 0;
  const int nq = static_cast<int>(
      a.q - j0 < 0 ? 0 : (a.q - j0 < V ? a.q - j0 : V));  // cells with j < Q
  if (kWide && n == V) {
    Word<T>::load(a.scores, i * a.c + j0, s);
    on = a.cmask != nullptr ? Word<T>::mask_bits(a.cmask + j0)
                            : (1u << V) - 1u;
    if (a.rah) load_ints<V>(a.cids + j0, cid);
    if (a.use_qids) {
      if (nq == V) {
        load_ints<V>(a.qids + j0, qid);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          qid[e] = e < nq ? __ldg(a.qids + j0 + e) : 0;
      }
    }
    if constexpr (kLogQ) {
#pragma unroll
      for (int k = 0; k < V / 4; ++k) {
        const float4 r = __ldg(reinterpret_cast<const float4*>(a.cprob + j0) + k);
        p[4 * k] = r.x;
        p[4 * k + 1] = r.y;
        p[4 * k + 2] = r.z;
        p[4 * k + 3] = r.w;
      }
    }
  } else {
#pragma unroll
    for (int e = 0; e < V; ++e) {
      s[e] = p[e] = 0.f;
      qid[e] = cid[e] = 0;
      if (e >= n) continue;
      const int64_t j = j0 + e;
      s[e] = Word<T>::load1(a.scores, i * a.c + j);
      on |= (a.cmask == nullptr || __ldg(a.cmask + j)) ? 1u << e : 0u;
      if (a.rah) cid[e] = __ldg(a.cids + j);
      if (a.use_qids) qid[e] = e < nq ? __ldg(a.qids + j) : 0;
      if constexpr (kLogQ) p[e] = __ldg(a.cprob + j);
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int64_t j = j0 + e;
    float x = s[e] / a.t;
    if constexpr (kLogQ) x = x - round_as<T>(logf(fmaxf(p[e], 1e-10f)));
    if (a.use_qids || a.rah) {
      const bool dup = (a.use_qids && e < nq && qid[e] == rc.qid) ||
                       (a.rah && cid[e] == rc.own);
      const float coef = (dup ? 1.f : 0.f) - (i == j ? 1.f : 0.f);
      x = x + coef * a.fmin;
    }
    x = (on >> e) & 1u ? x : a.fmin;
    if (i == j && e < n) diag = x;
    v[e] = e < n ? x : -INFINITY;
  }
  return on;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The max (kMax) or sum of v over a row's kRowThreads threads, in a fixed
// order (a butterfly in each warp, then the row's warps in order); every
// thread of the row gets it. Called by every thread of the block.
template <bool kMax>
__device__ __forceinline__ float row_reduce(float v, float* part) {
  v = kMax ? warp_max(v) : warp_sum(v);
  if constexpr (kRowWarps > 1) {
    const int row = threadIdx.x / kRowThreads;
    const int w = (threadIdx.x % kRowThreads) >> 5;
    if ((threadIdx.x & 31) == 0) part[row * kRowWarps + w] = v;
    __syncthreads();
    v = part[row * kRowWarps];
#pragma unroll
    for (int k = 1; k < kRowWarps; ++k)
      v = kMax ? fmaxf(v, part[row * kRowWarps + k]) : v + part[row * kRowWarps + k];
    __syncthreads();  // part is reused by the next call
  }
  return v;
}

template <typename T, bool kLogQ, bool kWide>
__global__ void __launch_bounds__(kFwdThreads)
    retrieval_fwd_kernel(Logits a, float* __restrict__ lse,
                         float* __restrict__ ce, float* __restrict__ loss_sum,
                         int32_t* __restrict__ count) {
  constexpr int V = Word<T>::V;
  constexpr int kWords = kLaneValues / V;            // a thread's words a chunk
  constexpr int64_t kChunk = kRowThreads * kLaneValues;  // a row's columns
  __shared__ float part[kBlockRows * kRowWarps];
  __shared__ float diag_of[kBlockRows];
  const int rb = threadIdx.x / kRowThreads;  // the block's row
  const int t = threadIdx.x % kRowThreads;   // the thread's place in it
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlockRows + rb;
  const bool live = i < a.q;  // a dead row loads nothing but joins the syncs
  RowConsts rc{0, 0};
  bool valid = false;
  if (live) {
    rc = row_consts(a, i);
    valid = a.qmask == nullptr || __ldg(a.qmask + i);
  }
  float m = -INFINITY, s = 0.f, diag = 0.f;
  for (int64_t c0 = 0; c0 < a.c; c0 += kChunk) {
    float v[kLaneValues];
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const int64_t j0 = c0 + static_cast<int64_t>(w * kRowThreads + t) * V;
      const int64_t left = live ? a.c - j0 : 0;
      const int n = static_cast<int>(left < 0 ? 0 : (left < V ? left : V));
      word_logits<T, kLogQ, kWide>(a, i, j0, n, rc, v + w * V, diag);
    }
    float cm = -INFINITY;
#pragma unroll
    for (int e = 0; e < kLaneValues; ++e) cm = fmaxf(cm, v[e]);
    const float m_new = fmaxf(m, row_reduce<true>(cm, part));
    s *= expf(m - m_new);  // 0 before the first chunk
#pragma unroll
    for (int e = 0; e < kLaneValues; ++e) s += expf(v[e] - m_new);
    m = m_new;
  }
  // Column i's thread (its word of the chunk: (i % kChunk) / V, the
  // thread that word's index modulo kRowThreads) holds v_ii.
  if (live && i < a.c &&
      t == static_cast<int>((i % kChunk) / V) % kRowThreads)
    diag_of[rb] = diag;
  s = row_reduce<false>(s, part);
  if constexpr (kRowWarps == 1) __syncthreads();  // diag_of is written
  if (live && t == 0) {
    const float l = m + logf(s);
    lse[i] = l;
    // Row i's label column is i when i < C; rows past C have no label.
    ce[i] = valid ? l - (i < a.c ? diag_of[rb] : 0.f) : 0.f;
  }
  // The last block to finish sums ce and counts qmask.
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&g_fwd_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc = 0.f;
  int cnt = 0;
  for (int64_t k = threadIdx.x; k < a.q; k += kFwdThreads) {
    acc += __ldcg(ce + k);
    cnt += (a.qmask == nullptr || __ldg(a.qmask + k)) ? 1 : 0;
  }
  acc = warp_sum(acc);
  cnt = warp_sum(cnt);
  __shared__ float warp_acc[kFwdThreads / 32];
  __shared__ int warp_cnt[kFwdThreads / 32];
  if ((threadIdx.x & 31) == 0) {
    warp_acc[threadIdx.x >> 5] = acc;
    warp_cnt[threadIdx.x >> 5] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    acc = warp_acc[0];
    cnt = warp_cnt[0];
#pragma unroll
    for (int w = 1; w < kFwdThreads / 32; ++w) {
      acc += warp_acc[w];
      cnt += warp_cnt[w];
    }
    *loss_sum = acc;
    *count = cnt;
  }
}

// A grid of (row words / kBwdThreads, rows): blockIdx.y walks the rows, so
// a thread finds its row and word with no division, and a block's row
// constants are one row's.
template <typename T, bool kLogQ, bool kWide>
__global__ void __launch_bounds__(kBwdThreads)
    retrieval_bwd_kernel(Logits a, int64_t words, const float* __restrict__ lse,
                         const float* __restrict__ g, void* __restrict__ ds) {
  constexpr int V = Word<T>::V;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kBwdThreads + threadIdx.x;
  if (w >= words) return;
  const int64_t j0 = w * V;
  const int64_t left = a.c - j0;
  const int n = static_cast<int>(left < V ? left : V);
  const float gg = __ldg(g);
  for (int64_t i = blockIdx.y; i < a.q; i += gridDim.y) {
    // Every load is issued before the row's qmask is known (a masked
    // row's words are read and dropped), so a thread waits for one round
    // trip.
    const bool valid = a.qmask == nullptr || __ldg(a.qmask + i);
    const float l = __ldg(lse + i);
    float v[V], d[V], diag;
    const uint32_t on =
        word_logits<T, kLogQ, kWide>(a, i, j0, n, row_consts(a, i), v, diag);
#pragma unroll
    for (int e = 0; e < V; ++e) {
      const float p = expf(v[e] - l);
      const float dv = gg * (p - (i == j0 + e ? 1.f : 0.f)) / a.t;
      d[e] = valid && ((on >> e) & 1u) ? dv : 0.f;
    }
    if (kWide && n == V) {
      Word<T>::store(ds, i * a.c + j0, d);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e)
        if (e < n) Word<T>::store1(ds, i * a.c + j0 + e, d[e]);
    }
  }
}

Logits make_logits(const void* scores, long long q, long long c,
                   const void* qids, const void* cids, const void* qmask,
                   const void* cmask, const void* cprob, float t, float fmin,
                   int use_qids, int rah) {
  return Logits{scores, q, c,
                static_cast<const int32_t*>(qids),
                static_cast<const int32_t*>(cids),
                static_cast<const uint8_t*>(qmask),
                static_cast<const uint8_t*>(cmask),
                static_cast<const float*>(cprob),
                t, fmin, use_qids != 0, rah != 0};
}

bool aligned(const void* p, uintptr_t to) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % to == 0;
}

// Every word a 16-byte load: rows whole words (C a multiple of V), S and
// the column terms on 16-byte boundaries, cmask on V-byte ones.
template <typename T>
bool wide(const Logits& a) {
  constexpr int V = Word<T>::V;
  return a.c % V == 0 && aligned(a.scores, 16) && aligned(a.cmask, V) &&
         aligned(a.qids, 16) && aligned(a.cids, 16) && aligned(a.cprob, 16);
}

template <typename T, bool kLogQ>
void launch_fwd(const Logits& a, float* lse, float* ce, float* loss_sum,
                int32_t* count, cudaStream_t s) {
  // one block even for Q = 0: it writes loss_sum = 0 and count = 0
  const unsigned blocks = static_cast<unsigned>(
      a.q > 0 ? (a.q + kBlockRows - 1) / kBlockRows : 1);
  if (wide<T>(a)) {
    retrieval_fwd_kernel<T, kLogQ, true><<<blocks, kFwdThreads, 0, s>>>(
        a, lse, ce, loss_sum, count);
  } else {
    retrieval_fwd_kernel<T, kLogQ, false><<<blocks, kFwdThreads, 0, s>>>(
        a, lse, ce, loss_sum, count);
  }
}

template <typename T, bool kLogQ>
void launch_bwd(const Logits& a, const float* lse, const float* g, void* ds,
                cudaStream_t s) {
  constexpr int V = Word<T>::V;
  const int64_t words = (a.c + V - 1) / V;
  const dim3 grid(static_cast<unsigned>((words + kBwdThreads - 1) / kBwdThreads),
                  static_cast<unsigned>(a.q < 65535 ? a.q : 65535));
  if (wide<T>(a) && aligned(ds, 16)) {
    retrieval_bwd_kernel<T, kLogQ, true><<<grid, kBwdThreads, 0, s>>>(
        a, words, lse, g, ds);
  } else {
    retrieval_bwd_kernel<T, kLogQ, false><<<grid, kBwdThreads, 0, s>>>(
        a, words, lse, g, ds);
  }
}

bool bad_args(const Logits& a, int dtype) {
  return (dtype != 0 && dtype != 1) || (a.use_qids && a.qids == nullptr) ||
         (a.rah && a.cids == nullptr) ||
         ((a.use_qids || a.rah) && a.c < a.q);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; cprob: [C] fp32 or NULL (logQ mode). Writes
// lse [Q] and ce [Q] (fp32), loss_sum (fp32 scalar) and count (int32
// scalar), in one launch.
extern "C" int gigl_retrieval_loss_fwd(
    const void* scores, long long q, long long c, int dtype, const void* qids,
    const void* cids, const void* qmask, const void* cmask, const void* cprob,
    float t, float fmin, int use_qids, int rah, void* lse, void* ce,
    void* loss_sum, void* count, void* stream) {
  const Logits a = make_logits(scores, q, c, qids, cids, qmask, cmask, cprob,
                               t, fmin, use_qids, rah);
  if (bad_args(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* e = static_cast<float*>(ce);
  float* ls = static_cast<float*>(loss_sum);
  int32_t* n = static_cast<int32_t*>(count);
  const bool logq = cprob != nullptr;
  if (dtype == 0) {
    logq ? launch_fwd<float, true>(a, l, e, ls, n, s)
         : launch_fwd<float, false>(a, l, e, ls, n, s);
  } else {
    logq ? launch_fwd<__nv_bfloat16, true>(a, l, e, ls, n, s)
         : launch_fwd<__nv_bfloat16, false>(a, l, e, ls, n, s);
  }
  return static_cast<int>(cudaGetLastError());
}

// g: device pointer to the (fp32 scalar) cotangent of loss_sum; ds [Q, C]
// in S's type.
extern "C" int gigl_retrieval_loss_bwd(
    const void* scores, long long q, long long c, int dtype, const void* qids,
    const void* cids, const void* qmask, const void* cmask, const void* cprob,
    float t, float fmin, int use_qids, int rah, const void* lse, const void* g,
    void* ds, void* stream) {
  const Logits a = make_logits(scores, q, c, qids, cids, qmask, cmask, cprob,
                               t, fmin, use_qids, rah);
  if (bad_args(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q > 0 && c > 0) {
    const float* l = static_cast<const float*>(lse);
    const float* gg = static_cast<const float*>(g);
    const bool logq = cprob != nullptr;
    if (dtype == 0) {
      logq ? launch_bwd<float, true>(a, l, gg, ds, s)
           : launch_bwd<float, false>(a, l, gg, ds, s);
    } else {
      logq ? launch_bwd<__nv_bfloat16, true>(a, l, gg, ds, s)
           : launch_bwd<__nv_bfloat16, false>(a, l, gg, ds, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Copies the forward's ticket counter (uint32) to the device word `out`
// on `stream`: 0 whenever no forward is in flight on this device.
extern "C" int gigl_retrieval_loss_ticket(void* out, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(
      out, g_fwd_ticket, sizeof(unsigned int), 0, cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream)));
}
