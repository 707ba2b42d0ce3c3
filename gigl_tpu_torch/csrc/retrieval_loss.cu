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
// of HBM time, so both are launch-bound. Design: the forward gives each
// query row one 128-thread block (512 blocks at the flagship, enough to
// fill the card), threads on consecutive columns (coalesced); each thread
// takes the max of its columns, then sums exp(v - max) over them in a
// second sweep (one exp per cell, the row is served from L1/L2), and the
// block merges the partials in a fixed shuffle + shared-memory tree. A
// second one-block kernel sums ce and counts qmask in a fixed tree order,
// so a repeat run is bit-equal (no float atomics). The backward is
// elementwise: one thread per cell, reading its row's lse.
#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

#include "gigl_common.cuh"

namespace {

constexpr int kRowThreads = 128;  // forward: one block per query row
constexpr int kBwdThreads = 256;  // backward: one thread per cell
constexpr int kSumThreads = 1024;

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

template <typename T>
__device__ __forceinline__ float load_f(const void* p, int64_t at);
template <>
__device__ __forceinline__ float load_f<float>(const void* p, int64_t at) {
  return __ldg(static_cast<const float*>(p) + at);
}
template <>
__device__ __forceinline__ float load_f<__nv_bfloat16>(const void* p,
                                                       int64_t at) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[at]);
}

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

template <typename T>
__device__ __forceinline__ void store_f(void* p, int64_t at, float v);
template <>
__device__ __forceinline__ void store_f<float>(void* p, int64_t at, float v) {
  static_cast<float*>(p)[at] = v;
}
template <>
__device__ __forceinline__ void store_f<__nv_bfloat16>(void* p, int64_t at,
                                                       float v) {
  static_cast<__nv_bfloat16*>(p)[at] = __float2bfloat16_rn(v);
}

// The masked logit v_ij (see the header). qid_i / own_i are row constants.
template <typename T, bool kLogQ>
__device__ __forceinline__ float logit(const Logits& a, int64_t i, int64_t j,
                                       int32_t qid_i, int32_t own_i) {
  if (a.cmask != nullptr && !__ldg(a.cmask + j)) return a.fmin;
  float v = load_f<T>(a.scores, i * a.c + j) / a.t;
  if constexpr (kLogQ)
    v = v - round_as<T>(logf(fmaxf(__ldg(a.cprob + j), 1e-10f)));
  if (a.use_qids || a.rah) {
    const bool dup = (a.use_qids && j < a.q && __ldg(a.qids + j) == qid_i) ||
                     (a.rah && __ldg(a.cids + j) == own_i);
    const float coef = (dup ? 1.f : 0.f) - (i == j ? 1.f : 0.f);
    v = v + coef * a.fmin;
  }
  return v;
}

// Reduce one value over the block in a fixed order (shuffle tree within
// each warp, then warps 0..3), max or sum; every thread gets the result.
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float part[kRowThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : v + o;
  }
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  v = part[0];
#pragma unroll
  for (int w = 1; w < kRowThreads / 32; ++w)
    v = kMax ? fmaxf(v, part[w]) : v + part[w];
  __syncthreads();  // part is reused by the next call
  return v;
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

template <typename T, bool kLogQ>
__global__ void retrieval_fwd_rows(Logits a, float* __restrict__ lse,
                                   float* __restrict__ ce) {
  const int64_t i = blockIdx.x;
  const RowConsts rc = row_consts(a, i);
  float m = -INFINITY;
  for (int64_t j = threadIdx.x; j < a.c; j += kRowThreads)
    m = fmaxf(m, logit<T, kLogQ>(a, i, j, rc.qid, rc.own));
  m = block_reduce<true>(m);
  float s = 0.f;
  for (int64_t j = threadIdx.x; j < a.c; j += kRowThreads)
    s += expf(logit<T, kLogQ>(a, i, j, rc.qid, rc.own) - m);
  s = block_reduce<false>(s);
  if (threadIdx.x == 0) {
    const float l = m + logf(s);
    const bool valid = a.qmask == nullptr || __ldg(a.qmask + i);
    // Row i's label column is i when i < C; rows past C have no label.
    const float diag =
        i < a.c ? logit<T, kLogQ>(a, i, i, rc.qid, rc.own) : 0.f;
    lse[i] = l;
    ce[i] = valid ? l - diag : 0.f;
  }
}

__global__ void retrieval_fwd_sum(const float* __restrict__ ce,
                                  const uint8_t* __restrict__ qmask, int64_t q,
                                  float* __restrict__ loss_sum,
                                  int32_t* __restrict__ count) {
  __shared__ float ssum[kSumThreads];
  __shared__ int scnt[kSumThreads];
  const int t = threadIdx.x;
  float acc = 0.f;
  int cnt = 0;
  for (int64_t i = t; i < q; i += kSumThreads) {
    acc += ce[i];
    cnt += (qmask == nullptr || qmask[i]) ? 1 : 0;
  }
  ssum[t] = acc;
  scnt[t] = cnt;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half >>= 1) {
    if (t < half) {
      ssum[t] += ssum[t + half];
      scnt[t] += scnt[t + half];
    }
    __syncthreads();
  }
  if (t == 0) {
    *loss_sum = ssum[0];
    *count = scnt[0];
  }
}

template <typename T, bool kLogQ>
__global__ void retrieval_bwd(Logits a, const float* __restrict__ lse,
                              const float* __restrict__ g,
                              void* __restrict__ ds) {
  const int64_t at = static_cast<int64_t>(blockIdx.x) * kBwdThreads +
                     threadIdx.x;
  if (at >= a.q * a.c) return;
  const int64_t i = at / a.c;
  const int64_t j = at - i * a.c;
  const bool valid = a.qmask == nullptr || __ldg(a.qmask + i);
  float d = 0.f;
  if (valid && (a.cmask == nullptr || __ldg(a.cmask + j))) {
    const RowConsts rc = row_consts(a, i);
    const float p =
        expf(logit<T, kLogQ>(a, i, j, rc.qid, rc.own) - __ldg(lse + i));
    d = __ldg(g) * (p - (i == j ? 1.f : 0.f)) / a.t;
  }
  store_f<T>(ds, at, d);
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

template <typename T, bool kLogQ>
void launch_fwd(const Logits& a, float* lse, float* ce, cudaStream_t s) {
  retrieval_fwd_rows<T, kLogQ>
      <<<static_cast<unsigned>(a.q), kRowThreads, 0, s>>>(a, lse, ce);
}

template <typename T, bool kLogQ>
void launch_bwd(const Logits& a, const float* lse, const float* g, void* ds,
                cudaStream_t s) {
  const unsigned blocks =
      static_cast<unsigned>((a.q * a.c + kBwdThreads - 1) / kBwdThreads);
  retrieval_bwd<T, kLogQ><<<blocks, kBwdThreads, 0, s>>>(a, lse, g, ds);
}

bool bad_args(const Logits& a, int dtype) {
  return (dtype != 0 && dtype != 1) || (a.use_qids && a.qids == nullptr) ||
         (a.rah && a.cids == nullptr) ||
         ((a.use_qids || a.rah) && a.c < a.q);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; cprob: [C] fp32 or NULL (logQ mode). Writes
// lse [Q] and ce [Q] (fp32), loss_sum (fp32 scalar) and count (int32
// scalar).
extern "C" int gigl_retrieval_loss_fwd(
    const void* scores, long long q, long long c, int dtype, const void* qids,
    const void* cids, const void* qmask, const void* cmask, const void* cprob,
    float t, float fmin, int use_qids, int rah, void* lse, void* ce,
    void* loss_sum, void* count, void* stream) {
  const Logits a = make_logits(scores, q, c, qids, cids, qmask, cmask, cprob,
                               t, fmin, use_qids, rah);
  if (bad_args(a, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q > 0) {
    float* l = static_cast<float*>(lse);
    float* e = static_cast<float*>(ce);
    const bool logq = cprob != nullptr;
    if (dtype == 0) {
      logq ? launch_fwd<float, true>(a, l, e, s)
           : launch_fwd<float, false>(a, l, e, s);
    } else {
      logq ? launch_fwd<__nv_bfloat16, true>(a, l, e, s)
           : launch_fwd<__nv_bfloat16, false>(a, l, e, s);
    }
  }
  retrieval_fwd_sum<<<1, kSumThreads, 0, s>>>(
      static_cast<const float*>(ce), static_cast<const uint8_t*>(qmask), q,
      static_cast<float*>(loss_sum), static_cast<int32_t*>(count));
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
