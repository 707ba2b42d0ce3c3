// K7 fanout_attention's warp path (see fanout_attention.cu for what it
// computes and its design): the kernel and its launch, a template over the
// table type, the piece width, the pieces per lane, the mode (-1: read at
// run time) and the optional operands. fanout_attention.cu instantiates the
// general forms; fanout_attention_fp32.cu and fanout_attention_bf16.cu the
// forms the launcher takes for 16-byte pieces with K <= 2 and 8-byte pieces
// with K = 1, one per mode (GIGL_K7_FAST), in parallel builds.
#pragma once

#include "gigl_attention.cuh"

namespace gigl {
namespace k7 {

using namespace gigl::attn;

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

// The logit of one head from its summed dot product.
__device__ __forceinline__ float finish_logit(float a, int mode, float sd_h,
                                              float slope, float sqrt_dh) {
  if (mode == kGat) return leaky(a + sd_h, slope);
  if (mode == kGatV2) return a;
  return a / sqrt_dh;
}

template <typename T>
struct Args {
  const T *xd, *ks, *vs;
  const int32_t* nbr;
  const uint8_t* mask;
  const float *att, *att2;
  const T* he;
  const int32_t* eidx;
  const float* bias;
  T* out;
  float* stats;
};

template <typename T, int PW, int K, int MODE, bool EXTRA>
__global__ void __launch_bounds__(kThreads) fanout_attention_warp(
    const T* __restrict__ xd, const T* __restrict__ ks,
    const T* __restrict__ vs, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ mask, const float* __restrict__ att,
    const float* __restrict__ att2, const T* __restrict__ he,
    const int32_t* __restrict__ eidx, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stats, int64_t n, int w,
    LaneMap m, int mode_arg, float slope, float sqrt_dh) {
  // MODE >= 0: the mode a compile-time constant (its branches fold away);
  // -1: read at run time. Without the optional operands their code folds
  // away (EXTRA false).
  const int mode = MODE >= 0 ? MODE : mode_arg;
  if constexpr (!EXTRA) {
    he = nullptr;
    bias = nullptr;
  }
  constexpr int V = PW / sizeof(T);
  constexpr int NW = PW / 4;
  constexpr int D = kDepth / K > 0 ? kDepth / K : 1;
  const float neg_inf = -__int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int lg = lane % m.lr;  // lane within the row's lanes
  const int rbase = lane - lg;
  const int grp = lg / m.ls;   // slot group
  const unsigned rmask = m.lr == 32 ? kFull : (1u << m.lr) - 1u;
  const int rows = 32 / m.lr;
  const int hd = m.hd;
  // keys and values one table: GAT and GATv2's fixed-mode forms (the
  // launcher sends two tables to the run-time form), never a Transformer's
  const bool same =
      MODE == kTransformer ? false : (MODE >= 0 ? true : ks == vs);
  // a lane's K pieces belong to one head (its scalars computed once)
  const bool one_head = K == 1 || m.sp >= K;
  const int32_t* ei = he != nullptr ? eidx : nullptr;
  const LanePieces<V, K> lp(m, lane);
  float at[K][V];  // att_src (GAT) or att (GATv2)
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int u = 0; u < V; ++u)
      at[k][u] = mode != kTransformer && lp.live[k] ? att[lp.e0[k] + u] : 0.f;
  for (int64_t rg = warp0; rg * rows < n; rg += nwarps) {
    const int64_t i = rg * rows + lane / m.lr;
    const bool row_ok = i < n;
    float q[K][V], sd[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      sd[k] = 0.f;
      if (row_ok && lp.live[k]) {
        load_vals<T, PW>(xd + i * hd + lp.e0[k], q[k]);
        if (mode == kGat) {
#pragma unroll
          for (int u = 0; u < V; ++u) sd[k] += q[k][u] * att2[lp.e0[k] + u];
        }
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) q[k][u] = 0.f;
      }
    }
    if (mode == kGat) head_sum<K>(sd, m.sp);
    float mx[K], den[K], acc[K][V];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      mx[k] = neg_inf;
      den[k] = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) acc[k][u] = 0.f;
    }
    for (int c0 = 0; c0 < w; c0 += m.lr) {
      const Chunk c =
          compact_chunk(nbr, mask, ei, i, row_ok, w, c0, lg, rbase, rmask);
      const int nit = static_cast<int>(__reduce_max_sync(
          kFull, static_cast<unsigned>((c.nv + m.gr - 1) / m.gr)));
      // the next D slots' loads are issued before the current ones'
      // arithmetic
      SlotBatch<D, K, NW> nxt;
      load_batch<T, PW, K, D, V>(nxt, c, 0, nit, m, grp, rbase, lp, ks, vs,
                                 he, bias, same);
      for (int it = 0; it < nit; it += D) {
        const SlotBatch<D, K, NW> cur = nxt;
        if (it + D < nit)
          load_batch<T, PW, K, D, V>(nxt, c, it + D, nit, m, grp, rbase, lp,
                                     ks, vs, he, bias, same);
        float lgt[D][K], val[D][K][V];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float kv[K][V], vv[K][V], a[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            unpack<T, PW>(cur.kr[d][k], kv[k]);
            if (!same) unpack<T, PW>(cur.vr[d][k], vv[k]);
            if (he != nullptr) {
              float ev[V];
              unpack<T, PW>(cur.er[d][k], ev);
#pragma unroll
              for (int u = 0; u < V; ++u) {
                kv[k][u] += ev[u];
                if (!same) vv[k][u] += ev[u];
              }
            }
            a[k] = 0.f;
#pragma unroll
            for (int u = 0; u < V; ++u) {
              if (mode == kGat)
                a[k] += kv[k][u] * at[k][u];
              else if (mode == kGatV2)
                a[k] += at[k][u] * leaky(kv[k][u] + q[k][u], slope);
              else
                a[k] += q[k][u] * kv[k][u];
            }
          }
          head_sum<K>(a, m.sp);
#pragma unroll
          for (int k = 0; k < K; ++k)
            lgt[d][k] = cur.ok[d] && lp.live[k]
                            ? finish_logit(a[k], mode, sd[k] + cur.br[d][k],
                                           slope, sqrt_dh)
                            : neg_inf;
#pragma unroll
          for (int k = 0; k < K; ++k)
#pragma unroll
            for (int u = 0; u < V; ++u)
              val[d][k][u] = same ? kv[k][u] : vv[k][u];
        }
        // online softmax over the D slots at once: one rescale to the new
        // max, one exp a slot; a lane's K pieces of one head share them
        float rk[K], pk[D][K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          rk[k] = 1.f;
#pragma unroll
          for (int d = 0; d < D; ++d) pk[d][k] = 0.f;
          if (!lp.live[k]) continue;
          if (k > 0 && one_head) {
            rk[k] = rk[0];
#pragma unroll
            for (int d = 0; d < D; ++d) pk[d][k] = pk[d][0];
            den[k] = den[0];
            mx[k] = mx[0];
            continue;
          }
          float nm = mx[k];
#pragma unroll
          for (int d = 0; d < D; ++d) nm = fmaxf(nm, lgt[d][k]);
          if (nm == neg_inf) continue;  // no valid slot yet
          rk[k] = mx[k] == neg_inf ? 0.f : expf(mx[k] - nm);
          float s = den[k] * rk[k];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            pk[d][k] = lgt[d][k] == neg_inf ? 0.f : expf(lgt[d][k] - nm);
            s += pk[d][k];
          }
          den[k] = s;
          mx[k] = nm;
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (!lp.live[k]) continue;
#pragma unroll
          for (int u = 0; u < V; ++u) {
            float a = acc[k][u] * rk[k];
#pragma unroll
            for (int d = 0; d < D; ++d) a += pk[d][k] * val[d][k][u];
            acc[k][u] = a;
          }
        }
      }
    }
    // the row's slot groups merged, rescaled to the common max
    for (int o = m.ls; o < m.lr; o <<= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float mo = __shfl_xor_sync(kFull, mx[k], o);
        const float dno = __shfl_xor_sync(kFull, den[k], o);
        const float nm = fmaxf(mx[k], mo);
        const float r1 = mx[k] == neg_inf ? 0.f : expf(mx[k] - nm);
        const float r2 = mo == neg_inf ? 0.f : expf(mo - nm);
        den[k] = den[k] * r1 + dno * r2;
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const float ao = __shfl_xor_sync(kFull, acc[k][u], o);
          acc[k][u] = acc[k][u] * r1 + ao * r2;
        }
        mx[k] = nm;
      }
    }
    if (row_ok && grp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!lp.live[k]) continue;
        const float dn = fmaxf(den[k], 1e-16f);
        float o[V];
#pragma unroll
        for (int u = 0; u < V; ++u) o[u] = acc[k][u] / dn;
        store_vals<T, PW>(out + i * hd + lp.e0[k], o);
        if (stats != nullptr && lp.lead[k]) {
          stats[(i * m.heads + lp.h[k]) * 2] = mx[k];
          stats[(i * m.heads + lp.h[k]) * 2 + 1] = den[k];
        }
      }
    }
  }
}

// Blocks for `warps` warps: at most as many as are resident on the card
// at once (each block's warps walk the rest).
template <typename F>
unsigned grid_for(F kernel, long long warps) {
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const long long need = (warps + kThreads / 32 - 1) / (kThreads / 32);
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(need < cap ? need : cap);
}

template <typename T, int PW, int K, int MODE, bool EXTRA>
void launch_warp(const Args<T>& a, long long n, int w, const LaneMap& m,
                 int mode, float slope, float sqrt_dh, cudaStream_t stream) {
  auto kernel = fanout_attention_warp<T, PW, K, MODE, EXTRA>;
  const long long warps = (n + 32 / m.lr - 1) / (32 / m.lr);
  kernel<<<grid_for(kernel, warps), kThreads, 0, stream>>>(
      a.xd, a.ks, a.vs, a.nbr, a.mask, a.att, a.att2, a.he, a.eidx, a.bias,
      a.out, a.stats, n, w, m, mode, slope, sqrt_dh);
}

// The forms with the mode fixed: 16-byte pieces at K 1 and 2 and 8-byte
// pieces at K 1, each mode with and without the optional operands (GATv2's
// are its edge rows).
#define GIGL_K7_FAST_PW_K(X, T, PW, K) \
  X(T, PW, K, 0, false) X(T, PW, K, 0, true) X(T, PW, K, 1, false) \
  X(T, PW, K, 1, true) X(T, PW, K, 2, false) X(T, PW, K, 2, true)
#define GIGL_K7_FAST(X, T) \
  GIGL_K7_FAST_PW_K(X, T, 16, 1) GIGL_K7_FAST_PW_K(X, T, 16, 2) \
  GIGL_K7_FAST_PW_K(X, T, 8, 1)
#define GIGL_K7_DECLARE(T, PW, K, MODE, EXTRA)                              \
  extern template void launch_warp<T, PW, K, MODE, EXTRA>(                  \
      const Args<T>&, long long, int, const LaneMap&, int, float, float,    \
      cudaStream_t);
#define GIGL_K7_DEFINE(T, PW, K, MODE, EXTRA)                               \
  template void launch_warp<T, PW, K, MODE, EXTRA>(                         \
      const Args<T>&, long long, int, const LaneMap&, int, float, float,    \
      cudaStream_t);

}  // namespace k7
}  // namespace gigl
