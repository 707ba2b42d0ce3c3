// K7b fanout_attention_bwd's warp path (see fanout_attention_bwd.cu for
// what it computes and its design): the kernel and its launch, a template
// over the table type, the piece width, the pieces per lane, the mode (-1:
// read at run time) and the optional operands. fanout_attention_bwd.cu
// instantiates the general forms; fanout_attention_bwd_fp32.cu and
// fanout_attention_bwd_bf16.cu the forms the launcher takes for 16-byte
// pieces with K <= 2 and 8-byte pieces with K = 1, one per mode
// (GIGL_K7B_FAST), in parallel builds.
#pragma once

#include "gigl_attention.cuh"

namespace gigl {
namespace k7b {

using namespace gigl::attn;

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

// jax.nn.leaky_relu's derivative: 1 for z >= 0, else the slope.
__device__ __forceinline__ float leaky_grad(float z, float slope) {
  return z >= 0.f ? 1.f : slope;
}

// The logit's per-value product of one slot (summed per head).
__device__ __forceinline__ float logit_term(int mode, float kv, float q,
                                            float a, float slope) {
  if (mode == kGat) return kv * a;
  if (mode == kGatV2) return a * leaky(kv + q, slope);
  return q * kv;
}

template <typename T>
struct Args {
  const T *g, *xd, *ks, *vs, *out;
  const float* stats;
  const int32_t* nbr;
  const uint8_t* mask;
  const float *att, *att2;
  const T* he;
  const int32_t* eidx;
  const float* bias;
  T* d_xd;
  float *e_alpha, *e_coef;
  T *d_ks, *d_vs;
  float* part;
};

// Dynamic shared memory of the warp path: [kWarps, 2 * hd] floats, the
// warps' d_att partials (GAT modes: att_src / att, then att_dst).
template <typename T, int PW, int K, int MODE, bool EXTRA>
__global__ void __launch_bounds__(kThreads) fanout_attention_bwd_warp(
    const T* __restrict__ g, const T* __restrict__ xd,
    const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ out, const float* __restrict__ stats,
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ att, const float* __restrict__ att2,
    const T* __restrict__ he, const int32_t* __restrict__ eidx,
    const float* __restrict__ bias, T* __restrict__ d_xd,
    float* __restrict__ e_alpha, float* __restrict__ e_coef,
    T* __restrict__ d_ks, T* __restrict__ d_vs, float* __restrict__ part,
    int64_t n, int w, LaneMap m, int mode_arg, float slope, float sqrt_dh) {
  // MODE >= 0: the mode a compile-time constant (its branches fold away);
  // -1: read at run time
  const int mode = MODE >= 0 ? MODE : mode_arg;
  if constexpr (!EXTRA) {
    he = nullptr;
    bias = nullptr;
  }
  extern __shared__ float red[];
  constexpr int V = PW / sizeof(T);
  constexpr int NW = PW / 4;
  constexpr int D = kDepth / K > 0 ? kDepth / K : 1;
  const bool gat = mode == kGat, v2 = mode == kGatV2;
  // keys and values one table: GAT and GATv2's fixed-mode forms (the
  // launcher sends two tables to the run-time form), never a Transformer's
  const bool same =
      MODE == kTransformer ? false : (MODE >= 0 ? true : ks == vs);
  // a lane's K pieces belong to one head (its scalars computed once)
  const bool one_head = K == 1 || m.sp >= K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t warp0 =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int lg = lane % m.lr;
  const int rbase = lane - lg;
  const int grp = lg / m.ls;
  const unsigned rmask = m.lr == 32 ? kFull : (1u << m.lr) - 1u;
  const int rows = 32 / m.lr;
  const int hd = m.hd, heads = m.heads;
  const int32_t* ei = he != nullptr ? eidx : nullptr;
  const LanePieces<V, K> lp(m, lane);
  float at[K][V];    // att_src (GAT) or att (GATv2)
  float racc[K][V];  // d_att_src (GATv2: d_att), over the warp's slots
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int u = 0; u < V; ++u) {
      at[k][u] = mode != kTransformer && lp.live[k] ? att[lp.e0[k] + u] : 0.f;
      racc[k][u] = 0.f;
    }
  // the warp's d_att partials in shared memory: d_att_src written at the
  // end, d_att_dst (GAT) summed there row by row
  float* rw = red + static_cast<int64_t>(warp) * 2 * hd;
  if (part != nullptr) {
    for (int e = lane; e < 2 * hd; e += 32) rw[e] = 0.f;
    __syncwarp();
  }
  for (int64_t rg = warp0; rg * rows < n; rg += nwarps) {
    const int64_t i = rg * rows + lane / m.lr;
    const bool row_ok = i < n;
    float q[K][V], gv[K][V], tt[K], sd[K], mx[K], dn[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      tt[k] = 0.f;
      sd[k] = 0.f;
      mx[k] = 0.f;
      dn[k] = 1.f;
      if (row_ok && lp.live[k]) {
        float ov[V];
        load_vals<T, PW>(xd + i * hd + lp.e0[k], q[k]);
        load_vals<T, PW>(g + i * hd + lp.e0[k], gv[k]);
        load_vals<T, PW>(out + i * hd + lp.e0[k], ov);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          tt[k] += gv[k][u] * ov[u];
          if (gat) sd[k] += q[k][u] * att2[lp.e0[k] + u];
        }
        mx[k] = stats[(i * heads + lp.h[k]) * 2];
        dn[k] = fmaxf(stats[(i * heads + lp.h[k]) * 2 + 1], 1e-16f);
      } else {
#pragma unroll
        for (int u = 0; u < V; ++u) q[k][u] = gv[k][u] = 0.f;
      }
    }
    head_sum<K>(tt, m.sp);
    if (gat) head_sum<K>(sd, m.sp);
    float rrow[K][V], ssum[K];  // d_xd (GATv2, Transformer); GAT sum d_pre
#pragma unroll
    for (int k = 0; k < K; ++k) {
      ssum[k] = 0.f;
#pragma unroll
      for (int u = 0; u < V; ++u) rrow[k][u] = 0.f;
    }
    for (int c0 = 0; c0 < w; c0 += m.lr) {
      const Chunk c =
          compact_chunk(nbr, mask, ei, i, row_ok, w, c0, lg, rbase, rmask);
      // zeros at the chunk's masked entries: each lane its own slot's
      // per-head scalars, a row's lanes together each masked slot's
      // gradient rows
      {
        const int j = c0 + lg;
        const bool zero = row_ok && j < w && mask[i * w + j] == 0;
        if (zero) {
          const int64_t pz = (i * w + j) * heads;
          for (int h = 0; h < heads; ++h) {
            if (e_alpha != nullptr) e_alpha[pz + h] = 0.f;
            if (e_coef != nullptr) e_coef[pz + h] = 0.f;
          }
        }
        if (d_ks != nullptr) {
          unsigned zb = (__ballot_sync(kFull, zero) >> rbase) & rmask;
          float zv[V];
#pragma unroll
          for (int u = 0; u < V; ++u) zv[u] = 0.f;
          while (zb != 0u) {
            const int b = __ffs(zb) - 1;
            zb &= zb - 1u;
            const int64_t pz = i * w + c0 + b;
            for (int pc = lg; pc < hd / V; pc += m.lr) {
              store_vals<T, PW>(d_ks + pz * hd + pc * V, zv);
              if (d_vs != nullptr) store_vals<T, PW>(d_vs + pz * hd + pc * V, zv);
            }
          }
        }
      }
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
        // ... then the arithmetic, slot by slot
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float kv[K][V], vv[K][V], p1[K], p2[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            unpack<T, PW>(cur.kr[d][k], kv[k]);
            if (same) {
#pragma unroll
              for (int u = 0; u < V; ++u) vv[k][u] = kv[k][u];
            } else {
              unpack<T, PW>(cur.vr[d][k], vv[k]);
            }
            if (he != nullptr) {
              float ev[V];
              unpack<T, PW>(cur.er[d][k], ev);
#pragma unroll
              for (int u = 0; u < V; ++u) {
                kv[k][u] += ev[u];
                vv[k][u] += ev[u];
              }
            }
            p1[k] = 0.f;
            p2[k] = 0.f;
#pragma unroll
            for (int u = 0; u < V; ++u) {
              p1[k] += logit_term(mode, kv[k][u], q[k][u], at[k][u], slope);
              p2[k] += gv[k][u] * vv[k][u];
            }
          }
          head_sum<K>(p1, m.sp);
          head_sum<K>(p2, m.sp);
          // a lane's K pieces of one head share its scalars
          float al[K], cfk[K], pre[K];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            al[k] = cfk[k] = pre[k] = 0.f;
            if (!cur.ok[d] || !lp.live[k]) continue;
            if (k > 0 && one_head) {
              al[k] = al[0];
              cfk[k] = cfk[0];
              continue;
            }
            float logit;
            if (gat) {
              pre[k] = p1[k] + sd[k] + cur.br[d][k];
              logit = leaky(pre[k], slope);
            } else {
              logit = v2 ? p1[k] : p1[k] / sqrt_dh;
            }
            al[k] = expf(logit - mx[k]) / dn[k];
            const float dlog = al[k] * (p2[k] - tt[k]);
            cfk[k] = gat ? dlog * leaky_grad(pre[k], slope)
                         : (v2 ? dlog : dlog / sqrt_dh);
          }
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (!cur.ok[d] || !lp.live[k]) continue;
            const float alpha = al[k], cf = cfk[k];
            const int64_t p = i * w + cur.col[d];
            if (lp.lead[k]) {
              if (e_alpha != nullptr) e_alpha[p * heads + lp.h[k]] = alpha;
              if (e_coef != nullptr) e_coef[p * heads + lp.h[k]] = cf;
            }
            ssum[k] += cf;
            float dk[V], dv[V];
#pragma unroll
            for (int u = 0; u < V; ++u) {
              if (gat) {
                racc[k][u] += cf * kv[k][u];
                dk[u] = at[k][u] * cf;
              } else if (v2) {
                const float z = kv[k][u] + q[k][u];
                dk[u] = cf * at[k][u] * leaky_grad(z, slope);
                rrow[k][u] += dk[u];
                racc[k][u] += cf * leaky(z, slope);
              } else {
                rrow[k][u] += cf * kv[k][u];
                dk[u] = q[k][u] * cf;
              }
              dv[u] = alpha * gv[k][u];
            }
            if (d_ks != nullptr) {
              if (d_vs != nullptr) {
                store_vals<T, PW>(d_ks + p * hd + lp.e0[k], dk);
                store_vals<T, PW>(d_vs + p * hd + lp.e0[k], dv);
              } else {
#pragma unroll
                for (int u = 0; u < V; ++u) dk[u] += dv[u];
                store_vals<T, PW>(d_ks + p * hd + lp.e0[k], dk);
              }
            }
          }
        }
      }
    }
    // the row's slot groups reduced; group 0 writes d_xd
    for (int o = m.ls; o < m.lr; o <<= 1) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        ssum[k] += __shfl_xor_sync(kFull, ssum[k], o);
#pragma unroll
        for (int u = 0; u < V; ++u)
          rrow[k][u] += __shfl_xor_sync(kFull, rrow[k][u], o);
      }
    }
    if (row_ok && grp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!lp.live[k]) continue;
        float dx[V];
#pragma unroll
        for (int u = 0; u < V; ++u)
          dx[u] = gat ? att2[lp.e0[k] + u] * ssum[k] : rrow[k][u];
        store_vals<T, PW>(d_xd + i * hd + lp.e0[k], dx);
      }
    }
    if (gat) {
      // d_att_dst += xd[i] * sum_j d_pre, the warp's rows one at a time;
      // GAT reads its query row again here rather than keep it live over
      // the slots (an L1 / L2 hit)
      for (int r = 0; r < rows; ++r) {
        if (lane / m.lr == r && row_ok && grp == 0) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            if (!lp.live[k]) continue;
            float qk[V];
            load_vals<T, PW>(xd + i * hd + lp.e0[k], qk);
#pragma unroll
            for (int u = 0; u < V; ++u) rw[hd + lp.e0[k] + u] += qk[u] * ssum[k];
          }
        }
        __syncwarp();
      }
    }
  }
  if (part == nullptr) return;
  // d_att: the warp's slot groups reduced, then its warps in order
  for (int o = K == 1 ? m.ls : 32; o < 32; o <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int u = 0; u < V; ++u)
        racc[k][u] += __shfl_xor_sync(kFull, racc[k][u], o);
  }
  if (K > 1 || lane < m.ls) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (!lp.live[k]) continue;
#pragma unroll
      for (int u = 0; u < V; ++u) rw[lp.e0[k] + u] = racc[k][u];
    }
  }
  __syncthreads();
  float* pb = part + static_cast<int64_t>(blockIdx.x) * 2 * hd;
  for (int e = threadIdx.x; e < 2 * hd; e += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k * 2 * hd + e];
    pb[e] = s;
  }
}

// The warp path's blocks: at most `grid` (the rows of `part`), at most as
// many as are resident on the card at once, at most one per kWarps row
// groups. Returns the number launched.
template <typename T, int PW, int K, int MODE, bool EXTRA>
int launch_warp(const Args<T>& a, long long n, int w, const LaneMap& m,
                int mode, float slope, float sqrt_dh, int grid,
                cudaStream_t stream) {
  auto kernel = fanout_attention_bwd_warp<T, PW, K, MODE, EXTRA>;
  const size_t smem =
      a.part != nullptr ? sizeof(float) * kWarps * 2 * m.hd : 0;
  int dev = 0, sms = 1, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  const long long rows = 32 / m.lr;
  const long long need = ((n + rows - 1) / rows + kWarps - 1) / kWarps;
  long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  blocks = blocks < need ? blocks : need;
  blocks = blocks < grid ? blocks : grid;
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      a.g, a.xd, a.ks, a.vs, a.out, a.stats, a.nbr, a.mask, a.att, a.att2,
      a.he, a.eidx, a.bias, a.d_xd, a.e_alpha, a.e_coef, a.d_ks, a.d_vs,
      a.part, n, w, m, mode, slope, sqrt_dh);
  return static_cast<int>(blocks);
}

// The forms with the mode fixed: 16-byte pieces at K 1 and 2 and 8-byte
// pieces at K 1, each mode with and without the optional operands (GATv2's
// are its edge rows).
#define GIGL_K7B_FAST_PW_K(X, T, PW, K) \
  X(T, PW, K, 0, false) X(T, PW, K, 0, true) X(T, PW, K, 1, false) \
  X(T, PW, K, 1, true) X(T, PW, K, 2, false) X(T, PW, K, 2, true)
#define GIGL_K7B_FAST(X, T) \
  GIGL_K7B_FAST_PW_K(X, T, 16, 1) GIGL_K7B_FAST_PW_K(X, T, 16, 2) \
  GIGL_K7B_FAST_PW_K(X, T, 8, 1)
#define GIGL_K7B_DECLARE(T, PW, K, MODE, EXTRA)                             \
  extern template int launch_warp<T, PW, K, MODE, EXTRA>(                   \
      const Args<T>&, long long, int, const LaneMap&, int, float, float,    \
      int, cudaStream_t);
#define GIGL_K7B_DEFINE(T, PW, K, MODE, EXTRA)                              \
  template int launch_warp<T, PW, K, MODE, EXTRA>(                          \
      const Args<T>&, long long, int, const LaneMap&, int, float, float,    \
      int, cudaStream_t);

}  // namespace k7b
}  // namespace gigl
