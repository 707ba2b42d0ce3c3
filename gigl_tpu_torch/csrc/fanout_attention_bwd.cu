// K7b fanout_attention_bwd — the backward of K7 fanout_attention, which the
// JAX package gets from autodiff of gigl_tpu/models/convs.py GATConv.block
// (:292-310, v1 and v2) and TransformerConv.block (:361-377) with
// masked_softmax (gigl_tpu/ops/fanout.py:83-95). Per destination row i and
// head h, over the W slots j of the row (rows [H * Dh], head-major, as K7):
//   logit_j  recomputed from xd[i], ks[nbr[i, j]] and the attention vectors
//            (GAT: pre_j = ks_j·att_src + xd_i·att_dst, logit = leaky(pre);
//            GATv2: att · leaky(ks_j + xd_i); Transformer: xd_i·ks_j /
//            sqrt(Dh));
//   alpha_j  = exp(logit_j - max) / den, from the (max, den) that K7 saved
//            per (row, head); masked slots and all-masked rows get 0;
//   d_alpha_j = g_i · vs_j;   t = sum_j alpha_j d_alpha_j = g_i · out_i
//            (the forward's output, as FlashAttention's backward does);
//   d_logit_j = alpha_j (d_alpha_j - t);  GAT: d_pre_j = d_logit_j *
//            leaky'(pre_j) (1 for pre >= 0, else the slope, as jax.nn's).
// It writes
//   d_xd[i]  GAT: att_dst * sum_j d_pre_j; GATv2: sum_j d_logit_j att *
//            leaky'(ks_j + xd_i) (per value); Transformer: sum_j d_logit_j
//            ks_j / sqrt(Dh);
//   per entry p = i * W + j (ELL mode): alpha[p, h] and coef[p, h] fp32 (GAT
//            d_pre, GATv2 d_logit, Transformer d_logit / sqrt(Dh)), 0 at
//            masked slots, at the flat entry position that the transpose
//            tables index; K6b then forms the source rows' gradients
//            (weighted mode; GATv2 its own mode, the key gradient depending
//            on each (key, query) pair);
//   per entry p (identity mode: the dense sampled block, nbr[p] = p, every
//            source row read once): d_vs[p] = alpha_j g_i and d_ks[p] = GAT
//            att_src * d_pre_j, GATv2 d_logit_j att * leaky'(ks_j + xd_i),
//            Transformer xd_i * d_logit_j / sqrt(Dh); with one table for
//            keys and values (GAT, GATv2), d_ks holds the sum;
//   d_att_src = sum d_pre_j ks_j and d_att_dst = sum (sum_j d_pre_j) xd_i
//            (GAT; GATv2: d_att = sum d_logit_j leaky(ks_j + xd_i)), as
//            per-block partials summed by a second small kernel in a fixed
//            order — no float atomics, the same bits on every run.
// With K7's optional operands, the slot's key and value rows are ks_j +
// he[eidx[i, j]] and vs_j + he[eidx[i, j]] (the edge row; its gradient is
// K11's, ell_edge_grad.cu, from the alpha and coef written here) and the
// GAT pre-activation carries bias[j, h] (SimpleHGN's relation term; its
// cotangent is d_pre, written per entry to e_coef in the identity layout
// too, and summed per relation by the caller).
// fp32 arithmetic, one rounding of d_xd / d_ks / d_vs to the tables' type.
//
// Bound: bytes. Each valid slot reads its key row (and value row) once
// more than the forward, and the per-entry arrays (ELL) or key / value
// gradient rows (identity) are written; at the flagship's ELL GAT step
// 0.153 ms for Dh 64 fp32 and 0.0359 ms for Dh 4 at the largest bucket.
//
// Design: persistent warps, a warp per destination row
// (fanout_attention_bwd_warp.cuh), the lane map of gigl_attention.cuh (as
// K7). The row's xd, g and att pieces sit in registers in a slot's lane
// layout, and each lane reads its head's g·out, max and denominator. The
// row's slots are compacted to the valid ones a chunk at a time (one slot
// a lane, a ballot) and every slot group takes its next valid slot; the
// key / value / edge rows of the next max(1, kDepth / K) slots are loaded
// before the current ones' arithmetic. The two per-head sums of a slot (its
// logit's and g·v) are xor butterflies inside the head's lanes, so every
// lane of a head computes the slot's alpha and coefficient itself, and the
// head's first lane writes the entry's alpha and coef. d_xd (GATv2,
// Transformer) and GAT's per-head sum of d_pre stay in registers over the
// row's slots and are reduced across the slot groups at the row's end;
// d_att_src (GATv2: d_att) stays in registers over every row the warp
// takes and d_att_dst is summed row by row in the warp's shared memory;
// the block sums its warps in order into `part`, which
// sum_partials_kernel sums in block order. No float atomics and no block
// barrier on the slot path; the same bits on every run (the grid is fixed
// by the card and the shape). At Dh 4 fp32 a slot's four heads are four
// lanes, each holding a whole head, so a slot needs no shuffle at all. The
// mode is a template constant for the hot shapes, as in K7. At the
// flagship's largest bucket (chip_smoke, H100 80GB HBM3, 700 W): 0.83 ms
// at GAT Dh 64 fp32, 0.14 at Dh 4; K7 gathers the same Dh 64 rows in
// ~0.5 ms, the floor here (each valid slot's row again from a 102 MB
// table).
// Heads whose bytes are not a multiple of 4 (bf16 heads of odd Dh), rows
// wider than 128 virtual lanes, and tables not 4-byte aligned take the
// scalar code instead — the first version's, chosen by shape in the
// launcher: persistent 128-thread blocks walking one row at a time, a warp
// per slot, per-head sums through shared memory.
// The first version ran every shape that way (with 16-byte register loads
// for rows of 16-byte pieces): 2.640 ms GAT Dh 64 fp32 and 1.446 ms at
// Dh 4 at the flagship's largest bucket, 17x and 40x their bounds: three
// or more block barriers a row, each slot a dependent chain through shared
// memory, 28 of 32 lanes idle at Dh 4.
#include "fanout_attention_bwd_warp.cuh"

namespace gigl {
namespace k7b {
GIGL_K7B_FAST(GIGL_K7B_DECLARE, float)
GIGL_K7B_FAST(GIGL_K7B_DECLARE, __nv_bfloat16)
}  // namespace k7b
}  // namespace gigl

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...
using namespace gigl::attn;
using namespace gigl::k7b;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// The scalar code (the first version's), for the shapes the warp path has
// no lane map for.

// Shared memory in floats: q, g, at, ad, adst [hd]; red1, red2, wrow, watt
// [kWarps, hd]; t, mx, dn, sd, ssum [heads]; cf, al, sacc [kWarps, heads].
__host__ __device__ inline size_t smem_floats(int heads, int dh) {
  const size_t hd = static_cast<size_t>(heads) * dh;
  return 5 * hd + 4 * kWarps * hd + 5 * static_cast<size_t>(heads) +
         3 * kWarps * static_cast<size_t>(heads);
}

template <typename T, bool EXTRA>
__global__ void __launch_bounds__(kThreads) fanout_attention_bwd_scalar(
    const T* __restrict__ g, const T* __restrict__ xd,
    const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ out, const float* __restrict__ stats,
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const float* __restrict__ att, const float* __restrict__ att2,
    const T* __restrict__ he, const int32_t* __restrict__ eidx,
    const float* __restrict__ bias, T* __restrict__ d_xd,
    float* __restrict__ e_alpha,
    float* __restrict__ e_coef, T* __restrict__ d_ks, T* __restrict__ d_vs,
    float* __restrict__ part, int64_t n, int w, int heads, int dh, int mode,
    float slope, float sqrt_dh) {
  if constexpr (!EXTRA) {
    he = nullptr;
    bias = nullptr;
  }
  extern __shared__ float smem[];
  const int hd = heads * dh;
  float* q = smem;                      // [hd] xd[i], fp32
  float* gr = q + hd;                   // [hd] g[i], fp32
  float* at = gr + hd;                  // [hd] att_src (GAT)
  float* ad = at + hd;                  // [hd] att_dst (GAT)
  float* adst = ad + hd;                // [hd] this block's d_att_dst
  float* red1 = adst + hd;              // [kWarps, hd] logit products
  float* red2 = red1 + kWarps * hd;     // [kWarps, hd] g·v products
  float* wrow = red2 + kWarps * hd;     // [kWarps, hd] Transformer d_xd
  float* watt = wrow + kWarps * hd;     // [kWarps, hd] GAT d_att_src
  float* tt = watt + kWarps * hd;       // [heads] g·out
  float* mx = tt + heads;               // [heads] the forward's max
  float* dn = mx + heads;               // [heads] its denominator
  float* sd = dn + heads;               // [heads] GAT xd·att_dst
  float* ssum = sd + heads;             // [heads] sum_j d_pre (GAT)
  float* cf = ssum + heads;             // [kWarps, heads] slot coefficient
  float* al = cf + kWarps * heads;      // [kWarps, heads] slot alpha
  float* sacc = al + kWarps * heads;    // [kWarps, heads] per-warp sums
  const bool gat = mode == kGat;
  const bool v2 = mode == kGatV2;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int e = t; e < hd; e += kThreads) {
    at[e] = mode != kTransformer ? att[e] : 0.f;
    ad[e] = gat ? att2[e] : 0.f;
    adst[e] = 0.f;
  }
  for (int e = t; e < kWarps * hd; e += kThreads) watt[e] = 0.f;
  __syncthreads();
  for (int64_t i = blockIdx.x; i < n; i += gridDim.x) {
    for (int e = t; e < hd; e += kThreads) {
      q[e] = to_float(xd[i * hd + e]);
      gr[e] = to_float(g[i * hd + e]);
    }
    for (int e = t; e < kWarps * hd; e += kThreads) wrow[e] = 0.f;
    for (int e = t; e < kWarps * heads; e += kThreads) sacc[e] = 0.f;
    for (int h = t; h < heads; h += kThreads) {
      mx[h] = stats[(i * heads + h) * 2];
      dn[h] = fmaxf(stats[(i * heads + h) * 2 + 1], 1e-16f);
    }
    __syncthreads();
    for (int h = warp; h < heads; h += kWarps) {
      float s1 = 0.f, s2 = 0.f;
      for (int c = lane; c < dh; c += 32) {
        s1 += gr[h * dh + c] * to_float(out[i * hd + h * dh + c]);
        if (gat) s2 += q[h * dh + c] * ad[h * dh + c];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        tt[h] = s1;
        sd[h] = s2;
      }
    }
    __syncthreads();
    float* r1 = red1 + warp * hd;
    float* r2 = red2 + warp * hd;
    float* wr = wrow + warp * hd;
    float* wa = watt + warp * hd;
    float* cw = cf + warp * heads;
    float* aw = al + warp * heads;
    float* sw = sacc + warp * heads;
    for (int jj = warp; jj < w; jj += kWarps) {
      const int64_t p = i * w + jj;
      if (!mask[p]) {  // the same for the whole warp
        for (int h = lane; h < heads; h += 32) {
          if (e_alpha != nullptr) e_alpha[p * heads + h] = 0.f;
          if (e_coef != nullptr) e_coef[p * heads + h] = 0.f;
        }
        if (d_ks != nullptr) {
          for (int e = lane; e < hd; e += 32) {
            store(d_ks + p * hd + e, 0.f);
            if (d_vs != nullptr) store(d_vs + p * hd + e, 0.f);
          }
        }
        continue;
      }
      const int64_t s = nbr[p];
      const T* kr = ks + s * hd;
      const T* vr = vs + s * hd;
      const T* er = he != nullptr ? he + static_cast<int64_t>(eidx[p]) * hd
                                  : nullptr;
      for (int e = lane; e < hd; e += 32) {
        const float ev1 = er != nullptr ? to_float(er[e]) : 0.f;
        const float kv1 = to_float(kr[e]) + ev1;
        const float vv1 = to_float(vr[e]) + ev1;
        r1[e] = logit_term(mode, kv1, q[e], at[e], slope);
        r2[e] = gr[e] * vv1;
      }
      __syncwarp();
      for (int h = lane; h < heads; h += 32) {
        float a1 = 0.f, a2 = 0.f;
        for (int c = 0; c < dh; ++c) {
          a1 += r1[h * dh + c];
          a2 += r2[h * dh + c];
        }
        float pre = 0.f, logit;
        if (gat) {
          pre = a1 + sd[h] + (bias != nullptr ? bias[jj * heads + h] : 0.f);
          logit = leaky(pre, slope);
        } else {
          logit = v2 ? a1 : a1 / sqrt_dh;
        }
        const float alpha = expf(logit - mx[h]) / dn[h];
        const float dlog = alpha * (a2 - tt[h]);
        const float coef = gat ? dlog * leaky_grad(pre, slope)
                               : (v2 ? dlog : dlog / sqrt_dh);
        cw[h] = coef;
        aw[h] = alpha;
        sw[h] += coef;
        if (e_alpha != nullptr) e_alpha[p * heads + h] = alpha;
        if (e_coef != nullptr) e_coef[p * heads + h] = coef;
      }
      __syncwarp();
      for (int e = lane; e < hd; e += 32) {
        const int h = e / dh;
        const float c = cw[h];
        const float kv1 =
            to_float(kr[e]) + (er != nullptr ? to_float(er[e]) : 0.f);
        float dk1;
        if (gat) {
          wa[e] += c * kv1;
          dk1 = at[e] * c;
        } else if (v2) {
          const float z = kv1 + q[e];
          dk1 = c * at[e] * leaky_grad(z, slope);
          wr[e] += dk1;
          wa[e] += c * leaky(z, slope);
        } else {
          wr[e] += c * kv1;
          dk1 = q[e] * c;
        }
        if (d_ks != nullptr) {
          const float dv1 = aw[h] * gr[e];
          if (d_vs != nullptr) {
            store(d_ks + p * hd + e, dk1);
            store(d_vs + p * hd + e, dv1);
          } else {
            store(d_ks + p * hd + e, dk1 + dv1);
          }
        }
      }
      __syncwarp();
    }
    __syncthreads();
    for (int h = t; h < heads; h += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += sacc[k * heads + h];
      ssum[h] = s;
    }
    __syncthreads();
    for (int e = t; e < hd; e += kThreads) {
      float dx;
      if (gat) {
        const float s = ssum[e / dh];
        dx = ad[e] * s;
        adst[e] += q[e] * s;
      } else {
        dx = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) dx += wrow[k * hd + e];
      }
      store(d_xd + i * hd + e, dx);
    }
    __syncthreads();
  }
  if (part != nullptr) {
    float* pb = part + static_cast<int64_t>(blockIdx.x) * 2 * hd;
    for (int e = t; e < hd; e += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) s += watt[k * hd + e];
      pb[e] = s;
      pb[hd + e] = adst[e];
    }
  }
}

// d_att[e] = sum over blocks b of part[b, e], in block order.
__global__ void sum_partials_kernel(const float* __restrict__ part,
                                    float* __restrict__ d_att, int blocks,
                                    int width) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  float s = 0.f;
  for (int b = 0; b < blocks; ++b) s += part[static_cast<int64_t>(b) * width + e];
  d_att[e] = s;
}

// ---------------------------------------------------------------------------

// The warp path's form for a (piece width, pieces per lane): the mode a
// compile-time constant where GIGL_K7B_FAST has it (GAT and GATv2 over one
// table for keys and values, as the port's callers pass them), else read
// at run time.
template <typename T, int PW, int K>
int launch_pw(const Args<T>& a, long long n, int w, const LaneMap& m,
              int mode, float slope, float sqrt_dh, int grid,
              cudaStream_t stream) {
  const bool extra = a.he != nullptr || a.bias != nullptr;
  constexpr bool fast = (PW == 16 && K <= 2) || (PW == 8 && K == 1);
  if constexpr (fast) {
    if (mode == kGat && a.ks == a.vs)
      return extra ? launch_warp<T, PW, K, kGat, true>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream)
                   : launch_warp<T, PW, K, kGat, false>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream);
    if (mode == kGatV2 && a.ks == a.vs && a.bias == nullptr)
      return extra ? launch_warp<T, PW, K, kGatV2, true>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream)
                   : launch_warp<T, PW, K, kGatV2, false>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream);
    if (mode == kTransformer)
      return extra ? launch_warp<T, PW, K, kTransformer, true>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream)
                   : launch_warp<T, PW, K, kTransformer, false>(
                         a, n, w, m, mode, slope, sqrt_dh, grid, stream);
  }
  return launch_warp<T, PW, K, -1, true>(a, n, w, m, mode, slope, sqrt_dh,
                                         grid, stream);
}

template <typename T, int PW>
int launch_k(int kk, const Args<T>& a, long long n, int w, const LaneMap& m,
             int mode, float slope, float sqrt_dh, int grid,
             cudaStream_t stream) {
  if (kk == 1)
    return launch_pw<T, PW, 1>(a, n, w, m, mode, slope, sqrt_dh, grid,
                               stream);
  if (kk == 2)
    return launch_pw<T, PW, 2>(a, n, w, m, mode, slope, sqrt_dh, grid,
                               stream);
  return launch_pw<T, PW, 4>(a, n, w, m, mode, slope, sqrt_dh, grid, stream);
}

template <typename T>
int launch(const void* g, const void* xd, const void* ks, const void* vs,
           const void* out, const void* stats, const void* nbr,
           const void* mask, const void* att, const void* att2,
           const void* he, const void* eidx, const void* bias, void* d_xd,
           void* e_alpha, void* e_coef, void* d_ks, void* d_vs, void* part,
           void* d_att, long long n, int w, int heads, int dh, int mode,
           float slope, float sqrt_dh, int grid, cudaStream_t stream) {
  if (n == 0) return 0;
  if (mode < kGat || mode > kTransformer || w < 1 || heads < 1 || dh < 1 ||
      grid < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kTransformer &&
      (att == nullptr || (mode == kGat && att2 == nullptr) ||
       part == nullptr || d_att == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // ELL layout: alpha and coef per entry; identity layout: d_ks, and coef
  // per entry only when asked (the bias's cotangent)
  if ((d_ks == nullptr && (e_alpha == nullptr || e_coef == nullptr)) ||
      (d_ks != nullptr && e_alpha != nullptr) ||
      (he != nullptr && eidx == nullptr) || (bias != nullptr && mode != kGat))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * smem_floats(heads, dh);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const Args<T> a{static_cast<const T*>(g), static_cast<const T*>(xd),
                  static_cast<const T*>(ks), static_cast<const T*>(vs),
                  static_cast<const T*>(out), static_cast<const float*>(stats),
                  static_cast<const int32_t*>(nbr),
                  static_cast<const uint8_t*>(mask),
                  static_cast<const float*>(att),
                  static_cast<const float*>(att2), static_cast<const T*>(he),
                  static_cast<const int32_t*>(eidx),
                  static_cast<const float*>(bias), static_cast<T*>(d_xd),
                  static_cast<float*>(e_alpha), static_cast<float*>(e_coef),
                  static_cast<T*>(d_ks), static_cast<T*>(d_vs),
                  mode != kTransformer ? static_cast<float*>(part) : nullptr};
  // the warp path wherever a lane map exists (the shape decides)
  LaneMap m;
  const int pw = piece_bytes(dh * static_cast<int>(sizeof(T)),
                             {g, xd, ks, vs, out, he, d_xd, d_ks, d_vs});
  const int kk = make_lane_map(heads, dh, sizeof(T), pw, w, &m);
  int blocks;
  if (kk != 0) {
    if (pw == 16)
      blocks = launch_k<T, 16>(kk, a, n, w, m, mode, slope, sqrt_dh, grid,
                               stream);
    else if (pw == 8)
      blocks = launch_k<T, 8>(kk, a, n, w, m, mode, slope, sqrt_dh, grid,
                              stream);
    else
      blocks = launch_k<T, 4>(kk, a, n, w, m, mode, slope, sqrt_dh, grid,
                              stream);
  } else {
    blocks = static_cast<int>(n < grid ? n : grid);
    const bool extra = he != nullptr || bias != nullptr;
    auto kernel = extra ? fanout_attention_bwd_scalar<T, true>
                        : fanout_attention_bwd_scalar<T, false>;
    kernel<<<blocks, kThreads, smem, stream>>>(
        a.g, a.xd, a.ks, a.vs, a.out, a.stats, a.nbr, a.mask, a.att, a.att2,
        a.he, a.eidx, a.bias, a.d_xd, a.e_alpha, a.e_coef, a.d_ks, a.d_vs,
        a.part, n, w, heads, dh, mode, slope, sqrt_dh);
  }
  if (mode != kTransformer) {
    const int width = 2 * heads * dh;
    sum_partials_kernel<<<(width + 255) / 256, 256, 0, stream>>>(
        static_cast<const float*>(part), static_cast<float*>(d_att), blocks,
        width);
  }
  return 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (g, xd, ks, vs, out, d_xd, d_ks, d_vs); stats
// fp32 [n, H, 2] from K7; att / att2 fp32 [H * Dh] (mode 0 GAT: att_src /
// att_dst; mode 1 GATv2: att / NULL; mode 2 Transformer: NULL / NULL).
// he / eidx / bias: K7's optional operands (NULL when absent). ELL mode:
// e_alpha / e_coef fp32 [n * w, H], d_ks = d_vs = NULL. Identity mode:
// e_alpha = NULL, e_coef NULL or fp32 [n * w, H] (d_pre, with a bias), d_ks
// [n * w, H * Dh] and d_vs (NULL when keys and values are one table; d_ks
// then holds the sum). GAT and GATv2: part fp32 [grid, 2 * H * Dh] scratch
// and d_att fp32 [2 * H * Dh] (GAT: d_att_src then d_att_dst; GATv2: d_att
// then zeros). grid: the most persistent blocks to launch (a few per SM;
// the warp path launches at most as many as are resident at once).
extern "C" int gigl_fanout_attention_bwd(
    const void* g, const void* xd, const void* ks, const void* vs,
    const void* out, const void* stats, const void* nbr, const void* mask,
    const void* att, const void* att2, const void* he, const void* eidx,
    const void* bias, void* d_xd, void* e_alpha, void* e_coef, void* d_ks,
    void* d_vs, void* part, void* d_att, long long n, int w, int heads,
    int dh, int dtype, int mode, float slope, float sqrt_dh, int grid,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(g, xd, ks, vs, out, stats, nbr, mask, att, att2, he,
                       eidx, bias, d_xd, e_alpha, e_coef, d_ks, d_vs, part,
                       d_att, n, w, heads, dh, mode, slope, sqrt_dh, grid, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(g, xd, ks, vs, out, stats, nbr, mask, att,
                               att2, he, eidx, bias, d_xd, e_alpha, e_coef,
                               d_ks, d_vs, part, d_att, n, w, heads, dh, mode,
                               slope, sqrt_dh, grid, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
