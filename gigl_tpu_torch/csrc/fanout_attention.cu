// K7 fanout_attention — replaces what gigl_tpu/models/convs.py computes
// between the projections in GATConv.block (:292-310, GAT v1 and GATv2)
// and TransformerConv.block (:361-377), with masked_softmax of
// gigl_tpu/ops/fanout.py (:83-95): per destination row i and head h, over
// the W slots j of the row,
//   logit_ij = leaky_relu(ks[j,h]·att_src[h] + xd[i,h]·att_dst[h])  GAT v1
//            = att[h] · leaky_relu(ks[j,h] + xd[i,h])                GATv2
//            = xd[i,h] · ks[j,h] / sqrt(Dh)                          Transformer
//   alpha_ij = masked softmax over j (finite logits only where the mask is
//              set; all-masked rows get weights 0; denominator >= 1e-16)
//   out[i,h] = sum_j alpha_ij vs[j,h]
// where ks[j] / vs[j] is row nbr[i, j] of the projected source tables (GAT:
// ks = vs = lin_src(x); Transformer: lin_k(x), lin_v(x)) and xd[i] the
// projected destination row (GAT: lin_dst(x_dst); Transformer: lin_q).
// Rows are [H * Dh], head-major. Arithmetic in fp32, one rounding to the
// output type; masked slots point at row 0 and are skipped by the mask.
// When a gradient will be needed, each (row, head)'s final max and
// denominator go to `stats` for the backward (K7b, fanout_attention_bwd.cu).
// Two optional operands:
//   he [E, H*Dh] an edge row per slot, read through eidx [n, W] int32 (the
//      ELL bucket's edge slots): added to the slot's key row and to its
//      value row, as EdgeAttrGAT adds lin_edge(e) to lin_src(x_j)
//      (convs.py:296-298, keys and values one table) and the Transformer
//      adds it to both k and v (:367-370) — the forward of ell_gather_edges
//      (gigl_tpu/ops/ell.py:289-316) fused in, no [n, W, H*Dh] block;
//   bias [W, H] fp32 (GAT v1 only) a logit term per slot column and head,
//      added before the leaky_relu: SimpleHGN's relation term
//      (edge_emb[r] @ w_rel)·att_rel broadcast to the relation's slots of
//      the concatenated block (gigl_tpu/models/hetero_convs.py:221-228).
//
// Bound: bytes at the flagship widths (two reads of ~2*Dh bytes per valid
// slot and head against ~6*Dh flops). Design: one 128-thread block per
// destination row (not one warp: the K5 lesson, 132 SMs to fill). W is
// walked in chunks of kChunk slots, each in three phases:
//   1. logits into shared memory;
//   2. one warp per head takes the chunk's max, rescales the running sum
//      once, and writes exp(logit - max) back — one exp per slot, as in
//      K5's second version, and a single chunk for every width up to
//      kChunk (the flagship's buckets);
//   3. the weighted sum of the value rows.
// Rows made of 16-byte pieces that stay within a head (H*Dh and Dh
// multiples of 8 bf16 / 4 fp32, H*Dh <= 64 pieces, 16-byte aligned tables)
// take the vector path: one warp per slot, each lane one or two 16-byte
// pieces of the slot's row, so every gathered row is read as coalesced
// 16-byte loads in phases 1 and 3; the per-piece dot products are summed
// per head through shared memory, and each warp's partial value sums are
// added across the block's warps. Other rows take the scalar path: one
// thread per (head, slot) reading the slot's Dh values in phase 1, one
// thread per output value looping over the chunk's slots in phase 3.
#include "gigl_pieces.cuh"

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...

constexpr int kGat = 0;
constexpr int kGatV2 = 1;
constexpr int kTransformer = 2;
constexpr int kChunk = 64;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPiecesPerLane = 2;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float leaky(float z, float slope) {
  return z > 0.f ? z : z * slope;
}

// The logit of one head from its summed dot product (phase 1's epilogue).
__device__ __forceinline__ float finish_logit(float a, int mode, float sd_h,
                                              float slope, float sqrt_dh) {
  if (mode == kGat) return leaky(a + sd_h, slope);
  if (mode == kGatV2) return a;
  return a / sqrt_dh;
}

// Shared memory in floats: q, att, acc [hd]; lg [heads, kChunk]; mx, den,
// rs, sd [heads]; and for the vector path red [kWarps, pieces] and wacc
// [kWarps, hd].
__host__ __device__ inline size_t smem_floats(int heads, int dh, bool vec,
                                              int pieces) {
  const size_t hd = static_cast<size_t>(heads) * dh;
  size_t n = 3 * hd + static_cast<size_t>(heads) * kChunk + 4 * heads;
  if (vec) n += kWarps * (static_cast<size_t>(pieces) + hd);
  return n;
}

template <typename T, bool VEC, bool EXTRA>
__global__ void __launch_bounds__(kThreads) fanout_attention_kernel(
    const T* __restrict__ xd, const T* __restrict__ ks,
    const T* __restrict__ vs, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ mask, const float* __restrict__ att,
    const float* __restrict__ att2, const T* __restrict__ he,
    const int32_t* __restrict__ eidx, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stats, int w, int heads, int dh,
    int mode, float slope, float sqrt_dh) {
  // without the optional operands their code folds away (EXTRA false)
  if constexpr (!EXTRA) {
    he = nullptr;
    bias = nullptr;
  }
  constexpr int P = 16 / sizeof(T);
  extern __shared__ float smem[];
  const int hd = heads * dh;
  const int pieces = hd / P;
  float* q = smem;                   // [hd] the destination row, fp32
  float* at = q + hd;                // [hd] att_src (v1) or att (v2)
  float* acc = at + hd;              // [hd] running weighted sums
  float* lg = acc + hd;              // [heads, kChunk] logits, then weights
  float* mx = lg + heads * kChunk;   // [heads] running max
  float* den = mx + heads;           // [heads] running denominator
  float* rs = den + heads;           // [heads] this chunk's rescale
  float* sd = rs + heads;            // [heads] GAT v1: xd[i,h]·att_dst[h]
  float* red = sd + heads;           // VEC: [kWarps, pieces] dot partials
  float* wacc = red + kWarps * pieces;  // VEC: [kWarps, hd] value partials
  const float neg_inf = -__int_as_float(0x7f800000);
  const int64_t i = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  for (int e = t; e < hd; e += kThreads) {
    q[e] = to_float(xd[i * hd + e]);
    at[e] = mode == kTransformer ? 0.f : att[e];
    acc[e] = 0.f;
  }
  for (int h = t; h < heads; h += kThreads) {
    mx[h] = neg_inf;
    den[h] = 0.f;
    sd[h] = 0.f;
  }
  __syncthreads();
  if (mode == kGat) {
    for (int h = warp; h < heads; h += kWarps) {
      float s = 0.f;
      for (int e = lane; e < dh; e += 32) s += q[h * dh + e] * att2[h * dh + e];
      s = warp_sum(s);
      if (lane == 0) sd[h] = s;
    }
    __syncthreads();
  }
  const int32_t* nrow = nbr + i * w;
  const uint8_t* mrow = mask + i * w;
  const int32_t* erow = he != nullptr ? eidx + i * w : nullptr;
  for (int c0 = 0; c0 < w; c0 += kChunk) {
    const int cw = min(kChunk, w - c0);
    // 1. logits of the chunk
    if constexpr (VEC) {
      const int pph = dh / P;  // pieces per head
      float* rw = red + warp * pieces;
      for (int jj = warp; jj < cw; jj += kWarps) {
        const bool valid = mrow[c0 + jj];  // the same for the whole warp
        if (valid) {
          const T* kr = ks + static_cast<int64_t>(nrow[c0 + jj]) * hd;
          const T* er = erow != nullptr
                            ? he + static_cast<int64_t>(erow[c0 + jj]) * hd
                            : nullptr;
          for (int pc = lane; pc < pieces; pc += 32) {
            float kv[P];
            load_piece<T, P>(kr + pc * P, kv);
            if (er != nullptr) {
              float ev[P];
              load_piece<T, P>(er + pc * P, ev);
#pragma unroll
              for (int u = 0; u < P; ++u) kv[u] += ev[u];
            }
            const int e0 = pc * P;
            float a = 0.f;
#pragma unroll
            for (int u = 0; u < P; ++u) {
              if (mode == kGat)
                a += kv[u] * at[e0 + u];
              else if (mode == kGatV2)
                a += at[e0 + u] * leaky(kv[u] + q[e0 + u], slope);
              else
                a += q[e0 + u] * kv[u];
            }
            rw[pc] = a;
          }
        }
        __syncwarp();
        for (int h = lane; h < heads; h += 32) {
          float l = neg_inf;
          if (valid) {
            float a = 0.f;
            for (int pc = h * pph; pc < (h + 1) * pph; ++pc) a += rw[pc];
            const float bj =
                bias != nullptr ? bias[(c0 + jj) * heads + h] : 0.f;
            l = finish_logit(a, mode, sd[h] + bj, slope, sqrt_dh);
          }
          lg[h * kChunk + jj] = l;
        }
        __syncwarp();
      }
    } else {
      for (int it = t; it < heads * cw; it += kThreads) {
        const int h = it / cw, jj = it - h * cw;
        float l = neg_inf;
        if (mrow[c0 + jj]) {
          const T* kr = ks + static_cast<int64_t>(nrow[c0 + jj]) * hd + h * dh;
          const T* er = erow != nullptr
                            ? he + static_cast<int64_t>(erow[c0 + jj]) * hd +
                                  h * dh
                            : nullptr;
          const float* qh = q + h * dh;
          const float* ah = at + h * dh;
          float a = 0.f;
          for (int e = 0; e < dh; ++e) {
            const float kv =
                to_float(kr[e]) + (er != nullptr ? to_float(er[e]) : 0.f);
            if (mode == kGat)
              a += kv * ah[e];
            else if (mode == kGatV2)
              a += ah[e] * leaky(kv + qh[e], slope);
            else
              a += qh[e] * kv;
          }
          const float bj =
              bias != nullptr ? bias[(c0 + jj) * heads + h] : 0.f;
          l = finish_logit(a, mode, sd[h] + bj, slope, sqrt_dh);
        }
        lg[h * kChunk + jj] = l;
      }
    }
    __syncthreads();
    // 2. per head: the chunk's max, one exp per slot, the rescaled sum
    for (int h = warp; h < heads; h += kWarps) {
      float* lh = lg + h * kChunk;
      float m = neg_inf;
      for (int jj = lane; jj < cw; jj += 32) m = fmaxf(m, lh[jj]);
      m = warp_max(m);
      const float old = mx[h];
      const float nm = fmaxf(old, m);
      float s = 0.f;
      for (int jj = lane; jj < cw; jj += 32) {
        const float l = lh[jj];
        const float e = l == neg_inf ? 0.f : expf(l - nm);
        lh[jj] = e;
        s += e;
      }
      s = warp_sum(s);
      if (lane == 0) {
        const float r = old == nm ? 1.f : expf(old - nm);
        rs[h] = r;
        den[h] = den[h] * r + s;
        mx[h] = nm;
      }
    }
    __syncthreads();
    // 3. weighted sum of the value rows
    if constexpr (VEC) {
      float part[kMaxPiecesPerLane][P];
#pragma unroll
      for (int k = 0; k < kMaxPiecesPerLane; ++k)
#pragma unroll
        for (int u = 0; u < P; ++u) part[k][u] = 0.f;
      for (int jj = warp; jj < cw; jj += kWarps) {
        if (!mrow[c0 + jj]) continue;  // the same for the whole warp
        const T* vr = vs + static_cast<int64_t>(nrow[c0 + jj]) * hd;
        const T* er = erow != nullptr
                          ? he + static_cast<int64_t>(erow[c0 + jj]) * hd
                          : nullptr;
#pragma unroll
        for (int k = 0; k < kMaxPiecesPerLane; ++k) {
          const int pc = lane + 32 * k;
          if (pc >= pieces) continue;
          const float p = lg[(pc * P / dh) * kChunk + jj];
          float vv[P];
          load_piece<T, P>(vr + pc * P, vv);
          if (er != nullptr) {
            float ev[P];
            load_piece<T, P>(er + pc * P, ev);
#pragma unroll
            for (int u = 0; u < P; ++u) vv[u] += ev[u];
          }
#pragma unroll
          for (int u = 0; u < P; ++u) part[k][u] += p * vv[u];
        }
      }
      float* wa = wacc + warp * hd;
#pragma unroll
      for (int k = 0; k < kMaxPiecesPerLane; ++k) {
        const int pc = lane + 32 * k;
        if (pc >= pieces) continue;
#pragma unroll
        for (int u = 0; u < P; ++u) wa[pc * P + u] = part[k][u];
      }
      __syncthreads();
      for (int e = t; e < hd; e += kThreads) {
        float a = acc[e] * rs[e / dh];
#pragma unroll
        for (int k = 0; k < kWarps; ++k) a += wacc[k * hd + e];
        acc[e] = a;
      }
    } else {
      for (int e = t; e < hd; e += kThreads) {
        const int h = e / dh;
        const float* ph = lg + h * kChunk;
        float a = acc[e] * rs[h];
        for (int jj = 0; jj < cw; ++jj) {
          const float p = ph[jj];
          if (p == 0.f) continue;
          float v = to_float(vs[static_cast<int64_t>(nrow[c0 + jj]) * hd + e]);
          if (erow != nullptr)
            v += to_float(he[static_cast<int64_t>(erow[c0 + jj]) * hd + e]);
          a += p * v;
        }
        acc[e] = a;
      }
    }
    __syncthreads();
  }
  for (int e = t; e < hd; e += kThreads)
    store(out + i * hd + e, acc[e] / fmaxf(den[e / dh], 1e-16f));
  if (stats != nullptr) {
    for (int h = t; h < heads; h += kThreads) {
      stats[(i * heads + h) * 2] = mx[h];
      stats[(i * heads + h) * 2 + 1] = den[h];
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* xd, const void* ks, const void* vs, const void* nbr,
           const void* mask, const void* att, const void* att2,
           const void* he, const void* eidx, const void* bias, void* out,
           void* stats, long long n, int w, int heads, int dh, int mode,
           float slope, float sqrt_dh, cudaStream_t stream) {
  if (n == 0) return 0;
  if (mode < kGat || mode > kTransformer || w < 1 || heads < 1 || dh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((mode != kTransformer && att == nullptr) ||
      (mode == kGat && att2 == nullptr) || (he != nullptr && eidx == nullptr) ||
      (bias != nullptr && mode != kGat))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int P = 16 / sizeof(T);
  const int pieces = heads * dh / P;
  const bool vec = dh % P == 0 && pieces <= 32 * kMaxPiecesPerLane &&
                   aligned16(ks) && aligned16(vs) &&
                   (he == nullptr || aligned16(he)) &&
                   smem_floats(heads, dh, true, pieces) * sizeof(float) <=
                       48 * 1024;
  const size_t smem = sizeof(float) * smem_floats(heads, dh, vec, pieces);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(n);
  const T* x = static_cast<const T*>(xd);
  const T* k = static_cast<const T*>(ks);
  const T* v = static_cast<const T*>(vs);
  const int32_t* nb = static_cast<const int32_t*>(nbr);
  const uint8_t* mk = static_cast<const uint8_t*>(mask);
  const float* a1 = static_cast<const float*>(att);
  const float* a2 = static_cast<const float*>(att2);
  const T* ev = static_cast<const T*>(he);
  const int32_t* ei = static_cast<const int32_t*>(eidx);
  const float* bs = static_cast<const float*>(bias);
  T* o = static_cast<T*>(out);
  float* st = static_cast<float*>(stats);
  const bool extra = he != nullptr || bias != nullptr;
  auto kernel = vec ? (extra ? fanout_attention_kernel<T, true, true>
                             : fanout_attention_kernel<T, true, false>)
                    : (extra ? fanout_attention_kernel<T, false, true>
                             : fanout_attention_kernel<T, false, false>);
  kernel<<<grid, kThreads, smem, stream>>>(x, k, v, nb, mk, a1, a2, ev, ei,
                                           bs, o, st, w, heads, dh, mode,
                                           slope, sqrt_dh);
  return 0;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (xd, ks, vs, out); att / att2 fp32 [H * Dh]
// (mode 0: att_src / att_dst; mode 1: att / NULL; mode 2: NULL / NULL).
// stats: NULL, or fp32 [n, H, 2] that receives each (row, head)'s final
// softmax max and denominator for the backward (K7b). he [E, H * Dh] of
// xd's type with eidx [n, W] int32, or both NULL: the slot's edge row,
// added to its key and value rows. bias [W, H] fp32 or NULL (mode 0 only):
// a logit term per slot column.
extern "C" int gigl_fanout_attention(const void* xd, const void* ks,
                                     const void* vs, const void* nbr,
                                     const void* mask, const void* att,
                                     const void* att2, const void* he,
                                     const void* eidx, const void* bias,
                                     void* out, void* stats, long long n,
                                     int w, int heads, int dh, int dtype,
                                     int mode, float slope, float sqrt_dh,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 0) {
    rc = launch<float>(xd, ks, vs, nbr, mask, att, att2, he, eidx, bias, out,
                       stats, n, w, heads, dh, mode, slope, sqrt_dh, s);
  } else if (dtype == 1) {
    rc = launch<__nv_bfloat16>(xd, ks, vs, nbr, mask, att, att2, he, eidx,
                               bias, out, stats, n, w, heads, dh, mode, slope,
                               sqrt_dh, s);
  } else {
    rc = static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
