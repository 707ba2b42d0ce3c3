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
// output type; masked slots are skipped. When a gradient will be needed,
// each (row, head)'s final max and the denominator relative to it go to
// `stats` for the backward (K7b, fanout_attention_bwd.cu). Two optional
// operands:
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
// Bound: bytes. Each valid slot gathers a key row (and a value row when it
// is another table) of H * Dh values, ~2-4 flops per value read; at the
// flagship's widths a row is 64 B (Dh 4 fp32) to 1 KB (Dh 64 fp32).
//
// Design: a warp per destination row (fanout_attention_warp.cuh), the lane
// map of gigl_attention.cuh. The row's query piece (and the attention
// vector's) sits in registers in the same lane layout as a slot's pieces.
// A chunk of the row's slots is read one slot a lane (nbr, mask, eidx
// coalesced) and compacted to its valid slots by a ballot, so masked slots
// cost nothing; each slot group then takes its next valid slot, broadcast
// by __shfl_sync. The raw 16-, 8- or 4-byte pieces of the next
// max(1, kDepth / K) slots (edge rows and bias terms too) are loaded
// before the current ones' arithmetic. Per head, a logit is a butterfly of
// xor shuffles inside the head's lanes, which all compute the same logit,
// and each slot group keeps an online softmax in registers (running max,
// denominator and weighted value sum; one rescale a batch, one exp a
// slot). At the row's end the groups are merged by shuffles, rescaled to
// the common max, and group 0 writes the output and the stats. No shared
// memory, no block barrier. Narrow heads fill the warp: at Dh 4 fp32, H 4
// a slot takes 4 lanes and a warp works on 8 slots at once (Dh 4 bf16:
// 8-byte pieces, the same); the W 4 and W 8 buckets put 2 to 8 rows on a
// warp. The mode is a template constant for the hot shapes (16-byte
// pieces at K <= 2, 8-byte pieces at K 1; fanout_attention_fp32.cu and
// _bf16.cu) and read at run time for the others. At the flagship's largest
// bucket (chip_smoke, H100 80GB HBM3, 700 W) bf16 GAT Dh 64 takes 0.32 ms
// and fp32 Dh 64 0.51-0.54: ~3 TB/s of gathered rows, since each valid
// slot's row comes again from a table the 50 MB L2 does not hold, where
// the bound counts each distinct row once.
// Heads whose bytes are not a multiple of 4 (bf16 heads of odd Dh), rows
// wider than 128 virtual lanes (more than 512 fp32 or 1,024 bf16 values at
// 16-byte pieces), and tables not 4-byte aligned take the scalar code
// instead — the first version's, chosen by shape in the launcher: one
// 128-thread block per row, chunks of kChunk slots in three phases through
// shared memory (logits; the chunk's max, exps and rescaled sum per head;
// one thread per output value summing the value rows).
// The first version ran every shape that way, with a warp per slot of a
// 16-byte-piece row: 0.983 ms for bf16 GAT Dh 64 at the flagship's largest
// bucket, 23x its 0.0427 ms bound, the block's fixed cost spread over ~20
// valid slots a row and 28 of 32 lanes idle at Dh 4.
#include "fanout_attention_warp.cuh"

namespace gigl {
namespace k7 {
GIGL_K7_FAST(GIGL_K7_DECLARE, float)
GIGL_K7_FAST(GIGL_K7_DECLARE, __nv_bfloat16)
}  // namespace k7
}  // namespace gigl

namespace {

using namespace gigl;  // to_float, from_float, load_piece, ...
using namespace gigl::attn;
using namespace gigl::k7;

constexpr int kChunk = 64;  // the scalar code's slots per chunk

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// The scalar code (the first version's), for the shapes the warp path has
// no lane map for.

// Shared memory in floats: q, att, acc [hd]; lg [heads, kChunk]; mx, den,
// rs, sd [heads].
__host__ __device__ inline size_t smem_floats(int heads, int dh) {
  const size_t hd = static_cast<size_t>(heads) * dh;
  return 3 * hd + static_cast<size_t>(heads) * kChunk + 4 * heads;
}

template <typename T, bool EXTRA>
__global__ void __launch_bounds__(kThreads) fanout_attention_scalar(
    const T* __restrict__ xd, const T* __restrict__ ks,
    const T* __restrict__ vs, const int32_t* __restrict__ nbr,
    const uint8_t* __restrict__ mask, const float* __restrict__ att,
    const float* __restrict__ att2, const T* __restrict__ he,
    const int32_t* __restrict__ eidx, const float* __restrict__ bias,
    T* __restrict__ out, float* __restrict__ stats, int w, int heads, int dh,
    int mode, float slope, float sqrt_dh) {
  if constexpr (!EXTRA) {
    he = nullptr;
    bias = nullptr;
  }
  extern __shared__ float smem[];
  const int hd = heads * dh;
  float* q = smem;                   // [hd] the destination row, fp32
  float* at = q + hd;                // [hd] att_src (v1) or att (v2)
  float* acc = at + hd;              // [hd] running weighted sums
  float* lg = acc + hd;              // [heads, kChunk] logits, then weights
  float* mx = lg + heads * kChunk;   // [heads] running max
  float* den = mx + heads;           // [heads] running denominator
  float* rs = den + heads;           // [heads] this chunk's rescale
  float* sd = rs + heads;            // [heads] GAT v1: xd[i,h]·att_dst[h]
  const float neg_inf = -__int_as_float(0x7f800000);
  const int64_t i = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  constexpr int kWarps = kThreads / 32;
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
    // 1. logits of the chunk, a thread per (head, slot)
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
        const float bj = bias != nullptr ? bias[(c0 + jj) * heads + h] : 0.f;
        l = finish_logit(a, mode, sd[h] + bj, slope, sqrt_dh);
      }
      lg[h * kChunk + jj] = l;
    }
    __syncthreads();
    // 2. per head: the chunk's max, one exp per slot, the rescaled sum
    for (int h = warp; h < heads; h += kWarps) {
      float* lh = lg + h * kChunk;
      float mm = neg_inf;
      for (int jj = lane; jj < cw; jj += 32) mm = fmaxf(mm, lh[jj]);
      mm = warp_max(mm);
      const float old = mx[h];
      const float nm = fmaxf(old, mm);
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
    // 3. weighted sum of the value rows, a thread per output value
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

// ---------------------------------------------------------------------------

// The warp path's form for a (piece width, pieces per lane): the mode a
// compile-time constant where GIGL_K7_FAST has it (GAT and GATv2 over one
// table for keys and values, as the port's callers pass them), else read
// at run time.
template <typename T, int PW, int K>
void launch_pw(const Args<T>& a, long long n, int w, const LaneMap& m,
               int mode, float slope, float sqrt_dh, cudaStream_t stream) {
  const bool extra = a.he != nullptr || a.bias != nullptr;
  constexpr bool fast = (PW == 16 && K <= 2) || (PW == 8 && K == 1);
  if constexpr (fast) {
    if (mode == kGat && a.ks == a.vs) {
      if (extra)
        launch_warp<T, PW, K, kGat, true>(a, n, w, m, mode, slope, sqrt_dh,
                                          stream);
      else
        launch_warp<T, PW, K, kGat, false>(a, n, w, m, mode, slope, sqrt_dh,
                                           stream);
      return;
    }
    if (mode == kGatV2 && a.ks == a.vs && a.bias == nullptr) {
      if (extra)
        launch_warp<T, PW, K, kGatV2, true>(a, n, w, m, mode, slope, sqrt_dh,
                                            stream);
      else
        launch_warp<T, PW, K, kGatV2, false>(a, n, w, m, mode, slope,
                                             sqrt_dh, stream);
      return;
    }
    if (mode == kTransformer) {
      if (extra)
        launch_warp<T, PW, K, kTransformer, true>(a, n, w, m, mode, slope,
                                                  sqrt_dh, stream);
      else
        launch_warp<T, PW, K, kTransformer, false>(a, n, w, m, mode, slope,
                                                   sqrt_dh, stream);
      return;
    }
  }
  launch_warp<T, PW, K, -1, true>(a, n, w, m, mode, slope, sqrt_dh, stream);
}

template <typename T, int PW>
void launch_k(int kk, const Args<T>& a, long long n, int w, const LaneMap& m,
              int mode, float slope, float sqrt_dh, cudaStream_t stream) {
  if (kk == 1)
    launch_pw<T, PW, 1>(a, n, w, m, mode, slope, sqrt_dh, stream);
  else if (kk == 2)
    launch_pw<T, PW, 2>(a, n, w, m, mode, slope, sqrt_dh, stream);
  else
    launch_pw<T, PW, 4>(a, n, w, m, mode, slope, sqrt_dh, stream);
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
  // the warp path wherever a lane map exists (the shape decides)
  LaneMap m;
  const int pw = piece_bytes(dh * static_cast<int>(sizeof(T)),
                             {xd, ks, vs, he, out});
  const int kk = make_lane_map(heads, dh, sizeof(T), pw, w, &m);
  if (kk != 0) {
    const Args<T> a{x, k, v, nb, mk, a1, a2, ev, ei, bs, o, st};
    if (pw == 16)
      launch_k<T, 16>(kk, a, n, w, m, mode, slope, sqrt_dh, stream);
    else if (pw == 8)
      launch_k<T, 8>(kk, a, n, w, m, mode, slope, sqrt_dh, stream);
    else
      launch_k<T, 4>(kk, a, n, w, m, mode, slope, sqrt_dh, stream);
    return 0;
  }
  const size_t smem = sizeof(float) * smem_floats(heads, dh);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const bool extra = he != nullptr || bias != nullptr;
  auto kernel = extra ? fanout_attention_scalar<T, true>
                      : fanout_attention_scalar<T, false>;
  kernel<<<static_cast<unsigned>(n), kThreads, smem, stream>>>(
      x, k, v, nb, mk, a1, a2, ev, ei, bs, o, st, w, heads, dh, mode, slope,
      sqrt_dh);
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
