// K17 ring_retrieval — replaces the per-block work of
// gigl_tpu/losses/sharded_retrieval.py ring_retrieval_loss (:40-143): the
// retrieval softmax over candidates sharded across the mesh, folded one
// candidate block at a time (the streaming logsumexp).
//
// Fold (gigl_ring_fold), per row r of a shard's fp32 scores S [P, Ql, Cl]
// (P candidate blocks in ring order, the shard's own first, each from a
// plain matmul), block by block in the reference's order (:76-108):
//   v = S[t] / T - logq[t, j]                      (logq optional)
//   label = t == 0 && j == label_col[r]            (label_col optional)
//   dup = qid[r] == pos_qid[t, j]  |  own_pos[r] == cand_id[t, j]
//   v = v + max(dup - label, 0) * fmin             (fmin = finfo(f32).min)
//   v = cmask[t, j] ? v : fmin
// then (:121-127) m_new = max(m[r], max_j v); s[r] = s[r] * (m[r] finite ?
// exp(m[r] - m_new) : 0) + sum_j exp(v finite ? v - m_new : fmin);
// m[r] = m_new; pos[r] += v at the label column. m, s, pos are read once
// and written once, after the P blocks. Backward (gigl_ring_block_bwd):
// the same v, the final lse[r] = log(max(s, 1e-30)) + m and the row
// cotangent g[r] (query mask folded in) give, for every block,
// dS = g * (exp(v - lse) - label) / T, 0 where cmask is 0.
//
// Bound: bytes (S read once, and for the backward dS written once; the
// per-column ids / masks are small). At the flagship ring step a shard's
// scores are [4, 128, 256] fp32 (512 KB): launch-bound. The first version
// launched once per block (16 folds and 16 backward launches a 4-shard
// step) and walked each row twice, recomputing v. This one:
// - folds a shard's P blocks in one launch: a warp per row walks them in
//   ring order with m, s and pos in registers;
// - per block, each lane computes its Cl / 32 values v once into
//   registers (NV of them; a row wider than 32 * NV, past 1,024 columns,
//   recomputes them for the exp-sum), loading up to 8 columns' scores and
//   terms at once: every column term is loaded whether its mask is on or
//   not (an absent one reads the scores), so no load waits on a branch.
//   The row's terms (label column, query id, own positive) are read once
//   per row, not per element;
// - keeps the first version's lane order and butterflies, so every fold
//   rounds as P sequential first-version folds, bit for bit;
// - gives the backward one launch over [P, Ql, Cl], a thread an element.
// kRingWarps rows a block (PERF.md §6).
//
// Own-block bias mode (gigl_ring_fold_bias, gigl_ring_block_bwd_bias) —
// replaces the dense [Ql, Cl] matrix of sharded_retrieval.py
// ring_own_block_edge_bias (:170-197) added to the own block's raw scores
// (:76-80). The query rows are B anchors x p positives (Ql = B p); the
// matrix is zero but for e_pos[r] at (r, r) and e_hard[c] at (r, Ql + c)
// for r / p == c / h (h hard negatives an anchor, c < B h). Both entries
// read the two vectors instead and add a cell's term to its score in
// registers, on block 0 only: S + e, then the division by T, as the
// reference rounds it. The fold takes the mode as a template flag (the
// plain fold's code is unchanged). The backward also writes the terms'
// cotangents: d e_pos[r] = dS[0, r, r], by the thread of that cell, and
// d e_hard[c] = sum over the p rows of anchor c / h of dS[0, r, Ql + c],
// by B h extra threads of the same launch that recompute those p cells
// (the same arithmetic as the cells' threads) and add them in row order:
// no atomics, the same bits every run.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRingWarps = 4;

struct Cols {
  const int32_t* label_col;  // [Ql] or null (block 0 is not the own block)
  const int32_t* qid;        // [Ql] or null
  const int32_t* own_pos;    // [Ql] or null (no accidental-hit mask)
  // [P, Cl] each; an absent one points at the scores (read, never used)
  const int32_t* pos_qid;
  const int32_t* cand_id;
  const uint8_t* cmask;
  const float* logq;
  bool has_logq, has_cmask;
  bool dup_q;    // the duplicate-query mask: qid and pos_qid
  bool dup_hit;  // the accidental-hit mask: own_pos and cand_id
  float temperature;
  float fmin;
  // own-block bias (null without): e_pos [Ql], e_hard [n_hard] fp32; p
  // positives and h hard negatives an anchor; hard0 = Ql, the first hard
  // column
  const float* e_pos;
  const float* e_hard;
  int bias_p, bias_h, n_hard, hard0;
};

// Row r's terms: its label column in block 0 (-1: none), query id and own
// positive id.
struct RowTerms {
  int label;
  int qid;
  int own_pos;
};

__device__ __forceinline__ RowTerms row_terms(const Cols& c, int r) {
  RowTerms t;
  t.label = c.label_col != nullptr ? __ldg(c.label_col + r) : -1;
  t.qid = c.dup_q ? __ldg(c.qid + r) : 0;
  t.own_pos = c.dup_hit ? __ldg(c.own_pos + r) : 0;
  return t;
}

// Column col (= t * Cl + j) of block t as loaded: the score and the
// column's terms. Every one is loaded, present or not, so that a lane's
// loads of several columns issue together.
struct ColTerms {
  float s, logq;
  int pos_qid, cand_id;
  uint8_t cmask;
};

__device__ __forceinline__ ColTerms load_terms(const Cols& c,
                                               const float* __restrict__ row,
                                               int j, int64_t col) {
  return {__ldg(row + j), __ldg(c.logq + col), __ldg(c.pos_qid + col),
          __ldg(c.cand_id + col), __ldg(c.cmask + col)};
}

// v of a loaded column; lab: the label column of this row in this block.
__device__ __forceinline__ float masked_value(const Cols& c,
                                              const RowTerms& rt,
                                              const ColTerms& ct, bool lab) {
  float v = ct.s / c.temperature;
  if (c.has_logq) v = v - ct.logq;
  bool dup = false;
  if (c.dup_q) dup = rt.qid == ct.pos_qid;
  if (c.dup_hit) dup = dup || rt.own_pos == ct.cand_id;
  if (dup && !lab) v = v + c.fmin;
  if (c.has_cmask && !ct.cmask) v = c.fmin;
  return v;
}

// The raw score s of own-block cell (r, j) plus its bias term, if any.
__device__ __forceinline__ float with_own_bias(const Cols& c, int r, int j,
                                               float s) {
  if (c.e_pos != nullptr && j == r) return s + __ldg(c.e_pos + r);
  if (c.e_hard != nullptr) {
    const int k = j - c.hard0;
    if (k >= 0 && k < c.n_hard && k / c.bias_h == r / c.bias_p)
      return s + __ldg(c.e_hard + k);
  }
  return s;
}

// Values a lane loads at once: their scores and column terms in flight
// together, then added in column order.
template <int NV>
__host__ __device__ constexpr int load_group() {
  return NV < 8 ? NV : 8;
}

template <int NV, bool BIAS>
__global__ void ring_fold_kernel(const float* __restrict__ scores, int p,
                                 int ql, int cl, Cols c,
                                 float* __restrict__ m_run,
                                 float* __restrict__ s_run,
                                 float* __restrict__ pos_score) {
  constexpr int L = load_group<NV>();
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= ql) return;
  const RowTerms rt = row_terms(c, r);
  const bool one_pass = cl <= 32 * NV;  // v kept in registers between sums
  float m = m_run[r], s = s_run[r], pos = pos_score[r];
  for (int t = 0; t < p; ++t) {
    const float* row = scores + (static_cast<int64_t>(t) * ql + r) * cl;
    const int64_t col0 = static_cast<int64_t>(t) * cl;
    const int label = t == 0 ? rt.label : -1;
    // the values of columns base + lane + 32 q, q in [q0, q0 + L), in
    // column order (a column past Cl loads column Cl - 1 and is not used)
    auto values = [&](int base, int q0, float* v) {
      ColTerms ct[L];
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int j = base + lane + 32 * (q0 + u);
        const int jj = j < cl ? j : cl - 1;
        ct[u] = load_terms(c, row, jj, col0 + jj);
        if (BIAS && t == 0) ct[u].s = with_own_bias(c, r, jj, ct[u].s);
      }
#pragma unroll
      for (int u = 0; u < L; ++u) {
        const int j = base + lane + 32 * (q0 + u);
        v[u] = masked_value(c, rt, ct[u], j == label);
      }
    };
    float vv[NV];
    float mx = c.fmin, pterm = 0.f;
    for (int base = 0; base < cl; base += 32 * NV) {
#pragma unroll
      for (int q0 = 0; q0 < NV; q0 += L) {
        values(base, q0, vv + q0);
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const int j = base + lane + 32 * (q0 + u);
          if (j < cl) {
            mx = fmaxf(mx, vv[q0 + u]);
            if (j == label) pterm += vv[q0 + u];
          }
        }
      }
    }
    for (int d = 16; d > 0; d >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
      pterm += __shfl_xor_sync(0xffffffffu, pterm, d);
    }
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int base = 0; base < cl; base += 32 * NV) {
#pragma unroll
      for (int q0 = 0; q0 < NV; q0 += L) {
        if (!one_pass) values(base, q0, vv + q0);
#pragma unroll
        for (int u = 0; u < L; ++u) {
          const int j = base + lane + 32 * (q0 + u);
          if (j < cl) {
            const float v = vv[q0 + u];
            sum += expf(isfinite(v) ? v - m_new : c.fmin);
          }
        }
      }
    }
    for (int d = 16; d > 0; d >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, d);
    const float scale = isfinite(m) ? expf(m - m_new) : 0.f;
    s = s * scale + sum;
    m = m_new;
    pos = pos + pterm;
  }
  if (lane == 0) {
    s_run[r] = s;
    m_run[r] = m;
    pos_score[r] = pos;
  }
}

// dS of cell (t, r, j): g (exp(v - lse) - label) / T, 0 where the
// column is masked; v with the own block's bias term in bias mode.
__device__ __forceinline__ float bwd_cell(const float* __restrict__ scores,
                                          int ql, int cl, const Cols& c,
                                          const RowTerms& rt,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ g, int t,
                                          int r, int j, bool bias) {
  const int64_t col = static_cast<int64_t>(t) * cl + j;
  const bool lab = t == 0 && j == rt.label;
  ColTerms ct = load_terms(
      c, scores + (static_cast<int64_t>(t) * ql + r) * cl, j, col);
  if (bias && t == 0) ct.s = with_own_bias(c, r, j, ct.s);
  const float v = masked_value(c, rt, ct, lab);
  float d = 0.f;
  if (!c.has_cmask || ct.cmask) {
    const float pr = expf(v - __ldg(lse + r));
    d = __ldg(g + r) * (pr - (lab ? 1.f : 0.f)) / c.temperature;
  }
  return d;
}

// A thread an element of dS [P, Ql, Cl]; in bias mode (de_pos / de_hard
// non-null as the terms are) the diagonal's threads also write d e_pos,
// and n_hard threads past the elements each sum one hard column's p cells.
__global__ void ring_block_bwd_kernel(const float* __restrict__ scores,
                                      int p, int ql, int cl, Cols c,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ g,
                                      float* __restrict__ ds,
                                      float* __restrict__ de_pos,
                                      float* __restrict__ de_hard) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t per_block = static_cast<int64_t>(ql) * cl;
  const int64_t total = per_block * p;
  const bool bias = c.e_pos != nullptr || c.e_hard != nullptr;
  if (i >= total) {
    const int64_t k = i - total;
    if (de_hard == nullptr || k >= c.n_hard) return;
    const int kk = static_cast<int>(k);
    const int r0 = (kk / c.bias_h) * c.bias_p;
    float acc = 0.f;
    for (int r = r0; r < r0 + c.bias_p; ++r)
      acc += bwd_cell(scores, ql, cl, c, row_terms(c, r), lse, g, 0, r,
                      c.hard0 + kk, true);
    de_hard[kk] = acc;
    return;
  }
  const int t = static_cast<int>(i / per_block);
  const int64_t rest = i - t * per_block;
  const int r = static_cast<int>(rest / cl);
  const int j = static_cast<int>(rest - static_cast<int64_t>(r) * cl);
  const float d =
      bwd_cell(scores, ql, cl, c, row_terms(c, r), lse, g, t, r, j, bias);
  ds[i] = d;
  if (de_pos != nullptr && t == 0 && j == r) de_pos[r] = d;
}

Cols make_cols(const void* scores, const void* label_col, const void* qid,
               const void* pos_qid, const void* own_pos, const void* cand_id,
               const void* cmask, const void* logq, float temperature,
               float fmin) {
  Cols c;
  c.label_col = static_cast<const int32_t*>(label_col);
  c.qid = static_cast<const int32_t*>(qid);
  c.own_pos = static_cast<const int32_t*>(own_pos);
  c.dup_q = qid != nullptr && pos_qid != nullptr;
  c.dup_hit = own_pos != nullptr && cand_id != nullptr;
  c.has_logq = logq != nullptr;
  c.has_cmask = cmask != nullptr;
  const void* any = scores;  // P * Ql * Cl >= P * Cl values of 4 bytes
  c.pos_qid = static_cast<const int32_t*>(pos_qid ? pos_qid : any);
  c.cand_id = static_cast<const int32_t*>(cand_id ? cand_id : any);
  c.cmask = static_cast<const uint8_t*>(cmask ? cmask : any);
  c.logq = static_cast<const float*>(logq ? logq : any);
  c.temperature = temperature;
  c.fmin = fmin;
  c.e_pos = nullptr;
  c.e_hard = nullptr;
  c.bias_p = c.bias_h = 1;
  c.n_hard = c.hard0 = 0;
  return c;
}

// The own-block bias terms added to c (see the header).
void add_bias(Cols& c, int ql, const void* e_pos, const void* e_hard,
              int bias_p, int bias_h, int n_hard) {
  c.e_pos = static_cast<const float*>(e_pos);
  c.e_hard = n_hard > 0 ? static_cast<const float*>(e_hard) : nullptr;
  c.bias_p = bias_p > 0 ? bias_p : 1;
  c.bias_h = bias_h > 0 ? bias_h : 1;
  c.n_hard = c.e_hard != nullptr ? n_hard : 0;
  c.hard0 = ql;
}

template <int NV>
void launch_fold(const float* scores, int p, int ql, int cl, const Cols& c,
                 float* m_run, float* s_run, float* pos_score,
                 cudaStream_t stream) {
  const int threads = kRingWarps * 32;
  const int blocks = (ql + kRingWarps - 1) / kRingWarps;
  if (c.e_pos != nullptr || c.e_hard != nullptr)
    ring_fold_kernel<NV, true><<<blocks, threads, 0, stream>>>(
        scores, p, ql, cl, c, m_run, s_run, pos_score);
  else
    ring_fold_kernel<NV, false><<<blocks, threads, 0, stream>>>(
        scores, p, ql, cl, c, m_run, s_run, pos_score);
}

void fold(const void* scores, int p, int ql, int cl, const Cols& c,
          void* m_run, void* s_run, void* pos_score, void* stream) {
  const float* sv = static_cast<const float*>(scores);
  float* mv = static_cast<float*>(m_run);
  float* ssv = static_cast<float*>(s_run);
  float* pv = static_cast<float*>(pos_score);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the fewest registers a lane that hold its values (32 past 1,024
  // columns, which recompute them)
  if (cl <= 32)
    launch_fold<1>(sv, p, ql, cl, c, mv, ssv, pv, st);
  else if (cl <= 64)
    launch_fold<2>(sv, p, ql, cl, c, mv, ssv, pv, st);
  else if (cl <= 128)
    launch_fold<4>(sv, p, ql, cl, c, mv, ssv, pv, st);
  else if (cl <= 256)
    launch_fold<8>(sv, p, ql, cl, c, mv, ssv, pv, st);
  else if (cl <= 512)
    launch_fold<16>(sv, p, ql, cl, c, mv, ssv, pv, st);
  else
    launch_fold<32>(sv, p, ql, cl, c, mv, ssv, pv, st);
}

void block_bwd(const void* scores, int p, int ql, int cl, const Cols& c,
               const void* lse, const void* g, void* ds, void* de_pos,
               void* de_hard, void* stream) {
  const long long total = static_cast<long long>(p) * ql * cl;
  const long long extra = de_hard != nullptr ? c.n_hard : 0;
  if (total + extra > 0) {
    const int threads = 256;
    const long long blocks = (total + extra + threads - 1) / threads;
    ring_block_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), p, ql, cl, c,
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(ds), static_cast<float*>(de_pos),
        static_cast<float*>(de_hard));
  }
}

}  // namespace

// scores [P, Ql, Cl] fp32; label_col [Ql] int32 (block 0 is the shard's
// own: its label columns apply) or NULL; qid, own_pos [Ql] int32 or NULL;
// pos_qid, cand_id [P, Cl] int32, cmask [P, Cl] bool, logq [P, Cl] fp32,
// each NULL when absent; m_run, s_run, pos_score [Ql] fp32, updated.
extern "C" int gigl_ring_fold(const void* scores, int p, int ql, int cl,
                              const void* label_col, const void* qid,
                              const void* pos_qid, const void* own_pos,
                              const void* cand_id, const void* cmask,
                              const void* logq, float temperature, float fmin,
                              void* m_run, void* s_run, void* pos_score,
                              void* stream) {
  if (ql > 0 && p > 0)
    fold(scores, p, ql, cl,
         make_cols(scores, label_col, qid, pos_qid, own_pos, cand_id, cmask,
                   logq, temperature, fmin),
         m_run, s_run, pos_score, stream);
  return static_cast<int>(cudaGetLastError());
}

// gigl_ring_fold's arguments with the own-block bias before the running
// state: e_pos [Ql] fp32 or NULL, e_hard [n_hard] fp32 or NULL, p
// positives and h hard negatives an anchor (Ql = B p, n_hard = B h).
extern "C" int gigl_ring_fold_bias(
    const void* scores, int p, int ql, int cl, const void* label_col,
    const void* qid, const void* pos_qid, const void* own_pos,
    const void* cand_id, const void* cmask, const void* logq,
    float temperature, float fmin, const void* e_pos, const void* e_hard,
    int bias_p, int bias_h, int n_hard, void* m_run, void* s_run,
    void* pos_score, void* stream) {
  if (ql > 0 && p > 0) {
    Cols c = make_cols(scores, label_col, qid, pos_qid, own_pos, cand_id,
                       cmask, logq, temperature, fmin);
    add_bias(c, ql, e_pos, e_hard, bias_p, bias_h, n_hard);
    fold(scores, p, ql, cl, c, m_run, s_run, pos_score, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fold's inputs, the final lse and the row cotangents g [Ql] fp32 ->
// ds [P, Ql, Cl] fp32.
extern "C" int gigl_ring_block_bwd(const void* scores, int p, int ql, int cl,
                                   const void* label_col, const void* qid,
                                   const void* pos_qid, const void* own_pos,
                                   const void* cand_id, const void* cmask,
                                   const void* logq, float temperature,
                                   float fmin, const void* lse, const void* g,
                                   void* ds, void* stream) {
  block_bwd(scores, p, ql, cl,
            make_cols(scores, label_col, qid, pos_qid, own_pos, cand_id,
                      cmask, logq, temperature, fmin),
            lse, g, ds, nullptr, nullptr, stream);
  return static_cast<int>(cudaGetLastError());
}

// gigl_ring_block_bwd's arguments with the bias of gigl_ring_fold_bias
// before lse, and after ds the terms' cotangents de_pos [Ql], de_hard
// [n_hard] fp32 (each NULL when its term is).
extern "C" int gigl_ring_block_bwd_bias(
    const void* scores, int p, int ql, int cl, const void* label_col,
    const void* qid, const void* pos_qid, const void* own_pos,
    const void* cand_id, const void* cmask, const void* logq,
    float temperature, float fmin, const void* e_pos, const void* e_hard,
    int bias_p, int bias_h, int n_hard, const void* lse, const void* g,
    void* ds, void* de_pos, void* de_hard, void* stream) {
  Cols c = make_cols(scores, label_col, qid, pos_qid, own_pos, cand_id,
                     cmask, logq, temperature, fmin);
  add_bias(c, ql, e_pos, e_hard, bias_p, bias_h, n_hard);
  block_bwd(scores, p, ql, cl, c, lse, g, ds,
            e_pos != nullptr ? de_pos : nullptr,
            c.e_hard != nullptr ? de_hard : nullptr, stream);
  return static_cast<int>(cudaGetLastError());
}
