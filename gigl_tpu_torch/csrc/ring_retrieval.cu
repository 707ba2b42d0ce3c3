// K17 ring_retrieval — replaces the per-block work of
// gigl_tpu/losses/sharded_retrieval.py ring_retrieval_loss (:40-143): the
// retrieval softmax over candidates sharded across the mesh, folded one
// candidate block at a time (the streaming logsumexp).
//
// Fold (gigl_ring_fold), per row r of one block's fp32 scores S [Ql, Cl]
// (from a plain matmul), in the reference's order (:76-108):
//   v = S / T - logq[j]                       (logq optional)
//   label = own block && j == label_col[r]
//   dup = qid[r] == pos_qid[j]  |  own_pos[r] == cand_id[j]   (each optional)
//   v = v + max(dup - label, 0) * fmin        (fmin = finfo(f32).min)
//   v = cmask[j] ? v : fmin
// then (:121-127) m_new = max(m[r], max_j v); s[r] = s[r] * (m[r] finite ?
// exp(m[r] - m_new) : 0) + sum_j exp(v finite ? v - m_new : fmin);
// m[r] = m_new; pos[r] += v at the label column. m, s, pos are updated in
// place. Backward (gigl_ring_block_bwd): the same v, the final
// lse[r] = log(max(s, 1e-30)) + m and the row cotangent g[r] (query mask
// folded in) give dS = g * (exp(v - lse) - label) / T, 0 where cmask is 0.
//
// Bound: bytes (S read once, and for the backward dS written once; the
// per-column ids / masks are small). At the flagship step a block is
// [128, 256] fp32 (128 KB): launch-bound. Design: the fold takes one warp
// per row and walks the row twice (max, then the exp-sum), recomputing v
// from S (L1 / L2 resident) rather than keeping it; the backward takes one
// thread per element. No [Ql, Cl] mask is materialised.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

struct Cols {
  const int32_t* label_col;  // [Ql] or null (not the own block)
  const int32_t* qid;        // [Ql] or null
  const int32_t* pos_qid;    // [Cl] or null
  const int32_t* own_pos;    // [Ql] or null (no accidental-hit mask)
  const int32_t* cand_id;    // [Cl] or null
  const uint8_t* cmask;      // [Cl] or null (all valid)
  const float* logq;         // [Cl] or null
  float temperature;
  float fmin;
};

__device__ __forceinline__ float masked_value(const Cols& c, float s, int r,
                                              int j, bool* label) {
  float v = s / c.temperature;
  if (c.logq != nullptr) v = v - __ldg(c.logq + j);
  const bool lab = c.label_col != nullptr && j == __ldg(c.label_col + r);
  bool dup = false;
  if (c.qid != nullptr && c.pos_qid != nullptr)
    dup = __ldg(c.qid + r) == __ldg(c.pos_qid + j);
  if (c.own_pos != nullptr && c.cand_id != nullptr)
    dup = dup || __ldg(c.own_pos + r) == __ldg(c.cand_id + j);
  if (dup && !lab) v = v + c.fmin;
  if (c.cmask != nullptr && !__ldg(c.cmask + j)) v = c.fmin;
  *label = lab;
  return v;
}

__global__ void ring_fold_kernel(const float* __restrict__ scores, int ql,
                                 int cl, Cols c, float* __restrict__ m_run,
                                 float* __restrict__ s_run,
                                 float* __restrict__ pos_score) {
  const int r = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (r >= ql) return;
  const float* row = scores + static_cast<int64_t>(r) * cl;
  float mx = c.fmin, pterm = 0.f;
  bool lab;
  for (int j = lane; j < cl; j += 32) {
    const float v = masked_value(c, __ldg(row + j), r, j, &lab);
    mx = fmaxf(mx, v);
    if (lab) pterm += v;
  }
  for (int d = 16; d > 0; d >>= 1) {
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, d));
    pterm += __shfl_xor_sync(0xffffffffu, pterm, d);
  }
  const float m_old = m_run[r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.f;
  for (int j = lane; j < cl; j += 32) {
    const float v = masked_value(c, __ldg(row + j), r, j, &lab);
    sum += expf(isfinite(v) ? v - m_new : c.fmin);
  }
  for (int d = 16; d > 0; d >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
  if (lane == 0) {
    const float scale = isfinite(m_old) ? expf(m_old - m_new) : 0.f;
    s_run[r] = s_run[r] * scale + sum;
    m_run[r] = m_new;
    pos_score[r] = pos_score[r] + pterm;
  }
}

__global__ void ring_block_bwd_kernel(const float* __restrict__ scores,
                                      int ql, int cl, Cols c,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ g,
                                      float* __restrict__ ds) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= static_cast<int64_t>(ql) * cl) return;
  const int r = static_cast<int>(i / cl);
  const int j = static_cast<int>(i - static_cast<int64_t>(r) * cl);
  bool lab;
  const float v = masked_value(c, __ldg(scores + i), r, j, &lab);
  float d = 0.f;
  if (c.cmask == nullptr || __ldg(c.cmask + j)) {
    const float p = expf(v - __ldg(lse + r));
    d = __ldg(g + r) * (p - (lab ? 1.f : 0.f)) / c.temperature;
  }
  ds[i] = d;
}

Cols make_cols(const void* label_col, const void* qid, const void* pos_qid,
               const void* own_pos, const void* cand_id, const void* cmask,
               const void* logq, float temperature, float fmin) {
  return {static_cast<const int32_t*>(label_col),
          static_cast<const int32_t*>(qid),
          static_cast<const int32_t*>(pos_qid),
          static_cast<const int32_t*>(own_pos),
          static_cast<const int32_t*>(cand_id),
          static_cast<const uint8_t*>(cmask),
          static_cast<const float*>(logq), temperature, fmin};
}

}  // namespace

extern "C" int gigl_ring_fold(const void* scores, int ql, int cl,
                              const void* label_col, const void* qid,
                              const void* pos_qid, const void* own_pos,
                              const void* cand_id, const void* cmask,
                              const void* logq, float temperature, float fmin,
                              void* m_run, void* s_run, void* pos_score,
                              void* stream) {
  if (ql > 0) {
    const int threads = 256;
    const int blocks = (ql * 32 + threads - 1) / threads;
    ring_fold_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), ql, cl,
        make_cols(label_col, qid, pos_qid, own_pos, cand_id, cmask, logq,
                  temperature, fmin),
        static_cast<float*>(m_run), static_cast<float*>(s_run),
        static_cast<float*>(pos_score));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gigl_ring_block_bwd(const void* scores, int ql, int cl,
                                   const void* label_col, const void* qid,
                                   const void* pos_qid, const void* own_pos,
                                   const void* cand_id, const void* cmask,
                                   const void* logq, float temperature,
                                   float fmin, const void* lse, const void* g,
                                   void* ds, void* stream) {
  const long long total = static_cast<long long>(ql) * cl;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    ring_block_bwd_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scores), ql, cl,
        make_cols(label_col, qid, pos_qid, own_pos, cand_id, cmask, logq,
                  temperature, fmin),
        static_cast<const float*>(lse), static_cast<const float*>(g),
        static_cast<float*>(ds));
  }
  return static_cast<int>(cudaGetLastError());
}
