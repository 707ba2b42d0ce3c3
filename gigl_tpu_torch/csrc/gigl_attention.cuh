// The warp-per-row lane map shared by K7 fanout_attention and K7b
// fanout_attention_bwd (see each source's note for what it computes).
//
// A row of H heads of Dh values (H * Dh, head-major) is cut into pieces of
// PW = 16, 8 or 4 bytes: the widest that divides a head's Dh * sizeof(T)
// bytes and to which every table is aligned. A head is pph = Dh *
// sizeof(T) / PW pieces, held by a segment of sp virtual lanes (pph
// rounded up to a power of two; the extra ones hold nothing), so a
// per-head sum is a butterfly of xor shuffles inside the segment and every
// lane of the segment ends with the same bits. A slot row then needs H * sp
// virtual lanes:
//   - up to 32: a slot takes ls lanes (H * sp rounded up to a power of
//     two), and the warp's 32 / ls slot groups work on as many slots at
//     once (8 at Dh 4 fp32, H 4); when a row is narrower than that (the W 4
//     and W 8 buckets) the groups are shared out among several rows;
//   - 33 to 128: one slot at a time, lane l holding the K = 2 or 4
//     consecutive virtual lanes K l .. K l + K - 1 (a head's pieces stay on
//     as few lanes as possible, so its sum takes log2(sp / K) shuffles).
// Rows wider than 128 virtual lanes, and heads whose bytes are not a
// multiple of 4, have no lane map: the launchers take the block-per-row
// scalar code for them.
#pragma once

#include <initializer_list>

#include "gigl_pieces.cuh"

namespace gigl {
namespace attn {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGat = 0;
constexpr int kGatV2 = 1;
constexpr int kTransformer = 2;
constexpr int kThreads = 128;
// Loads ahead: the pieces of the next max(1, kDepth / K) slots per lane
// are issued before the arithmetic of the current ones (K pieces a slot).
constexpr int kDepth = 2;

// The warp path's shape, fixed per launch (see the note above).
struct LaneMap {
  int heads, dh, hd;  // H, Dh, H * Dh values
  int pph;            // pieces per head
  int sp;             // lanes per head segment (pph to a power of two)
  int ls;             // lanes per slot
  int gr;             // slot groups per row
  int lr;             // lanes per row (gr * ls; 32 / lr rows per warp)
};

inline int next_pow2(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// Fills `m` and returns K (1, 2 or 4 pieces per lane) for rows of `heads`
// heads of `dh` values of `elem` bytes in pieces of `pw` bytes, over slot
// rows of width `w`; 0 when the warp path cannot hold the row.
inline int make_lane_map(int heads, int dh, int elem, int pw, int w,
                         LaneMap* m) {
  const int hb = dh * elem;
  if (pw == 0 || hb % pw != 0) return 0;
  m->heads = heads;
  m->dh = dh;
  m->hd = heads * dh;
  m->pph = hb / pw;
  m->sp = next_pow2(m->pph);
  const long long vl = static_cast<long long>(heads) * m->sp;
  const int k = vl <= 32 ? 1 : (vl <= 64 ? 2 : (vl <= 128 ? 4 : 0));
  if (k == 0) return 0;
  m->ls = k == 1 ? next_pow2(static_cast<int>(vl)) : 32;
  const int groups = 32 / m->ls;
  m->gr = groups < next_pow2(w) ? groups : next_pow2(w);
  m->lr = m->gr * m->ls;
  return k;
}

// The widest piece (16, 8 or 4 bytes) that divides a head's `hb` bytes and
// to which every given address is aligned; 0 if none.
inline int piece_bytes(int hb, std::initializer_list<const void*> ptrs) {
  for (int pw : {16, 8, 4}) {
    if (hb % pw != 0) continue;
    bool ok = true;
    for (const void* p : ptrs)
      ok = ok && (p == nullptr || reinterpret_cast<uintptr_t>(p) % pw == 0);
    if (ok) return pw;
  }
  return 0;
}

// What one lane holds at each of its K virtual lanes: the head, the first
// value's offset in the row, whether it holds a piece at all (live), and
// whether it holds its head's first piece (lead: the lane that writes the
// head's per-entry scalars).
template <int V, int K>
struct LanePieces {
  int h[K];
  int e0[K];
  bool live[K];
  bool lead[K];

  __device__ __forceinline__ LanePieces(const LaneMap& m, int lane) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int vl = K == 1 ? (lane % m.lr) % m.ls : lane * K + k;
      const int hh = vl / m.sp, pp = vl % m.sp;
      live[k] = hh < m.heads && pp < m.pph;
      lead[k] = live[k] && pp == 0;
      h[k] = live[k] ? hh : 0;
      e0[k] = live[k] ? (hh * m.pph + pp) * V : 0;
    }
  }
};

// Per-head sums of the lanes' partials, left in every lane of the head's
// segment (the same bits in each). Every lane of the warp calls it.
template <int K>
__device__ __forceinline__ void head_sum(float (&a)[K], int sp) {
  if (K == 1 || sp >= K) {
    // the lane's K pieces are one head's: add them, then the segment's
    // sp / K lanes
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < K; ++k) s += a[k];
    for (int o = (sp / K) >> 1; o > 0; o >>= 1)
      s += __shfl_xor_sync(kFull, s, o);
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = s;
  } else {
    // heads narrower than the lane's K pieces: each head's sp pieces sit
    // on this lane
    float s[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      s[k] = 0.f;
#pragma unroll
      for (int k2 = 0; k2 < K; ++k2)
        if (k2 / sp == k / sp) s[k] += a[k2];
    }
#pragma unroll
    for (int k = 0; k < K; ++k) a[k] = s[k];
  }
}

// Position of the n-th (0-based) set bit of m, which has more than n.
__device__ __forceinline__ int nth_set_bit(unsigned m, int n) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const unsigned lo = m & ((1u << w) - 1u);
    const int c = __popc(lo);
    if (n >= c) {
      n -= c;
      m >>= w;
      pos += w;
    } else {
      m = lo;
    }
  }
  return pos;
}

// One piece of PW bytes at p (PW-aligned) as raw 32-bit words: issued
// ahead of the arithmetic that reads it, converted later by unpack.
template <int PW>
__device__ __forceinline__ void load_raw(const void* __restrict__ p,
                                         uint32_t* r) {
  if constexpr (PW == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else if constexpr (PW == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    r[0] = v.x;
    r[1] = v.y;
  } else {
    static_assert(PW == 4, "pieces of 16, 8 or 4 bytes");
    r[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
}

// The V = PW / sizeof(T) values of a raw piece, in fp32.
template <typename T, int PW>
__device__ __forceinline__ void unpack(const uint32_t* r, float* v) {
#pragma unroll
  for (int w = 0; w < PW / 4; ++w) {
    if constexpr (sizeof(T) == 4) {
      v[w] = __uint_as_float(r[w]);
    } else {
      const float2 f = unpack_bf16(r[w]);
      v[2 * w] = f.x;
      v[2 * w + 1] = f.y;
    }
  }
}

template <typename T, int PW>
__device__ __forceinline__ void load_vals(const T* __restrict__ p, float* v) {
  uint32_t r[PW / 4];
  load_raw<PW>(p, r);
  unpack<T, PW>(r, v);
}

// V values rounded once to T, stored as one piece of PW bytes at p.
template <typename T, int PW>
__device__ __forceinline__ void store_vals(T* __restrict__ p, const float* v) {
  uint32_t r[PW / 4];
#pragma unroll
  for (int w = 0; w < PW / 4; ++w) {
    if constexpr (sizeof(T) == 4)
      r[w] = __float_as_uint(v[w]);
    else
      r[w] = pack_bf16(v[2 * w], v[2 * w + 1]);
  }
  if constexpr (PW == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(r[0], r[1], r[2], r[3]);
  } else if constexpr (PW == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(r[0], r[1]);
  } else {
    *reinterpret_cast<unsigned int*>(p) = r[0];
  }
}

// The row's slots c0 .. c0 + lr - 1 compacted to their valid ones: every
// lane of a row's lanes reads one slot (nbr, mask and edge slot, coalesced)
// and gets back the lg-th valid slot's (neighbor, edge slot, column); nv
// valid slots in all. Every lane of the warp calls it.
struct Chunk {
  int nbr, eslot, col, nv;
};

__device__ __forceinline__ Chunk compact_chunk(
    const int32_t* __restrict__ nbr, const uint8_t* __restrict__ mask,
    const int32_t* __restrict__ eidx, int64_t i, bool row_ok, int w, int c0,
    int lg, int rbase, unsigned rmask) {
  const int j = c0 + lg;
  const int64_t p = i * w + j;
  const bool in = row_ok && j < w;
  // the three reads issued together (masked slots hold valid indices)
  const bool v = in && mask[p] != 0;
  const int n_raw = in ? nbr[p] : 0;
  const int e_raw = eidx != nullptr && in ? eidx[p] : 0;
  const int my_nbr = v ? n_raw : 0;
  const int my_e = v ? e_raw : 0;
  const unsigned rb = (__ballot_sync(kFull, v) >> rbase) & rmask;
  Chunk c;
  c.nv = __popc(rb);
  const int src = lg < c.nv ? nth_set_bit(rb, lg) : 0;
  c.nbr = __shfl_sync(kFull, my_nbr, rbase + src);
  c.eslot = eidx != nullptr ? __shfl_sync(kFull, my_e, rbase + src) : 0;
  c.col = c0 + src;
  return c;
}

// The raw pieces of D compacted slots a lane loads ahead of their
// arithmetic: key, value (when another table) and edge rows, the bias
// term, the slot's column and whether it exists.
template <int D, int K, int NW>
struct SlotBatch {
  uint32_t kr[D][K][NW], vr[D][K][NW], er[D][K][NW];
  float br[D][K];
  int col[D];
  bool ok[D];
};

// Issues the loads of iterations it .. it + D - 1 of a chunk (each slot
// group its next valid slot). Every lane of the warp calls it.
template <typename T, int PW, int K, int D, int V>
__device__ __forceinline__ void load_batch(
    SlotBatch<D, K, PW / 4>& b, const Chunk& c, int it, int nit,
    const LaneMap& m, int grp, int rbase, const LanePieces<V, K>& lp,
    const T* __restrict__ ks, const T* __restrict__ vs,
    const T* __restrict__ he, const float* __restrict__ bias, bool same) {
  const int hd = m.hd;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int sr = (it + d) * m.gr + grp;
    b.ok[d] = it + d < nit && sr < c.nv;
    const int s = rbase + (b.ok[d] ? sr : 0);
    const int64_t nb = __shfl_sync(kFull, c.nbr, s);
    b.col[d] = __shfl_sync(kFull, c.col, s);
    const int64_t es = he != nullptr ? __shfl_sync(kFull, c.eslot, s) : 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      b.br[d][k] = 0.f;
#pragma unroll
      for (int x = 0; x < PW / 4; ++x)
        b.kr[d][k][x] = b.vr[d][k][x] = b.er[d][k][x] = 0u;
      if (!b.ok[d] || !lp.live[k]) continue;
      load_raw<PW>(ks + nb * hd + lp.e0[k], b.kr[d][k]);
      if (!same) load_raw<PW>(vs + nb * hd + lp.e0[k], b.vr[d][k]);
      if (he != nullptr) load_raw<PW>(he + es * hd + lp.e0[k], b.er[d][k]);
      if (bias != nullptr)
        b.br[d][k] = __ldg(bias + b.col[d] * m.heads + lp.h[k]);
    }
  }
}

}  // namespace attn
}  // namespace gigl
