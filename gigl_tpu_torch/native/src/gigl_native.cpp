// The port's host engine for out-of-core training (a copy of the parts of
// gigl_tpu/native/src/gigl_native.cpp that the streamed trainer needs):
// the threaded feature gather, the host fanout sampler and the fused
// tree-level expansion with its multi-table gather.
//
// It runs on the host's cores, never on the card: features too large for
// device memory stay in RAM or in a memory-mapped file, and each training
// batch's rows are gathered here straight into the buffers the caller
// gives (the streamed trainer's pinned host slots), from which they are
// copied to the card. Bound: host memory bandwidth and, for a table on
// disk, the page cache. Design: std::thread fan-out over contiguous chunks
// of rows (the gathers and the sampler are embarrassingly parallel), one
// memcpy a row.
//
// Determinism: the sampler draws with the same lowbias32 counter RNG keyed
// by (seed, node, hop, slot) as the port's device sampler (K1,
// csrc/sample_uniform.cu), so host and device draws agree bit for bit.
//
// A C ABI, loaded with ctypes (gigl_tpu_torch/native/__init__.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

extern "C" {

// Rows a call takes before it fans out over threads (a streamed batch's
// deepest level, 512 roots x 15 children, splits over the host's cores);
// scripts/streaming_fill_sweep.py builds copies with other values.
#ifndef GIGL_PARALLEL_ROWS
#define GIGL_PARALLEL_ROWS 4096
#endif
static const int64_t kParallelRows = GIGL_PARALLEL_ROWS;

static void parallel_for(int64_t n, int num_threads,
                         const std::function<void(int64_t, int64_t)>& fn) {
  if (num_threads <= 1 || n < kParallelRows) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back([=, &fn] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

static inline uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// float32 -> bfloat16 bits, round to nearest even, NaNs quieted to 0x7FC0:
// the bits of gigl_tpu_torch/utils/cast.py to_bfloat16.
static inline uint16_t to_bf16(float f) {
  uint32_t u;
  std::memcpy(&u, &f, sizeof(u));
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0u;
  return static_cast<uint16_t>((u + 0x7FFFu + ((u >> 16) & 1u)) >> 16);
}

static inline uint32_t counter_rng(uint32_t node, uint32_t seed, uint32_t hop,
                                   uint32_t slot) {
  uint32_t base = node * 0x9E3779B9u + seed * 0x85EBCA6Bu + hop * 0xC2B2AE35u;
  return mix32(base ^ mix32(slot + 0x27220A95u));
}

// out[i] = table[idx[i]] for [N, D] float32 rows; out_bf16: the rows are
// written as bfloat16 bits (uint16, to_bf16) in the same pass, the cast of
// a bf16 answer slot. Returns 0, or -(i + 1) for an index out of range (its
// output row is left unwritten).
int64_t gigl_gather_f32(const float* table, int64_t N, int64_t D,
                        const int64_t* idx, int64_t M, void* out,
                        int out_bf16, int num_threads) {
  std::atomic<int64_t> bad{0};
  parallel_for(M, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t r = idx[i];
      if (r < 0 || r >= N) {
        bad.store(i + 1);
        continue;
      }
      const float* row = table + r * D;
      if (out_bf16) {
        uint16_t* dst = static_cast<uint16_t*>(out) + i * D;
        for (int64_t c = 0; c < D; ++c) dst[c] = to_bf16(row[c]);
      } else {
        std::memcpy(static_cast<float*>(out) + i * D, row, sizeof(float) * D);
      }
    }
  });
  return bad.load() ? -bad.load() : 0;
}

// For each root: deg <= fanout -> its first deg slots (mask 1 for s <
// deg); deg > fanout -> draws with replacement through the counter RNG.
// nbr [R, fanout] int32 (0 where masked), mask [R, fanout] uint8,
// edge_slots [R, fanout] int64 (the CSR slot, clamped). Returns 0, or
// -(i + 1) for a root out of range.
int64_t gigl_sample_fanout(const int64_t* indptr, const int32_t* indices,
                           int64_t n_nodes, int64_t n_edges,
                           const int32_t* roots, int64_t R, int32_t fanout,
                           uint32_t seed, uint32_t hop, int32_t* nbr,
                           uint8_t* mask, int64_t* edge_slots,
                           int num_threads) {
  std::atomic<int64_t> bad{0};
  parallel_for(R, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = roots[i];
      if (v < 0 || v >= n_nodes) {
        bad.store(i + 1);
        continue;
      }
      int64_t start = indptr[v];
      int64_t deg = indptr[v + 1] - start;
      for (int32_t s = 0; s < fanout; ++s) {
        int64_t off;
        uint8_t m;
        if (deg <= fanout) {
          off = std::min<int64_t>(s, deg > 0 ? deg - 1 : 0);
          m = s < deg;
        } else {
          uint32_t bits = counter_rng(static_cast<uint32_t>(v), seed, hop,
                                      static_cast<uint32_t>(s));
          off = bits % static_cast<uint32_t>(deg);
          m = 1;
        }
        int64_t slot = start + off;
        if (slot >= n_edges) slot = n_edges - 1;
        if (slot < 0) slot = 0;
        int64_t o = i * fanout + s;
        edge_slots[o] = slot;
        nbr[o] = m ? indices[slot] : 0;
        mask[o] = m;
      }
    }
  });
  return bad.load() ? -bad.load() : 0;
}

// One streamed tree level in one threaded pass: expand the frontier
// through the frozen per-node sample table (ids_table / mask_table
// [N, K]) and gather, for every child, its feature row, its hop-cache
// aggregate row and its degree, straight into the output buffers. K == 0:
// the root level, the frontier's own rows (out_ids / out_mask unwritten).
// A masked child takes id 0 and row 0. out_bf16: the two rows are written
// as bfloat16 bits (uint16, to_bf16) instead of float32 — the cast of a
// bf16 stream in the same pass as the gather. Returns 0, or -1 for an id
// out of range.
int64_t gigl_expand_gather(const int32_t* frontier, const uint8_t* parent_mask,
                           int64_t M, const int32_t* ids_table,
                           const uint8_t* mask_table, int64_t N, int64_t K,
                           const float* feats, int64_t Df, const float* agg,
                           int64_t Da, const float* degrees, int32_t* out_ids,
                           uint8_t* out_mask, void* out_feats, void* out_agg,
                           float* out_degs, int out_bf16, int num_threads) {
  std::atomic<int64_t> bad{0};
  auto copy_row = [&](void* out, const float* row, int64_t o, int64_t d) {
    if (out_bf16) {
      uint16_t* dst = static_cast<uint16_t*>(out) + o * d;
      for (int64_t c = 0; c < d; ++c) dst[c] = to_bf16(row[c]);
    } else {
      std::memcpy(static_cast<float*>(out) + o * d, row, d * sizeof(float));
    }
  };
  auto gather_one = [&](int64_t o, int32_t id) {
    copy_row(out_feats, feats + static_cast<int64_t>(id) * Df, o, Df);
    copy_row(out_agg, agg + static_cast<int64_t>(id) * Da, o, Da);
    out_degs[o] = degrees[id];
  };
  if (K == 0) {
    parallel_for(M, num_threads, [&](int64_t lo, int64_t hi) {
      for (int64_t i = lo; i < hi; ++i) {
        int32_t id = frontier[i];
        if (id < 0 || id >= N) { bad.store(i + 1); return; }
        gather_one(i, id);
      }
    });
    return bad.load() ? -1 : 0;
  }
  parallel_for(M, num_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t node = frontier[i];
      if (node < 0 || node >= N) { bad.store(i + 1); return; }
      bool pm = parent_mask[i] != 0;
      const int32_t* row_ids = ids_table + static_cast<int64_t>(node) * K;
      const uint8_t* row_mask = mask_table + static_cast<int64_t>(node) * K;
      for (int64_t t = 0; t < K; ++t) {
        int64_t o = i * K + t;
        bool m = pm && row_mask[t] != 0;
        int32_t id = m ? row_ids[t] : 0;
        if (id < 0 || id >= N) { bad.store(i + 1); return; }
        out_ids[o] = id;
        out_mask[o] = m ? 1 : 0;
        gather_one(o, id);
      }
    }
  });
  return bad.load() ? -1 : 0;
}

}  // extern "C"
