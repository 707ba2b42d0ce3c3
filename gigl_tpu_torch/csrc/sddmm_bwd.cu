// K10b sddmm_bwd — the per-edge pass of the backward that jax's autodiff
// gives gigl_tpu/ops/segment.py sddmm (:90-103), with the port's per-head
// scale (out[e, h] = scale[h] * raw[e, h], raw = <q[dst_e, h], k[src_e, h]>):
//   coef[e, h] = g[e, h] * scale[h]                    (fp32, every edge)
//   dscale[h]  = sum_e g[e, h] * raw[e, h]              (when scale trains)
// coef weighs the two gathers of the rest of the backward, which are other
// kernels' forwards over the two indexes (ops/segment.py SDDMM.backward):
// dq[d] = sum_{e: dst_e = d} coef[e] * k[src_e] is K8 over the destination
// index, dk[s] = sum_{e: src_e = s} coef[e] * q[dst_e] is K8b's walk of the
// source-sorted index.
//
// Bound: bytes — g (and raw) read once, coef written once: at the COO
// Transformer's [2M, 4] fp32, 64 MB without raw, 96 MB with it. Design:
// ONE launch in every mode, a flat pass over the E * H values in pieces of
// V = 4 values (16 bytes of fp32 or 8 of bf16 g and raw; one 16-byte coef
// store: bf16 pieces of 8 values, two 16-byte stores each, measured 2x
// slower). Value i's head is i mod H; for H a power of two the grid's
// stride in pieces is a multiple of max(1, H / V), so each slot of a
// thread's pieces keeps one head: the thread loads its V scales into
// registers once and keeps one fp32 partial a slot. A thread issues the
// loads of kPiecesInFlight pieces before the first multiply; the grid is
// what the SMs hold at once, in blocks of 512 (blocks of 256 measured 6%
// slower with the cotangent, as fast without). coef is stored
// evict-first: in the COO Transformer step that took K10b 6% faster and
// left K8 and K8b, which read coef right after at random slots, as fast.
// The last partial piece, and tables off a piece's alignment, take the
// same slots with one load a value. Other head counts (3, 5, ..., 15)
// take a thread an edge, its heads in a loop.
//
// dscale in the same launch: a thread's slot partials are summed into its
// heads (slots H apart hold one head), then across the warp by
// __shfl_xor_sync over the lanes that hold the same heads and across the
// block's warps through shared memory, each in a fixed order; each block
// writes one [H] partial into the caller's buffer, and the block that
// finishes last — found by a per-device ticket counter that atomicInc
// wraps back to 0 (K5's pattern, retrieval_loss.cu) — sums the blocks'
// partials in a fixed order and writes dscale. No second launch and no
// fill; the same bits on every run (the grid is a function of E, H, the
// form, the buffer's rows and the card), and safe to capture in a CUDA
// graph. K10b calls on one device must be ordered on one stream (the
// counter is the device's).
#include "gigl_pieces.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeads = 16;
constexpr int kPiecesInFlight = 4;   // a thread's pieces loaded at once
constexpr int kValues = 4;           // a piece's values

// The last-block ticket (0 when the module loads; 0 between launches).
__device__ unsigned int g_ticket = 0;

// The kernel forms: pieces; the same slots a value at a time (a table off
// a piece's alignment); a thread an edge (H not a power of two).
enum Form { kPieces = 0, kScalar = 1, kRows = 2 };

// A piece: 4 values of T (16 bytes of fp32, 8 of bf16), loaded as one word
// (held) and widened to fp32.
template <typename T>
using Held = std::conditional_t<sizeof(T) == 4, uint4, uint2>;

template <typename T>
__device__ __forceinline__ Held<T> load_held(const T* __restrict__ p) {
  return __ldg(reinterpret_cast<const Held<T>*>(p));
}

template <typename T>
__device__ __forceinline__ void widen(const Held<T>& h, float* v) {
  if constexpr (sizeof(T) == 4) {
    gigl::widen<T, 4>(h, v);
  } else {
    const float2 a = gigl::unpack_bf16(h.x), b = gigl::unpack_bf16(h.y);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// A piece's coefficients, stored evict-first.
__device__ __forceinline__ void store_coef(float* p, const float (&c)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(c[0], c[1], c[2], c[3]));
}

// Per-head sums over the block in a fixed order. v[j] (j < cnt) is the
// partial of head hb + j; lanes that differ only in bits >= log2(m) hold
// the same heads (m | 32), so after the butterfly lanes 0..m-1 hold the
// warp's sums of every head. Returns head h's block sum in thread
// h < heads (0 elsewhere).
template <int R>
__device__ __forceinline__ float block_head_sum(float (&v)[R], int m, int hb,
                                                int cnt, int heads,
                                                float (*wsum)[kMaxHeads]) {
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off >= m) {
#pragma unroll
      for (int j = 0; j < R; ++j)
        v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
    }
  }
  const int lane = threadIdx.x & 31;
  __syncthreads();  // wsum is free (a second call in the last block)
  if (lane < m) {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < cnt) wsum[threadIdx.x >> 5][hb + j] = v[j];
  }
  __syncthreads();
  float s = 0.f;
  if (static_cast<int>(threadIdx.x) < heads) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += wsum[w][threadIdx.x];
  }
  return s;
}

// One piece p (slots j < V, flat values p * V + j), with `live` values
// (V but for the last partial piece), a value at a time.
template <typename T, bool SCALE, bool DSCALE, int V>
__device__ __forceinline__ void scalar_piece(const T* __restrict__ g,
                                             const T* __restrict__ raw,
                                             float* __restrict__ coef,
                                             int64_t p, int live,
                                             const float (&s)[V],
                                             float (&acc)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    if (j < live) {
      const int64_t i = p * V + j;
      const float gv = gigl::to_float(g[i]);
      coef[i] = SCALE ? gv * s[j] : gv;
      if constexpr (DSCALE) acc[j] = fmaf(gv, gigl::to_float(raw[i]), acc[j]);
    }
  }
}

template <typename T, int FORM, bool SCALE, bool DSCALE>
__global__ void __launch_bounds__(kThreads)
    sddmm_bwd_kernel(const T* __restrict__ g, const float* __restrict__ scale,
                     const T* __restrict__ raw, float* __restrict__ coef,
                     float* __restrict__ dscale,
                     float* __restrict__ partial, int64_t e, int heads) {
  __shared__ float wsum[kWarps][kMaxHeads];
  __shared__ bool last;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  float part = 0.f;  // this block's sum of head threadIdx.x
  if constexpr (FORM == kRows) {
    float s[kMaxHeads], acc[kMaxHeads];
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h) {
      acc[h] = 0.f;
      s[h] = SCALE && h < heads ? __ldg(scale + h) : 1.f;
    }
    for (int64_t r = t; r < e; r += stride) {
#pragma unroll
      for (int h = 0; h < kMaxHeads; ++h) {
        if (h < heads) {
          const int64_t i = r * heads + h;
          const float gv = gigl::to_float(g[i]);
          coef[i] = SCALE ? gv * s[h] : gv;
          if constexpr (DSCALE)
            acc[h] = fmaf(gv, gigl::to_float(raw[i]), acc[h]);
        }
      }
    }
    if constexpr (!DSCALE) return;
    part = block_head_sum<kMaxHeads>(acc, 1, 0, heads, heads, wsum);
  } else {
    constexpr int V = kValues;
    const int64_t n = e * heads;
    const int64_t full = n / V;           // whole pieces
    const int m = heads > V ? heads / V : 1;  // pieces a head group spans
    const int hb = heads > V ? static_cast<int>(t % m) * V : 0;
    float s[V], acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      acc[j] = 0.f;
      s[j] = SCALE ? __ldg(scale + ((hb + j) & (heads - 1))) : 1.f;
    }
    int64_t p = t;
    if constexpr (FORM == kPieces) {
      for (; p + (kPiecesInFlight - 1) * stride < full;
           p += kPiecesInFlight * stride) {
        Held<T> gh[kPiecesInFlight], rh[kPiecesInFlight];
#pragma unroll
        for (int u = 0; u < kPiecesInFlight; ++u) {
          gh[u] = load_held(g + (p + u * stride) * V);
          if constexpr (DSCALE)
            rh[u] = load_held(raw + (p + u * stride) * V);
        }
#pragma unroll
        for (int u = 0; u < kPiecesInFlight; ++u) {
          float gv[V], c[V];
          widen<T>(gh[u], gv);
#pragma unroll
          for (int j = 0; j < V; ++j) c[j] = SCALE ? gv[j] * s[j] : gv[j];
          store_coef(coef + (p + u * stride) * V, c);
          if constexpr (DSCALE) {
            float rv[V];
            widen<T>(rh[u], rv);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[j] = fmaf(gv[j], rv[j], acc[j]);
          }
        }
      }
      for (; p < full; p += stride) {
        float gv[V], c[V];
        widen<T>(load_held(g + p * V), gv);
#pragma unroll
        for (int j = 0; j < V; ++j) c[j] = SCALE ? gv[j] * s[j] : gv[j];
        store_coef(coef + p * V, c);
        if constexpr (DSCALE) {
          float rv[V];
          widen<T>(load_held(raw + p * V), rv);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = fmaf(gv[j], rv[j], acc[j]);
        }
      }
    } else {
      for (; p < full; p += stride)
        scalar_piece<T, SCALE, DSCALE, V>(g, raw, coef, p, V, s, acc);
    }
    // the last partial piece, by the thread whose stride it falls on
    if (full * V < n && p == full)
      scalar_piece<T, SCALE, DSCALE, V>(g, raw, coef, full,
                                        static_cast<int>(n - full * V), s,
                                        acc);
    if constexpr (!DSCALE) return;
    // slots H apart hold one head: fold them (fixed order) into the first H
#pragma unroll
    for (int d = V / 2; d >= 1; d >>= 1) {
      if (d >= heads) {
#pragma unroll
        for (int j = 0; j < d; ++j) acc[j] += acc[j + d];
      }
    }
    part = block_head_sum<V>(acc, m, hb, heads < V ? heads : V, heads, wsum);
  }
  // The last block to finish sums the blocks' partials.
  if (static_cast<int>(threadIdx.x) < heads)
    partial[blockIdx.x * heads + threadIdx.x] = part;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicInc(&g_ticket, gridDim.x - 1) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  float acc[kMaxHeads];
#pragma unroll
  for (int h = 0; h < kMaxHeads; ++h) acc[h] = 0.f;
  for (unsigned b = threadIdx.x; b < gridDim.x; b += kThreads) {
#pragma unroll
    for (int h = 0; h < kMaxHeads; ++h)
      if (h < heads) acc[h] += __ldcg(partial + b * heads + h);
  }
  const float total =
      block_head_sum<kMaxHeads>(acc, 1, 0, heads, heads, wsum);
  if (static_cast<int>(threadIdx.x) < heads) dscale[threadIdx.x] = total;
}

// The arguments of one call.
struct Call {
  const void* g;
  const float* scale;
  const void* raw;
  float* coef;
  float* dscale;
  float* partial;
  int64_t e;
  int heads;
  int rows;  // of partial
  cudaStream_t stream;
};

// The grid of one form: what the SMs hold at once (an occupancy query,
// read once a form), no more blocks than the work's threads need or the
// partial buffer's rows.
template <typename T, int FORM, bool SCALE, bool DSCALE>
int grid_of(int64_t work, int rows) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, sddmm_bwd_kernel<T, FORM, SCALE, DSCALE>, kThreads, 0);
    resident = sms * per_sm < 1 ? 1 : sms * per_sm;
  }
  int64_t grid = (work + kThreads - 1) / kThreads;
  if (grid > resident) grid = resident;
  if (DSCALE && grid > rows) grid = rows;
  return static_cast<int>(grid < 1 ? 1 : grid);
}

template <typename T, int FORM, bool SCALE, bool DSCALE>
void launch(const Call& c) {
  const int64_t work =
      FORM == kRows ? c.e : (c.e * c.heads + kValues - 1) / kValues;
  sddmm_bwd_kernel<T, FORM, SCALE, DSCALE>
      <<<grid_of<T, FORM, SCALE, DSCALE>(work, c.rows), kThreads, 0,
         c.stream>>>(static_cast<const T*>(c.g), c.scale,
                     static_cast<const T*>(c.raw), c.coef, c.dscale,
                     c.partial, c.e, c.heads);
}

template <typename T, int FORM>
void launch_form(const Call& c) {
  if (c.scale != nullptr) {
    c.dscale != nullptr ? launch<T, FORM, true, true>(c)
                        : launch<T, FORM, true, false>(c);
  } else {
    c.dscale != nullptr ? launch<T, FORM, false, true>(c)
                        : launch<T, FORM, false, false>(c);
  }
}

template <typename T>
void launch_dtype(const Call& c) {
  const bool pow2 = (c.heads & (c.heads - 1)) == 0;
  constexpr uintptr_t piece = sizeof(Held<T>);  // g's and raw's loads
  const bool aligned = reinterpret_cast<uintptr_t>(c.g) % piece == 0 &&
                       reinterpret_cast<uintptr_t>(c.raw) % piece == 0 &&
                       reinterpret_cast<uintptr_t>(c.coef) % 16 == 0;
  if (!pow2)
    launch_form<T, kRows>(c);
  else if (aligned)
    launch_form<T, kPieces>(c);
  else
    launch_form<T, kScalar>(c);
}

}  // namespace

// g [E, heads] (fp32: dtype 0, bf16: 1), scale fp32 [heads] or NULL (1),
// raw [E, heads] of g's type or NULL, coef fp32 [E, heads]; dscale fp32
// [heads] or NULL, given when raw is (raw may be NULL when E = 0: dscale
// is then 0), with partial fp32 [rows, heads] (rows >= 1) for the blocks'
// sums; the grid has at most `rows` blocks. heads <= 16. One launch (none
// when E = 0 and no dscale is asked for).
extern "C" int gigl_sddmm_bwd(const void* g, const void* scale,
                              const void* raw, void* coef, void* dscale,
                              void* partial, long long e, int heads,
                              int rows, int dtype, void* stream) {
  if (heads <= 0 || heads > kMaxHeads || e < 0 ||
      (raw != nullptr && dscale == nullptr) ||
      (raw == nullptr && dscale != nullptr && e > 0) ||
      (dscale != nullptr && (partial == nullptr || rows < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (e == 0 && dscale == nullptr) return 0;
  const Call c{g, static_cast<const float*>(scale), raw,
               static_cast<float*>(coef), static_cast<float*>(dscale),
               static_cast<float*>(partial), e, heads, rows,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) {
    launch_dtype<float>(c);
  } else if (dtype == 1) {
    launch_dtype<__nv_bfloat16>(c);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Copies the ticket counter (uint32) to the device word `out` on `stream`:
// 0 whenever no K10b launch with dscale is in flight on this device.
extern "C" int gigl_sddmm_bwd_ticket(void* out, void* stream) {
  return static_cast<int>(cudaMemcpyFromSymbolAsync(
      out, g_ticket, sizeof(unsigned int), 0, cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream)));
}
