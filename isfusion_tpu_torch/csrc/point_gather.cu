// Point gathers for Hopper (sm_90a) — K14-gather — forward and backward.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:61 gather_points, :105
// group_points and :118 three_interpolate (XLA gathers of (N, C) rows,
// and the interpolation's weighted sum over its 3 slots), with their
// gradients. The PointNet++ backbone gathers each SA level's sampled xyz
// (S rows), groups each ball's xyz and features (S x K rows) and
// interpolates each FP level's features (S x 3 rows); the vote
// aggregation gathers and groups the votes, whose coordinates are
// learned, so the backward carries gradients to them.
//
// Each form is a sum over flattened slots: feats (B, N, C) float32, idx
// (B * R * J) int32 into each sample's N rows, weights (B * R * J) or none
// (then J = 1: a copy), out (B, R, C) with out[r] = sum_{j < J} w[r, j] *
// feats[idx[r, j]] added in slot order (the JAX package's reduction over
// the 3 slots). Row widths are any C: xyz rows are 3 floats (12 bytes),
// which K12's 16-byte rows do not take.
//
// Bound: bytes. The forward reads each distinct source row once and the
// indices and weights once, and writes the output once; the backward reads
// the output gradient, the indices and the weights once and writes the
// gradients once (its list adds ~20 bytes a slot). At VoteNet's sizes the
// calls are short (SA2's grouping moves 18 MB): what bounds them is the
// latency of two dependent reads (an index, then its row) and, for a call
// from Python, the host's launch. The first design took a thread an
// element: two 64-bit divisions an element and each slot's index read once
// a channel; its backward's list came from a stable torch.argsort and
// searchsorted. Design now:
// - a row (output row, source row or slot) is a group of G lanes; a row
//   of C % 4 == 0 floats whose base pointers are 16-byte aligned (checked
//   here: a view's storage offset can break it) moves as float4, so 128
//   or 256 floats take one warp, one or two 16-byte loads a lane; rows of
//   C <= 4 otherwise (xyz, SA1's height) take a thread a row; other widths
//   a warp of 4-byte lanes.
// - op 0, forward: a warp takes a tile of 32 / G rows (UNROLL tiles at a
//   time): one lane of each row's group loads each of the row's J
//   indices (and weights), all of the tile's first, then checks each
//   index once (an index outside [0, N) stops the kernel: __trap, the
//   launch fails with a CUDA error, where the plain version's
//   torch.gather raises) and shares it with the group by shuffle; then
//   every row's loads go out together. Offsets are
//   32-bit when B x N x C and B x R x C are below 2^31, 64-bit otherwise.
//   A copy (J = 1) and three weighted slots (J = 3) are compiled apart.
// - op 1, the features' gradient: gfeats[n] = sum over the slots that read
//   row n, in increasing slot order, of w * g[slot's row] (w = 1 without
//   weights). The call first builds the list (below) in the scratch the
//   wrapper passes, with no sort and no host synchronisation; then a
//   group a source row walks its list eight slots at a time, their loads
//   in flight together with the next eight slot ids, the sums in slot
//   order. No atomics on floats: the
//   sums run in one fixed order and repeat bit for bit.
// - op 2, the weights' gradient: gw[slot] = sum_c g[row, c] * feats[idx,
//   c], a group a slot: each lane sums its channels in order (its float4's
//   four in order), then a fixed butterfly of shuffles adds the G partial
//   sums.
// - op 1's list: the CSR of the slots that read each source row, each
//   row's in increasing order, by the builder of stable_lists.cuh (which
//   ball_query.cu's cell grid shares): a warp orders a row of up to 256
//   slots, a block a longer row by a bitmap of its sample's slot ids, so
//   its cost grows with the slots, not their square. K1's list stage
//   (dynamic_voxelize.cu, op 1) builds the same list with a thread
//   ordering a segment, 2-8 SMs busy at VoteNet's 1,024-2,048 rows: 0.14
//   device ms at SA2's grouping against 0.018 for the warp stage here
//   (chip_smoke.py --k14). K1 keeps its own (ROADMAP queue 2).
// Products and sums are rounded step by step (__fmul_rn, __fadd_rn: no FMA
// contraction), so the forward equals the plain version bit for bit.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "stable_lists.cuh"

namespace {

constexpr int THREADS = 256;
// row tiles a warp keeps in flight (a tile is 32 rows of up to 4 floats,
// or fewer wider rows): one, so that the registers leave room for more
// resident warps, which hide the two dependent reads' latency
constexpr int UNROLL = 1;

using slist::build_list;
using slist::grid_for;
using slist::list_layout;
using slist::source_row;

__device__ __forceinline__ float mul(float a, float w) {
  return __fmul_rn(a, w);
}
__device__ __forceinline__ float4 mul(float4 a, float w) {
  return make_float4(__fmul_rn(a.x, w), __fmul_rn(a.y, w), __fmul_rn(a.z, w),
                     __fmul_rn(a.w, w));
}
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}
__device__ __forceinline__ float zero(float) { return 0.f; }
__device__ __forceinline__ float4 zero(float4) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
// a lane's share of a dot product: its elements in order
__device__ __forceinline__ float dot(float acc, float a, float b) {
  return __fadd_rn(acc, __fmul_rn(a, b));
}
__device__ __forceinline__ float dot(float acc, float4 a, float4 b) {
  acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
  acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
  acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
  return __fadd_rn(acc, __fmul_rn(a.w, b.w));
}

// op 0. V: float or float4 (cv = C in V units); G lanes a row; I: offset
// type; J: 1 (a copy: no weights), 3 (3 weighted slots) or 0 (any j,
// weights or none). Rows are tiles of (32 / G) consecutive rows, UNROLL
// tiles a warp at a time.
template <typename V, int G, typename I, int J>
__global__ void __launch_bounds__(THREADS)
    gather_kernel(const V* __restrict__ feats,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w, V* __restrict__ out, I rows,
                  int j_rt, I n, I cv, I r) {
  constexpr int RW = 32 / G;                // rows a warp tile
  constexpr int JJ = J > 0 ? J : 1;         // slots held in registers
  const int j = J > 0 ? J : j_rt;
  const int lane = threadIdx.x & 31, q = lane & (G - 1), gi = lane / G;
  const I warps = (I)gridDim.x * (THREADS / 32);
  for (I tile = (I)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       tile * RW * UNROLL < rows; tile += warps) {
    I row[UNROLL];
    I off[UNROLL][JJ];        // each slot's source row, in elements
    float sw[UNROLL][JJ];
    if constexpr (J > 0) {
      // lane t % G of each row's group loads the row's slot t (and its
      // weight): every load of the tile first, then the checks and the
      // shuffles, so that the loads overlap
      int32_t raw[UNROLL][J];
      float wraw[UNROLL][J];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        row[u] = (tile * UNROLL + u) * RW + gi;
#pragma unroll
        for (int t = 0; t < J; ++t) {
          const bool mine = row[u] < rows && q == t % G;
          raw[u][t] = mine ? idx[row[u] * J + t] : 0;
          if constexpr (J > 1) wraw[u][t] = mine ? w[row[u] * J + t] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const I base = row[u] < rows ? row[u] / r * n : 0;
#pragma unroll
        for (int t = 0; t < J; ++t) {
          if (row[u] < rows && q == t % G) source_row<I>(raw[u][t], n);
          off[u][t] = (base + (I)__shfl_sync(0xffffffffu, raw[u][t],
                                             gi * G + t % G)) * cv;
          if constexpr (J > 1)
            sw[u][t] = __shfl_sync(0xffffffffu, wraw[u][t], gi * G + t % G);
        }
      }
    } else {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) row[u] = (tile * UNROLL + u) * RW + gi;
    }
    if constexpr (J > 0) {
#pragma unroll 2
      for (I col = q; col < cv; col += G) {
        V v[UNROLL][J];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u)
#pragma unroll
          for (int t = 0; t < J; ++t)
            if (row[u] < rows) v[u][t] = feats[off[u][t] + col];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (row[u] >= rows) continue;
          V acc = v[u][0];
          if constexpr (J > 1) {
            acc = mul(acc, sw[u][0]);
#pragma unroll
            for (int t = 1; t < J; ++t) acc = add(acc, mul(v[u][t], sw[u][t]));
          }
          out[row[u] * cv + col] = acc;
        }
      }
    } else {
      // any J: the slots one at a time, each loaded by one lane of the
      // group and shared
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool live = row[u] < rows;
        const V* src = feats + (live ? row[u] / r : 0) * n * cv;
        for (I col0 = 0; col0 < cv; col0 += G) {
          const I col = col0 + q;
          V acc = zero(V());
          for (int t = 0; t < j; ++t) {
            int32_t s = 0;
            float ws = 1.f;
            if (live && q == t % G) {
              s = (int32_t)source_row<I>(idx[row[u] * j + t], n);
              if (w != nullptr) ws = w[row[u] * j + t];
            }
            s = __shfl_sync(0xffffffffu, s, gi * G + t % G);
            ws = __shfl_sync(0xffffffffu, ws, gi * G + t % G);
            if (live && col < cv) {
              const V x = src[(I)s * cv + col];
              const V y = w == nullptr ? x : mul(x, ws);
              acc = t == 0 ? y : add(acc, y);
            }
          }
          if (live && col < cv) out[row[u] * cv + col] = acc;
        }
      }
    }
  }
}

// op 1: G lanes a source row sum its slots' gradient rows in slot order,
// IN_FLIGHT slots' loads at a time, the next IN_FLIGHT slot ids loaded
// beside them: a row read by many slots (thousands, where a cloud's
// slots crowd onto a few rows) costs about one load latency per
// IN_FLIGHT slots. J: slots an output row (0: the runtime j).
constexpr int IN_FLIGHT = 8;

template <typename V, int G, int J>
__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const V* __restrict__ g, const int32_t* __restrict__ order,
                   const float* __restrict__ w,
                   const int32_t* __restrict__ ptr, V* __restrict__ out,
                   int64_t src_rows, int j_rt, int64_t cv) {
  const int j = J > 0 ? J : j_rt;
  const int q = threadIdx.x & (G - 1);
  const int64_t groups = (int64_t)gridDim.x * (THREADS / G);
  for (int64_t row = (int64_t)blockIdx.x * (THREADS / G) + threadIdx.x / G;
       row < src_rows; row += groups) {
    const int32_t lo = ptr[row], hi = ptr[row + 1];
    for (int64_t col = q; col < cv; col += G) {
      V acc = zero(V());
      int32_t sl[IN_FLIGHT];
#pragma unroll
      for (int e = 0; e < IN_FLIGHT; ++e)
        sl[e] = lo + e < hi ? order[lo + e] : -1;
      for (int32_t l = lo; l < hi; l += IN_FLIGHT) {
        int32_t next[IN_FLIGHT];
        float ws[IN_FLIGHT];
        V v[IN_FLIGHT];
#pragma unroll
        for (int e = 0; e < IN_FLIGHT; ++e)
          ws[e] = w != nullptr && sl[e] >= 0 ? w[sl[e]] : 1.f;
#pragma unroll
        for (int e = 0; e < IN_FLIGHT; ++e)
          v[e] = sl[e] >= 0 ? g[(int64_t)(sl[e] / j) * cv + col] : zero(V());
#pragma unroll
        for (int e = 0; e < IN_FLIGHT; ++e)
          next[e] = l + IN_FLIGHT + e < hi ? order[l + IN_FLIGHT + e] : -1;
#pragma unroll
        for (int e = 0; e < IN_FLIGHT; ++e)
          if (sl[e] >= 0) acc = add(acc, w == nullptr ? v[e] : mul(v[e], ws[e]));
#pragma unroll
        for (int e = 0; e < IN_FLIGHT; ++e) sl[e] = next[e];
      }
      out[row * cv + col] = acc;
    }
  }
}

// op 2: G lanes a slot; each lane its channels in order, then a butterfly
template <typename V, int G>
__global__ void __launch_bounds__(THREADS)
    weight_grad_kernel(const V* __restrict__ g, const V* __restrict__ feats,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, int64_t slots, int j,
                       int64_t n, int64_t cv, int64_t r) {
  const int lane = threadIdx.x & 31, q = lane & (G - 1), gi = lane / G;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t base = ((int64_t)blockIdx.x * (THREADS / 32) +
                       (threadIdx.x >> 5)) * (32 / G);
       base < slots; base += warps * (32 / G)) {
    const int64_t slot = base + gi;
    const bool live = slot < slots;
    float acc = 0.f;
    if (live) {
      const int64_t row = slot / j;
      const int32_t s = idx[slot];
      if (q == 0) source_row<int64_t>(s, n);
      const V* gr = g + row * cv;
      const V* fr = feats + ((row / r) * n + s) * cv;
      for (int64_t col = q; col < cv; col += G) {
        if (s < 0 || s >= n) break;
        acc = dot(acc, gr[col], fr[col]);
      }
    }
#pragma unroll
    for (int off = G / 2; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off, G));
    if (live && q == 0) out[slot] = acc;
  }
}

// the group width for cv elements a row: a thread a row up to 4 elements
// of float (C <= 4) or one float4; else the power of two up to 32 that
// covers the row
int lanes_for(int64_t cv, bool vec) {
  if (!vec && cv <= 4) return 1;
  if (!vec) return 32;
  int g = 1;
  while (g < 32 && g < cv) g <<= 1;
  return g;
}

template <typename V, int G>
int launch_g(int op, const void* a, const void* b, const void* idx,
             const void* w, void* scratch, void* out, long long rows,
             long long j, long long n, long long cv, long long r,
             bool narrow, cudaStream_t st) {
  if (op == 0) {
    const unsigned tiles = grid_for(
        (rows + UNROLL * (32 / G) - 1) / (UNROLL * (32 / G)) * 32);
#define GATHER(I, JV)                                                     \
  gather_kernel<V, G, I, JV><<<tiles, THREADS, 0, st>>>(                  \
      (const V*)a, (const int32_t*)idx, (const float*)w, (V*)out, (I)rows, \
      (int)j, (I)n, (I)cv, (I)r)
    const bool copy = j == 1 && w == nullptr, three = j == 3 && w;
    if (narrow) {
      if (copy) GATHER(int32_t, 1);
      else if (three) GATHER(int32_t, 3);
      else GATHER(int32_t, 0);
    } else {
      if (copy) GATHER(int64_t, 1);
      else if (three) GATHER(int64_t, 3);
      else GATHER(int64_t, 0);
    }
#undef GATHER
  } else if (op == 1) {
    // the list into the scratch, after the list stage's own words
    const int64_t segs = rows / r * n, slots = rows * j;
    uint32_t* ws = (uint32_t*)scratch;
    int32_t* ptr = (int32_t*)(ws + list_layout(segs, slots).words);
    int32_t* order = ptr + segs + 1;
    const int err = build_list((const int32_t*)idx, slots, r * j, n, segs,
                               ws, ptr, order, st);
    if (err) return err;
    const unsigned grid = grid_for((segs + THREADS / G - 1) / (THREADS / G) *
                                   THREADS);
    if (j == 1)
      scatter_kernel<V, G, 1><<<grid, THREADS, 0, st>>>(
          (const V*)a, order, (const float*)w, ptr, (V*)out, segs, (int)j,
          cv);
    else
      scatter_kernel<V, G, 0><<<grid, THREADS, 0, st>>>(
          (const V*)a, order, (const float*)w, ptr, (V*)out, segs, (int)j,
          cv);
  } else {
    const long long slots = rows * j;
    weight_grad_kernel<V, G>
        <<<grid_for((slots + 32 / G - 1) / (32 / G) * 32), THREADS, 0, st>>>(
            (const V*)a, (const V*)b, (const int32_t*)idx, (float*)out,
            slots, (int)j, n, cv, r);
  }
  return (int)cudaGetLastError();
}

// float rows take 1 or 32 lanes (lanes_for), float4 rows any of six
template <typename V, bool ANY>
int launch_v(int lanes, int op, const void* a, const void* b,
             const void* idx, const void* w, void* scratch, void* out,
             long long rows, long long j, long long n, long long cv,
             long long r, bool narrow, cudaStream_t st) {
#define LANES(G)                                                        \
  case G:                                                               \
    return launch_g<V, G>(op, a, b, idx, w, scratch, out, rows, j, n, cv, \
                          r, narrow, st);
  if constexpr (ANY) {
    switch (lanes) {
      LANES(1) LANES(2) LANES(4) LANES(8) LANES(16) LANES(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
  } else {
    switch (lanes) {
      LANES(1) LANES(32)
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
#undef LANES
}

}  // namespace

// Words of int32 scratch that op 1 needs for B * N = segs source rows and
// slots = B * R * J slots (the list stage's words, then ptr (segs + 1) and
// order (slots)).
extern "C" long long point_gather_scratch(long long segs, long long slots) {
  return slist::list_words(segs, slots);
}

// args: twelve int64 (op, a, b, idx, w, scratch, out, rows, j, n, c, r):
// the pointers as integers (0 for none), then
// op 0: a = feats (B, N, C), idx (rows * j), w (rows * j) or null, out
//       (rows, C); r rows a sample.
// op 1: a = g (rows = B * R, C), idx the forward's (rows * j), w (rows *
//       j) or null, scratch (point_gather_scratch words), out (B * N, C).
// op 2: a = g (B * R, C), b = feats (B, N, C), idx (rows * j), out
//       (rows * j); r rows a sample.
// Rows move as float4 when C % 4 == 0 and the row arrays (a, b, out) are
// 16-byte aligned. An index outside [0, n) stops the kernel (__trap).
extern "C" int point_gather(const long long* args, void* stream) {
  const int op = (int)args[0];
  const void* a = (const void*)args[1];
  const void* b = (const void*)args[2];
  const void* idx = (const void*)args[3];
  const void* w = (const void*)args[4];
  void* scratch = (void*)args[5];
  void* out = (void*)args[6];
  const long long rows = args[7], j = args[8], n = args[9], c = args[10],
                  r = args[11];
  if (rows <= 0 || c <= 0) return 0;
  if (op < 0 || op > 2 || j < 1 || j > INT_MAX || n <= 0 || n >= INT_MAX ||
      r <= 0 || rows % r != 0 || rows / r * n + rows * j >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const uintptr_t rows_at = (uintptr_t)a | (uintptr_t)out |
                            (op == 2 ? (uintptr_t)b : (uintptr_t)0);
  const bool vec = c % 4 == 0 && rows_at % 16 == 0;
  const long long cv = vec ? c / 4 : c;
  // 32-bit offsets when every element offset of the forward fits (with
  // room for a grid's stride past the last row)
  const long long lim = ((long long)1 << 31) - ((long long)1 << 22);
  const bool narrow = rows / r * n * c < lim && rows * c < lim &&
                      rows * j < lim;
  const int lanes = lanes_for(cv, vec);
  return vec ? launch_v<float4, true>(lanes, op, a, b, idx, w, scratch, out,
                                      rows, j, n, cv, r, narrow, st)
             : launch_v<float, false>(lanes, op, a, b, idx, w, scratch, out,
                                      rows, j, n, cv, r, narrow, st);
}
