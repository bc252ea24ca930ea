// A stable CSR list builder for Hopper (sm_90a), shared by K14's kernels:
// point_gather.cu (op 1: the slots that read each source row, for the
// features' gradient) and ball_query.cu (the points of each cell-grid
// bucket). No TPU kernel has a counterpart: XLA's gathers and scatters
// never materialise such a list.
//
// Input: `slots` slot ids 0 .. slots - 1 in samples of rs consecutive ids,
// each with a row idx[i] in [0, n) of its sample (an id outside stops the
// kernel: __trap). Output: ptr (segs + 1, segs = samples x n) and order
// (slots): the ids of row r of all samples' rows at order[ptr[r] ..
// ptr[r + 1]), in increasing order, as a stable sort by row would give,
// with no sort and no host synchronisation. Bound: bytes, ~20 a slot and
// ~16 a row; at K14's sizes the five launches' latency.
#pragma once
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "prefix_scan.cuh"

namespace slist {

constexpr int THREADS = 256;
constexpr int SCAN_ITEMS = 8;       // counts a thread scans
constexpr int PER_LANE = 8;         // a list's ids a lane ranks at a time
// a row of more slots than this is ordered by a block, not a warp
constexpr uint32_t WARP_ROW = 32 * PER_LANE;
// the most bitmap words of a block's window (32 KB: 262,144 slot ids)
constexpr int64_t WINDOW_WORDS = 8192;

// a slot's row; an index outside [0, n) is a fault upstream: stop
template <typename I>
__device__ __forceinline__ I source_row(int32_t s, I n) {
  if (s < 0 || (I)s >= n) __trap();
  return (I)s;
}

// The list: a CSR of the slots that read each row, each row's slot ids in
// increasing order (the stable order of a sort by row; K1's list stage in
// dynamic_voxelize.cu follows the same steps, with a thread a segment in
// its last). In four launches after a memset of the counts:
// count (each slot's row counted by an integer atomic, its arrival rank
// kept), scan (prefix_scan.cuh: the rows' offsets), place (each slot id at
// its row's offset plus its arrival rank: in no fixed order), order (a
// warp a row of up to WARP_ROW slots ranks its slot ids, each the count of
// smaller ones in the row, and writes them in increasing order, with the
// row's offsets; then a block a longer row sets one bit a slot id in a
// bitmap of its sample's ids and writes the set bits in order).
struct ListLayout {          // offsets in 4-byte words of the scratch
  int64_t counts, ticket, totals, tiles, prefix, arrival, unsorted, words;
};

inline ListLayout list_layout(int64_t segs, int64_t slots) {
  ListLayout L{};
  L.counts = 0;
  L.ticket = segs;                                  // zeroed: segs + 1
  L.totals = (segs + 2) & ~int64_t(1);              // a long long total
  L.tiles = L.totals + 2;
  L.prefix = L.tiles + pscan::n_tiles<SCAN_ITEMS>(segs);
  L.arrival = L.prefix + segs;
  L.unsorted = L.arrival + slots;
  L.words = L.unsorted + slots;
  return L;
}

// a slot's row among all samples' source rows: rs slots a sample
__device__ __forceinline__ int64_t slot_key(const int32_t* idx, int64_t i,
                                            int64_t rs, int64_t n) {
  return i / rs * n + idx[i];
}

__global__ void __launch_bounds__(THREADS)
    count_kernel(const int32_t* __restrict__ idx, int64_t slots, int64_t rs,
                 int64_t n, uint32_t* __restrict__ counts,
                 uint32_t* __restrict__ arrival) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= slots) return;
  source_row<int64_t>(idx[i], n);
  arrival[i] = atomicAdd(counts + slot_key(idx, i, rs, n), 1u);
}

__global__ void __launch_bounds__(pscan::THREADS)
    scan_kernel(const uint32_t* __restrict__ counts, int64_t segs,
                uint32_t* __restrict__ prefix, uint32_t* tiles,
                unsigned* ticket, long long* total) {
  pscan::scan_tile<SCAN_ITEMS>([&](int64_t i) { return counts[i]; }, segs,
                               prefix, tiles);
  pscan::finish_scan(tiles, ticket, total);
}

__global__ void __launch_bounds__(THREADS)
    place_kernel(const int32_t* __restrict__ idx, int64_t slots, int64_t rs,
                 int64_t n, const uint32_t* __restrict__ prefix,
                 const uint32_t* __restrict__ tiles,
                 const uint32_t* __restrict__ arrival,
                 int32_t* __restrict__ unsorted) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= slots) return;
  const int64_t key = slot_key(idx, i, rs, n);
  unsorted[pscan::tile_offset<SCAN_ITEMS>(prefix, tiles, key) + arrival[i]] =
      (int32_t)i;
}

// a block's exclusive prefix sum of one value a thread; total: the sum
__device__ __forceinline__ uint32_t block_scan(uint32_t v, uint32_t* total) {
  __shared__ uint32_t warp_sums[THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  uint32_t before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < THREADS / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0u;
    all += warp_sums[w];
  }
  __syncthreads();
  *total = all;
  return before + x - v;
}

// rows of up to WARP_ROW slots: a warp a row (g consecutive rows at a
// time: g = 32 where every warp has that many, its lanes reading their
// rows' counts and offsets together, so that a table of mostly empty rows
// costs one round of loads per 32 rows); then longer rows: a block a row,
// each block's rows checked 256 at a time, through windows of `window`
// bitmap words (dynamic shared memory) over its sample's rs slot ids
__global__ void __launch_bounds__(THREADS)
    order_kernel(const uint32_t* __restrict__ counts,
                 const uint32_t* __restrict__ prefix,
                 const uint32_t* __restrict__ tiles, int64_t segs,
                 int64_t rs, int64_t n, int64_t window,
                 const int32_t* __restrict__ unsorted,
                 int32_t* __restrict__ ptr, int32_t* __restrict__ order) {
  extern __shared__ uint32_t bits[];
  __shared__ int64_t longs[THREADS];
  __shared__ int n_long;
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  const int g = segs >= warps * 32 ? 32 : 1;
  if (blockIdx.x == 0 && threadIdx.x == 0) ptr[0] = 0;
  for (int64_t row0 = ((int64_t)blockIdx.x * (THREADS / 32) +
                       (threadIdx.x >> 5)) * g;
       row0 < segs; row0 += warps * g) {
    const int64_t row = row0 + lane;
    uint32_t my_m = 0, my_start = 0;
    if (lane < g && row < segs) {
      my_start = pscan::tile_offset<SCAN_ITEMS>(prefix, tiles, row);
      my_m = counts[row];
      ptr[row + 1] = (int32_t)(my_start + my_m);
    }
    // the rows a warp orders (a block's, below, past WARP_ROW)
    unsigned todo = __ballot_sync(0xffffffffu, my_m > 0 && my_m <= WARP_ROW);
    while (todo) {
      const int src = __ffs(todo) - 1;
      todo &= todo - 1;
      const uint32_t m = __shfl_sync(0xffffffffu, my_m, src);
      const uint32_t start = __shfl_sync(0xffffffffu, my_start, src);
      // PER_LANE of the row's ids a lane at a time, each ranked against
      // all m, streamed 32 at a time through shuffles
      for (uint32_t base = 0; base < m; base += 32 * PER_LANE) {
        int32_t e[PER_LANE];
        uint32_t rank[PER_LANE];
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k) {
          const uint32_t at = base + lane + 32 * k;
          e[k] = at < m ? unsorted[start + at] : INT_MAX;
          rank[k] = 0;
        }
        for (uint32_t t0 = 0; t0 < m; t0 += 32) {
          const int32_t id = t0 + lane < m ? unsorted[start + t0 + lane]
                                           : INT_MAX;
          const uint32_t cnt = min(32u, m - t0);
          for (uint32_t t = 0; t < cnt; ++t) {
            const int32_t x = __shfl_sync(0xffffffffu, id, t);
#pragma unroll
            for (int k = 0; k < PER_LANE; ++k) rank[k] += x < e[k];
          }
        }
#pragma unroll
        for (int k = 0; k < PER_LANE; ++k)
          if (base + lane + 32 * k < m) order[start + rank[k]] = e[k];
      }
    }
  }
  // the long rows among the block's next 256 (rows blockIdx.x + i x
  // gridDim.x, so that long rows close together go to different blocks);
  // n_long and the rows found are the same for every thread: the loop and
  // its barriers are uniform
  for (int64_t i0 = 0; blockIdx.x + i0 * gridDim.x < segs; i0 += THREADS) {
    if (threadIdx.x == 0) n_long = 0;
    __syncthreads();
    const int64_t row = blockIdx.x + (i0 + threadIdx.x) * gridDim.x;
    if (row < segs && counts[row] > WARP_ROW)
      longs[atomicAdd(&n_long, 1)] = row;
    __syncthreads();
    const int found = n_long;
    for (int l = 0; l < found; ++l) {
      const int64_t seg = longs[l];
      const uint32_t m = counts[seg];
      const uint32_t start =
          pscan::tile_offset<SCAN_ITEMS>(prefix, tiles, seg);
      const int64_t first = seg / n * rs;   // the sample's first slot id
      // each thread writes the set bits of a run of consecutive words
      const int64_t per = (window + THREADS - 1) / THREADS;
      const int64_t lo = threadIdx.x * per;
      const int64_t hi = lo + per < window ? lo + per : window;
      uint32_t done = 0;
      for (int64_t w0 = 0; w0 < rs; w0 += window * 32) {
        for (int64_t t = threadIdx.x; t < window; t += THREADS) bits[t] = 0u;
        __syncthreads();
        for (uint32_t at = threadIdx.x; at < m; at += THREADS) {
          const int64_t id = unsorted[start + at] - first - w0;
          if (id >= 0 && id < window * 32)
            atomicOr(bits + (id >> 5), 1u << (id & 31));
        }
        __syncthreads();
        uint32_t set = 0, total;
        for (int64_t t = lo; t < hi; ++t) set += __popc(bits[t]);
        uint32_t at = start + done + block_scan(set, &total);
        for (int64_t t = lo; t < hi; ++t)
          for (uint32_t x = bits[t]; x; x &= x - 1)
            order[at++] = (int32_t)(first + w0 + t * 32 + __ffs(x) - 1);
        done += total;
        __syncthreads();                    // before the next window
      }
    }
    __syncthreads();                        // before n_long is reset
  }
}

inline unsigned grid_for(int64_t threads) {
  int64_t blocks = (threads + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;            // grid-stride beyond
  return (unsigned)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

// the list of `slots` slot ids into (ptr, order), its scratch at w
inline int build_list(const int32_t* idx, int64_t slots, int64_t rs,
                      int64_t n, int64_t segs, uint32_t* w, int32_t* ptr,
                      int32_t* order, cudaStream_t st) {
  const ListLayout L = list_layout(segs, slots);
  cudaError_t e = cudaMemsetAsync(w + L.counts, 0,
                                  (L.ticket + 1) * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  const unsigned slot_blocks = (unsigned)((slots + THREADS - 1) / THREADS);
  count_kernel<<<slot_blocks, THREADS, 0, st>>>(idx, slots, rs, n,
                                                w + L.counts, w + L.arrival);
  scan_kernel<<<(unsigned)pscan::n_tiles<SCAN_ITEMS>(segs), pscan::THREADS,
                0, st>>>(w + L.counts, segs, w + L.prefix, w + L.tiles,
                         w + L.ticket, (long long*)(w + L.totals));
  place_kernel<<<slot_blocks, THREADS, 0, st>>>(
      idx, slots, rs, n, w + L.prefix, w + L.tiles, w + L.arrival,
      (int32_t*)(w + L.unsorted));
  const int64_t window = (rs + 31) / 32 < WINDOW_WORDS ? (rs + 31) / 32
                                                       : WINDOW_WORDS;
  order_kernel<<<grid_for(segs * 32), THREADS, window * sizeof(uint32_t),
                 st>>>(w + L.counts, w + L.prefix, w + L.tiles, segs, rs, n,
                       window, (const int32_t*)(w + L.unsorted), ptr,
                       order);
  return (int)cudaGetLastError();
}

// int32 words of scratch for a list of `slots` ids over `segs` rows: the
// builder's own words, then ptr (segs + 1) and order (slots)
inline int64_t list_words(int64_t segs, int64_t slots) {
  return list_layout(segs, slots).words + segs + 1 + slots;
}

}  // namespace slist
