// Exclusive prefix sums of uint32 values for Hopper (sm_90a) in one
// launch, for dynamic_voxelize.cu (the points' valid flags, the popcounts
// of its bitmap's words, the points per voxel).
//
// Each block scans its tile of THREADS * ITEMS values (scan_tile), writing
// each value's exclusive prefix inside the tile to prefix[] and the tile's
// total to tile_sums[b]; then the last block to finish (a ticket taken with
// one atomic after a fence: the threadFenceReduction pattern) scans the
// tile totals in place and writes the grand total (finish_scan). The
// prefix of value i is then tile_sums[i / TILE] + prefix[i] (tile_offset),
// for the kernels that run after. The sums are integers added in a fixed
// order; only which block does the second pass depends on scheduling.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pscan {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int ITEMS>
__host__ __device__ constexpr int64_t tile() {
  return (int64_t)THREADS * ITEMS;
}

template <int ITEMS>
inline int64_t n_tiles(int64_t n) {
  return (n + tile<ITEMS>() - 1) / tile<ITEMS>();
}

__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// Inclusive scan of one value per thread across the block; returns the
// thread's inclusive prefix, *block_total the block's sum. Every thread of
// the block must call it.
__device__ __forceinline__ uint32_t block_inclusive(uint32_t x,
                                                    uint32_t* block_total) {
  __shared__ uint32_t warp_sums[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_inclusive(x, lane);
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t w = lane < WARPS ? warp_sums[lane] : 0u;
    w = warp_inclusive(w, lane);
    if (lane < WARPS) warp_sums[lane] = w;
  }
  __syncthreads();
  if (warp > 0) x += warp_sums[warp - 1];
  *block_total = warp_sums[WARPS - 1];
  __syncthreads();        // warp_sums is reused by the next call
  return x;
}

// The first pass for this block's tile; load(i) gives value i < n. Thread
// t takes values t * ITEMS .. t * ITEMS + ITEMS - 1 of the tile.
template <int ITEMS, typename Load>
__device__ __forceinline__ void scan_tile(Load load, int64_t n,
                                          uint32_t* __restrict__ prefix,
                                          uint32_t* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * tile<ITEMS>() +
                       (int64_t)threadIdx.x * ITEMS;
  uint32_t v[ITEMS];
  uint32_t sum = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    v[k] = base + k < n ? load(base + k) : 0u;
    sum += v[k];
  }
  uint32_t total;
  uint32_t excl = block_inclusive(sum, &total) - sum;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    if (base + k < n) prefix[base + k] = excl;
    excl += v[k];
  }
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// The second pass, by the last block of the grid to get here: an exclusive
// scan of the gridDim.x tile totals in place, the grand total into *total.
// *ticket (zero on entry) is zero again on return. Every thread of every
// block calls it after scan_tile.
__device__ __forceinline__ void finish_scan(uint32_t* tile_sums,
                                            unsigned* ticket,
                                            long long* total) {
  __shared__ bool last;
  if (threadIdx.x == 0) {               // the writer of this tile's total
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  volatile uint32_t* sums = tile_sums;  // written by the other blocks
  // thread t scans the run [t * per, t * per + per) of the totals
  const int64_t n = gridDim.x, per = (n + THREADS - 1) / THREADS;
  const int64_t lo = min(n, threadIdx.x * per), hi = min(n, lo + per);
  uint32_t run = 0;
  for (int64_t i = lo; i < hi; ++i) run += sums[i];
  uint32_t all;
  uint32_t excl = block_inclusive(run, &all) - run;
  for (int64_t i = lo; i < hi; ++i) {
    const uint32_t v = sums[i];
    sums[i] = excl;
    excl += v;
  }
  if (threadIdx.x == 0) {
    *total = (long long)all;
    *ticket = 0u;
  }
}

template <int ITEMS>
__device__ __forceinline__ uint32_t tile_offset(
    const uint32_t* __restrict__ prefix,
    const uint32_t* __restrict__ tile_sums, int64_t i) {
  return tile_sums[i / tile<ITEMS>()] + prefix[i];
}

}  // namespace pscan
