// Exclusive prefix sums of uint32 values for Hopper (sm_90a), in two
// passes and no atomics, shared by dynamic_voxelize.cu (popcounts of an
// occupancy bitmap's words) and dynamic_scatter.cu (points per segment).
//
// Pass 1 (scan_tile, inside a caller's kernel): block b scans the TILE
// values [b * TILE, (b + 1) * TILE), writing each value's exclusive prefix
// inside its tile to prefix[] and the tile's total to tile_sums[b]. Pass 2
// (scan_tiles_kernel, one block): an exclusive scan of the tile totals in
// place, the grand total into *total. The prefix of value i is then
// tile_sums[i / TILE] + prefix[i] (tile_offset). Both passes add the same
// integers in a fixed order: the result does not depend on scheduling.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace pscan {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                       // values per thread
constexpr int64_t TILE = THREADS * ITEMS;      // values per block
constexpr int WARPS = THREADS / 32;

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

// Pass 1 for the tile of this block; load(i) gives value i < n.
template <typename Load>
__device__ __forceinline__ void scan_tile(Load load, int64_t n,
                                          uint32_t* __restrict__ prefix,
                                          uint32_t* __restrict__ tile_sums) {
  const int64_t base = (int64_t)blockIdx.x * TILE +
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

// Pass 2: launch with one block of THREADS threads.
__global__ void __launch_bounds__(THREADS)
    scan_tiles_kernel(uint32_t* __restrict__ tile_sums, int64_t n_tiles,
                      long long* __restrict__ total) {
  uint32_t carry = 0;
  for (int64_t start = 0; start < n_tiles; start += THREADS) {
    const int64_t i = start + threadIdx.x;
    const uint32_t v = i < n_tiles ? tile_sums[i] : 0u;
    uint32_t chunk;
    const uint32_t incl = block_inclusive(v, &chunk);
    if (i < n_tiles) tile_sums[i] = carry + incl - v;
    carry += chunk;
  }
  if (threadIdx.x == 0) *total = (long long)carry;
}

__device__ __forceinline__ uint32_t tile_offset(
    const uint32_t* __restrict__ prefix,
    const uint32_t* __restrict__ tile_sums, int64_t i) {
  return tile_sums[i / TILE] + prefix[i];
}

inline int64_t n_tiles(int64_t n) { return (n + TILE - 1) / TILE; }

}  // namespace pscan
