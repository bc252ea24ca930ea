// Dynamic scatter for Hopper (sm_90a) — K2: per-segment max (with its
// gradient) and mean of point rows.
//
// Replaces the XLA compositions isfusion_tpu/ops/voxel.py:169
// dynamic_scatter, ops/scatter.py:28 segment_max and :33 segment_mean:
// for data (P, C) float32 and segment ids (P,) int64 in [0, S), out[s] is
// the max (or mean) over the rows of segment s, 0 for an empty segment.
// DynamicVFE (the IS-Fusion flagship and MVX-Net) takes the voxel mean of
// xyz (C = 3) and the voxel max of every layer's point features (C = 64,
// 128) through it, on every request and train step.
//
// Bound: bytes. Each call reads the rows and ids once and writes the
// segments once: (P * C + P) * 4 + P * 8 + S * C * 4 bytes (the max's
// backward also reads the output and its gradient and writes the rows'
// gradient).
//
// op 0, max: one thread an element atomicMax-es the order-preserving
// unsigned image of the float (f >= 0: bits | 2^31; f < 0: ~bits) into a
// zeroed (S, C) buffer, then a pass decodes it in place (0 = empty segment
// -> 0.0f). A maximum does not depend on the order, so the result equals
// the plain version's (scatter_reduce amax) bit for bit.
// op 1, the max's backward: the gradient of out[s, c] goes in equal parts
// to the rows equal to it. One pass counts the ties of each (s, c) with
// integer atomics, the next writes grad_in = eq * (grad_out / ties) with
// eq 1 or 0, rounded as the plain version rounds (_rn intrinsics; 0 times a
// negative share is -0, as in PyTorch).
// op 2, mean: the segments' rows are counted (integer atomics), their
// offsets scanned (prefix_scan.cuh) and the row ids filled in per segment
// (atomic cursors: in no fixed order). Then one warp a segment walks its
// rows in increasing row id (each step a warp minimum over the segment's
// list) and lane c sums channel c in that order, from 0. The sums' order is
// therefore fixed — the CPU's index_add_ order — so the mean repeats from
// run to run and equals the plain version on the CPU bit for bit; the
// plain version on the card (index_add_, atomics) sums in another order.
// A segment of n rows costs n warp minima over n / 32 loads a lane.
// Allocates nothing (the wrapper passes zeroed buffers and scratch) and
// does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "prefix_scan.cuh"

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0u) return 0.f;               // empty segment
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__global__ void __launch_bounds__(THREADS)
    max_kernel(const float* __restrict__ data, const int64_t* __restrict__ ids,
               int64_t n, int64_t c, uint32_t* __restrict__ keys) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int64_t row = t / c, col = t - row * c;
  atomicMax(keys + ids[row] * c + col, order_key(data[t]));
}

__global__ void __launch_bounds__(THREADS)
    decode_kernel(uint32_t* __restrict__ buf, int64_t n) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t < n) buf[t] = __float_as_uint(key_value(buf[t]));
}

__global__ void __launch_bounds__(THREADS)
    ties_kernel(const float* __restrict__ data, const int64_t* __restrict__ ids,
                const float* __restrict__ out, int64_t n, int64_t c,
                int32_t* __restrict__ ties) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int64_t row = t / c, col = t - row * c;
  const int64_t o = ids[row] * c + col;
  if (data[t] == out[o]) atomicAdd(ties + o, 1);
}

__global__ void __launch_bounds__(THREADS)
    max_grad_kernel(const float* __restrict__ data,
                    const int64_t* __restrict__ ids,
                    const float* __restrict__ out,
                    const float* __restrict__ grad_out,
                    const int32_t* __restrict__ ties, int64_t n, int64_t c,
                    float* __restrict__ grad_in) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (t >= n) return;
  const int64_t row = t / c, col = t - row * c;
  const int64_t o = ids[row] * c + col;
  const float share = __fdiv_rn(grad_out[o], (float)ties[o]);
  grad_in[t] = __fmul_rn(data[t] == out[o] ? 1.f : 0.f, share);
}

__global__ void __launch_bounds__(THREADS)
    count_kernel(const int64_t* __restrict__ ids, int64_t p,
                 uint32_t* __restrict__ counts) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i < p) atomicAdd(counts + ids[i], 1u);
}

__global__ void __launch_bounds__(pscan::THREADS)
    scan_counts_kernel(const uint32_t* __restrict__ counts, int64_t s,
                       uint32_t* __restrict__ prefix,
                       uint32_t* __restrict__ tile_sums) {
  pscan::scan_tile([&](int64_t i) { return counts[i]; }, s, prefix,
                   tile_sums);
}

__global__ void __launch_bounds__(THREADS)
    fill_kernel(const int64_t* __restrict__ ids, int64_t p,
                const uint32_t* __restrict__ prefix,
                const uint32_t* __restrict__ tile_sums,
                uint32_t* __restrict__ cursor, int32_t* __restrict__ members) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= p) return;
  const int64_t seg = ids[i];
  const uint32_t slot = pscan::tile_offset(prefix, tile_sums, seg) +
                        atomicAdd(cursor + seg, 1u);
  members[slot] = (int32_t)i;
}

// one warp a segment; lane l sums channels l, l + 32, ... < c in turn
__global__ void __launch_bounds__(THREADS)
    mean_kernel(const float* __restrict__ data,
                const uint32_t* __restrict__ counts,
                const uint32_t* __restrict__ prefix,
                const uint32_t* __restrict__ tile_sums,
                const int32_t* __restrict__ members, int64_t s, int64_t c,
                float* __restrict__ out) {
  const int64_t seg = ((int64_t)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (seg >= s) return;                  // whole warps leave together
  const uint32_t n = counts[seg];
  const int32_t* list = members + pscan::tile_offset(prefix, tile_sums, seg);
  const float denom = (float)(n > 0u ? n : 1u);
  for (int64_t c0 = 0; c0 < c; c0 += 32) {
    const int64_t col = c0 + lane;
    float acc = 0.f;
    int32_t last = -1;
    for (uint32_t k = 0; k < n; ++k) {
      int32_t best = 0x7fffffff;
      for (uint32_t j = lane; j < n; j += 32) {
        const int32_t r = list[j];
        if (r > last && r < best) best = r;
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1)
        best = min(best, __shfl_xor_sync(0xffffffffu, best, d));
      last = best;
      if (col < c) acc = __fadd_rn(acc, data[(int64_t)best * c + col]);
    }
    if (col < c) out[seg * c + col] = __fdiv_rn(acc, denom);
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// op 0 (max): out (S, C) zeroed by the caller, written in place.
// op 1 (max backward): out = the forward's output, grad_out (S, C), ties
//      (S, C) int32 zeroed, grad_in (P, C).
// op 2 (mean): counts and cursor (S,) zeroed, prefix (S,), tile_sums
//      ceil(S / 2048) words, total one int64 (the rows counted), members
//      (P,) int32, out (S, C).
extern "C" int dynamic_scatter(int op, const void* data, const void* ids,
                               long long p, long long c, long long s,
                               void* out, const void* grad_out, void* ties,
                               void* grad_in, void* counts, void* cursor,
                               void* prefix, void* tile_sums, void* members,
                               void* total, void* stream) {
  if (p < 0 || c <= 0 || s < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t n = (int64_t)p * c;
  if (op == 0) {
    if (n > 0)
      max_kernel<<<blocks_for(n), THREADS, 0, st>>>(
          (const float*)data, (const int64_t*)ids, n, c, (uint32_t*)out);
    if ((int64_t)s * c > 0)
      decode_kernel<<<blocks_for((int64_t)s * c), THREADS, 0, st>>>(
          (uint32_t*)out, (int64_t)s * c);
    return (int)cudaGetLastError();
  }
  if (op == 1) {
    if (n > 0) {
      ties_kernel<<<blocks_for(n), THREADS, 0, st>>>(
          (const float*)data, (const int64_t*)ids, (const float*)out, n, c,
          (int32_t*)ties);
      max_grad_kernel<<<blocks_for(n), THREADS, 0, st>>>(
          (const float*)data, (const int64_t*)ids, (const float*)out,
          (const float*)grad_out, (const int32_t*)ties, n, c,
          (float*)grad_in);
    }
    return (int)cudaGetLastError();
  }
  if (op != 2) return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const int64_t tiles = pscan::n_tiles(s);
  if (p > 0)
    count_kernel<<<blocks_for(p), THREADS, 0, st>>>(
        (const int64_t*)ids, p, (uint32_t*)counts);
  scan_counts_kernel<<<(unsigned)tiles, pscan::THREADS, 0, st>>>(
      (const uint32_t*)counts, s, (uint32_t*)prefix, (uint32_t*)tile_sums);
  pscan::scan_tiles_kernel<<<1, pscan::THREADS, 0, st>>>(
      (uint32_t*)tile_sums, tiles, (long long*)total);
  if (p > 0)
    fill_kernel<<<blocks_for(p), THREADS, 0, st>>>(
        (const int64_t*)ids, p, (const uint32_t*)prefix,
        (const uint32_t*)tile_sums, (uint32_t*)cursor, (int32_t*)members);
  mean_kernel<<<blocks_for((int64_t)s * 32), THREADS, 0, st>>>(
      (const float*)data, (const uint32_t*)counts, (const uint32_t*)prefix,
      (const uint32_t*)tile_sums, (const int32_t*)members, s, c,
      (float*)out);
  return (int)cudaGetLastError();
}
