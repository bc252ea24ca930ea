// The pairwise pass of K10-normal (csrc/nms_normal_bev.cu) and of
// K10-circle past its one-launch size (csrc/nms_circle.cu): a sample's
// (K, ceil(K / 64)) 64-bit suppression bitmask in original index order,
// mask[s, i, u] bit b = pred(box i, box 64 u + b), for a predicate that is
// symmetric bit for bit (each kernel's note says why), so each unordered
// pair is computed once.
//
// Design: a warp takes one 32 x 32 tile (a, b), a <= b, of 32-box blocks.
// Lane l holds row box 32 a + l in registers and stages column box 32 b +
// l in the warp's shared memory; the warp walks the 32 column boxes (one
// broadcast read each), each lane ORs its row's 32-bit half-word, and one
// ballot a column gives the mirrored half-word of that column box's row.
// Both are written as 32-bit halves of the 64-bit words, the mirror only
// off the diagonal; the last tile of an odd count of blocks also clears
// its row's unused half. No chain longer than 32 pairs a thread.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int PAIR_WARPS = 8;  // tiles (warps) a block, along b
constexpr int PAIR_THREADS = 32 * PAIR_WARPS;

// P: typename Box; Ctx ctx(s) (per-sample constants); Box load(s, i);
// bool bit(ctx, row box, column box)
template <class P>
__global__ void __launch_bounds__(PAIR_THREADS)
    nms_pairwise_kernel(P p, uint32_t* __restrict__ mask32, int64_t k,
                        int w) {
  __shared__ typename P::Box cols[PAIR_WARPS][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t a = blockIdx.y;
  const int64_t b = (int64_t)blockIdx.x * PAIR_WARPS + warp;
  const int64_t blocks = (k + 31) / 32, halves = 2 * (int64_t)w;
  if (b < a || b >= blocks) return;  // the whole warp
  const int64_t s = blockIdx.z;
  const int64_t i = a * 32 + lane, j = b * 32 + lane;
  const typename P::Ctx ctx = p.ctx(s);
  const typename P::Box row = p.load(s, i < k ? i : k - 1);
  cols[warp][lane] = p.load(s, j < k ? j : k - 1);
  __syncwarp();
  const int ncol = k - b * 32 < 32 ? (int)(k - b * 32) : 32;
  uint32_t word = 0u, mirror = 0u;
#pragma unroll 8
  for (int e = 0; e < 32; ++e) {
    const bool on = e < ncol && i < k && p.bit(ctx, row, cols[warp][e]);
    word |= (uint32_t)on << e;
    const uint32_t m = __ballot_sync(0xffffffffu, on);
    mirror = lane == e ? m : mirror;
  }
  uint32_t* out = mask32 + s * k * halves;
  if (i < k) {
    out[i * halves + b] = word;
    if (b + 1 == blocks && blocks < halves) out[i * halves + blocks] = 0u;
  }
  if (b > a && j < k) out[j * halves + a] = mirror;
}

// one launch of the pass over `batch` samples (refused past 65,535 samples
// or 65,535 blocks of 32 boxes)
template <class P>
cudaError_t launch_pairwise(const P& p, uint64_t* mask, int64_t batch,
                            int64_t k, cudaStream_t st) {
  const int64_t blocks = (k + 31) / 32;
  if (batch > 65535 || blocks > 65535) return cudaErrorInvalidValue;
  const int w = (int)((k + 63) / 64);
  nms_pairwise_kernel<P><<<dim3((unsigned)((blocks + PAIR_WARPS - 1) /
                                           PAIR_WARPS),
                                (unsigned)blocks, (unsigned)batch),
                           PAIR_THREADS, 0, st>>>(p, (uint32_t*)mask, k, w);
  return cudaGetLastError();
}

}  // namespace
