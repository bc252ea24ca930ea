// Greedy circle NMS for Hopper (sm_90a) — K10-circle.
//
// keep[r, i] for box set r, box i: the function of
// isfusion_tpu/ops/box_ops.py:243 circle_nms_mask with :196
// _greedy_suppress (the reference's circle_nms, box3d_nms.py:181): walk
// the set's boxes by descending score (the wrapper's stable sort: ties keep
// the lower index first); a box that is valid and not suppressed is kept,
// and it suppresses every box whose squared centre distance to it is
// <= thr[r] (the squared distance against the threshold as it is, as the
// reference compares them). Invalid boxes neither keep nor suppress. The
// sets are independent: CenterHead.get_bboxes hands one launch every
// (sample, task) pair of a request or an eval batch, each with its task's
// min_radius.
//
// Bound: operations, and few of them. Each unordered pair of a set's K
// boxes needs one squared distance and a comparison (6 float32
// operations; box_ops.circle_nms_ops), 0.75 M operations for a request's
// 6 sets of 500: ~0.01 us at 67 float32 TFLOP/s, under one launch's
// latency. The greedy walk has an inherent serial length of K dependent
// steps, taken as K / 64 chunks on a register word.
//
// Design, two launches on the caller's stream:
// 1. Pairwise pass: one thread per (set, box i, 64-box word u) writes
//    mask[r, i, u] bit b = d2(i, 64 u + b) <= thr[r], the (K, ceil(K / 64))
//    64-bit words K10-NMS's greedy pass reads. d2 is
//    __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) with dx and dy rounded
//    first: without the intrinsics nvcc contracts the sum into an FMA, and
//    a pair exactly on the threshold would flip against the plain version
//    (box_ops.circle_nms_mask_ref). dx = x_j - x_i is the exact negation
//    of x_i - x_j, so the mask is symmetric, diagonal set.
// 2. Greedy pass: csrc/nms_greedy.cuh, one block per set with one score
//    order (the set's own mask in shared memory, (1 + K) * ceil(K / 64) * 8
//    bytes: 32 KB at K = 500; the launch is refused above 227 KB, K >
//    1,344).
// Allocates nothing (the wrapper passes the mask scratch) and does not
// synchronise.
#include <stdint.h>

#include "nms_greedy.cuh"

namespace {

constexpr int CIRCLE_THREADS = 256;

__global__ void __launch_bounds__(CIRCLE_THREADS)
    circle_mask_kernel(const float* __restrict__ centers,
                       const float* __restrict__ thr,
                       uint64_t* __restrict__ mask, int64_t k, int w) {
  const int64_t r = blockIdx.y;
  const int64_t e = (int64_t)blockIdx.x * CIRCLE_THREADS + threadIdx.x;
  if (e >= k * w) return;
  const int64_t i = e / w;
  const int64_t j0 = (e % w) * 64;
  const float* c = centers + r * k * 2;
  const float xi = c[2 * i], yi = c[2 * i + 1], t = thr[r];
  const int n = k - j0 < 64 ? (int)(k - j0) : 64;
  uint64_t bits = 0ull;
  for (int b = 0; b < n; ++b) {
    const float dx = __fsub_rn(c[2 * (j0 + b)], xi);
    const float dy = __fsub_rn(c[2 * (j0 + b) + 1], yi);
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    bits |= (uint64_t)(d2 <= t) << b;
  }
  mask[(r * k + i) * w + (e % w)] = bits;
}

}  // namespace

// centers (R, K, 2) float32 and thr (R,) float32, contiguous; order (R, K)
// int64 and valid (R, K) bool read through their element strides
// (strides: order's two, then valid's two); mask (R, K, ceil(K / 64))
// int64 scratch; keep a contiguous (R, K) byte tensor.
extern "C" int nms_circle(const void* centers, const void* thr,
                          const void* order, const void* valid, void* mask,
                          void* keep, long long sets, long long k,
                          const long long* strides, void* stream) {
  if (sets <= 0 || k <= 0) return 0;
  if (sets > 65535) return (int)cudaErrorInvalidValue;
  const int w = (int)((k + 63) / 64);
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t words = k * w;
  circle_mask_kernel<<<dim3((unsigned)((words + CIRCLE_THREADS - 1) /
                                       CIRCLE_THREADS),
                            (unsigned)sets),
                       CIRCLE_THREADS, 0, st>>>(
      (const float*)centers, (const float*)thr, (uint64_t*)mask, (int64_t)k,
      w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Strides sd{strides[0], 0, strides[1], strides[2], 0, strides[3]};
  return (int)launch_greedy((const uint64_t*)mask, (const int64_t*)order,
                            (const uint8_t*)valid, (uint8_t*)keep,
                            (int64_t)sets, 1, (int64_t)k, sd, st);
}
