// Pairwise 3D IoU of LiDAR boxes for Hopper (sm_90a) — K10.
//
// out[s, i, j] = IoU of a[s, i] and b[s, j] for every sample s, boxes
// (x, y, z_bottom, dx, dy, dz, yaw) in float32. The function of
// isfusion_tpu/ops/box_ops.py:180 boxes_iou_3d (the JAX package's own
// arithmetic for the reference's iou3d_kernel.cu): the BEV intersection of
// rotated_box.cuh times the vertical overlap of the bottom-origin boxes,
// over the union clamped at 1e-8.
//
// Bound: operations. Each pair reads 14 floats and writes one, so bytes are
// negligible; the arithmetic per pair (IOU3D_OPS_PER_PAIR in
// ops/box_ops.py: the point-in-box tests, 16 segment intersections, the
// centroid, the angles, the sort of the valid candidates and the shoelace)
// over the card's float32 rate bounds it. At the assigner's shapes (200
// proposals x 64 GTs a sample) one sample fills under half a wave of the
// 132 SMs, so the launch covers every sample of the step at once: the
// grid's z-dimension runs over samples (4 x 200 x 64 pairs, 200 blocks).
//
// Design: one thread per pair. A block covers 4 rows of a and 64 columns
// of b of one sample; the 64 + 4 boxes of the block are staged once in
// shared memory. No atomics, no cross-thread reduction: every output is
// written once. Runs on the caller's stream, allocates nothing and does
// not synchronise.
#include <stdint.h>

#include "rotated_box.cuh"

namespace {

constexpr int TILE_M = 64;  // columns of b per block (threadIdx.x)
constexpr int TILE_N = 4;   // rows of a per block (threadIdx.y)

__device__ float iou_pair(const float* A, const float* B) {
  const float area = rotated_box::intersection_area(
      A[3], A[4], A[6], B[0] - A[0], B[1] - A[1], B[3], B[4], B[6]);
  const float hi = fminf(A[2] + A[5], B[2] + B[5]);
  const float lo = fmaxf(A[2], B[2]);
  const float inter = area * fmaxf(hi - lo, 0.f);
  const float va = A[3] * A[4] * A[5], vb = B[3] * B[4] * B[5];
  return inter / fmaxf(va + vb - inter, 1e-8f);
}

__global__ void boxes_iou_3d_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b,
                                    float* __restrict__ out, int64_t n,
                                    int64_t m) {
  __shared__ float sb[TILE_M * 7];
  __shared__ float sa[TILE_N * 7];
  const int64_t s = blockIdx.z;
  a += s * n * 7;
  b += s * m * 7;
  out += s * n * m;
  const int64_t m0 = (int64_t)blockIdx.x * TILE_M;
  const int64_t n0 = (int64_t)blockIdx.y * TILE_N;
  const int t = threadIdx.y * TILE_M + threadIdx.x;
  for (int e = t; e < TILE_M * 7; e += TILE_M * TILE_N) {
    const int64_t j = m0 + e / 7;
    sb[e] = j < m ? b[m0 * 7 + e] : 0.f;
  }
  for (int e = t; e < TILE_N * 7; e += TILE_M * TILE_N) {
    const int64_t i = n0 + e / 7;
    sa[e] = i < n ? a[n0 * 7 + e] : 0.f;
  }
  __syncthreads();
  const int64_t i = n0 + threadIdx.y, j = m0 + threadIdx.x;
  if (i < n && j < m)
    out[i * m + j] = iou_pair(sa + threadIdx.y * 7, sb + threadIdx.x * 7);
}

}  // namespace

extern "C" int boxes_iou_3d(const void* a, const void* b, void* out,
                            long long batch, long long n, long long m,
                            void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const long long gy = (n + TILE_N - 1) / TILE_N;
  const long long gx = (m + TILE_M - 1) / TILE_M;
  if (gy > 65535 || batch > 65535 || gx > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  boxes_iou_3d_kernel<<<dim3((unsigned)gx, (unsigned)gy, (unsigned)batch),
                        dim3(TILE_M, TILE_N), 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, (int64_t)n,
      (int64_t)m);
  return (int)cudaGetLastError();
}
