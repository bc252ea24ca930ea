// Pairwise 3D IoU of LiDAR boxes for Hopper (sm_90a) — K10.
//
// out[i, j] = IoU of a[i] and b[j], boxes (x, y, z_bottom, dx, dy, dz, yaw)
// in float32. The function of isfusion_tpu/ops/box_ops.py:180 boxes_iou_3d
// (the JAX package's own arithmetic for the reference's iou3d_kernel.cu):
// BEV intersection by the candidate-point method — the 4 + 4 vertices of
// each box inside the other, the 16 edge-edge intersections, sorted by
// angle around their centroid, shoelace area — times the vertical overlap
// of the bottom-origin boxes, over the union clamped at 1e-8. Both boxes
// are first moved into a frame centred on a[i] (IoU is translation
// invariant): corners then carry box-sized, not scene-sized, coordinates,
// and the area keeps float32 precision for boxes far from the origin. The
// plain version (ops/box_ops.py:boxes_iou_3d_ref) does the same.
//
// Bound: operations. Each pair reads 14 floats and writes one, so bytes are
// negligible; the arithmetic per pair (IOU3D_OPS_PER_PAIR in
// ops/box_ops.py: the point-in-box tests, 16 segment intersections, the
// centroid, the angles, the sort of the valid candidates and the shoelace)
// over the card's float32 rate bounds it.
//
// Design: one thread per pair. A block covers 4 rows of a and 64 columns
// of b; the 64 + 4 boxes of the block are staged once in shared memory.
// The at most 24 candidates and their angles live in per-thread arrays; an
// insertion sort (stable, invalid candidates keyed last) orders them. No
// atomics, no cross-thread reduction: every output is written once. Runs
// on the caller's stream, allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_M = 64;  // columns of b per block (threadIdx.x)
constexpr int TILE_N = 4;   // rows of a per block (threadIdx.y)
constexpr int NCAND = 24;

__device__ __forceinline__ void box_corners(float x, float y, float dx,
                                            float dy, float yaw, float* cx,
                                            float* cy) {
  const float c = cosf(yaw), s = sinf(yaw);
  const float ox[4] = {0.5f * dx, 0.5f * dx, -0.5f * dx, -0.5f * dx};
  const float oy[4] = {-0.5f * dy, 0.5f * dy, 0.5f * dy, -0.5f * dy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cx[k] = ox[k] * c + oy[k] * s + x;
    cy[k] = -ox[k] * s + oy[k] * c + y;
  }
}

// point (px, py) inside the convex CCW quad (qx, qy), with tolerance 1e-5
__device__ __forceinline__ bool in_quad(float px, float py, const float* qx,
                                        const float* qy) {
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float abx = qx[f] - qx[e], aby = qy[f] - qy[e];
    const float apx = px - qx[e], apy = py - qy[e];
    inside = inside && (abx * apy - aby * apx >= -1e-5f);
  }
  return inside;
}

__device__ float iou_pair(const float* A, const float* B) {
  // frame centred on box a
  float ax[4], ay[4], bx[4], by[4];
  box_corners(0.f, 0.f, A[3], A[4], A[6], ax, ay);
  box_corners(B[0] - A[0], B[1] - A[1], B[3], B[4], B[6], bx, by);

  float px[NCAND], py[NCAND];
  bool ok[NCAND];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = ax[k];
    py[k] = ay[k];
    ok[k] = in_quad(ax[k], ay[k], bx, by);
    px[4 + k] = bx[k];
    py[4 + k] = by[k];
    ok[4 + k] = in_quad(bx[k], by[k], ax, ay);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float qx = ax[(i + 1) & 3] - ax[i], qy = ay[(i + 1) & 3] - ay[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sx = bx[(j + 1) & 3] - bx[j], sy = by[(j + 1) & 3] - by[j];
      const float denom = qx * sy - qy * sx;
      const bool par = fabsf(denom) < 1e-8f;
      const float d = par ? 1.f : denom;
      const float rx = bx[j] - ax[i], ry = by[j] - ay[i];
      const float t = (rx * sy - ry * sx) / d;
      const float u = (rx * qy - ry * qx) / d;
      const int c = 8 + 4 * i + j;
      ok[c] = !par && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f;
      px[c] = ax[i] + t * qx;
      py[c] = ay[i] + t * qy;
    }
  }

  int cnt = 0;
  float mx = 0.f, my = 0.f;
#pragma unroll
  for (int c = 0; c < NCAND; ++c) {
    if (ok[c]) {
      mx += px[c];
      my += py[c];
      ++cnt;
    }
  }
  float area = 0.f;
  if (cnt > 0) {
    mx /= (float)cnt;
    my /= (float)cnt;
    // valid candidates relative to the centroid, keyed by angle, then a
    // stable insertion sort
    float kx[NCAND], ky[NCAND], ang[NCAND];
    int n = 0;
    for (int c = 0; c < NCAND; ++c) {
      if (!ok[c]) continue;
      const float x = px[c] - mx, y = py[c] - my;
      const float a = atan2f(y, x);
      int p = n++;
      while (p > 0 && ang[p - 1] > a) {
        ang[p] = ang[p - 1];
        kx[p] = kx[p - 1];
        ky[p] = ky[p - 1];
        --p;
      }
      ang[p] = a;
      kx[p] = x;
      ky[p] = y;
    }
    float sum = 0.f;
    for (int c = 0; c < n; ++c) {
      const int d = (c + 1 == n) ? 0 : c + 1;
      sum += kx[c] * ky[d] - kx[d] * ky[c];
    }
    area = 0.5f * fabsf(sum);
  }
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
                            long long n, long long m, void* stream) {
  if (n <= 0 || m <= 0) return 0;
  const long long gy = (n + TILE_N - 1) / TILE_N;
  const long long gx = (m + TILE_M - 1) / TILE_M;
  if (gy > 65535 || gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  boxes_iou_3d_kernel<<<dim3((unsigned)gx, (unsigned)gy),
                        dim3(TILE_M, TILE_N), 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, (int64_t)n,
      (int64_t)m);
  return (int)cudaGetLastError();
}
