// Rotated-rectangle geometry for Hopper (sm_90a): K10-NMS's per-thread
// intersection (nms_bev.cu), and the rounded primitives, corners and
// point-in-box test that K10 and K10-BEV (boxes_iou_3d.cu, a pair to a
// warp) share with it.
//
// The candidate-point method of the JAX package's
// isfusion_tpu/ops/box_ops.py:122 rotated_rect_intersection_area: the
// 4 + 4 vertices of each box inside the other, the 16 edge-edge
// intersections, sorted by angle around their centroid, shoelace area.
// The pair is first moved into a frame centred on box a (area is
// translation invariant): corners then carry box-sized, not scene-sized,
// coordinates, and the area keeps float32 precision for boxes far from
// the origin. The plain version (ops/box_ops.py:
// rotated_rect_intersection_area) does the same.
//
// Rounding: every step is rounded as the plain version rounds it, in its
// order (the _rn intrinsics keep nvcc from contracting a product and a
// sum into one FMA, which rounds once where the plain version rounds
// twice). Candidates that coincide there coincide here, and a shoelace
// term that is exactly 0 there is exactly 0 here: a degenerate pair (a box
// of zero width or length, boxes touching along an edge) whose plain area
// is 0 is 0 here, where a contracted x y' - x' y of two opposite points
// left a rounding residue that, over a union of 0, read as an IoU > 1.
// nan_max and nan_min are torch.maximum / torch.minimum (and
// clamp_min): NaN if either input is NaN, as the plain version's union
// and overlap are; fmaxf would drop the NaN.
//
// One thread computes one pair: the at most 24 candidates and their angles
// live in per-thread arrays, and a stable insertion sort over the valid
// ones orders them (invalid candidates never enter it). The caller passes
// each box's cos / sin, computed once (intersection_area_cs).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rotated_box {

constexpr int NCAND = 24;
constexpr float QUAD_TOL = 1e-5f;  // in_quad's tolerance
// a tame box: every value finite, |x|, |y|, |dx|, |dy| (|z|, |dz|) <= TAME
// (box_ops.IOU3D_TAME)
constexpr float TAME = 1e8f;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.maximum / torch.minimum: NaN if either input is NaN (one
// instruction each: max.NaN / min.NaN, sm_80 and later)
__device__ __forceinline__ float nan_max(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// CCW corners of a BEV box (x, y, dx, dy) rotated by (c, s), as
// box_ops.rotated_corners_2d forms them, step by step
__device__ __forceinline__ void corners(float x, float y, float dx, float dy,
                                        float c, float s, float* cx,
                                        float* cy) {
  const float hx = mul(dx, 0.5f), hy = mul(dy, 0.5f);
  const float ox[4] = {hx, hx, -hx, -hx};
  const float oy[4] = {-hy, hy, hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    cx[k] = add(add(mul(ox[k], c), mul(oy[k], s)), x);
    cy[k] = add(add(mul(-ox[k], s), mul(oy[k], c)), y);
  }
}

// point (px, py) inside the convex CCW quad (qx, qy), tolerance 1e-5
// (box_ops._point_in_rect)
__device__ __forceinline__ bool in_quad(float px, float py, const float* qx,
                                        const float* qy) {
  bool inside = true;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int f = (e + 1) & 3;
    const float abx = sub(qx[f], qx[e]), aby = sub(qy[f], qy[e]);
    const float apx = sub(px, qx[e]), apy = sub(py, qy[e]);
    inside = inside && sub(mul(abx, apy), mul(aby, apx)) >= -QUAD_TOL;
  }
  return inside;
}

// Intersection area of box a = (0, 0, adx, ady) rotated by (ac, as) and
// box b, whose centre (bx, by) is given relative to a's, rotated by
// (bc, bs)
__device__ inline float intersection_area_cs(float adx, float ady, float ac,
                                             float as, float bx, float by,
                                             float bdx, float bdy, float bc,
                                             float bs) {
  float ax[4], ay[4], qx4[4], qy4[4];
  corners(0.f, 0.f, adx, ady, ac, as, ax, ay);
  corners(bx, by, bdx, bdy, bc, bs, qx4, qy4);

  float px[NCAND], py[NCAND];
  bool ok[NCAND];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    px[k] = ax[k];
    py[k] = ay[k];
    ok[k] = in_quad(ax[k], ay[k], qx4, qy4);
    px[4 + k] = qx4[k];
    py[4 + k] = qy4[k];
    ok[4 + k] = in_quad(qx4[k], qy4[k], ax, ay);
  }
  // box_ops._segment_intersections: edge i of a, edge j of b
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float ex = sub(ax[(i + 1) & 3], ax[i]);
    const float ey = sub(ay[(i + 1) & 3], ay[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float fx = sub(qx4[(j + 1) & 3], qx4[j]);
      const float fy = sub(qy4[(j + 1) & 3], qy4[j]);
      const float denom = sub(mul(ex, fy), mul(ey, fx));
      const bool par = fabsf(denom) < 1e-8f;
      const float d = par ? 1.f : denom;
      const float rx = sub(qx4[j], ax[i]), ry = sub(qy4[j], ay[i]);
      const float t = __fdiv_rn(sub(mul(rx, fy), mul(ry, fx)), d);
      const float u = __fdiv_rn(sub(mul(rx, ey), mul(ry, ex)), d);
      const int c = 8 + 4 * i + j;
      ok[c] = !par && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f;
      px[c] = add(ax[i], mul(t, ex));
      py[c] = add(ay[i], mul(t, ey));
    }
  }

  // the centroid, summed in candidate order
  int cnt = 0;
  float mx = 0.f, my = 0.f;
#pragma unroll
  for (int c = 0; c < NCAND; ++c) {
    if (ok[c]) {
      mx = add(mx, px[c]);
      my = add(my, py[c]);
      ++cnt;
    }
  }
  if (cnt == 0) return 0.f;
  mx = __fdiv_rn(mx, (float)cnt);
  my = __fdiv_rn(my, (float)cnt);
  // valid candidates relative to the centroid, keyed by angle, then a
  // stable insertion sort
  float kx[NCAND], ky[NCAND], ang[NCAND];
  int n = 0;
  for (int c = 0; c < NCAND; ++c) {
    if (!ok[c]) continue;
    const float x = sub(px[c], mx), y = sub(py[c], my);
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
    sum = add(sum, sub(mul(kx[c], ky[d]), mul(kx[d], ky[c])));
  }
  return mul(0.5f, fabsf(sum));
}

}  // namespace rotated_box
