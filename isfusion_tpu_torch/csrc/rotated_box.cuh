// Rotated-rectangle intersection for Hopper (sm_90a), K10-NMS's
// (nms_bev.cu; K10, boxes_iou_3d.cu, computes a pair with a warp instead).
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
// One thread computes one pair: the at most 24 candidates and their angles
// live in per-thread arrays, and a stable insertion sort over the valid
// ones orders them (invalid candidates never enter it). The caller passes
// each box's cos / sin, computed once (intersection_area_cs).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rotated_box {

constexpr int NCAND = 24;

// a box's rotation, given by its cos and sin
struct CosSin {
  float c, s;
  __device__ __forceinline__ float2 cos_sin() const {
    return make_float2(c, s);
  }
};

// CCW corners of a BEV box (x, y, dx, dy) rotated by rot, as
// core.bbox.structures does (wx = lx cos + ly sin)
template <class Rot>
__device__ __forceinline__ void corners(float x, float y, float dx, float dy,
                                        Rot rot, float* cx, float* cy) {
  const float2 cs = rot.cos_sin();
  const float c = cs.x, s = cs.y;
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

// Intersection area of box a = (0, 0, adx, ady) rotated by ar and box b,
// whose centre (bx, by) is given relative to a's
template <class Rot>
__device__ inline float intersection(float adx, float ady, Rot ar, float bx,
                                     float by, float bdx, float bdy,
                                     Rot br) {
  float ax[4], ay[4], qx4[4], qy4[4];
  corners(0.f, 0.f, adx, ady, ar, ax, ay);
  corners(bx, by, bdx, bdy, br, qx4, qy4);

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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float qx = ax[(i + 1) & 3] - ax[i], qy = ay[(i + 1) & 3] - ay[i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float sx = qx4[(j + 1) & 3] - qx4[j];
      const float sy = qy4[(j + 1) & 3] - qy4[j];
      const float denom = qx * sy - qy * sx;
      const bool par = fabsf(denom) < 1e-8f;
      const float d = par ? 1.f : denom;
      const float rx = qx4[j] - ax[i], ry = qy4[j] - ay[i];
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
  if (cnt == 0) return 0.f;
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
  return 0.5f * fabsf(sum);
}

// with each box's cos and sin (ac, as), (bc, bs)
__device__ __forceinline__ float intersection_area_cs(
    float adx, float ady, float ac, float as, float bx, float by, float bdx,
    float bdy, float bc, float bs) {
  return intersection(adx, ady, CosSin{ac, as}, bx, by, bdx, bdy,
                      CosSin{bc, bs});
}

}  // namespace rotated_box
