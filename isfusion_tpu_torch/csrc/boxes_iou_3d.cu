// Pairwise 3D IoU of LiDAR boxes (K10) and pairwise rotated BEV IoU
// (K10-BEV) for Hopper (sm_90a): one tile kernel, templated on BEV, and
// K10-BEV's drain kernel.
//
// K10, entry boxes_iou_3d: out[s, i, j] = IoU of a[s, i] and b[s, j] for
// every sample s, boxes (x, y, z_bottom, dx, dy, dz, yaw) in float32. The
// function of isfusion_tpu/ops/box_ops.py:180 boxes_iou_3d (the JAX
// package's own arithmetic for the reference's iou3d_kernel.cu): the BEV
// intersection by the candidate-point method (the 4 + 4 corners of each
// box inside the other, the 16 edge intersections, sorted by angle around
// their centroid, shoelace; in a frame centred on box a) times the
// vertical overlap of the bottom-origin boxes, over the union clamped at
// 1e-8.
// K10-BEV, entry boxes_iou_bev: the same for BEV boxes (x, y, dx, dy,
// yaw): the function of isfusion_tpu/ops/box_ops.py:154 boxes_iou_bev,
// the intersection area over a1 + a2 - inter clamped at 1e-8, as
// ops/box_ops.py:boxes_iou_bev_ref computes it; no vertical overlap.
// weighted_nms (core/post_processing.py) calls it on the merge's
// candidates of one class against themselves.
//
// Bound: what these inputs need. Each pair reads 14 floats (10 BEV) and
// writes one. Most pairs of the assigner's 200 proposals x 64 GTs a
// sample are far apart, and each pair needs only its cheapest certificate
// that the IoU is 0 (a vertical overlap test, ~4 float32 operations; a
// bounding-circle test, ~8; a separating-axis test, ~52) or else the exact
// intersection (~630; box_ops.iou3d_needed_ops, iou_bev_needed_ops). At
// the assigner's shapes the output's bytes then bound it (4 x 200 x 64
// floats, 0.06 us at 3.35 TB/s), far under one launch's latency.
//
// Design: no copies: a and b are read through their batch and row strides
// (the assigner hands slices of 10- and 9-wide rows). A block takes a
// 16 x 32 tile of one sample's pairs with 8 warps:
// 0. stages its 16 + 32 boxes once in shared memory: centre, sides, cos
//    and sin of the yaw, z range, volume (area for BEV), reach (below) and
//    whether the box is tame (every value finite, |x|, |y|, |z|, |dx|,
//    |dy|, |dz| <= 1e8);
// A. settles the tile's 512 pairs, 2 a thread: a tame pair whose vertical
//    overlap min(top) - max(bottom) is <= 0 (3D only), or whose BEV
//    bounding circles, widened by the point-in-box tolerance, do not meet,
//    has IoU exactly 0 and is written at once; the other pairs are
//    compacted into a list in shared memory (warp ballot, popcount prefix,
//    one shared atomic a warp);
// B. a warp computes one listed pair at a time, a lane a candidate point:
//    lanes 0-3 the corners of a inside b, 4-7 those of b inside a, 8-23
//    the 16 edge intersections; the centroid summed in candidate order by
//    shuffles, each valid point's angle, its place in the angle order by
//    counting (ties: the lower candidate first, torch.argsort's stable
//    order), the shoelace over the order by a warp sum. No per-thread
//    array: nothing in local memory.
// K10 (entry boxes_iou_3d) is that one launch: the assigner's exact pairs
// are few and spread over its tiles (box_ops.iou_tile_counts). K10-BEV
// (entry boxes_iou_bev) spreads step B over the card: a score-sorted merge
// set holds each object up to four times, so its exact pairs bunch on the
// diagonal tiles (on the merge's 808-box class set at most 32 in a tile
// against a mean of 5), which one block's 8 warps would take one after
// another. Its call is three operations on the caller's stream: the list
// counter zeroed (a memset of 8 bytes), the tile kernel doing 0 and A and
// appending the tile's list, by output index, to one list in a scratch
// that the wrapper allocates (one global atomic a tile), then the drain
// kernel: a grid of the resident blocks whose every warp takes a listed
// pair at a time (step B, its two boxes' values formed again from their
// rows by step 0's code). Neither kernel waits on another block.
// Rounding: every step is rounded as the plain version (box_ops.
// rotated_rect_intersection_area) rounds it, in its order (the _rn
// intrinsics keep nvcc from contracting into FMAs): candidates that
// coincide there coincide here, so a degenerate pair (boxes touching
// along an edge or at a corner) whose plain area is exactly 0 is 0 here.
// Why the cuts are exact: the plain version (box_ops.boxes_iou_3d_ref)
// multiplies the BEV area by the overlap clamped at 0; for tame boxes the
// area is finite (every valid candidate lies on the boxes, and the
// shoelace's products stay far from float32's range), so a pair with no
// vertical overlap has IoU exactly 0. The circle cut is K10-NMS's
// (box_ops.bev_circles_meet; the note of csrc/nms_bev.cu says why no
// candidate is valid, so the area is exactly 0). A pair that is not tame
// is always computed.
// Runs on the caller's stream, allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_N = 16;   // rows of a per block
constexpr int TILE_M = 32;   // columns of b per block
constexpr int THREADS = 256;  // 8 warps share the tile's listed pairs
constexpr int WARPS = THREADS / 32;
constexpr int PAIRS = TILE_N * TILE_M / THREADS;  // cut tests a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr float QUAD_TOL = 1e-5f;  // in_quad's tolerance
constexpr float CUT_REL = 1.0f + 1e-4f, CUT_ABS = 1e-3f;
constexpr float TAME = 1e8f;

template <int T>
struct Boxes {
  // vol: the volume, or the area for BEV boxes (lo, hi unused)
  float x[T], y[T], dx[T], dy[T], c[T], s[T], lo[T], hi[T], vol[T],
      reach[T];
  bool tame[T];
};

// a row's columns: 3D (x, y, z, dx, dy, dz, yaw), BEV (x, y, dx, dy, yaw)
template <bool BEV, int T>
__device__ void stage(Boxes<T>& t, const float* row, bool in, int e) {
  constexpr int W = BEV ? 5 : 7, DX = BEV ? 2 : 3, YAW = W - 1;
  float v[W] = {};
  if (in) {
#pragma unroll
    for (int q = 0; q < W; ++q) v[q] = row[q];
  }
  const float dx = v[DX], dy = v[DX + 1];
  t.x[e] = v[0];
  t.y[e] = v[1];
  t.dx[e] = dx;
  t.dy[e] = dy;
  t.c[e] = cosf(v[YAW]);
  t.s[e] = sinf(v[YAW]);
  if (BEV) {
    t.vol[e] = __fmul_rn(dx, dy);
  } else {
    t.lo[e] = v[2];
    t.hi[e] = __fadd_rn(v[2], v[5]);
    t.vol[e] = __fmul_rn(__fmul_rn(dx, dy), v[5]);
  }
  t.reach[e] = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, hypotf(dx, dy)),
                                   __fdiv_rn(QUAD_TOL, fabsf(dx))),
                         __fdiv_rn(QUAD_TOL, fabsf(dy)));
  bool tame = isfinite(v[YAW]);
#pragma unroll
  for (int q = 0; q < YAW; ++q) tame = tame && fabsf(v[q]) <= TAME;
  t.tame[e] = tame;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// the value of arr[k] for a run-time k in 0..3, without indexing a
// register array at run time
__device__ __forceinline__ float pick(const float* arr, int k) {
  float r = arr[0];
#pragma unroll
  for (int q = 1; q < 4; ++q) r = k == q ? arr[q] : r;
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
// box b, centre (bx, by) relative to a's, computed by one warp (every lane
// returns it); scratch: 64 floats of the warp's shared memory. UNROLLED:
// the centroid's and the angle order's 24 candidate shuffles issued at
// once (the valid ones still added in candidate order), shorter for a
// warp alone on its pair (the drain); else a loop over the valid
// candidates, fewer instructions where a block's warps share the issue
// slots
template <bool UNROLLED>
__device__ __forceinline__ float warp_intersection(
    float adx, float ady, float ac, float as, float bx, float by, float bdx,
    float bdy, float bc, float bs, float* scratch, int lane) {
  float ax[4], ay[4], qx[4], qy[4];
  corners(0.f, 0.f, adx, ady, ac, as, ax, ay);
  corners(bx, by, bdx, bdy, bc, bs, qx, qy);
  float px = 0.f, py = 0.f;
  bool ok = false;
  if (lane < 4) {
    px = pick(ax, lane);
    py = pick(ay, lane);
    ok = in_quad(px, py, qx, qy);
  } else if (lane < 8) {
    px = pick(qx, lane - 4);
    py = pick(qy, lane - 4);
    ok = in_quad(px, py, ax, ay);
  } else if (lane < 24) {
    // box_ops._segment_intersections: edge i of a, edge j of b
    const int i = (lane - 8) >> 2, j = (lane - 8) & 3;
    const float x0 = pick(ax, i), y0 = pick(ay, i);
    const float ex = sub(pick(ax, (i + 1) & 3), x0);
    const float ey = sub(pick(ay, (i + 1) & 3), y0);
    const float fx0 = pick(qx, j), fy0 = pick(qy, j);
    const float fx = sub(pick(qx, (j + 1) & 3), fx0);
    const float fy = sub(pick(qy, (j + 1) & 3), fy0);
    const float denom = sub(mul(ex, fy), mul(ey, fx));
    const bool par = fabsf(denom) < 1e-8f;
    const float d = par ? 1.f : denom;
    const float rx = sub(fx0, x0), ry = sub(fy0, y0);
    const float t = __fdiv_rn(sub(mul(rx, fy), mul(ry, fx)), d);
    const float u = __fdiv_rn(sub(mul(rx, ey), mul(ry, ex)), d);
    ok = !par && t >= 0.f && t <= 1.f && u >= 0.f && u <= 1.f;
    px = add(x0, mul(t, ex));
    py = add(y0, mul(t, ey));
  }
  const unsigned valid = __ballot_sync(FULL, ok);
  if (!valid) return 0.f;
  const int n = __popc(valid);
  // the centroid, summed in candidate order
  float sx = 0.f, sy = 0.f;
  if (UNROLLED) {
#pragma unroll
    for (int d = 0; d < 24; ++d) {
      const float xd = __shfl_sync(FULL, px, d);
      const float yd = __shfl_sync(FULL, py, d);
      if ((valid >> d) & 1u) {
        sx = add(sx, xd);
        sy = add(sy, yd);
      }
    }
  } else {
    for (unsigned m = valid; m; m &= m - 1u) {
      const int d = __ffs(m) - 1;
      sx = add(sx, __shfl_sync(FULL, px, d));
      sy = add(sy, __shfl_sync(FULL, py, d));
    }
  }
  const float x = sub(px, __fdiv_rn(sx, (float)n));
  const float y = sub(py, __fdiv_rn(sy, (float)n));
  const float ang = ok ? atan2f(y, x) : 0.f;
  // place in the angle order: valid candidates before, ties by lane
  int rank = 0;
  if (UNROLLED) {
#pragma unroll
    for (int d = 0; d < 24; ++d) {
      const float ad = __shfl_sync(FULL, ang, d);
      rank += ((valid >> d) & 1u) && ((ad < ang) || (ad == ang && d < lane));
    }
  } else {
    for (unsigned m = valid; m; m &= m - 1u) {
      const int d = __ffs(m) - 1;
      const float ad = __shfl_sync(FULL, ang, d);
      rank += (ad < ang) || (ad == ang && d < lane);
    }
  }
  if (ok) {
    scratch[rank] = x;
    scratch[32 + rank] = y;
  }
  __syncwarp();
  float term = 0.f;
  if (ok) {
    const int nx = rank + 1 == n ? 0 : rank + 1;
    term = sub(mul(x, scratch[32 + nx]), mul(scratch[nx], y));
  }
  const float sum = warp_sum(term);
  __syncwarp();  // the scratch is free for the next pair
  return mul(0.5f, fabsf(sum));
}

// the tile kernel's body (each kernel keeps its own name in a profile);
// BEV: step B left to the drain, the tile's list appended to `pairs` at
// `npairs`
template <bool BEV>
__device__ __forceinline__ void boxes_iou(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int64_t n, int64_t m, int64_t asb, int64_t asn,
    int64_t bsb, int64_t bsn, int64_t* __restrict__ pairs,
    unsigned long long* npairs) {
  __shared__ Boxes<TILE_N> rows;
  __shared__ Boxes<TILE_M> cols;
  __shared__ uint16_t list[TILE_N * TILE_M];
  __shared__ float scratch[WARPS][64];
  __shared__ int count;

  const int64_t s = blockIdx.z;
  const int64_t n0 = (int64_t)blockIdx.y * TILE_N;
  const int64_t m0 = (int64_t)blockIdx.x * TILE_M;
  out += s * n * m;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (t < TILE_N) {
    const int64_t i = n0 + t;
    stage<BEV>(rows, a + s * asb + i * asn, i < n, t);
  } else if (t < TILE_N + TILE_M) {
    const int64_t j = m0 + t - TILE_N;
    stage<BEV>(cols, b + s * bsb + j * bsn, j < m, t - TILE_N);
  }
  if (t == 0) count = 0;
  __syncthreads();

  // A. the exact cuts; the rest listed
#pragma unroll
  for (int q = 0; q < PAIRS; ++q) {
    const int p = q * THREADS + t;
    const int r = p / TILE_M, c = p % TILE_M;
    const int64_t i = n0 + r, j = m0 + c;
    const bool in = i < n && j < m;
    bool zero = false;
    if (in && rows.tame[r] && cols.tame[c]) {
      // BEV boxes have no vertical extent: only the circle cut
      const float ov = BEV ? 1.f : sub(fminf(rows.hi[r], cols.hi[c]),
                                       fmaxf(rows.lo[r], cols.lo[c]));
      const float ddx = sub(cols.x[c], rows.x[r]);
      const float ddy = sub(cols.y[c], rows.y[r]);
      const float lim =
          add(mul(add(rows.reach[r], cols.reach[c]), CUT_REL), CUT_ABS);
      zero = ov <= 0.f || add(mul(ddx, ddx), mul(ddy, ddy)) > mul(lim, lim);
    }
    if (zero) out[i * m + j] = 0.f;
    const bool listed = in && !zero;
    const unsigned bal = __ballot_sync(FULL, listed);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&count, __popc(bal));
    base = __shfl_sync(FULL, base, 0);
    if (listed) list[base + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)p;
  }
  __syncthreads();

  const int total = count;
  if (BEV) {
    // the tile's list appended to the global one, by output index
    __shared__ unsigned long long at;
    if (t == 0 && total) at = atomicAdd(npairs, (unsigned long long)total);
    __syncthreads();
    for (int e = t; e < total; e += THREADS) {
      const int p = list[e];
      pairs[at + e] = (s * n + n0 + p / TILE_M) * m + m0 + p % TILE_M;
    }
    return;
  }

  // B. the listed pairs, a warp each
  for (int e = warp; e < total; e += WARPS) {
    const int p = list[e], r = p / TILE_M, c = p % TILE_M;
    const float area = warp_intersection<false>(
        rows.dx[r], rows.dy[r], rows.c[r], rows.s[r], sub(cols.x[c], rows.x[r]),
        sub(cols.y[c], rows.y[r]), cols.dx[c], cols.dy[c], cols.c[c], cols.s[c],
        scratch[warp], lane);
    if (lane == 0) {
      const float hi = fminf(rows.hi[r], cols.hi[c]);
      const float lo = fmaxf(rows.lo[r], cols.lo[c]);
      const float inter = BEV ? area : mul(area, fmaxf(sub(hi, lo), 0.f));
      out[(n0 + r) * m + m0 + c] = __fdiv_rn(
          inter, fmaxf(sub(add(rows.vol[r], cols.vol[c]), inter), 1e-8f));
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    boxes_iou_3d_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ out,
                        int64_t n, int64_t m, int64_t asb, int64_t asn,
                        int64_t bsb, int64_t bsn) {
  boxes_iou<false>(a, b, out, n, m, asb, asn, bsb, bsn, nullptr, nullptr);
}

__global__ void __launch_bounds__(THREADS)
    boxes_iou_bev_kernel(const float* __restrict__ a,
                         const float* __restrict__ b,
                         float* __restrict__ out, int64_t n, int64_t m,
                         int64_t asb, int64_t asn, int64_t bsb, int64_t bsn,
                         int64_t* __restrict__ pairs,
                         unsigned long long* npairs) {
  boxes_iou<true>(a, b, out, n, m, asb, asn, bsb, bsn, pairs, npairs);
}

// K10-BEV's step B over the tile kernel's list: every warp of the grid
// takes a listed pair at a time
__global__ void __launch_bounds__(THREADS)
    boxes_iou_bev_drain(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ out,
                        int64_t n, int64_t m, int64_t asb, int64_t asn,
                        int64_t bsb, int64_t bsn,
                        const int64_t* __restrict__ pairs,
                        const unsigned long long* __restrict__ npairs) {
  __shared__ float scratch[WARPS][64];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long total = *npairs;
  const unsigned long long step = (unsigned long long)gridDim.x * WARPS;
  for (unsigned long long e = (unsigned long long)blockIdx.x * WARPS + warp;
       e < total; e += step) {
    const int64_t o = pairs[e];
    const int64_t j = o % m, si = o / m;
    const int64_t i = si % n, s = si / n;
    Boxes<1> r, c;  // in registers: every index is a constant
    stage<true>(r, a + s * asb + i * asn, true, 0);
    stage<true>(c, b + s * bsb + j * bsn, true, 0);
    const float area = warp_intersection<true>(
        r.dx[0], r.dy[0], r.c[0], r.s[0], sub(c.x[0], r.x[0]),
        sub(c.y[0], r.y[0]), c.dx[0], c.dy[0], c.c[0], c.s[0],
        scratch[warp], lane);
    if (lane == 0)
      out[o] = __fdiv_rn(area,
                         fmaxf(sub(add(r.vol[0], c.vol[0]), area), 1e-8f));
  }
}

// the tile grid of (batch, n, m): false where it is too large
bool tile_grid(long long batch, long long n, long long m, dim3* grid) {
  const long long gy = (n + TILE_N - 1) / TILE_N;
  const long long gx = (m + TILE_M - 1) / TILE_M;
  if (gy > 65535 || batch > 65535 || gx > 0x7fffffffLL) return false;
  *grid = dim3((unsigned)gx, (unsigned)gy, (unsigned)batch);
  return true;
}

}  // namespace

// a (batch, n, >=7) and b (batch, m, >=7) float32 (>=5 for boxes_iou_bev)
// with unit element stride along a row; strides: a's batch and row
// strides, then b's, in elements; out a contiguous (batch, n, m) float32
// tensor.
extern "C" int boxes_iou_3d(const void* a, const void* b, void* out,
                            long long batch, long long n, long long m,
                            const long long* strides, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  dim3 grid;
  if (!tile_grid(batch, n, m, &grid)) return (int)cudaErrorInvalidValue;
  boxes_iou_3d_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)a, (const float*)b, (float*)out, (int64_t)n, (int64_t)m,
      strides[0], strides[1], strides[2], strides[3]);
  return (int)cudaGetLastError();
}

// list: a (1 + batch * n * m) int64 scratch, element 0 the list's count
extern "C" int boxes_iou_bev(const void* a, const void* b, void* out,
                             long long batch, long long n, long long m,
                             const long long* strides, void* list,
                             void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  dim3 grid;
  if (!tile_grid(batch, n, m, &grid)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned long long* npairs = (unsigned long long*)list;
  int64_t* pairs = (int64_t*)list + 1;
  // the drain's grid: the blocks resident at once
  int dev = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, boxes_iou_bev_drain, THREADS, 0);
  if (err == cudaSuccess) err = cudaMemsetAsync(npairs, 0, 8, st);
  if (err != cudaSuccess) return (int)err;
  boxes_iou_bev_kernel<<<grid, THREADS, 0, st>>>(
      (const float*)a, (const float*)b, (float*)out, (int64_t)n, (int64_t)m,
      strides[0], strides[1], strides[2], strides[3], pairs, npairs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  boxes_iou_bev_drain<<<per_sm * sms > 0 ? per_sm * sms : 1, THREADS, 0,
                        st>>>(
      (const float*)a, (const float*)b, (float*)out, (int64_t)n, (int64_t)m,
      strides[0], strides[1], strides[2], strides[3], pairs, npairs);
  return (int)cudaGetLastError();
}
