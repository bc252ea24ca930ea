// Greedy rotated-BEV NMS for Hopper (sm_90a) — K10-NMS.
//
// keep[s, c, i] for sample s, class c, box i: the function of
// isfusion_tpu/ops/box_ops.py:216 nms_bev_mask with :196 _greedy_suppress
// (the reference's nms_gpu): walk the class's boxes by descending score
// (the wrapper's stable sort: ties keep the lower index first); a box that
// is valid and not suppressed is kept, and it suppresses every box whose
// BEV IoU with it (inter / union clamped at 1e-8, NaN where the union is;
// rotated_box.cuh, rounded as the plain version rounds it) exceeds thr.
// Invalid boxes neither keep nor suppress.
//
// Bound: operations, and what these inputs need of them. Each unordered
// pair of a sample's K boxes needs only its cheapest certificate: an area
// ratio (IoU <= min / max area, ~4 float32 operations), a bounding-circle
// test (~8), a separating-axis test (~52), and the IoU (~630,
// IOU3D_OPS_PER_PAIR in ops/box_ops.py) only where the boxes intersect.
// In a scene most pairs are far apart (2% of the pairs' circles meet in a
// nuScenes-like set of 1,000 boxes). The count is
// box_ops.nms_bev_needed_ops, over the card's float32 rate; this kernel
// computes more (box_ops.nms_bev_cut_ops: the IoU for every pair whose
// circles meet). Bytes are negligible. The greedy walk has an inherent
// serial length of K dependent steps per class, taken here as K / 64
// chunks, each resolved on a register word.
//
// Design, two launches on the caller's stream:
// 1. Pairwise pass. The boxes do not depend on the class, so a sample's
//    IoU matrix is computed once for all its classes, as a symmetric
//    suppression bitmask in original index order: mask[s, i, u] bit b is
//    iou(i, 64 u + b) > thr, (K, ceil(K / 64)) 64-bit words. A block takes
//    one 32 x 32 tile (ti, tj) with ti <= tj, so each unordered pair is
//    computed once (528 blocks a sample at K = 1,000, four blocks of four
//    warps an SM: the exact intersection is long serial code, and on a
//    dense set, such as pp-serve's request where 73% of the pairs meet,
//    16 warps an SM hide its latency where one 64 x 64 tile an SM did
//    not). It stages its 32 + 32 boxes with cos, sin, area and reach
//    (below) in shared memory, then
//    A. tests the bounding circles of the tile's 1,024 pairs (8 a thread)
//       and compacts the pairs that pass, i <= j, into a list in shared
//       memory (warp ballot, popcount prefix, one shared atomic per warp);
//    B. computes the exact intersection (rotated_box.cuh, in the frame of
//       the lower-index box) for the listed pairs, 32 consecutive entries a
//       warp, and sets bit (i, j) in a shared row word and bit (j, i) in a
//       shared column word; then writes the tile's 32 row half-words and,
//       off the diagonal, its 32 mirrored half-words.
//    The diagonal bits stay iou(i, i) > thr. The plain version (like the
//    JAX package) computes both orders of a pair, each in its first box's
//    frame. For regular boxes (every value finite, |x|, |y|, |dx|, |dy| <=
//    1e8 as K10's tame boxes, and neither side 0) the two differ only by
//    rounding, as close pairs near the threshold may, and one order gives
//    both bits. A pair with another box may differ by more (a side past
//    float32's range once squared; a zero-area box, which accepts every
//    point of the other box in one order and none in the other), so bit
//    (j, i) is computed in j's frame; such pairs are rare, and an
//    untrained detector's decode makes them.
// 2. Greedy pass (csrc/nms_greedy.cuh): one block per (sample, class),
//    64 sorted positions a step resolved on a register word by one warp
//    while sixteen prepare the next step's bits from the mask rows (1-4
//    rounds a chunk on testing.py's nms_scene_set, at most 65).
//
// Why the circle cut is exact. Take box B (sides dx, dy, circumradius r).
// in_quad (rotated_box.cuh) accepts a point whose cross product with each
// edge is >= -1e-5, i.e. a point within 1e-5 / dy of B's sides along x and
// 1e-5 / dx along y: within reach = r + 1e-5 / |dx| + 1e-5 / |dy| of B's
// centre. A's vertices and edges lie within A's circle. When the centres
// are more than reach_a + reach_b apart, no vertex of either box passes
// the other's test and no edge meets an edge, so no candidate is valid and
// the area is exactly 0; IoU 0 is not > thr for thr >= 0. The pass cuts
// only when d^2 > ((reach_a + reach_b) (1 + 1e-4) + 1e-3)^2: the relative
// and absolute margins hold the float32 rounding of the corners and cross
// products (~1e-6 of the pair's extent) on the safe side. A degenerate
// side (0, inf, NaN) gives an infinite or NaN reach and the pair is
// computed. Edges that are collinear up to rounding can give the full
// computation at most two spurious candidates (one on each of A's two
// parallel edges), whose area is again 0 up to rounding.
//
// Refused (cudaErrorInvalidValue) only past the grids' limits (65,535
// samples, 2^31 - 1 tiles or (sample, class) pairs) or a class whose
// removed words exceed the greedy pass's shared memory (greedy_fits).
// Allocates nothing (the wrapper passes the mask scratch) and does not
// synchronise.
#include <stdint.h>

#include "nms_greedy.cuh"
#include "rotated_box.cuh"

namespace {

constexpr int TILE = 32;      // boxes a tile side: a half mask word
constexpr int THREADS = 128;  // pairwise pass: 4 warps, 4 blocks an SM
constexpr int PAIRS = TILE * TILE / THREADS;  // circle tests a thread
using rotated_box::QUAD_TOL;
using rotated_box::TAME;
constexpr float CUT_REL = 1.0f + 1e-4f, CUT_ABS = 1e-3f;

struct TileBoxes {
  float x[TILE], y[TILE], dx[TILE], dy[TILE], c[TILE], s[TILE], area[TILE],
      reach[TILE];
  bool regular[TILE];  // one order of a pair of these gives both bits
};

__device__ void stage(TileBoxes& t, const float* bx, int64_t i, int64_t k,
                      int e) {
  float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (i < k) {
#pragma unroll
    for (int q = 0; q < 5; ++q) v[q] = bx[i * 5 + q];
  }
  t.x[e] = v[0];
  t.y[e] = v[1];
  t.dx[e] = v[2];
  t.dy[e] = v[3];
  t.c[e] = cosf(v[4]);
  t.s[e] = sinf(v[4]);
  t.area[e] = rotated_box::mul(v[2], v[3]);
  t.reach[e] = 0.5f * hypotf(v[2], v[3]) + QUAD_TOL / fabsf(v[2]) +
               QUAD_TOL / fabsf(v[3]);
  bool regular = isfinite(v[4]) && v[2] != 0.f && v[3] != 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) regular = regular && fabsf(v[q]) <= TAME;
  t.regular[e] = regular;
}

// BEV IoU(p[a], q[b]) > thr in p[a]'s frame, the plain version's order:
// the intersection over the union clamped at 1e-8 as torch's clamp_min
// clamps it (a NaN union, an infinite side times a zero one, gives IoU
// NaN, which is not > thr)
__device__ __forceinline__ bool suppresses(const TileBoxes& p, int a,
                                           const TileBoxes& q, int b,
                                           float thr) {
  using rotated_box::add;
  using rotated_box::sub;
  const float inter = rotated_box::intersection_area_cs(
      p.dx[a], p.dy[a], p.c[a], p.s[a], sub(q.x[b], p.x[a]),
      sub(q.y[b], p.y[a]), q.dx[b], q.dy[b], q.c[b], q.s[b]);
  const float uni = sub(add(p.area[a], q.area[b]), inter);
  return __fdiv_rn(inter, rotated_box::nan_max(uni, 1e-8f)) > thr;
}

// mask32 views the (K, w) 64-bit mask words of a sample as (K, 2 w)
// 32-bit halves: half u holds columns 32 u .. 32 u + 31, one tile's width
__global__ void __launch_bounds__(THREADS, 4)
    nms_mask_kernel(const float* __restrict__ boxes,
                    uint32_t* __restrict__ mask32, int64_t k, int tiles,
                    float thr) {
  __shared__ TileBoxes rows, cols;
  __shared__ uint16_t list[TILE * TILE];
  __shared__ unsigned row_bits[TILE], col_bits[TILE];
  __shared__ int count;

  // the tile (ti, tj), ti <= tj, of the upper-triangular index blockIdx.x
  int ti = 0, rem = blockIdx.x;
  while (rem >= tiles - ti) {
    rem -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rem;
  const bool diag = ti == tj;
  const int64_t s = blockIdx.y, halves = 2 * ((k + 63) / 64);
  const float* bx = boxes + s * k * 5;
  const int64_t i0 = (int64_t)ti * TILE, j0 = (int64_t)tj * TILE;
  const int t = threadIdx.x, lane = t & 31;
  if (t < TILE) {
    stage(rows, bx, i0 + t, k, t);
  } else if (t < 2 * TILE) {
    stage(cols, bx, j0 + t - TILE, k, t - TILE);
  } else if (t < 3 * TILE) {
    row_bits[t - 2 * TILE] = 0u;
    col_bits[t - 2 * TILE] = 0u;
  }
  if (t == 0) count = 0;
  __syncthreads();

  // A. the circle cut, compacted: a warp tests one row against the tile's
  // 32 columns
  for (int q = 0; q < PAIRS; ++q) {
    const int p = q * THREADS + t;
    const int a = p / TILE, b = p % TILE;
    bool meet = false;
    if (i0 + a < k && j0 + b < k && (!diag || a <= b)) {
      const float ddx = cols.x[b] - rows.x[a], ddy = cols.y[b] - rows.y[a];
      const float lim = (rows.reach[a] + cols.reach[b]) * CUT_REL + CUT_ABS;
      meet = !(ddx * ddx + ddy * ddy > lim * lim);  // NaN: computed
    }
    const unsigned bal = __ballot_sync(FULL, meet);
    int base = 0;
    if (lane == 0 && bal) base = atomicAdd(&count, __popc(bal));
    base = __shfl_sync(FULL, base, 0);
    if (meet) list[base + __popc(bal & ((1u << lane) - 1u))] = (uint16_t)p;
  }
  __syncthreads();

  // B. the exact intersection of the listed pairs
  const int n = count;
  for (int e = t; e < n; e += THREADS) {
    const int p = list[e], a = p / TILE, b = p % TILE;
    const bool ab = suppresses(rows, a, cols, b, thr);
    const bool ba = rows.regular[a] && cols.regular[b]
                        ? ab
                        : suppresses(cols, b, rows, a, thr);
    if (ab) atomicOr(&row_bits[a], 1u << b);
    if (ba) atomicOr(&col_bits[b], 1u << a);
  }
  __syncthreads();

  // the tile's row halves and, off the diagonal, its mirrored halves; the
  // last column tile also clears the unused half of an odd tile count
  if (t < TILE) {
    const int64_t i = i0 + t;
    if (i < k) {
      mask32[(s * k + i) * halves + tj] =
          row_bits[t] | (diag ? col_bits[t] : 0u);
      if (tj + 1 == tiles && tiles < halves)
        mask32[(s * k + i) * halves + tiles] = 0u;
    }
  } else if (t < 2 * TILE && !diag) {
    const int64_t j = j0 + t - TILE;
    if (j < k) mask32[(s * k + j) * halves + ti] = col_bits[t - TILE];
  }
}

}  // namespace

// greedy = 0 runs the pairwise pass alone (the suppression bitmask is the
// output; order, valid, keep and strides are not read): the check of the
// bitmask against the plain IoU. strides: the six element strides of
// order (B, C, K) int64 and valid (B, C, K) bool, in that order; keep is a
// contiguous (B, C, K) byte tensor.
extern "C" int nms_bev(const void* boxes, const void* order,
                       const void* valid, void* mask, void* keep,
                       long long batch, long long nc, long long k, float thr,
                       int greedy, const long long* strides, void* stream) {
  if (batch <= 0 || nc <= 0 || k <= 0) return 0;
  const int64_t tiles = (k + TILE - 1) / TILE;
  if (!greedy_fits(batch, nc, k) || batch > 65535 ||
      tiles * (tiles + 1) / 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3((unsigned)(tiles * (tiles + 1) / 2),
                         (unsigned)batch),
                    THREADS, 0, st>>>((const float*)boxes, (uint32_t*)mask,
                                      (int64_t)k, (int)tiles, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !greedy) return (int)err;

  const Strides sd{strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5]};
  return (int)launch_greedy((const uint64_t*)mask, (const int64_t*)order,
                            (const uint8_t*)valid, (uint8_t*)keep,
                            (int64_t)batch, (int64_t)nc, (int64_t)k, sd, st);
}
