// RoI-aware mean pooling for Hopper (sm_90a), forward and backward — K16.
//
// Replaces isfusion_tpu/models/roi_heads/part_aggregation_roi_head.py:26
// roiaware_pool (an XLA composition: every voxel centre moved into every
// RoI's frame, binned to a G x G x G grid, segment sums), the reference's
// roiaware_pool3d CUDA op in its mean mode. For sample b, RoI r, cell q
// and channel ch:
//
//   pooled[b, r, q, ch] = sum over the valid voxels v inside r whose cell
//                         is q of feats[b, v, ch], / max(count, 1)
//   dfeats[b, v, ch]    = sum over r with v inside r of
//                         dpooled[b, r, cell(r, v), ch] / max(count, 1)
//
// Membership and cell follow ops/box_ops.py:box_local_uvw, one rounding a
// step (the _rn intrinsics keep nvcc from contracting into FMAs, division
// is IEEE): rx = px - x, ry = py - y, rz = (pz - z) - dz * 0.5, lx = rx c -
// ry s, ly = rx s + ry c, u = lx / max(dx, 1e-3) + 0.5 (v, w alike),
// inside = all of 0 <= u, v, w < 1; cell = clip(trunc(u G), 0, G - 1) per
// axis, (i G + j) G + k. The wrapper passes each RoI's cos and sin
// (torch's, on the card), so the (r, v) -> cell map equals the plain
// version's there.
//
// Bound (ops/roiaware_pool.py: roiaware_pool_bytes, roiaware_pool_ops):
// at serve (1 x 100 RoIs x <= 40,000 voxels x 20 channels, G = 6) the
// cut's 10 operations for each of the 4e6 pairs, 0.6 us at 67 TFLOP/s,
// and 2.25 MB of centres, mask and output, 0.67 us at 3.35 TB/s.
//
// The cut. The exact test costs three IEEE divisions; a pair runs it only
// if two float32 tests on rx, ry, rz (computed as above, so the very
// values the exact test uses) let it through: the vertical slab |rz| <=
// zlim and the BEV circle rx^2 + ry^2 <= lim^2, with dx' = max(dx, 1e-3)
// (dy', dz' alike), zlim = (dz' 0.5) (1 + 1e-4) + 1e-3, lim = 0.5
// hypot(dx', dy') (1 + 1e-4) + 1e-3, each step rounded once. A comparison
// with NaN lets the pair through. Why no inside pair is cut:
// - u = fl(q + 0.5) with q = fl(lx / dx'). A sum of two floats rounds to 0
//   only if it is exactly 0, and rounding is monotonic, so 0 <= u < 1
//   holds exactly when -0.5 <= q < 0.5. A face centre (u = 0) has q =
//   -0.5; u = 1 - 2^-24, the last cell, has q = 0.5 - 2^-24. Then |lx /
//   dx'| <= 0.5 + 2^-25 (a quotient rounds to -0.5 from at most half an
//   ulp of 0.5 below it), so |lx| <= 0.5 dx' (1 + 2^-24); ly and rz alike.
// - The slab: |rz| <= 0.5 dz' (1 + 2^-24) < zlim, since 0.5 dz' is exact
//   for dz' >= 1e-3 and the product and sum lose at most 2^-23 relative.
// - The circle: lx = fl(fl(rx c) - fl(ry s)) is within 2^-23 |L| of Lx =
//   rx c - ry s (|rx c| + |ry s| <= |L|, L the exact rotation of (rx,
//   ry)), ly alike, so |L| (1 - 2^-22) <= hypot(lx, ly) <= 0.5 hypot(dx',
//   dy') (1 + 2^-24). |L| = |r| sqrt(c^2 + s^2), and cos and sin within 2
//   ulp give c^2 + s^2 >= 1 - 2^-21: |r| <= 0.5 hypot(dx', dy') (1 +
//   2^-20). hypotf (<= 3 ulp) and the rounded products and sums of lim^2
//   and rx^2 + ry^2 lose less than 2^-19 in all, far inside the 1e-4
//   slack. Where a square overflows: lim^2 = inf lets every pair through;
//   rx^2 + ry^2 = inf with a finite lim^2 means |r| > 1.8e19 > lim.
// ops/roiaware_pool.py:roiaware_cut_ref is the plain mirror the CPU tests
// hold against the plain membership.
//
// Design, with no float atomics (two calls agree bit for bit):
// - forward, launch 1 (roiaware_test_kernel): a block per (256-voxel
//   tile, 32-RoI group, sample), 628 blocks at serve. The group's frames
//   and cut limits sit in shared memory; a thread takes one voxel and runs
//   the cut, and the exact test behind it, against each RoI; a warp ballot
//   gives the 32-voxel membership word, and lane j writes RoI j's. The
//   membership bitmap (B, R, ceil(V / 32)) uint32 is written whole (a
//   masked voxel's bit is 0); the cell of each inside pair goes to a
//   (B, R, V) uint16 map, written at the inside pairs only.
// - forward, launch 2 (roiaware_pool_kernel): a block of 1,024 threads per
//   (sample, RoI). (a) Warp w takes a run of the RoI's bitmap words; a
//   block scan of the runs' popcounts places it, and its lanes take the
//   bits of a word (8 words' cells read from the map at once), listing
//   the inside voxels (v G^3 + cell) in voxel order in the RoI's scratch
//   row, as the plain version lists them, and counting each warp's cells
//   in shared memory (integer atomics). (b) A scan of the cell counts and
//   of the warps' counts gives each (warp, cell) its start; each warp
//   places its part of the list into a stable counting sort by cell
//   (__match_any_sync ranks equal cells within 32 entries). (c) Warp w
//   sums the cells that start in [w n / 32, (w + 1) n / 32) of the n
//   sorted entries, lane = channel, 16 rows in flight: each cell from 0
//   in voxel order (__fadd_rn), written as sum / count when its last row
//   is in (the cell of an entry by a binary search of the starts). An
//   empty cell writes 0.
// - backward (roiaware_backward_kernel, one launch): a block of 8 warps
//   per (32-voxel bitmap word, sample). For 128 RoIs at a time it stages
//   their words and the segments of their inside pairs (from the cell
//   map: no test runs again); warp w lists the pairs of its 4 voxels in
//   RoI order and adds dpooled / max(count, 1) (lane = channel, 16 pairs'
//   rows in flight) to the voxels' rows in shared memory, in RoI order;
//   the block then writes its 32 rows together.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TEST_THREADS = 256;         // voxels of a test tile
constexpr int GROUP = 32;                 // RoIs of a test block
constexpr int POOL_THREADS = 1024;        // a pool block: one RoI
constexpr int POOL_WARPS = POOL_THREADS / 32;
constexpr int BWD_THREADS = 256;          // a backward block: 32 voxels
constexpr int BWD_WARPS = BWD_THREADS / 32;
constexpr int BWD_VOXELS = 32 / BWD_WARPS;  // a warp's voxels of the 32
constexpr int BWD_ROIS = 128;             // RoIs a backward block stages
constexpr int ROWS_IN_FLIGHT = 16;        // feature rows a warp loads ahead
constexpr int WORDS_IN_FLIGHT = 8;        // bitmap words a warp lists at once
constexpr int PAIRS_IN_FLIGHT = 16;       // dpooled rows a backward warp loads
constexpr unsigned FULL = 0xffffffffu;
constexpr float CUT_REL = 1.0f + 1e-4f, CUT_ABS = 1e-3f;

struct RoiFrame {
  float x, y, z, hz, dx, dy, dz, c, s;
};

__device__ __forceinline__ RoiFrame load_roi(const float* __restrict__ rois,
                                             const float* __restrict__ trig,
                                             int64_t i) {
  const float* b = rois + 7 * i;
  RoiFrame f;
  f.x = b[0];
  f.y = b[1];
  f.z = b[2];
  f.hz = __fmul_rn(b[5], 0.5f);
  f.dx = fmaxf(b[3], 1e-3f);
  f.dy = fmaxf(b[4], 1e-3f);
  f.dz = fmaxf(b[5], 1e-3f);
  f.c = trig[2 * i];
  f.s = trig[2 * i + 1];
  return f;
}

__device__ __forceinline__ int axis_cell(float u, int g) {
  return min(max((int)__fmul_rn(u, (float)g), 0), g - 1);
}

// the cell of the point at (rx, ry, rz) from RoI f's bottom centre, or -1
// outside it
__device__ __forceinline__ int cell_of(const RoiFrame& f, float rx,
                                       float ry, float rz, int g) {
  const float lx = __fsub_rn(__fmul_rn(rx, f.c), __fmul_rn(ry, f.s));
  const float ly = __fadd_rn(__fmul_rn(rx, f.s), __fmul_rn(ry, f.c));
  const float u = __fadd_rn(__fdiv_rn(lx, f.dx), 0.5f);
  const float v = __fadd_rn(__fdiv_rn(ly, f.dy), 0.5f);
  const float w = __fadd_rn(__fdiv_rn(rz, f.dz), 0.5f);
  if (!(u >= 0.f && u < 1.f && v >= 0.f && v < 1.f && w >= 0.f && w < 1.f))
    return -1;
  return (axis_cell(u, g) * g + axis_cell(v, g)) * g + axis_cell(w, g);
}

// exclusive scan of one int a thread over a block of T threads; *total
// gets the block's sum. Every thread calls it; it synchronises.
template <int T>
__device__ int block_exclusive_scan(int x, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += y;
  }
  __syncthreads();  // warp_tot may still be read by an earlier call
  if (lane == 31) warp_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int t = lane < T / 32 ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    if (lane < T / 32) warp_tot[lane] = t;  // inclusive over warps
  }
  __syncthreads();
  *total = warp_tot[T / 32 - 1];
  return inc - x + (warp ? warp_tot[warp - 1] : 0);
}

__global__ void __launch_bounds__(TEST_THREADS)
    roiaware_test_kernel(const float* __restrict__ rois,
                         const float* __restrict__ trig,
                         const float* __restrict__ centers,
                         const uint8_t* __restrict__ mask,
                         uint32_t* __restrict__ bits,
                         uint16_t* __restrict__ cells, int64_t nr,
                         int64_t nv, int g) {
  __shared__ RoiFrame fr[GROUP];
  __shared__ float zlim[GROUP], lim2[GROUP];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t b = blockIdx.z, r0 = (int64_t)blockIdx.y * GROUP;
  const int ng = (int)min((int64_t)GROUP, nr - r0);
  if (threadIdx.x < ng) {
    const RoiFrame f = load_roi(rois, trig, b * nr + r0 + threadIdx.x);
    fr[threadIdx.x] = f;
    zlim[threadIdx.x] =
        __fadd_rn(__fmul_rn(__fmul_rn(f.dz, 0.5f), CUT_REL), CUT_ABS);
    const float lim = __fadd_rn(
        __fmul_rn(__fmul_rn(0.5f, hypotf(f.dx, f.dy)), CUT_REL), CUT_ABS);
    lim2[threadIdx.x] = __fmul_rn(lim, lim);
  }
  __syncthreads();
  const int64_t vi = (int64_t)blockIdx.x * TEST_THREADS + threadIdx.x;
  float px = 0.f, py = 0.f, pz = 0.f;
  if (vi < nv) {  // loaded beside the mask, not behind it
    const float* p = centers + (b * nv + vi) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  const bool valid = vi < nv && mask[b * nv + vi];
  uint32_t word = 0;
  for (int j = 0; j < ng; ++j) {
    int cell = -1;
    if (valid) {
      const RoiFrame& f = fr[j];
      const float rz = __fsub_rn(__fsub_rn(pz, f.z), f.hz);
      if (!(fabsf(rz) > zlim[j])) {
        const float rx = __fsub_rn(px, f.x), ry = __fsub_rn(py, f.y);
        const float d2 = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
        if (!(d2 > lim2[j])) cell = cell_of(f, rx, ry, rz, g);
      }
    }
    if (cell >= 0) cells[(b * nr + r0 + j) * nv + vi] = (uint16_t)cell;
    const uint32_t bal = __ballot_sync(FULL, cell >= 0);
    if (lane == j) word = bal;
  }
  const int64_t nw = (nv + 31) / 32;
  const int64_t wi = (int64_t)blockIdx.x * (TEST_THREADS / 32) + warp;
  if (wi < nw && lane < ng) bits[(b * nr + r0 + lane) * nw + wi] = word;
}

// the first cell that starts after entry x (G^3 if none): start is
// nondecreasing over the cells, so the cell before it holds entry x
__device__ __forceinline__ int first_cell_after(const int* start, int g3,
                                                int x) {
  int lo = 0, hi = g3;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (start[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(POOL_THREADS)
    roiaware_pool_kernel(const uint32_t* __restrict__ bits,
                         const uint16_t* __restrict__ cells,
                         const float* __restrict__ feats,
                         int* __restrict__ counts, float* __restrict__ out,
                         int* __restrict__ scratch, int64_t nr, int64_t nv,
                         int nc, int g) {
  extern __shared__ int smem[];
  __shared__ int warp_tot[POOL_WARPS];
  __shared__ int seg_end[POOL_WARPS];
  const int g3 = g * g * g;
  int* base = smem;                     // (warps, G^3): counts, then starts
  int* cnt = base + POOL_WARPS * g3;    // (G^3) cell counts
  int* start = cnt + g3;                // (G^3) first entry of each cell
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t br = blockIdx.x, b = br / nr;
  const int64_t nw = (nv + 31) / 32;
  const uint32_t* row_bits = bits + br * nw;
  const uint16_t* row_cells = cells + br * nv;
  int* list = scratch + br * 2 * nv;    // (v G^3 + cell) in voxel order
  int* sorted = list + nv;              // their voxels sorted by cell
  for (int i = tid; i < POOL_WARPS * g3; i += POOL_THREADS) base[i] = 0;

  // (a) list the inside voxels in voxel order: warp w takes a run of the
  // bitmap words, a block scan of the runs' popcounts places it, and its
  // lanes take the bits of a word (WORDS_IN_FLIGHT words' cells loaded at
  // once)
  const unsigned below = (1u << lane) - 1u;
  const int64_t per = (nw + POOL_WARPS - 1) / POOL_WARPS;
  const int64_t w0 = min(nw, per * warp), w1 = min(nw, w0 + per);
  int mine = 0;
  for (int64_t w = w0 + lane; w < w1; w += 32) mine += __popc(row_bits[w]);
#pragma unroll
  for (int d = 16; d; d >>= 1) mine += __shfl_xor_sync(FULL, mine, d);
  int n;
  int at = __shfl_sync(FULL, block_exclusive_scan<POOL_THREADS>(
                                  lane ? 0 : mine, warp_tot, &n), 0);
  if (lane == 0) seg_end[warp] = at + mine;
  int* hist = base + warp * g3;
  for (int64_t i0 = w0; i0 < w1; i0 += 32) {
    const uint32_t word_l = i0 + lane < w1 ? row_bits[i0 + lane] : 0u;
    for (uint32_t nz = __ballot_sync(FULL, word_l != 0u); nz;) {
      uint32_t word[WORDS_IN_FLIGHT];
      int vi[WORDS_IN_FLIGHT], cell[WORDS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < WORDS_IN_FLIGHT; ++u) {
        const int j = __ffs(nz) - 1;  // -1 once nz is spent
        nz &= nz - 1;
        word[u] = __shfl_sync(FULL, word_l, j & 31) & (j >= 0 ? FULL : 0u);
        vi[u] = (int)((i0 + (j & 31)) * 32) + lane;
        cell[u] = (word[u] >> lane) & 1u ? row_cells[vi[u]] : 0;
      }
#pragma unroll
      for (int u = 0; u < WORDS_IN_FLIGHT; ++u) {
        if ((word[u] >> lane) & 1u) {
          list[at + __popc(word[u] & below)] = vi[u] * g3 + cell[u];
          atomicAdd(&hist[cell[u]], 1);
        }
        at += __popc(word[u]);
      }
    }
  }
  __syncthreads();

  // (b) each cell's start, each warp's start within the cell, then a
  // stable counting sort by cell
  for (int c0 = 0; c0 < g3; c0 += POOL_THREADS) {
    const int c = c0 + tid;
    int tot = 0;
    if (c < g3) {
      for (int w = 0; w < POOL_WARPS; ++w) tot += base[w * g3 + c];
      cnt[c] = tot;
    }
    int carry;
    const int ex = block_exclusive_scan<POOL_THREADS>(tot, warp_tot, &carry);
    if (c < g3) start[c] = (c0 ? start[c0 - 1] + cnt[c0 - 1] : 0) + ex;
    __syncthreads();
  }
  for (int c = tid; c < g3; c += POOL_THREADS) {
    int run = start[c];
    for (int w = 0; w < POOL_WARPS; ++w) {
      const int t = base[w * g3 + c];
      base[w * g3 + c] = run;
      run += t;
    }
  }
  __syncthreads();
  const int s1 = seg_end[warp], s0 = warp ? seg_end[warp - 1] : 0;
  for (int i0 = s0; i0 < s1; i0 += 32) {
    const int i = i0 + lane;
    const bool live = i < s1;
    const int e = live ? list[i] : 0;
    const int cell = e % g3;
    const unsigned act = __ballot_sync(FULL, live);
    unsigned peers = 0;
    int rank = 0;
    if (live) {
      peers = __match_any_sync(act, cell);
      rank = __popc(peers & below);
      sorted[base[warp * g3 + cell] + rank] = e / g3;
    }
    __syncwarp();
    if (live && rank == 0) base[warp * g3 + cell] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // (c) the sums, lane = channel: warp w takes the cells that start in
  // [w n / W, (w + 1) n / W) (W warps), a contiguous run of the sorted
  // list, and streams it ROWS_IN_FLIGHT rows at a time; each cell sums
  // from 0 in voxel order and writes sum / count when its last row is in.
  // Empty cells write 0.
  const float* fb = feats + b * nv * nc;
  float* o = out + br * g3 * nc;
  for (int c = tid; c < g3; c += POOL_THREADS) counts[br * g3 + c] = cnt[c];
  for (int c = warp; c < g3; c += POOL_WARPS)
    if (!cnt[c])
      for (int ch = lane; ch < nc; ch += 32) o[c * nc + ch] = 0.f;
  const int lo = min(n, (int)(((int64_t)warp * n + POOL_WARPS - 1) /
                              POOL_WARPS));
  const int hi = min(n, (int)(((int64_t)(warp + 1) * n + POOL_WARPS - 1) /
                              POOL_WARPS));
  // entries [lo, hi) of the list, moved to the starts of the cells that
  // hold them
  const int c_lo = lo < n ? first_cell_after(start, g3, lo) - 1 : g3;
  const int c_hi = hi < n ? first_cell_after(start, g3, hi) - 1 : g3;
  const int e_lo = c_lo < g3 ? (start[c_lo] < lo ? start[c_lo] + cnt[c_lo]
                                                 : start[c_lo]) : n;
  const int e_hi = c_hi < g3 ? (start[c_hi] < hi ? start[c_hi] + cnt[c_hi]
                                                 : start[c_hi]) : n;
  for (int c0 = 0; c0 < nc; c0 += 32) {
    const int ch = c0 + lane;
    float acc = 0.f;
    int cur = -1, end = e_lo;   // the cell being summed, its end
    for (int e0 = e_lo; e0 < e_hi; e0 += 32) {
      const int m = min(32, e_hi - e0);
      const int vl = lane < m ? sorted[e0 + lane] : 0;
      for (int j0 = 0; j0 < m; j0 += ROWS_IN_FLIGHT) {
        float vals[ROWS_IN_FLIGHT];
#pragma unroll
        for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
          const int vj = __shfl_sync(FULL, vl, (j0 + j) & 31);
          vals[j] = j0 + j < m && ch < nc ? fb[(int64_t)vj * nc + ch] : 0.f;
        }
#pragma unroll
        for (int j = 0; j < ROWS_IN_FLIGHT; ++j) {
          const int i = e0 + j0 + j;
          if (j0 + j < m) {
            if (i == end) {  // the next non-empty cell begins
              if (cur >= 0 && ch < nc)
                o[cur * nc + ch] = __fdiv_rn(acc, (float)cnt[cur]);
              cur = first_cell_after(start, g3, i) - 1;
              end = start[cur] + cnt[cur];
              acc = 0.f;
            }
            acc = __fadd_rn(acc, vals[j]);
          }
        }
      }
    }
    if (cur >= 0 && ch < nc) o[cur * nc + ch] = __fdiv_rn(acc, (float)cnt[cur]);
  }
}

__global__ void __launch_bounds__(BWD_THREADS)
    roiaware_backward_kernel(const uint32_t* __restrict__ bits,
                             const uint16_t* __restrict__ cells,
                             const float* __restrict__ dpooled,
                             const int* __restrict__ counts,
                             float* __restrict__ dfeats, int64_t nr,
                             int64_t nv, int nc, int g) {
  __shared__ uint32_t words[BWD_ROIS];
  __shared__ int segs[BWD_ROIS * 32];           // (RoI, voxel) -> segment
  __shared__ uint16_t pairs[BWD_WARPS][BWD_ROIS * BWD_VOXELS];
  extern __shared__ float rows[];               // (32, C + 1)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.y, wi = blockIdx.x, nw = (nv + 31) / 32;
  const int g3 = g * g * g, stride = nc + 1;
  for (int i = tid; i < 32 * stride; i += BWD_THREADS) rows[i] = 0.f;
  const int64_t vi = wi * 32 + lane;
  // warp w's voxels of the word
  const uint32_t vmask = ((1u << BWD_VOXELS) - 1u) << (BWD_VOXELS * warp);
  for (int64_t r0 = 0; r0 < nr; r0 += BWD_ROIS) {
    const int n = (int)min((int64_t)BWD_ROIS, nr - r0);
    __syncthreads();  // the last chunk is no longer read
    if (tid < n) words[tid] = bits[(b * nr + r0 + tid) * nw + wi];
    __syncthreads();
    // lane = voxel: each inside pair's segment (b R + r) G^3 + cell, warp
    // w taking every BWD_WARPS-th RoI
#pragma unroll
    for (int t = 0; t < BWD_ROIS / BWD_WARPS; ++t) {
      const int j = warp + t * BWD_WARPS;
      if (j < n && (words[j] >> lane) & 1u) {
        const int64_t rr = b * nr + r0 + j;
        segs[j * 32 + lane] = (int)(rr * g3 + cells[rr * nv + vi]);
      }
    }
    __syncthreads();
    // warp w's pairs (RoI, one of its voxels) in RoI order, lane = RoI
    int np = 0;
    for (int j0 = 0; j0 < n; j0 += 32) {
      const uint32_t m = j0 + lane < n ? words[j0 + lane] & vmask : 0u;
      const int c = __popc(m);
      int at = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, at, d);
        if (lane >= d) at += y;
      }
      const int total = __shfl_sync(FULL, at, 31);
      at += np - c;
      for (uint32_t k = m; k; k &= k - 1)
        pairs[warp][at++] = (uint16_t)((j0 + lane) * 32 + __ffs(k) - 1);
      np += total;
    }
    __syncwarp();
    // lane = channel: PAIRS_IN_FLIGHT pairs' count and dpooled loaded at
    // once, then dpooled / max(count, 1) added in pair order (each
    // voxel's RoIs in order)
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int ch = c0 + lane;
      for (int i0 = 0; i0 < np; i0 += PAIRS_IN_FLIGHT) {
        float vals[PAIRS_IN_FLIGHT];
#pragma unroll
        for (int u = 0; u < PAIRS_IN_FLIGHT; ++u) {
          vals[u] = 0.f;
          if (i0 + u < np) {
            const int64_t sk = segs[pairs[warp][i0 + u]];
            const int k = counts[sk];
            const float d = ch < nc ? dpooled[sk * nc + ch] : 0.f;
            vals[u] = __fdiv_rn(d, (float)max(k, 1));
          }
        }
#pragma unroll
        for (int u = 0; u < PAIRS_IN_FLIGHT; ++u)
          if (i0 + u < np && ch < nc) {
            float* a = rows + (pairs[warp][i0 + u] & 31) * stride + ch;
            *a = __fadd_rn(*a, vals[u]);
          }
      }
    }
  }
  __syncthreads();
  const int nrow = (int)min((int64_t)32, nv - wi * 32);
  float* d = dfeats + (b * nv + wi * 32) * nc;
  for (int i = tid; i < nrow * nc; i += BWD_THREADS)
    d[i] = rows[(i / nc) * stride + i % nc];
}

}  // namespace

// op 0 forward (two launches): in = feats (B, V, C); the first writes bits
//   (B, R, ceil(V / 32)) uint32 whole and cells (B, R, V) uint16 at the
//   inside pairs only, the second out = pooled (B, R, G^3, C) and counts
//   (B, R, G^3) int32, and scratch (B * R, 2 V) int32: row b R + r starts
//   with the RoI's list, counts[b, r].sum() entries v G^3 + cell in voxel
//   order (its second half: the same entries sorted by cell);
// op 1 backward (one launch): in = dpooled (B, R, G^3, C), bits, cells and
//   counts read, out = dfeats (B, V, C) written whole.
// rois (B, R, 7), trig (B, R, 2) cos and sin, centers (B, V, 3) float32,
// mask (B, V) bool; everything contiguous; V >= 1. The wrapper checks V
// G^3 < 2^31 and the shared memory (roiaware_smem_bytes), which keeps G^3
// far below the 65,536 cells a uint16 holds.
extern "C" int roiaware_pool(int op, const void* rois, const void* trig,
                             const void* centers, const void* mask,
                             const void* in, void* counts, void* out,
                             void* scratch, void* bits, void* cells,
                             long long batch, long long nr, long long nv,
                             long long nc, long long g, void* stream) {
  if (batch <= 0 || nr <= 0 || nc <= 0 || g <= 0 || nv <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const int g3 = (int)(g * g * g);
  if (op == 0) {
    dim3 tgrid((unsigned)((nv + TEST_THREADS - 1) / TEST_THREADS),
               (unsigned)((nr + GROUP - 1) / GROUP), (unsigned)batch);
    roiaware_test_kernel<<<tgrid, TEST_THREADS, 0, st>>>(
        (const float*)rois, (const float*)trig, (const float*)centers,
        (const uint8_t*)mask, (uint32_t*)bits, (uint16_t*)cells, nr, nv,
        (int)g);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)(POOL_WARPS + 2) * g3 * 4;
    if (smem > 46 * 1024) {  // beside 256 bytes of static shared memory
      err = cudaFuncSetAttribute(roiaware_pool_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    roiaware_pool_kernel<<<(unsigned)(batch * nr), POOL_THREADS, smem,
                           st>>>((const uint32_t*)bits,
                                 (const uint16_t*)cells, (const float*)in,
                                 (int*)counts, (float*)out, (int*)scratch,
                                 nr, nv, (int)nc, (int)g);
  } else if (op == 1) {
    const size_t smem = (size_t)32 * (nc + 1) * 4;
    if (smem > 20 * 1024) {  // beside 24.5 KB of static shared memory
      cudaError_t err = cudaFuncSetAttribute(
          roiaware_backward_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    dim3 grid((unsigned)((nv + 31) / 32), (unsigned)batch);
    roiaware_backward_kernel<<<grid, BWD_THREADS, smem, st>>>(
        (const uint32_t*)bits, (const uint16_t*)cells, (const float*)in,
        (const int*)counts, (float*)out, nr, nv, (int)nc, (int)g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
