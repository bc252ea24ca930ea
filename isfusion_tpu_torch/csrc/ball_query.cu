// Ball query for Hopper (sm_90a) — K14-ball.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:77 ball_query (an XLA
// composition that builds the whole (S, N) distance matrix, an integer key
// matrix over it and a top_k over N): for points (B, N, 3), a validity
// mask (B, N) and queries (B, S, 3), the first K points in index order
// whose squared distance to the query is <= r2 (the wrapper passes
// radius ** 2 rounded to float32, what JAX compares against), as (B, S, K)
// int32 indices and a (B, S, K) valid flag. Slots past the in-radius count
// repeat the first in-radius point (valid False); a query with no point in
// its ball takes the nearest point (masked points lie at 1e10; the lowest
// index among equal distances; a NaN distance counts as the nearest, as
// in torch's argmin, so a NaN query takes its first valid point) in every
// slot, valid False: every index is inside [0, N). Each SA level
// of the PointNet++ backbone calls it once (VoteNet: 2,048 queries over
// 40,000 points, K 64, r 0.2; then 1,024 / 2,048, 512 / 1,024 and 256 /
// 512), the vote aggregation once (256 queries over 1,024 votes, K 16).
//
// Bound: the least work is the distances to the points that can lie in
// each ball (those of the cells its cube overlaps, below), 8 float
// operations each; the bytes are the points and queries read once and the
// outputs written once.
//
// Two routes, chosen by the wrapper from the shapes and the radius alone:
// - scan (route 0): a warp a query scans the points in index order, 32 at
//   a time (lane j tests point base + j), and stops as soon as it holds K
//   in-radius points. The in-radius lanes of a chunk append their indices
//   in lane order at the count so far plus the popcount of the lower
//   lanes' ballot bits, so the list is in index order with no sort. Each
//   lane also keeps its nearest point (lowest index among equal
//   distances); a warp whose ball is empty after the whole scan reduces
//   them by shuffles. A ball with fewer than K points reads all N points:
//   SA1's balls hold ~20 points, so each of its 2,048 warps read 40,000.
// - grid (route 1): a cell grid cuts the candidates to the points near the
//   ball. Per call and per sample, with no host synchronisation:
//   1. bucket_kernel: each valid point's cell, c = floor((x - o) * inv)
//      per axis (o: the sample's first point; rounded step by step,
//      clamped to +-2^30), hashed into a power-of-two table of 2^bits
//      buckets (the wrapper takes >= 2N); a masked point goes to bucket
//      2^bits, which no query reads. The cell side 1 / inv is
//      33/32 x rho, rho = sqrt(r2) (1 + 2^-18) >= every |q - p| per axis
//      that the float32 test admits (below).
//   2. the buckets' lists of point ids in increasing order, by the stable
//      CSR builder of stable_lists.cuh (count, scan, place, order).
//   3. ball_grid_kernel, a warp a query: the cells of the query's cube,
//      floor(f(q) -+ a) per axis with f(q) the query's float cell
//      coordinate and a = reach + 2^-12 + |f(q)| 2^-18 (reach = rho x
//      inv, rounded up): 27 cells, up to 64 where rounding adds a layer.
//      A lane a cell hashes it, drops a bucket that a lower cell already
//      has (hash collisions only add candidates: each point is read once),
//      reads its bucket's range; a warp prefix sum places the buckets'
//      ids in the warp's buffer of CAP ids. Then 32 candidates at a time:
//      the exact float32 test, the in-radius ids compacted in place; the
//      first K in index order by each id's rank among them (a warp sort
//      of a few dozen), slots past the count the smallest.
//   A query whose cube spans more than 64 cells or holds more than CAP
//   candidates (a crowded ball: collapsed votes, duplicate points, a
//   radius larger than the room), or whose ball is empty (its nearest
//   point), takes the scan route's code in the same launch: every query
//   answers exactly.
// Why the cut is exact: if the rounded test admits p, each rounded
// square, and so fl(dx)^2 (1 - u), is <= r2, and |qx - px| <= |fl(dx)| /
// (1 - u), so |qx - px| <= sqrt(r2) (1 + 2u) <= rho (u = 2^-24). f(x) =
// fl(fl(x - o) * inv) is monotone in x, and |f(p) - f(q) - (p - q) inv|
// <= ~4u (|f(q)| + rho inv); a's margins (2^-12, |f(q)| 2^-18 = 64u |f(q)|)
// cover that error and the rounding of f(q) -+ a, so floor(f(q) - a) <=
// floor(f(p)) <= floor(f(q) + a): p's cell is one the query reads, and the
// clamp is monotone too. The wrapper takes the scan route where the grid
// cannot hold that: r2 = 0 or not finite, or r2 >= 1e10 (masked points,
// left out of the grid, would then be in the ball).
// Squared distances are (dx*dx + dy*dy) + dz*dz of query minus point,
// rounded step by step (__fsub_rn, __fmul_rn, __fadd_rn): the plain
// version's float32 arithmetic with no FMA contraction, so the in-radius
// tests, and the indices, are the plain version's on both routes.
// Allocates nothing (the grid's scratch comes from the wrapper:
// ball_query_scratch words) and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "stable_lists.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int CAP = 512;           // candidate ids a warp's buffer holds
constexpr int MAX_CELLS = 64;      // cells of a cube a warp reads
constexpr float CELL_LIMIT = 1073741824.f;   // 2^30

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// a coordinate's float cell coordinate and its cell (clamped: monotone)
__device__ __forceinline__ float cell_coord(float x, float o, float inv) {
  return __fmul_rn(__fsub_rn(x, o), inv);
}
__device__ __forceinline__ int cell_of(float f) {
  return (int)fminf(fmaxf(floorf(f), -CELL_LIMIT), CELL_LIMIT);
}
__device__ __forceinline__ uint32_t bucket_of(int cx, int cy, int cz,
                                              uint32_t table_mask) {
  uint32_t h = (uint32_t)cx * 0x9E3779B1u ^ (uint32_t)cy * 0x85EBCA77u ^
               (uint32_t)cz * 0xC2B2AE3Du;
  h ^= h >> 15;
  h *= 0x2C1B3C6Du;
  h ^= h >> 12;
  return h & table_mask;
}

// (d, i) before (bd, bi) in the plain version's argmin order: a NaN
// distance before every number (a NaN query's or a NaN point's), then the
// smaller distance, then the lower index; bi == INT_MAX is no point yet
__device__ __forceinline__ bool nearer(float d, int i, float bd, int bi) {
  if (i == INT_MAX) return false;
  if (bi == INT_MAX) return true;
  if (isnan(d) != isnan(bd)) return isnan(d);
  return d < bd || (!(d > bd) && i < bi);
}

// the scan route for one query (a whole warp): see the header
__device__ void scan_query(const float* __restrict__ p,
                           const uint8_t* __restrict__ m, int64_t n,
                           float qx, float qy, float qz, int k, float r2,
                           int lane, int32_t* __restrict__ o,
                           uint8_t* __restrict__ ov) {
  int cnt = 0, first = 0;
  float near_d = INFINITY;
  int near_i = INT_MAX;
  for (int64_t base = 0; base < n && cnt < k; base += 32) {
    const int64_t i = base + lane;
    bool in = false;
    if (i < n) {
      const float d = m[i] ? sqdist(qx, qy, qz, p[3 * i], p[3 * i + 1],
                                    p[3 * i + 2])
                           : 1e10f;
      in = d <= r2;
      if (nearer(d, (int)i, near_d, near_i)) {
        near_d = d;
        near_i = (int)i;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (ballot != 0u && cnt == 0) first = (int)base + __ffs(ballot) - 1;
    if (in) {
      const int pos = cnt + __popc(ballot & ((1u << lane) - 1u));
      if (pos < k) o[pos] = (int32_t)i;
    }
    cnt += __popc(ballot);
  }
  const int found = cnt < k ? cnt : k;
  if (cnt == 0) {
    // an empty ball: the nearest point, the lowest index among equals
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float d2 = __shfl_down_sync(0xffffffffu, near_d, off);
      const int i2 = __shfl_down_sync(0xffffffffu, near_i, off);
      if (nearer(d2, i2, near_d, near_i)) {
        near_d = d2;
        near_i = i2;
      }
    }
    first = __shfl_sync(0xffffffffu, near_i, 0);
  }
  for (int j = lane; j < k; j += 32) {
    if (j >= found) o[j] = first;
    ov[j] = j < found;
  }
}

__global__ void __launch_bounds__(THREADS)
    ball_scan_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ query,
                     const uint8_t* __restrict__ mask, int64_t n, int64_t s,
                     int64_t total, int k, float r2,
                     int32_t* __restrict__ idx, uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= total) return;                  // whole warps leave together
  const int64_t b = q / s;
  scan_query(xyz + b * n * 3, mask + b * n, n, query[3 * q],
             query[3 * q + 1], query[3 * q + 2], k, r2, lane, idx + q * k,
             valid + q * k);
}

// grid step 1: each point's bucket (2^bits for a masked point)
__global__ void __launch_bounds__(THREADS)
    bucket_kernel(const float* __restrict__ xyz,
                  const uint8_t* __restrict__ mask, int64_t n, int64_t total,
                  float inv, uint32_t table_mask,
                  int32_t* __restrict__ bucket) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= total) return;
  if (!mask[i]) {
    bucket[i] = (int32_t)(table_mask + 1u);
    return;
  }
  const float* o = xyz + i / n * n * 3;
  const float* p = xyz + i * 3;
  bucket[i] = (int32_t)bucket_of(cell_of(cell_coord(p[0], o[0], inv)),
                                 cell_of(cell_coord(p[1], o[1], inv)),
                                 cell_of(cell_coord(p[2], o[2], inv)),
                                 table_mask);
}

// a warp's inclusive prefix sum
__device__ __forceinline__ int warp_inclusive(int x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  return x;
}

// grid step 3: a warp a query (see the header)
__global__ void __launch_bounds__(THREADS)
    ball_grid_kernel(const float* __restrict__ xyz,
                     const float* __restrict__ query,
                     const uint8_t* __restrict__ mask, int64_t n, int64_t s,
                     int64_t total, int k, float r2, float inv, float reach,
                     uint32_t table_mask, const int32_t* __restrict__ ptr,
                     const int32_t* __restrict__ order,
                     int32_t* __restrict__ idx, uint8_t* __restrict__ valid) {
  __shared__ int32_t buffers[WARPS][CAP];
  __shared__ uint32_t cube_buckets[WARPS][MAX_CELLS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t q = (int64_t)blockIdx.x * WARPS + warp;
  if (q >= total) return;                  // no block barrier below
  const int64_t b = q / s;
  const float* p = xyz + b * n * 3;
  const uint8_t* m = mask + b * n;
  const float qx = query[3 * q], qy = query[3 * q + 1],
              qz = query[3 * q + 2];
  int32_t* o = idx + q * k;
  uint8_t* ov = valid + q * k;
  int32_t* buf = buffers[warp];
  uint32_t* cb = cube_buckets[warp];

  // the cube's cells, per axis floor(f(q) - a) .. floor(f(q) + a)
  const float qc[3] = {qx, qy, qz};
  int lo[3];
  int64_t span[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float f = cell_coord(qc[a], p[a], inv);
    const float margin = __fadd_rn(__fadd_rn(reach, 0.000244140625f),
                                   __fmul_rn(fabsf(f), 3.814697265625e-06f));
    lo[a] = cell_of(__fsub_rn(f, margin));
    span[a] = (int64_t)cell_of(__fadd_rn(f, margin)) - lo[a] + 1;
  }
  const int64_t cells = span[0] * span[1] * span[2];
  int cand = CAP + 1;                      // the scan route unless set
  if (cells <= MAX_CELLS) {
    // a lane's cells: lane and lane + 32
    uint32_t bk[2] = {0u, 0u};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = lane + 32 * t;
      if (c < cells) {
        const int cz = c % (int)span[2], cy = c / (int)span[2] % (int)span[1],
                  cx = c / (int)(span[2] * span[1]);
        bk[t] = bucket_of(lo[0] + cx, lo[1] + cy, lo[2] + cz, table_mask);
        cb[c] = bk[t];
      }
    }
    __syncwarp();
    int start[2] = {0, 0}, len[2] = {0, 0};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int c = lane + 32 * t;
      if (c < cells) {
        bool seen = false;
        for (int c2 = 0; c2 < c; ++c2) seen |= cb[c2] == bk[t];
        if (!seen) {
          const int64_t row = b * ((int64_t)table_mask + 2) + bk[t];
          start[t] = ptr[row];
          len[t] = ptr[row + 1] - start[t];
        }
      }
    }
    const int mine = len[0] + len[1];
    const int incl = warp_inclusive(mine, lane);
    cand = __shfl_sync(0xffffffffu, incl, 31);
    if (cand <= CAP) {
      // the buckets' ids, sample-local, bucket after bucket
      const int32_t base = (int32_t)(b * n);
      int at = incl - mine;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        for (int i = 0; i < len[t]; ++i)
          buf[at++] = order[start[t] + i] - base;
    }
  }
  if (cand > CAP) {
    scan_query(p, m, n, qx, qy, qz, k, r2, lane, o, ov);
    return;
  }
  __syncwarp();
  // the exact test, in-radius ids compacted in place (a round reads its
  // ids before the ballot and writes at or below them after it)
  int cnt = 0;
  for (int base = 0; base < cand; base += 32) {
    const int t = base + lane;
    bool in = false;
    int32_t j = 0;
    if (t < cand) {
      j = buf[t];
      in = sqdist(qx, qy, qz, p[3 * j], p[3 * j + 1], p[3 * j + 2]) <= r2;
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (in) buf[cnt + __popc(ballot & ((1u << lane) - 1u))] = j;
    cnt += __popc(ballot);
  }
  __syncwarp();
  if (cnt == 0) {                          // an empty ball: its nearest
    scan_query(p, m, n, qx, qy, qz, k, r2, lane, o, ov);
    return;
  }
  // the first K in index order: each id at its rank among the in-radius
  int first = INT_MAX;
  for (int i = lane; i < cnt; i += 32) {
    const int32_t e = buf[i];
    int rank = 0;
    for (int j = 0; j < cnt; ++j) rank += buf[j] < e;
    if (rank < k) o[rank] = e;
    first = min(first, (int)e);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    first = min(first, __shfl_xor_sync(0xffffffffu, first, off));
  const int found = cnt < k ? cnt : k;
  for (int j = lane; j < k; j += 32) {
    if (j >= found) o[j] = first;
    ov[j] = j < found;
  }
}

unsigned query_blocks(int64_t total) {
  return (unsigned)((total + WARPS - 1) / WARPS);
}

}  // namespace

// int32 words of scratch the grid route needs for b samples of n points
// and a table of 2^table_bits buckets: the buckets' list (stable_lists.cuh)
// over b x (2^table_bits + 1) rows, then each point's bucket.
extern "C" long long ball_query_scratch(long long b, long long n,
                                        long long table_bits) {
  const int64_t rows = b * (((int64_t)1 << table_bits) + 1);
  return slist::list_words(rows, b * n) + b * n;
}

// xyz (b, n, 3), query (b, s, 3) float32, mask (b, n) uint8; idx (b, s, k)
// int32, valid (b, s, k) uint8 (torch.bool). route 0: scan; route 1: the
// grid, with inv (1 / cell side), reach (rho x inv rounded up), a table of
// 2^table_bits buckets and scratch of ball_query_scratch words.
extern "C" int ball_query(const void* xyz, const void* query,
                          const void* mask, long long b, long long n,
                          long long s, long long k, float r2, int route,
                          float inv, float reach, int table_bits,
                          void* scratch, void* idx, void* valid,
                          void* stream) {
  if (b <= 0 || s <= 0 || k <= 0) return 0;
  if (n <= 0 || n >= INT_MAX || k >= INT_MAX || route < 0 || route > 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int64_t total = (int64_t)b * s;
  if (route == 0) {
    ball_scan_kernel<<<query_blocks(total), THREADS, 0, st>>>(
        (const float*)xyz, (const float*)query, (const uint8_t*)mask,
        (int64_t)n, (int64_t)s, total, (int)k, r2, (int32_t*)idx,
        (uint8_t*)valid);
    return (int)cudaGetLastError();
  }
  if (table_bits < 0 || table_bits > 30 || scratch == nullptr ||
      !(inv > 0.f) || !isfinite(inv) || !isfinite(reach))
    return (int)cudaErrorInvalidValue;
  const int64_t slots = (int64_t)b * n;
  const uint32_t table_mask = (uint32_t)(((int64_t)1 << table_bits) - 1);
  const int64_t rows_per = (int64_t)table_mask + 2, rows = b * rows_per;
  if (rows + slots >= INT_MAX) return (int)cudaErrorInvalidValue;
  uint32_t* w = (uint32_t*)scratch;
  int32_t* ptr = (int32_t*)(w + slist::list_layout(rows, slots).words);
  int32_t* order = ptr + rows + 1;
  int32_t* bucket = order + slots;
  bucket_kernel<<<(unsigned)((slots + THREADS - 1) / THREADS), THREADS, 0,
                  st>>>((const float*)xyz, (const uint8_t*)mask,
                        (int64_t)n, slots, inv, table_mask, bucket);
  const int err = slist::build_list(bucket, slots, n, rows_per, rows, w, ptr,
                                    order, st);
  if (err) return err;
  ball_grid_kernel<<<query_blocks(total), THREADS, 0, st>>>(
      (const float*)xyz, (const float*)query, (const uint8_t*)mask,
      (int64_t)n, (int64_t)s, total, (int)k, r2, inv, reach, table_mask, ptr,
      order, (int32_t*)idx, (uint8_t*)valid);
  return (int)cudaGetLastError();
}
