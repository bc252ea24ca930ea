// Dynamic voxelization for Hopper (sm_90a) — K1 — and each voxel's point
// list.
//
// Replaces the XLA composition isfusion_tpu/ops/voxel.py:125
// voxelize_dynamic (with :34 compute_voxel_coords and ops/scatter.py:54
// unique_with_ranks): for points (B, P, C) float32 and a validity mask
// (B, P), each point's voxel coordinates floor((xyz - low) * inv), the
// sorted table of the occupied voxels as (b, z, y, x) int32 rows ordered by
// batch and then by the z-major linear id, and each point's row in that
// table (int64, -1 for a masked or out-of-range point). It also emits each
// voxel's points in CSR form: voxel_ptr (Nv + 1) int32 offsets and
// point_order, the valid points' compacted indices (their order in
// points[row >= 0]) grouped by voxel, each voxel's in increasing order — a
// stable sort of the valid points by voxel. K2 (dynamic_scatter.cu) reads
// that list for every segment max, its backward and the mean. The
// IS-Fusion flagship and MVX-Net run it on every request and train step
// (ops/voxel.py:voxelize_dynamic). No cap: every occupied voxel is kept.
// op 1 builds the same list from given segment ids (ops/voxel.py:
// segment_layout), for a K2 caller that has none.
//
// Bound: bytes. The function reads xyz and the mask once and writes the
// rows, the table and the list once: (12 + 1 + 8 + 4) bytes a point + 20 a
// voxel, about 7.6 MB at the flagship's 200,000 points and 126,000 voxels.
//
// Design: a two-level occupancy bitmap that is never scanned whole, in a
// workspace that the wrapper keeps per device and stream, zeroed once when
// it is allocated; every call leaves it zeroed again (the order pass clears
// each voxel's bitmap words and count, each scan's last block its
// ticket). Six kernels, in stream order:
//  1. mark, a thread a point: a valid point sets its voxel's bit in L0
//     (one bit a cell, atomicOr, order-free) and, if it found the word
//     empty, the word's bit in L1 (one bit an L0 word); it keeps its linear
//     id in rows[], and the block scans the points' valid flags (each valid
//     point's compacted index, and their count).
//  2. scan_l1, a thread a group of 32 L0 words (an L1 word; 1/1024 of the
//     grid's cells, 40 KB a flagship sample): the group's voxels (the
//     popcounts of the occupied words, the only ones read), scanned: each
//     group's first row, and the total Nv.
//  3. rows, a thread a point: its row is its group's first row plus the
//     voxels of the occupied words before its own in the group plus the
//     popcount of the lower bits of its word. It writes its voxel's
//     (b, z, y, x) at that row (a voxel's points write the same 16 bytes):
//     the ranks of a bitmap are the sorted order of the linear ids, so the
//     table comes out sorted. It counts the point in its voxel (an integer
//     atomic, order-free) and keeps the count the atomic returned (its
//     arrival rank in the voxel: in no fixed order).
//  4-6. the list: a scan of the counts gives voxel_ptr; place puts each
//     valid point's compacted index into its voxel's slice at its arrival
//     rank; order sorts each slice into increasing order: a thread a slice
//     of <= SMALL points, a warp a slice of <= MEDIUM, the block a longer
//     one (each element's rank is the count of smaller ones in the slice;
//     the values are distinct). So the list is the stable order, the same
//     on every run.
// The scans take one launch each (prefix_scan.cuh: the last block scans
// the tile totals). Bytes moved beyond the function's: the L1 words read
// and their prefixes written and read (12 bytes an L1 word), the occupied
// L0 words read again (a point reads its group's), each valid point's key
// read again (8 bytes), its table row written again where a voxel has more
// than one point, its compacted index, list entry, count and arrival rank
// (about 24 bytes, plus the 32-byte sectors that the scattered
// updates touch), each voxel's table row read again to clear its words.
// The voxel and valid-point counts are copied to pinned host memory and
// the call waits for them (its one synchronisation; torch.unique syncs
// too); the wrapper returns views of one output buffer sized for the worst
// case.
//
// Two calls in flight are kept apart by the wrapper: a workspace belongs to
// one (device, stream) pair, and the calls on one stream run in order.
//
// Exactness: the coordinates are floor(__fmul_rn(__fsub_rn(x, low), inv))
// with inv = 1 / voxel_size rounded once from float64 to float32 by the
// wrapper, the plain version's float32 arithmetic with no contraction into
// an FMA, so a point on a voxel face lands where the plain version puts
// it. The range test is made on the floored floats (0 <= f < n), which
// equals the plain version's test on their int32 casts for finite points.
// Every number is an integer computed in an order that cannot change the
// result. Allocates nothing; op 0 synchronises its stream once, at the
// end.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "prefix_scan.cuh"

namespace {

constexpr int THREADS = pscan::THREADS;
constexpr int SCAN_ITEMS = 8;      // counts a thread scans
constexpr int SMALL = 16;          // a thread sorts a slice this long
constexpr int MEDIUM = 256;        // a warp sorts a slice this long
constexpr int PER_LANE = MEDIUM / 32;
constexpr int PER_THREAD = 4;      // a block ranks THREADS * 4 at a time
constexpr int LONG_TILE = 2048;    // slice values staged in shared memory
constexpr unsigned FULL = 0xffffffffu;

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

inline int64_t align4(int64_t words) { return (words + 3) & ~int64_t(3); }

__device__ __forceinline__ uint32_t below(uint32_t word, int64_t bit) {
  return word & ((1u << (bit & 31)) - 1u);
}

// Where the workspace's arrays lie (offsets in 4-byte words). The zeroed
// region holds the scans' tickets, L0, L1 and the counts; the
// scratch region the rest, its first 8 words the totals (int64: valid
// points, voxels, points listed).
struct Layout {
  int64_t tickets, l0, l1, counts, zeroed;
  int64_t totals, vprefix, vtile, l1prefix, l1tile, cprefix, ctile,
      arrival, unsorted, scratch;
  int64_t n_l1;
};

Layout make_layout(int op, int64_t n_pts, int64_t segs, int64_t cells) {
  Layout L{};
  const int64_t n_l0 = op == 0 ? (cells + 31) / 32 : 0;
  L.n_l1 = op == 0 ? (n_l0 + 31) / 32 : 0;
  int64_t at = 0;
  auto take = [&at](int64_t words) {
    const int64_t o = at;
    at += align4(words);
    return o;
  };
  L.tickets = take(4);
  L.l0 = take(n_l0);
  L.l1 = take(L.n_l1);
  L.counts = take(segs);
  L.zeroed = at;
  at = 0;
  L.totals = take(8);
  L.vprefix = take(op == 0 ? n_pts : 0);
  L.vtile = take(op == 0 ? pscan::n_tiles<1>(n_pts) + 1 : 0);
  L.l1prefix = take(L.n_l1);
  L.l1tile = take(pscan::n_tiles<1>(L.n_l1) + 1);
  L.cprefix = take(segs);
  L.ctile = take(pscan::n_tiles<SCAN_ITEMS>(segs) + 1);
  L.arrival = take(n_pts);
  L.unsorted = take(n_pts);
  L.scratch = at;
  return L;
}

// 1. a thread a point
__global__ void __launch_bounds__(THREADS)
    mark_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                int64_t n_pts, uint32_t p, int64_t c, float lx, float ly,
                float lz, float ix, float iy, float iz, int nx, int ny,
                int nz, uint32_t* __restrict__ l0, uint32_t* __restrict__ l1,
                int64_t* __restrict__ keys, uint32_t* __restrict__ vprefix,
                uint32_t* vtile, unsigned* ticket, long long* n_valid) {
  pscan::scan_tile<1>(
      [&](int64_t i) -> uint32_t {
        const float* q = pts + i * c;
        const float fx = floorf(__fmul_rn(__fsub_rn(q[0], lx), ix));
        const float fy = floorf(__fmul_rn(__fsub_rn(q[1], ly), iy));
        const float fz = floorf(__fmul_rn(__fsub_rn(q[2], lz), iz));
        if (!(mask[i] && fx >= 0.f && fx < (float)nx && fy >= 0.f &&
              fy < (float)ny && fz >= 0.f && fz < (float)nz)) {
          keys[i] = -1;
          return 0u;
        }
        const int64_t b = (uint32_t)i / p;
        const int64_t key =
            ((b * nz + (int64_t)fz) * ny + (int64_t)fy) * nx + (int64_t)fx;
        const int64_t w = key >> 5;
        if (atomicOr(l0 + w, 1u << (key & 31)) == 0u)   // the word's first
          atomicOr(l1 + (w >> 5), 1u << (w & 31));
        keys[i] = key;
        return 1u;
      },
      n_pts, vprefix, vtile);
  pscan::finish_scan(vtile, ticket, n_valid);
}

// The voxels of the words of group g that "bits" marks: the loads are
// unrolled over the 32 words (predicated on the bits), so they are issued
// together.
__device__ __forceinline__ uint32_t group_voxels(
    const uint32_t* __restrict__ l0, int64_t g, uint32_t bits) {
  uint32_t words[32];
#pragma unroll
  for (int j = 0; j < 32; ++j)
    words[j] = (bits >> j) & 1u ? l0[g * 32 + j] : 0u;
  uint32_t voxels = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) voxels += __popc(words[j]);
  return voxels;
}

// 2. a thread a group of 32 L0 words (an L1 word): its voxels, scanned
__global__ void __launch_bounds__(THREADS)
    scan_l1_kernel(const uint32_t* __restrict__ l0,
                   const uint32_t* __restrict__ l1, int64_t n_l1,
                   uint32_t* __restrict__ prefix, uint32_t* tile_sums,
                   unsigned* ticket, long long* n_voxels) {
  pscan::scan_tile<1>([&](int64_t g) { return group_voxels(l0, g, l1[g]); },
                      n_l1, prefix, tile_sums);
  pscan::finish_scan(tile_sums, ticket, n_voxels);
}

// 3. a thread a point: its row (its group's first voxel, the voxels of the
// occupied words before its own in the group, the popcount of the lower
// bits of its word) and its voxel's (b, z, y, x) at that row (the points
// of a voxel write the same 16 bytes: the ranks of a bitmap are the sorted
// order of the linear ids, so the table comes out sorted); the points of
// each voxel counted
__global__ void __launch_bounds__(THREADS)
    rows_kernel(const uint32_t* __restrict__ l0,
                const uint32_t* __restrict__ l1,
                const uint32_t* __restrict__ l1prefix,
                const uint32_t* __restrict__ l1tile, int64_t n_pts,
                uint32_t p, uint32_t cells, int nx, int ny,
                int64_t* __restrict__ rows, int32_t* __restrict__ table,
                uint32_t* __restrict__ counts, uint32_t* __restrict__ arrival) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_pts) return;
  const int64_t key = rows[i];
  if (key < 0) return;
  const int64_t w = key >> 5, g = key >> 10;
  const uint32_t row = pscan::tile_offset<1>(l1prefix, l1tile, g) +
                       group_voxels(l0, g, below(l1[g], w)) +
                       __popc(below(l0[w], key));
  rows[i] = row;
  const int64_t b = (uint32_t)i / p;
  const uint32_t local = (uint32_t)(key - b * cells);
  const uint32_t zy = local / nx, x = local - zy * nx;
  const uint32_t z = zy / ny, y = zy - z * ny;
  reinterpret_cast<int4*>(table)[row] =
      make_int4((int32_t)b, (int32_t)z, (int32_t)y, (int32_t)x);
  arrival[i] = atomicAdd(counts + row, 1u);
}

// op 1: the points of each segment counted (ids outside [0, S) skipped)
__global__ void __launch_bounds__(THREADS)
    count_kernel(const int64_t* __restrict__ ids, int64_t n, int64_t segs,
                 uint32_t* __restrict__ counts,
                 uint32_t* __restrict__ arrival) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t id = ids[i];
  if (id >= 0 && id < segs) arrival[i] = atomicAdd(counts + id, 1u);
}

// 5. the counts of the segments below *segs_dev (or segs_bound), scanned
__global__ void __launch_bounds__(THREADS)
    scan_counts_kernel(const uint32_t* __restrict__ counts,
                       const long long* __restrict__ segs_dev,
                       int64_t segs_bound, uint32_t* __restrict__ prefix,
                       uint32_t* tile_sums, unsigned* ticket,
                       long long* listed) {
  const int64_t segs = segs_dev ? *segs_dev : segs_bound;
  pscan::scan_tile<SCAN_ITEMS>(
      [&](int64_t i) { return i < segs ? counts[i] : 0u; }, segs_bound,
      prefix, tile_sums);
  pscan::finish_scan(tile_sums, ticket, listed);
}

// 6. each listed point's value (its compacted index: the valid points'
// scan, or its own index) into its segment's slice, in no fixed order
__global__ void __launch_bounds__(THREADS)
    place_kernel(const int64_t* __restrict__ ids, int64_t n,
                 const long long* __restrict__ segs_dev, int64_t segs_bound,
                 const uint32_t* __restrict__ vprefix,
                 const uint32_t* __restrict__ vtile,
                 const uint32_t* __restrict__ cprefix,
                 const uint32_t* __restrict__ ctile,
                 const uint32_t* __restrict__ arrival,
                 int32_t* __restrict__ unsorted) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const int64_t id = ids[i];
  const int64_t segs = segs_dev ? *segs_dev : segs_bound;
  if (id < 0 || id >= segs) return;
  const uint32_t v = vprefix ? pscan::tile_offset<1>(vprefix, vtile, i)
                             : (uint32_t)i;
  const uint32_t pos = pscan::tile_offset<SCAN_ITEMS>(cprefix, ctile, id) +
                       arrival[i];
  unsorted[pos] = (int32_t)v;
}

// 7. a thread a segment: its offsets, the zero invariant of its count and
// (and, for a voxel, of its bitmap words), and its slice sorted
// when short; a warp sorts the medium slices
// of its 32 segments together, the block the long slices of its THREADS
// segments. Every thread reaches the ballot and the barriers.
__global__ void __launch_bounds__(THREADS)
    order_kernel(uint32_t* __restrict__ counts,
                 const uint32_t* __restrict__ cprefix,
                 const uint32_t* __restrict__ ctile,
                 const long long* __restrict__ segs_dev, int64_t segs_bound,
                 const int32_t* __restrict__ unsorted,
                 int32_t* __restrict__ ptr, int32_t* __restrict__ order,
                 const int32_t* __restrict__ table, int nx, int ny, int nz,
                 uint32_t* __restrict__ l0, uint32_t* __restrict__ l1) {
  __shared__ uint32_t long_start[THREADS], long_n[THREADS];
  __shared__ int n_long;
  __shared__ int32_t tile[LONG_TILE];
  const int64_t v = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int64_t segs = segs_dev ? *segs_dev : segs_bound;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  uint32_t n = 0, start = 0;
  if (v == 0) ptr[0] = 0;
  if (v < segs) {
    n = counts[v];
    start = pscan::tile_offset<SCAN_ITEMS>(cprefix, ctile, v);
    ptr[v + 1] = (int32_t)(start + n);
    counts[v] = 0u;
    if (table) {        // its bitmap words (the last readers are done)
      const int4 t = reinterpret_cast<const int4*>(table)[v];
      const int64_t key =
          (((int64_t)t.x * nz + t.y) * ny + t.z) * (int64_t)nx + t.w;
      l0[key >> 5] = 0u;            // every writer stores the same 0
      l1[key >> 10] = 0u;
    }
    if (n <= SMALL) {
      for (uint32_t k = 0; k < n; ++k) {
        const int32_t x = unsorted[start + k];
        uint32_t rank = 0;
        for (uint32_t j = 0; j < n; ++j) rank += unsorted[start + j] < x;
        order[start + rank] = x;
      }
    } else if (n > MEDIUM) {
      const int slot = atomicAdd(&n_long, 1);
      long_start[slot] = start;
      long_n[slot] = n;
    }
  }
  unsigned todo = __ballot_sync(FULL, v < segs && n > SMALL && n <= MEDIUM);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1u;
    const uint32_t s0 = __shfl_sync(FULL, start, src);
    const uint32_t m = __shfl_sync(FULL, n, src);
    int32_t e[PER_LANE];
    uint32_t rank[PER_LANE];
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const uint32_t k = lane + 32 * q;
      e[q] = k < m ? unsorted[s0 + k] : INT_MAX;
      rank[q] = 0;
    }
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      if (32u * q >= m) break;           // the same for the whole warp
      for (int t = 0; t < 32; ++t) {
        const int32_t x = __shfl_sync(FULL, e[q], t);
#pragma unroll
        for (int u = 0; u < PER_LANE; ++u) rank[u] += x < e[u];
      }
    }
#pragma unroll
    for (int q = 0; q < PER_LANE; ++q) {
      const uint32_t k = lane + 32 * q;
      if (k < m) order[s0 + rank[q]] = e[q];
    }
  }
  __syncthreads();
  for (int j = 0; j < n_long; ++j) {
    const uint32_t s0 = long_start[j], m = long_n[j];
    for (uint32_t base = 0; base < m; base += THREADS * PER_THREAD) {
      int32_t e[PER_THREAD];
      uint32_t rank[PER_THREAD];
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const uint32_t k = base + threadIdx.x + q * THREADS;
        e[q] = k < m ? unsorted[s0 + k] : INT_MAX;
        rank[q] = 0;
      }
      for (uint32_t t0 = 0; t0 < m; t0 += LONG_TILE) {
        const uint32_t len = min((uint32_t)LONG_TILE, m - t0);
        __syncthreads();
        for (uint32_t k = threadIdx.x; k < len; k += THREADS)
          tile[k] = unsorted[s0 + t0 + k];
        __syncthreads();
        for (uint32_t k = 0; k < len; ++k) {
          const int32_t x = tile[k];
#pragma unroll
          for (int q = 0; q < PER_THREAD; ++q) rank[q] += x < e[q];
        }
      }
#pragma unroll
      for (int q = 0; q < PER_THREAD; ++q) {
        const uint32_t k = base + threadIdx.x + q * THREADS;
        if (k < m) order[s0 + rank[q]] = e[q];
      }
    }
  }
}

// 5-7: the counts are in place; scans them, places, orders
int list_stage(const int64_t* ids, int64_t n, const long long* segs_dev,
               int64_t segs_bound, const uint32_t* vprefix,
               const uint32_t* vtile, uint32_t* z, uint32_t* w,
               const Layout& L, int32_t* ptr, int32_t* order,
               const int32_t* table, int nx, int ny, int nz, cudaStream_t s) {
  long long* totals = reinterpret_cast<long long*>(w + L.totals);
  uint32_t* cprefix = w + L.cprefix;
  uint32_t* ctile = w + L.ctile;
  const int64_t ctiles = pscan::n_tiles<SCAN_ITEMS>(segs_bound);
  scan_counts_kernel<<<ctiles > 0 ? (unsigned)ctiles : 1u, THREADS, 0, s>>>(
      z + L.counts, segs_dev, segs_bound, cprefix, ctile, z + L.tickets + 2,
      totals + 2);
  if (n > 0)
    place_kernel<<<blocks_for(n), THREADS, 0, s>>>(
        ids, n, segs_dev, segs_bound, vprefix, vtile, cprefix, ctile,
        w + L.arrival, (int32_t*)(w + L.unsorted));
  order_kernel<<<segs_bound > 0 ? blocks_for(segs_bound) : 1u, THREADS, 0,
                 s>>>(z + L.counts, cprefix, ctile, segs_dev,
                      segs_bound, (const int32_t*)(w + L.unsorted), ptr,
                      order, table, nx, ny, nz, z + L.l0, z + L.l1);
  return (int)cudaGetLastError();
}

}  // namespace

// op 0 (voxelize): points (B, P, C) float32 and mask (B, P) uint8; out is
//   int32: the (B * P, 4) table, then the rows (B * P int64), voxel_ptr
//   (B * P + 1) and point_order (B * P), filled up to the counts written
//   to host_totals (pinned host memory: int64 valid points, voxels,
//   points listed). It ends by synchronising the stream (the wrapper's one
//   synchronisation).
// op 1 (list only): ids (P,) int64 in [0, S) (others are left out); out
//   is int32 voxel_ptr (S + 1) then point_order (P): b = 1, p = P, s = S.
// With sizes (a host int64[2]) it launches nothing and writes there the
//   zeroed and the scratch region's sizes in 4-byte words that the op
//   needs at this shape and grid.
// The zeroed region must be all zero on entry and is all zero on return.
extern "C" int dynamic_voxelize(int op, const void* pts, const void* mask,
                                const void* ids, long long b, long long p,
                                long long c, long long s, float lx, float ly,
                                float lz, float ix, float iy, float iz, int nx,
                                int ny, int nz, void* zeroed, void* scratch,
                                void* out, void* host_totals, void* sizes,
                                void* stream) {
  if (op < 0 || op > 1 || b <= 0 || p < 0 || s < 0 || nx <= 0 || ny <= 0 ||
      nz <= 0 || (op == 0 && c < 3) ||
      (int64_t)nz * ny * nx >= ((int64_t)1 << 32) - 32)
    return (int)cudaErrorInvalidValue;
  const int64_t n = (int64_t)b * p;
  const int64_t cells = (int64_t)b * nz * ny * nx;
  const int64_t segs = op == 0 ? n : s;     // voxels <= valid points
  const Layout L = make_layout(op, n, segs, cells);
  if (sizes) {
    long long* out_sizes = (long long*)sizes;
    out_sizes[0] = L.zeroed;
    out_sizes[1] = L.scratch;
    return 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  uint32_t* z = (uint32_t*)zeroed;
  uint32_t* w = (uint32_t*)scratch;
  long long* totals = reinterpret_cast<long long*>(w + L.totals);
  int32_t* o = (int32_t*)out;
  if (op == 1) {
    if (n > 0)
      count_kernel<<<blocks_for(n), THREADS, 0, st>>>(
          (const int64_t*)ids, n, segs, z + L.counts, w + L.arrival);
    return list_stage((const int64_t*)ids, n, nullptr, segs, nullptr, nullptr,
                      z, w, L, o, o + segs + 1, nullptr, 1, 1, 1, st);
  }
  int64_t* rows = reinterpret_cast<int64_t*>(o + 4 * n);
  int32_t* ptr = o + 6 * n;
  int32_t* order = ptr + n + 1;
  mark_kernel<<<n > 0 ? blocks_for(n) : 1u, THREADS, 0, st>>>(
      (const float*)pts, (const uint8_t*)mask, n, (uint32_t)p, c, lx, ly, lz,
      ix, iy, iz, nx, ny, nz, z + L.l0, z + L.l1, rows, w + L.vprefix,
      w + L.vtile, z + L.tickets, totals);
  scan_l1_kernel<<<blocks_for(L.n_l1), THREADS, 0, st>>>(
      z + L.l0, z + L.l1, L.n_l1, w + L.l1prefix, w + L.l1tile,
      z + L.tickets + 1, totals + 1);
  if (n > 0)
    rows_kernel<<<blocks_for(n), THREADS, 0, st>>>(
        z + L.l0, z + L.l1, w + L.l1prefix, w + L.l1tile, n, (uint32_t)p,
        (uint32_t)((int64_t)nz * ny * nx), nx, ny, rows, o, z + L.counts,
        w + L.arrival);
  const int err = list_stage(rows, n, totals + 1, n, w + L.vprefix,
                             w + L.vtile, z, w, L, ptr, order, o, nx, ny, nz,
                             st);
  if (err) return err;
  const cudaError_t copy = cudaMemcpyAsync(
      host_totals, totals, 3 * sizeof(long long), cudaMemcpyDeviceToHost, st);
  return (int)(copy != cudaSuccess ? copy : cudaStreamSynchronize(st));
}
