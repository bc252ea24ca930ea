// Dynamic voxelization for Hopper (sm_90a) — K1.
//
// Replaces the XLA composition isfusion_tpu/ops/voxel.py:125
// voxelize_dynamic (with :34 compute_voxel_coords and ops/scatter.py:54
// unique_with_ranks): for points (B, P, C) float32 and a validity mask
// (B, P), each point's voxel coordinates floor((xyz - low) * inv), the
// sorted table of the occupied voxels as (b, z, y, x) int32 rows ordered by
// batch and then by the z-major linear id, and each point's row in that
// table (int64, -1 for a masked or out-of-range point). The IS-Fusion
// flagship and MVX-Net run it on every request and train step
// (ops/voxel.py:voxelize_dynamic). No cap: every occupied voxel is kept.
//
// Bound: bytes. The function reads xyz and the mask once and writes the
// rows and the table once: (12 + 1 + 8) bytes a point + 16 a voxel, 6.7 MB
// at the flagship's 200,000 points and 156,444 voxels, 0.002 ms at 3.35
// TB/s. The design below moves more: an occupancy bitmap of B x nz x ny x
// nx bits (10.4 MB a flagship sample, 11.3 MB an MVX one) is zeroed,
// read by the scan and read again by the table pass, and the per-word
// prefix (4 bytes a word) is written and read — about 30 MB more a
// flagship sample.
//
// Design (no sort): pass 0 marks each valid point's voxel bit with
// atomicOr (order-free) and keeps its linear id; an exclusive prefix sum
// of the words' popcounts (prefix_scan.cuh: per-block scans, then a scan
// of the block totals) gives the number of occupied voxels before each
// word, and the total, which the wrapper reads to size the table (its one
// synchronisation; torch.unique syncs too). Pass 1 gives each point the
// rank of its bit — its word's prefix plus the popcount of the lower bits
// of the word — and writes each set bit's (b, z, y, x) at its rank. The
// ranks of a bitmap are the sorted order of the linear ids, so the table
// comes out sorted, and every number is a deterministic integer.
//
// Exactness: the coordinates are floor(__fmul_rn(__fsub_rn(x, low), inv))
// with inv = 1 / voxel_size rounded once from float64 to float32 by the
// wrapper, the plain version's float32 arithmetic with no contraction into
// an FMA, so a point on a voxel face lands where the plain version puts
// it. The range test is made on the floored floats (0 <= f < n), which
// equals the plain version's test on their int32 casts for finite points.
// Allocates nothing (the wrapper passes the zeroed bitmap and the
// scratch) and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "prefix_scan.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    mark_kernel(const float* __restrict__ pts, const uint8_t* __restrict__ mask,
                int64_t n_pts, int64_t p, int64_t c, float lx, float ly,
                float lz, float ix, float iy, float iz, int nx, int ny,
                int nz, uint32_t* __restrict__ bitmap,
                int64_t* __restrict__ keys) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_pts) return;
  const float* q = pts + i * c;
  const float fx = floorf(__fmul_rn(__fsub_rn(q[0], lx), ix));
  const float fy = floorf(__fmul_rn(__fsub_rn(q[1], ly), iy));
  const float fz = floorf(__fmul_rn(__fsub_rn(q[2], lz), iz));
  int64_t key = -1;
  if (mask[i] && fx >= 0.f && fx < (float)nx && fy >= 0.f &&
      fy < (float)ny && fz >= 0.f && fz < (float)nz) {
    const int64_t b = i / p;
    key = ((b * nz + (int64_t)fz) * ny + (int64_t)fy) * nx + (int64_t)fx;
    atomicOr(bitmap + (key >> 5), 1u << (key & 31));
  }
  keys[i] = key;
}

__global__ void __launch_bounds__(pscan::THREADS)
    scan_words_kernel(const uint32_t* __restrict__ bitmap, int64_t n_words,
                      uint32_t* __restrict__ prefix,
                      uint32_t* __restrict__ tile_sums) {
  pscan::scan_tile([&](int64_t w) { return (uint32_t)__popc(bitmap[w]); },
                   n_words, prefix, tile_sums);
}

__global__ void __launch_bounds__(THREADS)
    rows_kernel(const int64_t* __restrict__ keys,
                const uint32_t* __restrict__ bitmap,
                const uint32_t* __restrict__ prefix,
                const uint32_t* __restrict__ tile_sums, int64_t n_pts,
                int64_t* __restrict__ rows) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n_pts) return;
  const int64_t key = keys[i];
  if (key < 0) {
    rows[i] = -1;
    return;
  }
  const int64_t w = key >> 5;
  const uint32_t lower = bitmap[w] & ((1u << (key & 31)) - 1u);
  rows[i] = (int64_t)pscan::tile_offset(prefix, tile_sums, w) +
            __popc(lower);
}

__global__ void __launch_bounds__(THREADS)
    table_kernel(const uint32_t* __restrict__ bitmap,
                 const uint32_t* __restrict__ prefix,
                 const uint32_t* __restrict__ tile_sums, int64_t n_words,
                 int nx, int ny, int nz, int32_t* __restrict__ table) {
  const int64_t w = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (w >= n_words) return;
  uint32_t bits = bitmap[w];
  if (!bits) return;
  int64_t r = pscan::tile_offset(prefix, tile_sums, w);
  while (bits) {
    const int bit = __ffs(bits) - 1;
    bits &= bits - 1u;
    int64_t key = w * 32 + bit;
    const int32_t x = (int32_t)(key % nx);
    key /= nx;
    const int32_t y = (int32_t)(key % ny);
    key /= ny;
    const int32_t z = (int32_t)(key % nz);
    const int32_t b = (int32_t)(key / nz);
    reinterpret_cast<int4*>(table)[r++] = make_int4(b, z, y, x);
  }
}

inline unsigned blocks_for(int64_t n) {
  return (unsigned)((n + THREADS - 1) / THREADS);
}

}  // namespace

// stage 0: mark the bitmap (zeroed by the caller) and scan it; writes the
//          occupied voxel count to *total (device memory).
// stage 1: each point's row and the (total, 4) table.
// Scratch: bitmap and prefix n_words = ceil(B * nz * ny * nx / 32) words,
// tile_sums ceil(n_words / 2048) words, keys B * P int64.
extern "C" int dynamic_voxelize(int stage, const void* pts, const void* mask,
                                long long b, long long p, long long c,
                                float lx, float ly, float lz, float ix,
                                float iy, float iz, int nx, int ny, int nz,
                                void* bitmap, void* prefix, void* tile_sums,
                                void* keys, void* total, void* rows,
                                void* table, void* stream) {
  if (b <= 0 || p < 0 || c < 3 || nx <= 0 || ny <= 0 || nz <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int64_t n_pts = (int64_t)b * p;
  const int64_t n_words = ((int64_t)b * nz * ny * nx + 31) / 32;
  const int64_t tiles = pscan::n_tiles(n_words);
  if (stage == 0) {
    if (n_pts > 0)
      mark_kernel<<<blocks_for(n_pts), THREADS, 0, s>>>(
          (const float*)pts, (const uint8_t*)mask, n_pts, p, c, lx, ly, lz,
          ix, iy, iz, nx, ny, nz, (uint32_t*)bitmap, (int64_t*)keys);
    scan_words_kernel<<<(unsigned)tiles, pscan::THREADS, 0, s>>>(
        (const uint32_t*)bitmap, n_words, (uint32_t*)prefix,
        (uint32_t*)tile_sums);
    pscan::scan_tiles_kernel<<<1, pscan::THREADS, 0, s>>>(
        (uint32_t*)tile_sums, tiles, (long long*)total);
    return (int)cudaGetLastError();
  }
  if (stage != 1) return (int)cudaErrorInvalidValue;
  if (n_pts > 0)
    rows_kernel<<<blocks_for(n_pts), THREADS, 0, s>>>(
        (const int64_t*)keys, (const uint32_t*)bitmap,
        (const uint32_t*)prefix, (const uint32_t*)tile_sums, n_pts,
        (int64_t*)rows);
  table_kernel<<<blocks_for(n_words), THREADS, 0, s>>>(
      (const uint32_t*)bitmap, (const uint32_t*)prefix,
      (const uint32_t*)tile_sums, n_words, nx, ny, nz, (int32_t*)table);
  return (int)cudaGetLastError();
}
