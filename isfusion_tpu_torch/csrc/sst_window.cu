// SST's sparse window partition and token moves for Hopper (sm_90a) — K17.
//
// Replaces the XLA compositions of isfusion_tpu/models/sst/sst_sparse.py:
// :39 get_window_coors, :79 bucketize_shift (with ops/scatter.py:102
// group_ranks and ops/sparse.py:162 unique_sorted_ids), :142 window2flat,
// :329 _rebind and the canvas scatter of :257 SSTv2Sparse (recover_bev).
// The JAX package sorts every voxel's window id (argsort for the ranks, two
// sorts for the unique-id tables, one a level) and scatters the tokens into
// (V / lo)-window buckets; here the window-id space is dense and small
// (ceil(s / w) + 1 windows an axis: 1,922 a sample at 180 x 180 / 6, 3,200
// at 468 x 468 / 12), so nothing is sorted.
//
// Entry sst_partition: one shift variant's partition of B samples of V
// voxels in one call, every output equal to the plain version
// (ops/sst_window.py:sst_partition_ref) bit for bit:
// 1. coords: each voxel's window id and in-window (z, y, x) from the
//    integer formulas (floor division, as JAX's // on int32, so rows
//    outside the grid give JAX's values); a valid voxel outside the grid
//    stops the kernel (__trap). Invalid rows get their final values here
//    (rank 0, count 0, level -1, keep 0, slot 0, dest -1, cell -1); the
//    output tables are filled with INT_MAX and the token and canvas maps
//    with -1.
// 2. the list of each window's voxels in increasing voxel index, by
//    stable_lists.cuh (a warp orders a window of up to 256 voxels): the
//    order of JAX's stable argsort, with no sort. Invalid voxels go to a
//    trash window NW of their sample.
// 3. windows: a warp a window: rank = the position in the list, count = its
//    length, level = the last level with lo <= count < hi, keep (before
//    the caps) = some level has lo <= count < hi and rank < max_tokens;
//    one flag a (sample, level, window): the window is of that level.
// 4. the flags' exclusive prefix sums (prefix_scan.cuh), sample-major,
//    level, then window id: a window's slot in its level's table is its
//    prefix less that of the (sample, level)'s first window.
// 5. slots: a warp a window again: a window of level l at slot s < cap_l
//    is table_l[b, s] and keeps its kept voxels; past the cap its voxels
//    drop (JAX's table keeps the lowest ids, as here); each kept voxel's
//    token row dest = off_l + (b * cap_l + s) * T_l + min(rank, T_l - 1),
//    the inverse map tok_src[dest] = b * V + v, and each valid voxel's
//    canvas cell b * sy * sx + y * sx + x with cell_src[cell] = b * V + v.
// cap_l is the level's table size (the wrapper's min(win_caps[l], NW): a
// level cannot hold more windows than a sample has).
//
// Entry sst_move: the token moves, all one row gather with unique
// destinations (no atomics): out[r] = idx[r] >= 0 ? src[idx[r]] :
// (pass ? pass[r] : 0), or with `complement` out[r] = idx[r] >= 0 ? 0 :
// pass[r]. The wrapper (ops/sst_window.py) drives it as op 0 flat ->
// window (idx = tok_src: every level's buckets in one launch, zeros where
// no token sits), op 1 window -> flat (idx = dest, pass = the features:
// window2flat), op 2 flat -> canvas (idx = cell_src); each backward is the
// matching gather (op 0's is op 1's form with no pass, op 1's the tokens'
// op 0 form plus the complement copy, op 2's a gather by cell). Source and
// destination rows may lie in up to MAX_SEGS tensors (one a drop level),
// addressed as one row space by each tensor's first row. Rows move as
// 16-, 8-, 4- or 2-byte words (the widest that divides the row and every
// pointer's alignment), G lanes a row (the K14 gathers' row groups,
// point_gather.cu), so float32 and bfloat16 rows move alike.
//
// Bound: bytes. The partition reads 13 bytes a voxel and writes 41 (and
// the tables and maps); its list adds ~20 bytes a voxel, and its ten
// launches (with three memsets) cost more than its bytes at these sizes. A
// move reads each source row it copies once and writes each output row
// once. Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "prefix_scan.cuh"
#include "stable_lists.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_LEVELS = 8;
constexpr int MAX_SEGS = 8;
constexpr int SCAN_ITEMS = 8;

using slist::grid_for;

struct Geometry {
  int sx, sy, sz, wx, wy, wz, nwx, nwy, nwz, ox, oy, oz;
  int64_t b, v, nw;             // samples, voxels a sample, windows a sample
};

struct Levels {
  int n;
  int lo[MAX_LEVELS], hi[MAX_LEVELS], tokens[MAX_LEVELS], cap[MAX_LEVELS];
  int64_t tok_off[MAX_LEVELS];  // first token row of each level
  int64_t tab_off[MAX_LEVELS];  // first table entry of each level
};

struct Outputs {
  int32_t *win, *inner, *rank, *count, *level, *slot, *dest, *cell;
  uint8_t* keep;
  int32_t *tables, *tok_src, *cell_src;
  int64_t tab_words, tok_rows, cells;
};

// floor division and modulo by a positive divisor (JAX's // and % on int)
__device__ __forceinline__ int64_t fdiv(int64_t a, int64_t d) {
  const int64_t q = a / d;
  return (a % d != 0 && a < 0) ? q - 1 : q;
}
__device__ __forceinline__ int64_t fmod_(int64_t a, int64_t d) {
  return a - fdiv(a, d) * d;
}
__device__ __forceinline__ int32_t wrap(uint32_t a) { return (int32_t)a; }

// the level of a window of m voxels: the last whose range holds m (JAX
// assigns the levels in order, the last in range winning), -1 for none
__device__ __forceinline__ int level_of(const Levels& L, int64_t m) {
  int lvl = -1;
  for (int l = 0; l < L.n; ++l)
    if (m > 0 && m >= L.lo[l] && m < L.hi[l]) lvl = l;
  return lvl;
}

// step 1 (and the fills)
__global__ void __launch_bounds__(THREADS)
    coords_kernel(const int32_t* __restrict__ coords,
                  const uint8_t* __restrict__ valid, Geometry g, Outputs o,
                  int32_t* __restrict__ key) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t t0 = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  for (int64_t i = t0; i < o.tab_words; i += stride) o.tables[i] = INT_MAX;
  for (int64_t i = t0; i < o.tok_rows; i += stride) o.tok_src[i] = -1;
  for (int64_t i = t0; i < o.cells; i += stride) o.cell_src[i] = -1;
  for (int64_t i = t0; i < g.b * g.v; i += stride) {
    const int32_t z = coords[3 * i], y = coords[3 * i + 1],
                  x = coords[3 * i + 2];
    // int32 arithmetic as JAX's (wrapping), on any row
    const int32_t cx = wrap((uint32_t)x + (uint32_t)g.ox),
                  cy = wrap((uint32_t)y + (uint32_t)g.oy),
                  cz = wrap((uint32_t)z + (uint32_t)g.oz);
    o.win[i] = wrap((uint32_t)fdiv(cx, g.wx) * (uint32_t)(g.nwy * g.nwz) +
                    (uint32_t)fdiv(cy, g.wy) * (uint32_t)g.nwz +
                    (uint32_t)fdiv(cz, g.wz));
    o.inner[3 * i] = (int32_t)fmod_(cz, g.wz);
    o.inner[3 * i + 1] = (int32_t)fmod_(cy, g.wy);
    o.inner[3 * i + 2] = (int32_t)fmod_(cx, g.wx);
    if (valid[i]) {
      if (x < 0 || x >= g.sx || y < 0 || y >= g.sy || z < 0 || z >= g.sz)
        __trap();
      key[i] = o.win[i];
      o.cell[i] = (int32_t)((i / g.v) * g.sy * g.sx + y * g.sx + x);
    } else {
      key[i] = (int32_t)g.nw;                // the sample's trash window
      o.rank[i] = 0;
      o.count[i] = 0;
      o.level[i] = -1;
      o.keep[i] = 0;
      o.slot[i] = 0;
      o.dest[i] = -1;
      o.cell[i] = -1;
    }
  }
}

// step 3: a warp a (sample, window) of the sample's NW real windows
__global__ void __launch_bounds__(THREADS)
    window_kernel(const int32_t* __restrict__ ptr,
                  const int32_t* __restrict__ order, Geometry g, Levels L,
                  Outputs o, uint32_t* __restrict__ flags) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t w = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       w < g.b * g.nw; w += warps) {
    const int64_t b = w / g.nw, win = w % g.nw;
    const int64_t seg = b * (g.nw + 1) + win;
    const int32_t start = ptr[seg], m = ptr[seg + 1] - start;
    const int lvl = level_of(L, m);
    for (int32_t r = lane; r < m; r += 32) {
      const int32_t i = order[start + r];
      bool kept = false;
      for (int l = 0; l < L.n; ++l)
        kept |= m >= L.lo[l] && m < L.hi[l] && r < L.tokens[l];
      o.rank[i] = r;
      o.count[i] = m;
      o.level[i] = lvl;
      o.keep[i] = kept;
    }
    if (lane < L.n)
      flags[(b * L.n + lane) * g.nw + win] = lvl == lane ? 1u : 0u;
  }
}

__global__ void __launch_bounds__(pscan::THREADS)
    scan_kernel(const uint32_t* __restrict__ flags, int64_t n,
                uint32_t* __restrict__ prefix, uint32_t* tiles,
                unsigned* ticket, long long* total) {
  pscan::scan_tile<SCAN_ITEMS>([&](int64_t i) { return flags[i]; }, n,
                               prefix, tiles);
  pscan::finish_scan(tiles, ticket, total);
}

// step 5: a warp a (sample, window) again
__global__ void __launch_bounds__(THREADS)
    slot_kernel(const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ order,
                const uint32_t* __restrict__ prefix,
                const uint32_t* __restrict__ tiles, Geometry g, Levels L,
                Outputs o) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t w = (int64_t)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       w < g.b * g.nw; w += warps) {
    const int64_t b = w / g.nw, win = w % g.nw;
    const int64_t seg = b * (g.nw + 1) + win;
    const int32_t start = ptr[seg], m = ptr[seg + 1] - start;
    if (m == 0) continue;
    const int lvl = level_of(L, m);
    int64_t s = 0;
    bool in_table = false;
    if (lvl >= 0) {
      const int64_t first = (b * L.n + lvl) * g.nw;
      s = pscan::tile_offset<SCAN_ITEMS>(prefix, tiles, first + win) -
          pscan::tile_offset<SCAN_ITEMS>(prefix, tiles, first);
      in_table = s < L.cap[lvl];
      if (in_table && lane == 0)
        o.tables[L.tab_off[lvl] + b * L.cap[lvl] + s] = (int32_t)win;
    }
    for (int32_t r = lane; r < m; r += 32) {
      const int32_t i = order[start + r];      // b * V + v
      const bool ok = in_table && o.keep[i];
      o.keep[i] = ok;
      o.slot[i] = ok ? (int32_t)s : 0;
      int32_t d = -1;
      if (ok) {
        const int t = L.tokens[lvl];
        d = (int32_t)(L.tok_off[lvl] + (b * L.cap[lvl] + s) * t +
                      (r < t - 1 ? r : t - 1));
        o.tok_src[d] = i;
      }
      o.dest[i] = d;
      o.cell_src[o.cell[i]] = i;
    }
  }
}

// ---------------------------------------------------------------- moves

struct Segs {
  int n;
  const char* ptr[MAX_SEGS];
  int64_t first[MAX_SEGS];      // first row of each tensor, increasing
};

// the address of row r of a segmented row space
__device__ __forceinline__ const char* seg_row(const Segs& s, int64_t r,
                                               int64_t row_bytes) {
  int k = 0;
  for (int j = 1; j < s.n; ++j)
    if (r >= s.first[j]) k = j;
  return s.ptr[k] + (r - s.first[k]) * row_bytes;
}

// G lanes a row of rv words of type W; 32 / G rows a warp
template <typename W, int G>
__global__ void __launch_bounds__(THREADS)
    move_kernel(const int32_t* __restrict__ idx, Segs src, int64_t src_rows,
                Segs dst, const char* __restrict__ pass, int64_t rows,
                int64_t row_bytes, int complement) {
  const int lane = threadIdx.x & 31, q = lane & (G - 1), gi = lane / G;
  const int64_t rv = row_bytes / (int64_t)sizeof(W);
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t r0 = ((int64_t)blockIdx.x * (THREADS / 32) +
                     (threadIdx.x >> 5)) * (32 / G);
       r0 < rows; r0 += warps * (32 / G)) {
    const int64_t r = r0 + gi;
    if (r >= rows) continue;
    const int32_t j = idx[r];
    if (j >= src_rows) __trap();               // a fault upstream
    W* out = (W*)seg_row(dst, r, row_bytes);
    const W* from = nullptr;
    if (j >= 0 && !complement)
      from = (const W*)seg_row(src, j, row_bytes);
    else if (pass != nullptr && !(j >= 0 && complement))
      from = (const W*)(pass + r * row_bytes);
    for (int64_t c = q; c < rv; c += G) out[c] = from ? from[c] : W{};
  }
}

template <typename W>
int launch_w(const int32_t* idx, const Segs& src, int64_t src_rows,
             const Segs& dst, const char* pass, int64_t rows,
             int64_t row_bytes, int complement, cudaStream_t st) {
  const int64_t rv = row_bytes / (int64_t)sizeof(W);
  int g = 1;
  while (g < 32 && g < rv) g <<= 1;
  const unsigned grid = grid_for((rows + 32 / g - 1) / (32 / g) * 32);
#define MOVE(G)                                                         \
  case G:                                                               \
    move_kernel<W, G><<<grid, THREADS, 0, st>>>(idx, src, src_rows, dst, \
                                                pass, rows, row_bytes,  \
                                                complement);            \
    break;
  switch (g) {
    MOVE(1) MOVE(2) MOVE(4) MOVE(8) MOVE(16) MOVE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef MOVE
  return (int)cudaGetLastError();
}

// the partition's scratch, in 4-byte words: the list stage's, then the
// keys, the level flags, their prefixes and tile sums, the scan's ticket
// and its total (8-byte aligned)
struct Scratch {
  int64_t list, key, flags, prefix, tiles, ticket, total, words;
};

Scratch scratch_layout(int64_t b, int64_t v, int64_t nw, int64_t levels) {
  Scratch s{};
  const int64_t segs = b * (nw + 1), slots = b * v, n = b * levels * nw;
  s.list = 0;
  s.key = slist::list_words(segs, slots);
  s.flags = s.key + slots;
  s.prefix = s.flags + n;
  s.tiles = s.prefix + n;
  s.ticket = s.tiles + pscan::n_tiles<SCAN_ITEMS>(n);
  s.total = (s.ticket + 2) & ~int64_t(1);
  s.words = s.total + 2;
  return s;
}

int64_t windows(int64_t s, int64_t w) { return (s + w - 1) / w + 1; }

}  // namespace

// int32 words of scratch for sst_partition over B samples of V voxels, NW
// windows a sample and L levels
extern "C" long long sst_partition_scratch(long long b, long long v,
                                           long long nw, long long levels) {
  return scratch_layout(b, v, nw, levels).words;
}

// args (int64): coords (B, V, 3) int32 zyx, valid (B, V) bool, then the
// outputs win, inner (B, V, 3), rank, count, level (B, V) int32, keep (B,
// V) bool, slot, dest, cell (B, V) int32, tables (sum_l B * cap_l) int32,
// tok_src (sum_l B * cap_l * T_l) int32, cell_src (B * sy * sx) int32, the
// scratch (sst_partition_scratch words), then B, V, sx, sy, sz, wx, wy, wz,
// shift, L and each level's lo, hi, T, cap.
extern "C" int sst_partition(const long long* a, void* stream) {
  const int32_t* coords = (const int32_t*)a[0];
  const uint8_t* valid = (const uint8_t*)a[1];
  Outputs o{};
  o.win = (int32_t*)a[2];
  o.inner = (int32_t*)a[3];
  o.rank = (int32_t*)a[4];
  o.count = (int32_t*)a[5];
  o.level = (int32_t*)a[6];
  o.keep = (uint8_t*)a[7];
  o.slot = (int32_t*)a[8];
  o.dest = (int32_t*)a[9];
  o.cell = (int32_t*)a[10];
  o.tables = (int32_t*)a[11];
  o.tok_src = (int32_t*)a[12];
  o.cell_src = (int32_t*)a[13];
  uint32_t* w = (uint32_t*)a[14];
  Geometry g{};
  g.b = a[15];
  g.v = a[16];
  g.sx = (int)a[17];
  g.sy = (int)a[18];
  g.sz = (int)a[19];
  g.wx = (int)a[20];
  g.wy = (int)a[21];
  g.wz = (int)a[22];
  const bool shift = a[23] != 0;
  Levels L{};
  L.n = (int)a[24];
  if (L.n < 1 || L.n > MAX_LEVELS || g.sx < 1 || g.sy < 1 || g.sz < 1 ||
      g.wx < 1 || g.wy < 1 || g.wz < 1 || g.b < 0 || g.v < 0)
    return (int)cudaErrorInvalidValue;
  g.nwx = (int)windows(g.sx, g.wx);
  g.nwy = (int)windows(g.sy, g.wy);
  g.nwz = (int)windows(g.sz, g.wz);
  g.nw = (int64_t)g.nwx * g.nwy * g.nwz;
  g.ox = shift ? g.wx / 2 : g.wx;
  g.oy = shift ? g.wy / 2 : g.wy;
  g.oz = g.sz == g.wz ? 0 : (shift ? g.wz / 2 : g.wz);
  int64_t tok = 0, tab = 0;
  for (int l = 0; l < L.n; ++l) {
    L.lo[l] = (int)a[25 + 4 * l];
    L.hi[l] = (int)a[26 + 4 * l];
    L.tokens[l] = (int)a[27 + 4 * l];
    L.cap[l] = (int)a[28 + 4 * l];
    if (L.tokens[l] < 1 || L.cap[l] < 1 || L.cap[l] > g.nw)
      return (int)cudaErrorInvalidValue;
    L.tok_off[l] = tok;
    L.tab_off[l] = tab;
    tok += g.b * L.cap[l] * L.tokens[l];
    tab += g.b * L.cap[l];
  }
  o.tab_words = tab;
  o.tok_rows = tok;
  o.cells = g.b * g.sy * g.sx;
  const int64_t slots = g.b * g.v, segs = g.b * (g.nw + 1),
                n = g.b * L.n * g.nw;
  if (slots + segs >= INT_MAX || tok >= INT_MAX || o.cells >= INT_MAX ||
      n >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (slots == 0) {
    // nothing to partition: the tables and maps still get their fills
    if (tab + tok + o.cells == 0) return 0;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const Scratch S = scratch_layout(g.b, g.v, g.nw, L.n);
  int32_t* key = (int32_t*)(w + S.key);
  coords_kernel<<<grid_for(tab + tok + o.cells + slots), THREADS, 0, st>>>(
      coords, valid, g, o, key);
  if (slots == 0) return (int)cudaGetLastError();
  const slist::ListLayout LL = slist::list_layout(segs, slots);
  int32_t* ptr = (int32_t*)(w + LL.words);
  int32_t* order = ptr + segs + 1;
  int err = slist::build_list(key, slots, g.v, g.nw + 1, segs, w + S.list,
                              ptr, order, st);
  if (err) return err;
  const unsigned warp_grid = grid_for(g.b * g.nw * 32);
  window_kernel<<<warp_grid, THREADS, 0, st>>>(ptr, order, g, L, o,
                                               w + S.flags);
  cudaError_t e = cudaMemsetAsync(w + S.ticket, 0, 2 * sizeof(uint32_t), st);
  if (e != cudaSuccess) return (int)e;
  scan_kernel<<<(unsigned)pscan::n_tiles<SCAN_ITEMS>(n), pscan::THREADS, 0,
                st>>>(w + S.flags, n, w + S.prefix, w + S.tiles,
                      (unsigned*)(w + S.ticket),
                      (long long*)(w + S.total));
  slot_kernel<<<warp_grid, THREADS, 0, st>>>(ptr, order, w + S.prefix,
                                             w + S.tiles, g, L, o);
  return (int)cudaGetLastError();
}

// args (int64): rows, row_bytes, idx (rows int32), pass (rows x row_bytes,
// or 0), complement, src_rows, n_src, n_dst, then n_src (pointer, first
// row) pairs and n_dst pairs. out[r] = idx[r] >= 0 ? src[idx[r]] : (pass ?
// pass[r] : 0); with complement, idx[r] >= 0 ? 0 : pass[r]. An index at or
// past src_rows stops the kernel (__trap).
extern "C" int sst_move(const long long* a, void* stream) {
  const int64_t rows = a[0], row_bytes = a[1];
  const int32_t* idx = (const int32_t*)a[2];
  const char* pass = (const char*)a[3];
  const int complement = (int)a[4];
  const int64_t src_rows = a[5];
  Segs src{}, dst{};
  src.n = (int)a[6];
  dst.n = (int)a[7];
  if (rows < 0 || row_bytes <= 0 || row_bytes % 2 || src.n < 1 ||
      src.n > MAX_SEGS || dst.n < 1 || dst.n > MAX_SEGS ||
      (complement && pass == nullptr))
    return (int)cudaErrorInvalidValue;
  uintptr_t at = (uintptr_t)pass | (uintptr_t)row_bytes;
  for (int k = 0; k < src.n; ++k) {
    src.ptr[k] = (const char*)a[8 + 2 * k];
    src.first[k] = a[9 + 2 * k];
    at |= (uintptr_t)src.ptr[k];
  }
  for (int k = 0; k < dst.n; ++k) {
    dst.ptr[k] = (const char*)a[8 + 2 * src.n + 2 * k];
    dst.first[k] = a[9 + 2 * src.n + 2 * k];
    at |= (uintptr_t)dst.ptr[k];
  }
  if (rows == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (at % 16 == 0)
    return launch_w<uint4>(idx, src, src_rows, dst, pass, rows, row_bytes,
                           complement, st);
  if (at % 8 == 0)
    return launch_w<uint2>(idx, src, src_rows, dst, pass, rows, row_bytes,
                           complement, st);
  if (at % 4 == 0)
    return launch_w<uint32_t>(idx, src, src_rows, dst, pass, rows,
                              row_bytes, complement, st);
  return launch_w<uint16_t>(idx, src, src_rows, dst, pass, rows, row_bytes,
                            complement, st);
}
