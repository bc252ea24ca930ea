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
// Bound at serve (1 x 100 RoIs x <= 40,000 voxels x 20 channels, G = 6):
// bytes ~5.4 MB (centres and features read once, 1.7 MB of output), 1.6 us
// at 3.35 TB/s; operations ~4e6 membership tests of ~25 float operations,
// 1.5 us at 67 TFLOP/s.
//
// Design, with no float atomics (two calls agree bit for bit):
// - forward (op 0): one block per (sample, RoI). Its threads test the
//   voxels 256 at a time and compact the inside ones, in voxel order, into
//   the RoI's row of a scratch list (entry v * G^3 + cell; a ballot and a
//   scan of the 8 warp counts keep the order); cell counts are integer
//   atomics in shared memory. Then warp w owns the cells with cell % 8 ==
//   w: it walks the list 32 entries at a time, loads the features of its
//   entries (32 rows in flight) and adds them, lane = channel, into the
//   cell's sums in shared memory in list order. The sums go out divided by
//   max(count, 1), with the counts (the backward reads them).
// - backward (op 1): one thread per voxel walks the sample's RoIs in
//   order (256 at a time staged in shared memory), recomputes membership
//   and adds dpooled / max(count, 1) of its cell to its own row.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

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

// the cell of point p in RoI f, or -1 outside it
__device__ __forceinline__ int roi_cell(const RoiFrame& f, float px,
                                        float py, float pz, int g) {
  const float rx = __fsub_rn(px, f.x), ry = __fsub_rn(py, f.y);
  const float rz = __fsub_rn(__fsub_rn(pz, f.z), f.hz);
  const float lx = __fsub_rn(__fmul_rn(rx, f.c), __fmul_rn(ry, f.s));
  const float ly = __fadd_rn(__fmul_rn(rx, f.s), __fmul_rn(ry, f.c));
  const float u = __fadd_rn(__fdiv_rn(lx, f.dx), 0.5f);
  const float v = __fadd_rn(__fdiv_rn(ly, f.dy), 0.5f);
  const float w = __fadd_rn(__fdiv_rn(rz, f.dz), 0.5f);
  if (!(u >= 0.f && u < 1.f && v >= 0.f && v < 1.f && w >= 0.f && w < 1.f))
    return -1;
  return (axis_cell(u, g) * g + axis_cell(v, g)) * g + axis_cell(w, g);
}

__global__ void __launch_bounds__(THREADS)
    roiaware_forward_kernel(const float* __restrict__ rois,
                            const float* __restrict__ trig,
                            const float* __restrict__ centers,
                            const uint8_t* __restrict__ mask,
                            const float* __restrict__ feats,
                            int* __restrict__ counts,
                            float* __restrict__ out, int* __restrict__ list,
                            int64_t nr, int64_t nv, int nc, int g) {
  extern __shared__ float smem[];
  __shared__ int warp_tot[WARPS];
  const int g3 = g * g * g;
  float* acc = smem;                          // (G^3, C) sums
  int* cnt = reinterpret_cast<int*>(acc + (int64_t)g3 * nc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t br = blockIdx.x, b = br / nr;
  const RoiFrame f = load_roi(rois, trig, br);
  for (int i = tid; i < g3 * nc; i += THREADS) acc[i] = 0.f;
  for (int i = tid; i < g3; i += THREADS) cnt[i] = 0;
  const float* cen = centers + b * nv * 3;
  const uint8_t* m = mask + b * nv;
  int* row = list + br * nv;
  const unsigned below = (1u << lane) - 1u;
  int64_t total = 0;
  __syncthreads();
  for (int64_t base = 0; base < nv; base += THREADS) {
    const int64_t vi = base + tid;
    int cell = -1;
    if (vi < nv && m[vi])
      cell = roi_cell(f, cen[3 * vi], cen[3 * vi + 1], cen[3 * vi + 2], g);
    const unsigned bal = __ballot_sync(FULL, cell >= 0);
    if (lane == 0) warp_tot[warp] = __popc(bal);
    __syncthreads();
    int before = 0, chunk = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int t = warp_tot[w];
      before += w < warp ? t : 0;
      chunk += t;
    }
    if (cell >= 0) {
      row[total + before + __popc(bal & below)] = (int)vi * g3 + cell;
      atomicAdd(&cnt[cell], 1);
    }
    total += chunk;
    __syncthreads();
  }
  const float* fb = feats + b * nv * nc;
  for (int64_t e0 = 0; e0 < total; e0 += 32) {
    const int64_t ei = e0 + lane;
    const int ent = ei < total ? row[ei] : 0;
    const int cell = ent % g3, vv = ent / g3;
    const unsigned bal =
        __ballot_sync(FULL, ei < total && cell % WARPS == warp);
    if (!bal) continue;
    for (int c0 = 0; c0 < nc; c0 += 32) {
      const int ch = c0 + lane;
      float vals[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int vj = __shfl_sync(FULL, vv, j);
        vals[j] = ((bal >> j) & 1u) && ch < nc
                      ? fb[(int64_t)vj * nc + ch] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int cj = __shfl_sync(FULL, cell, j);
        if (((bal >> j) & 1u) && ch < nc)
          acc[cj * nc + ch] = __fadd_rn(acc[cj * nc + ch], vals[j]);
      }
    }
  }
  __syncthreads();
  float* o = out + br * g3 * nc;
  for (int i = tid; i < g3 * nc; i += THREADS)
    o[i] = __fdiv_rn(acc[i], (float)max(cnt[i / nc], 1));
  for (int i = tid; i < g3; i += THREADS) counts[br * g3 + i] = cnt[i];
}

__global__ void __launch_bounds__(THREADS)
    roiaware_backward_kernel(const float* __restrict__ rois,
                             const float* __restrict__ trig,
                             const float* __restrict__ centers,
                             const uint8_t* __restrict__ mask,
                             const float* __restrict__ dpooled,
                             const int* __restrict__ counts,
                             float* __restrict__ dfeats, int64_t nr,
                             int64_t nv, int nc, int g) {
  __shared__ RoiFrame tile[THREADS];
  const int g3 = g * g * g;
  const int64_t b = blockIdx.y, vi = (int64_t)blockIdx.x * THREADS +
                                     threadIdx.x;
  const bool live = vi < nv;
  const bool valid = live && mask[b * nv + vi];
  float px = 0.f, py = 0.f, pz = 0.f;
  if (valid) {
    const float* p = centers + (b * nv + vi) * 3;
    px = p[0];
    py = p[1];
    pz = p[2];
  }
  float* row = dfeats + (b * nv + vi) * nc;
  if (live)
    for (int ch = 0; ch < nc; ++ch) row[ch] = 0.f;
  for (int64_t r0 = 0; r0 < nr; r0 += THREADS) {
    __syncthreads();
    if (r0 + threadIdx.x < nr)
      tile[threadIdx.x] = load_roi(rois, trig, b * nr + r0 + threadIdx.x);
    __syncthreads();
    const int n = (int)min((int64_t)THREADS, nr - r0);
    if (!valid) continue;
    for (int j = 0; j < n; ++j) {
      const int cell = roi_cell(tile[j], px, py, pz, g);
      if (cell < 0) continue;
      const int64_t seg = (b * nr + r0 + j) * g3 + cell;
      const float q = (float)max(counts[seg], 1);
      const float* d = dpooled + seg * nc;
      for (int ch = 0; ch < nc; ++ch)
        row[ch] = __fadd_rn(row[ch], __fdiv_rn(d[ch], q));
    }
  }
}

}  // namespace

// op 0 forward: in = feats (B, V, C), out = pooled (B, R, G^3, C), counts
//   (B, R, G^3) int32 written, scratch (B * R, V) int32 (row b R + r
//   starts with the RoI's list, counts[b, r].sum() entries v G^3 + cell);
// op 1 backward: in = dpooled (B, R, G^3, C), counts read, out = dfeats
//   (B, V, C).
// rois (B, R, 7), trig (B, R, 2) cos and sin, centers (B, V, 3) float32,
// mask (B, V) bool; everything contiguous. The wrapper checks V * G^3 <
// 2^31 and the forward's shared memory (G^3 (C + 1) 4 bytes).
extern "C" int roiaware_pool(int op, const void* rois, const void* trig,
                             const void* centers, const void* mask,
                             const void* in, void* counts, void* out,
                             void* scratch, long long batch, long long nr,
                             long long nv, long long nc, long long g,
                             void* stream) {
  if (batch <= 0 || nr <= 0 || nc <= 0 || g <= 0 || nv < 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const float* r = (const float*)rois;
  const float* t = (const float*)trig;
  const float* c = (const float*)centers;
  const uint8_t* m = (const uint8_t*)mask;
  if (op == 0) {
    const size_t smem = (size_t)(g * g * g) * (size_t)(nc + 1) * 4;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          roiaware_forward_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    roiaware_forward_kernel<<<(unsigned)(batch * nr), THREADS, smem, st>>>(
        r, t, c, m, (const float*)in, (int*)counts, (float*)out,
        (int*)scratch, nr, nv, (int)nc, (int)g);
  } else if (op == 1) {
    if (nv == 0) return 0;
    dim3 grid((unsigned)((nv + THREADS - 1) / THREADS), (unsigned)batch);
    roiaware_backward_kernel<<<grid, THREADS, 0, st>>>(
        r, t, c, m, (const float*)in, (const int*)counts, (float*)out, nr,
        nv, (int)nc, (int)g);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
