// Greedy axis-aligned BEV NMS for Hopper (sm_90a) — K10-normal.
//
// keep[s, c, i] for sample s, class c, box i: the function of
// isfusion_tpu/ops/box_ops.py:226 nms_normal_bev_mask with :196
// _greedy_suppress (the reference's nms_normal_gpu) over boxes (x1, y1,
// x2, y2): walk the class's boxes by descending score (the wrapper's
// stable sort: ties keep the lower index first); a box that is valid and
// not suppressed is kept, and it suppresses every box whose axis-aligned
// IoU with it exceeds thr. IoU = inter / max(area_i + area_j - inter,
// 1e-8), area = max(x2 - x1, 0) max(y2 - y1, 0), the intersection's sides
// clamped at 0; every step rounded as the plain version
// (ops/box_ops.py:nms_normal_bev_mask_ref) rounds it, in its order (the
// _rn intrinsics keep nvcc from contracting into FMAs), and a NaN
// propagates through max and min as in torch, so the bits equal the plain
// IoU's > thr exactly. Invalid boxes neither keep nor suppress.
//
// Bound: operations. Each unordered pair needs ~15 float32 operations
// (two max, two min, two differences, two clamps, a product, the union's
// sum and difference, its floor, the ratio and the comparison); the
// greedy walk is bit operations with an inherent serial length of K
// dependent steps per class, taken here as K / 64 chunks.
//
// Design, two launches on the caller's stream:
// 1. Pairwise pass: the IoU matrix is computed once a sample for all its
//    classes, as a (K, ceil(K / 64)) 64-bit suppression bitmask in
//    original index order (mask[s, i, u] bit b = iou(i, 64 u + b) > thr;
//    the IoU is symmetric in rounding too, so both orders of a pair are
//    computed and agree). A block stages one 64-box column word in shared
//    memory and a thread forms one row's word: 64 IoUs from registers and
//    shared memory, one 8-byte store.
// 2. Greedy pass: csrc/nms_greedy.cuh, shared with K10-NMS (one block a
//    sample, one warp a class, 64 sorted positions at a time resolved on
//    a register word).
// The launch is refused (cudaErrorInvalidValue) past 32 classes or C *
// ceil(K / 64) removed words over SMEM_MAX (launch_greedy). Allocates
// nothing (the wrapper passes the mask scratch) and does not synchronise.
#include <math.h>
#include <stdint.h>

#include "nms_greedy.cuh"

namespace {

constexpr int ROWS = 128;  // pairwise pass: rows (threads) a block

// torch.maximum / torch.minimum: NaN if either input is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b);
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

__device__ __forceinline__ float area(float4 r) {
  return __fmul_rn(nan_max(__fsub_rn(r.z, r.x), 0.f),
                   nan_max(__fsub_rn(r.w, r.y), 0.f));
}

__global__ void __launch_bounds__(ROWS)
    nms_normal_mask_kernel(const float4* __restrict__ boxes,
                           uint64_t* __restrict__ mask, int64_t k, int w,
                           float thr) {
  __shared__ float4 col[64];
  __shared__ float col_area[64];
  const int64_t s = blockIdx.z;
  const int u = blockIdx.y;
  const float4* bx = boxes + s * k;
  const int t = threadIdx.x;
  if (t < 64) {
    const int64_t j = (int64_t)u * 64 + t;
    const float4 r = j < k ? bx[j] : make_float4(0.f, 0.f, 0.f, 0.f);
    col[t] = r;
    col_area[t] = area(r);
  }
  __syncthreads();
  const int64_t i = (int64_t)blockIdx.x * ROWS + t;
  if (i >= k) return;
  const float4 a = bx[i];
  const float aa = area(a);
  const int n = k - (int64_t)u * 64 < 64 ? (int)(k - (int64_t)u * 64) : 64;
  uint64_t word = 0ull;
  for (int e = 0; e < n; ++e) {
    const float4 b = col[e];
    const float iw = nan_max(__fsub_rn(nan_min(a.z, b.z), nan_max(a.x, b.x)),
                             0.f);
    const float ih = nan_max(__fsub_rn(nan_min(a.w, b.w), nan_max(a.y, b.y)),
                             0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni =
        nan_max(__fsub_rn(__fadd_rn(aa, col_area[e]), inter), 1e-8f);
    word |= (uint64_t)(__fdiv_rn(inter, uni) > thr) << e;
  }
  mask[(s * k + i) * w + u] = word;
}

}  // namespace

// boxes: contiguous (B, K, 4) float32 (x1, y1, x2, y2); mask: (B, K,
// ceil(K / 64)) 64-bit scratch; strides: the six element strides of order
// (B, C, K) int64 and valid (B, C, K) bool, in that order; keep a
// contiguous (B, C, K) byte tensor.
extern "C" int nms_normal_bev(const void* boxes, const void* order,
                              const void* valid, void* mask, void* keep,
                              long long batch, long long nc, long long k,
                              float thr, const long long* strides,
                              void* stream) {
  if (batch <= 0 || nc <= 0 || k <= 0) return 0;
  const int w = (int)((k + 63) / 64);
  if (!greedy_fits(nc, k) || batch > 65535 || w > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  nms_normal_mask_kernel<<<dim3((unsigned)((k + ROWS - 1) / ROWS),
                                (unsigned)w, (unsigned)batch),
                           ROWS, 0, st>>>((const float4*)boxes,
                                          (uint64_t*)mask, (int64_t)k, w,
                                          thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const Strides sd{strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5]};
  return (int)launch_greedy((const uint64_t*)mask, (const int64_t*)order,
                            (const uint8_t*)valid, (uint8_t*)keep,
                            (int64_t)batch, (int64_t)nc, (int64_t)k, sd, st);
}
