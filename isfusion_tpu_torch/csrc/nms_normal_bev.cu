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
// 1. Pairwise pass (csrc/nms_pairwise.cuh): the IoU matrix is computed
//    once a sample for all its classes, as a (K, ceil(K / 64)) 64-bit
//    suppression bitmask in original index order, a warp a 32 x 32 tile
//    on or above the diagonal, the other half mirrored by ballots; max
//    and min propagate NaN in one instruction each (max.NaN, min.NaN). The
//    mirror is exact: every step commutes bit for bit. nan_max and nan_min
//    are symmetric (a NaN gives the canonical NaN either way; two zeros of
//    either sign may come back either way, and no comparison tells them
//    apart), __fadd_rn(area_i, area_j) is commutative, and the
//    intersection's sides are the same numbers in both orders. A pair
//    whose clamped intersection is exactly 0 has IoU exactly 0 (the union
//    is at least 1e-8, or NaN when the areas' sum is), so its bit is 0 >
//    thr, taken without the division; a NaN intersection takes the full
//    path.
// 2. Greedy pass: csrc/nms_greedy.cuh, shared with K10-NMS (a block a
//    (sample, class), 64 sorted positions a step resolved on a register
//    word by one warp while sixteen prepare the next step's bits).
// Refused (cudaErrorInvalidValue) only past the grids' limits or a class
// whose removed words exceed the greedy pass's shared memory (greedy_fits,
// launch_pairwise). Allocates nothing (the wrapper passes the mask
// scratch) and does not synchronise.
#include <math.h>
#include <stdint.h>

#include "nms_greedy.cuh"
#include "nms_pairwise.cuh"
#include "rotated_box.cuh"

namespace {

// torch.maximum / torch.minimum: NaN if either input is NaN
using rotated_box::nan_max;
using rotated_box::nan_min;

// axis-aligned IoU > thr of a sample's (x1, y1, x2, y2) boxes
struct NormalPair {
  struct Box {
    float4 r;
    float area;
  };
  struct Ctx {};
  const float4* boxes;  // (B, K) contiguous, 16-byte aligned
  int64_t k;
  float thr;
  bool zero_bit;  // 0 > thr: the bit of a pair with IoU 0

  __device__ Ctx ctx(int64_t) const { return {}; }
  __device__ Box load(int64_t s, int64_t i) const {
    const float4 r = boxes[s * k + i];
    return {r, __fmul_rn(nan_max(__fsub_rn(r.z, r.x), 0.f),
                         nan_max(__fsub_rn(r.w, r.y), 0.f))};
  }
  __device__ bool bit(Ctx, const Box& a, const Box& b) const {
    const float iw = nan_max(
        __fsub_rn(nan_min(a.r.z, b.r.z), nan_max(a.r.x, b.r.x)), 0.f);
    const float ih = nan_max(
        __fsub_rn(nan_min(a.r.w, b.r.w), nan_max(a.r.y, b.r.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float sum = __fadd_rn(a.area, b.area);
    if (inter == 0.f) return zero_bit && sum == sum;
    const float uni = nan_max(__fsub_rn(sum, inter), 1e-8f);
    return __fdiv_rn(inter, uni) > thr;
  }
};

}  // namespace

// boxes: contiguous (B, K, 4) float32 (x1, y1, x2, y2), 16-byte aligned;
// mask: (B, K, ceil(K / 64)) 64-bit scratch; strides: the six element
// strides of order (B, C, K) int64 and valid (B, C, K) bool, in that
// order; keep a contiguous (B, C, K) byte tensor.
extern "C" int nms_normal_bev(const void* boxes, const void* order,
                              const void* valid, void* mask, void* keep,
                              long long batch, long long nc, long long k,
                              float thr, const long long* strides,
                              void* stream) {
  if (batch <= 0 || nc <= 0 || k <= 0) return 0;
  if (!greedy_fits(batch, nc, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const NormalPair pair{(const float4*)boxes, (int64_t)k, thr, 0.f > thr};
  cudaError_t err =
      launch_pairwise(pair, (uint64_t*)mask, (int64_t)batch, (int64_t)k, st);
  if (err != cudaSuccess) return (int)err;
  const Strides sd{strides[0], strides[1], strides[2],
                   strides[3], strides[4], strides[5]};
  return (int)launch_greedy((const uint64_t*)mask, (const int64_t*)order,
                            (const uint8_t*)valid, (uint8_t*)keep,
                            (int64_t)batch, (int64_t)nc, (int64_t)k, sd, st);
}
