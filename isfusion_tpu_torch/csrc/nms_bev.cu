// Greedy rotated-BEV NMS for Hopper (sm_90a) — K10-NMS.
//
// keep[s, c, i] for sample s, class c, box i: the function of
// isfusion_tpu/ops/box_ops.py:216 nms_bev_mask with :196 _greedy_suppress
// (the reference's nms_gpu): walk the class's boxes by descending score
// (the wrapper's stable sort: ties keep the lower index first); a box that
// is valid and not suppressed is kept, and it suppresses every box whose
// BEV IoU with it (inter / max(union, 1e-8), rotated_box.cuh) exceeds
// thr. Invalid boxes neither keep nor suppress.
//
// Bound: operations. One IoU per unordered pair of a sample's K boxes
// (~630 float32 operations, IOU3D_OPS_PER_PAIR in ops/box_ops.py) over the
// card's float32 rate: at K = 1,000 about 0.005 ms a sample. Bytes are
// negligible (boxes, scores' order and validity in, keep flags out). The
// greedy walk has an inherent serial length of K dependent steps per
// class.
//
// Design, two launches on the caller's stream:
// 1. Pairwise pass. The boxes do not depend on the class, so the IoU
//    matrix of a sample is computed once for all its classes, as a
//    suppression bitmask in original index order: mask[s, i, w] bit b is
//    iou(i, 64 w + b) > thr, (K, ceil(K / 64)) 64-bit words. A block
//    covers 4 row boxes x 64 column boxes (staged in shared memory); each
//    thread computes one pair and a warp ballot packs 32 of them into half
//    a word.
// 2. Greedy pass. One block per sample, one warp per class. The sample's
//    mask (128 KB at K = 1,000) is copied into shared memory; each warp
//    keeps its removed-bitmask (ceil(K / 64) words) there too,
//    reads its class's order 32 entries at a time (one coalesced load,
//    then warp shuffles) and, for each kept box, ORs the box's mask row
//    into the removed-bitmask, one word per lane.
// The launch is refused (cudaErrorInvalidValue) when the mask and the
// removed-bitmasks, (K + C) * ceil(K / 64) words, exceed SMEM_MAX: with 32
// classes up to K = 1,344, against an nms_pre of at most 1,000 in the
// repo's configs. Allocates nothing (the wrapper passes the mask scratch)
// and does not synchronise.
#include <stdint.h>

#include "rotated_box.cuh"

namespace {

constexpr int ROWS = 4;       // row boxes per block of the pairwise pass
constexpr int COLS = 64;      // column boxes per block: one mask word
constexpr int THREADS = 256;  // 8 warps: (row, half word) each
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 227 * 1024;  // Hopper's opt-in shared memory/block

__global__ void nms_mask_kernel(const float* __restrict__ boxes,
                                uint32_t* __restrict__ mask32, int64_t k,
                                int w, float thr) {
  __shared__ float sc[COLS * 5];
  __shared__ float sr[ROWS * 5];
  const int64_t s = blockIdx.z;
  const float* bx = boxes + s * k * 5;
  const int64_t c0 = (int64_t)blockIdx.x * COLS;
  const int64_t r0 = (int64_t)blockIdx.y * ROWS;
  const int t = threadIdx.x;
  for (int e = t; e < COLS * 5; e += THREADS)
    sc[e] = c0 + e / 5 < k ? bx[c0 * 5 + e] : 0.f;
  for (int e = t; e < ROWS * 5; e += THREADS)
    sr[e] = r0 + e / 5 < k ? bx[r0 * 5 + e] : 0.f;
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  const int row = warp >> 1, half = warp & 1;
  const int col = half * 32 + lane;
  const int64_t i = r0 + row, j = c0 + col;
  bool sup = false;
  if (i < k && j < k) {
    const float* A = sr + row * 5;
    const float* B = sc + col * 5;
    const float inter = rotated_box::intersection_area(
        A[2], A[3], A[4], B[0] - A[0], B[1] - A[1], B[2], B[3], B[4]);
    const float uni = A[2] * A[3] + B[2] * B[3] - inter;
    const float iou = inter / fmaxf(uni, 1e-8f);
    sup = iou > thr;
  }
  const unsigned bits = __ballot_sync(FULL, sup);
  if (i < k && lane == 0)
    mask32[((s * k + i) * w + blockIdx.x) * 2 + half] = bits;
}

__global__ void nms_greedy_kernel(const uint64_t* __restrict__ mask,
                                  const int* __restrict__ order,
                                  const uint8_t* __restrict__ valid,
                                  uint8_t* __restrict__ keep, int64_t nc,
                                  int64_t k, int w) {
  extern __shared__ uint64_t smem[];
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  uint64_t* removed_all = smem;            // nc * w words
  uint64_t* rows = smem + nc * w;          // the sample's k * w mask words
  const uint64_t* src = mask + s * k * w;
  for (int64_t e = tid; e < k * w; e += nthreads) rows[e] = src[e];
  for (int64_t e = tid; e < nc * w; e += nthreads) removed_all[e] = 0ull;
  uint8_t* keep_s = keep + s * nc * k;
  for (int64_t e = tid; e < nc * k; e += nthreads) keep_s[e] = 0;
  __syncthreads();

  const int c = tid >> 5, lane = tid & 31;
  uint64_t* removed = removed_all + c * w;
  const int* ord = order + (s * nc + c) * k;
  const uint8_t* val = valid + (s * nc + c) * k;
  uint8_t* kp = keep_s + c * k;
  for (int64_t base = 0; base < k; base += 32) {
    int o = 0, v = 0;
    if (base + lane < k) {
      o = ord[base + lane];
      v = val[o];
    }
    const int n = k - base < 32 ? (int)(k - base) : 32;
    for (int q = 0; q < n; ++q) {
      const int i = __shfl_sync(FULL, o, q);
      const int vi = __shfl_sync(FULL, v, q);
      const bool alive = vi && !((removed[i >> 6] >> (i & 63)) & 1ull);
      __syncwarp();  // every lane has read the word before any lane ORs
      if (alive) {
        if (lane == 0) kp[i] = 1;
        for (int u = lane; u < w; u += 32)
          removed[u] |= rows[(int64_t)i * w + u];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// greedy = 0 runs the pairwise pass alone (the suppression bitmask is the
// output; order, valid and keep are not read): the check of the bitmask
// against the plain IoU
extern "C" int nms_bev(const void* boxes, const void* order,
                       const void* valid, void* mask, void* keep,
                       long long batch, long long nc, long long k, float thr,
                       int greedy, void* stream) {
  if (batch <= 0 || nc <= 0 || k <= 0) return 0;
  const int w = (int)((k + 63) / 64);
  const size_t bytes = (size_t)(nc + k) * w * sizeof(uint64_t);
  if (nc > 32 || bytes > (size_t)SMEM_MAX || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  nms_mask_kernel<<<dim3((unsigned)w, (unsigned)((k + ROWS - 1) / ROWS),
                         (unsigned)batch),
                    THREADS, 0, st>>>((const float*)boxes, (uint32_t*)mask,
                                      (int64_t)k, w, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !greedy) return (int)err;

  // set on every call: the attribute belongs to the current device
  err = cudaFuncSetAttribute(nms_greedy_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (err != cudaSuccess) return (int)err;
  nms_greedy_kernel<<<(unsigned)batch, (unsigned)(32 * nc), bytes, st>>>(
      (const uint64_t*)mask, (const int*)order, (const uint8_t*)valid,
      (uint8_t*)keep, (int64_t)nc, (int64_t)k, w);
  return (int)cudaGetLastError();
}
