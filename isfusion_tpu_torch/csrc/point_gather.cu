// Point gathers for Hopper (sm_90a) — K14-gather — forward and backward.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:61 gather_points, :105
// group_points and :118 three_interpolate (XLA gathers of (N, C) rows,
// and the interpolation's weighted sum over its 3 slots), with their
// gradients. The PointNet++ backbone gathers each SA level's sampled xyz
// (S rows), groups each ball's xyz and features (S x K rows) and
// interpolates each FP level's features (S x 3 rows); the vote
// aggregation gathers and groups the votes, whose coordinates are
// learned, so the backward carries gradients to them.
//
// Each form is a sum over flattened slots: feats (B, N, C) float32, idx
// (B * R * J) int32 into each sample's N rows, weights (B * R * J) or none
// (then J = 1: a copy), out (B, R, C) with out[r] = sum_{j < J} w[r, j] *
// feats[idx[r, j]] added in slot order (the JAX package's reduction over
// the 3 slots). Row widths are any C: xyz rows are 3 floats (12 bytes),
// which K12's 16-byte rows do not take.
//
// op 0, forward: a thread an output element, the channel fastest, so a
//   warp writes contiguous bytes and reads each slot's source row as
//   contiguous bytes too.
// op 1, the features' gradient: gfeats[n] = sum over the slots that read
//   row n, in increasing slot order, of w * g[slot's row] (w = 1 without
//   weights): a thread an element of gfeats walks the row's list (ptr, the
//   CSR offsets (B * N + 1), and the slot ids grouped by row, each row's in
//   increasing order; the wrapper builds them with a stable sort). No
//   atomics: the sums run in one fixed order and repeat bit for bit.
// op 2, the weights' gradient: gw[slot] = sum_c g[row, c] * feats[idx, c],
//   a warp a slot: each lane sums its channels in order, then a fixed
//   butterfly of shuffles adds the 32 partial sums.
//
// Bound: bytes. The forward reads each distinct source row once and the
// indices and weights once, and writes the output once; the backward reads
// the output gradient, the lists and the weights once and writes the
// gradients once. Products and sums are rounded step by step (__fmul_rn,
// __fadd_rn: no FMA contraction), so the forward equals the plain version
// bit for bit. An index outside [0, N) stops the kernel (__trap: the
// launch fails with a CUDA error, where the plain version's torch.gather
// raises) instead of reading another row. Allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// a slot's source row; an index outside [0, n) is a fault upstream: stop
__device__ __forceinline__ int64_t source_row(int32_t s, int64_t n) {
  if (s < 0 || s >= n) __trap();
  return s;
}

__global__ void __launch_bounds__(THREADS)
    gather_kernel(const float* __restrict__ feats,
                  const int32_t* __restrict__ idx,
                  const float* __restrict__ w, float* __restrict__ out,
                  int64_t rows, int j, int64_t n, int64_t c, int64_t r) {
  const int64_t total = rows * c;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t row = e / c, ch = e - row * c;
    const float* src = feats + (row / r) * n * c + ch;
    const int32_t* ri = idx + row * j;
    float acc;
    if (w == nullptr) {
      acc = src[source_row(ri[0], n) * c];
    } else {
      const float* rw = w + row * j;
      acc = 0.f;
      for (int t = 0; t < j; ++t) {
        const float v = __fmul_rn(src[source_row(ri[t], n) * c], rw[t]);
        acc = t == 0 ? v : __fadd_rn(acc, v);
      }
    }
    out[e] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
    scatter_kernel(const float* __restrict__ g,
                   const int32_t* __restrict__ slots,
                   const float* __restrict__ w,
                   const int32_t* __restrict__ ptr, float* __restrict__ out,
                   int64_t src_rows, int j, int64_t c) {
  const int64_t total = src_rows * c;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const int64_t row = e / c, ch = e - row * c;
    float acc = 0.f;
    for (int32_t l = ptr[row]; l < ptr[row + 1]; ++l) {
      const int64_t slot = slots[l];
      const float v = g[(slot / j) * c + ch];
      acc = __fadd_rn(acc, w == nullptr ? v : __fmul_rn(w[slot], v));
    }
    out[e] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
    weight_grad_kernel(const float* __restrict__ g,
                       const float* __restrict__ feats,
                       const int32_t* __restrict__ idx,
                       float* __restrict__ out, int64_t slots, int j,
                       int64_t n, int64_t c, int64_t r) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t slot = (int64_t)blockIdx.x * (THREADS / 32) +
                      (threadIdx.x >> 5);
       slot < slots; slot += warps) {
    const int64_t row = slot / j;
    const float* gr = g + row * c;
    const float* fr = feats + ((row / r) * n + source_row(idx[slot], n)) * c;
    float acc = 0.f;
    for (int64_t ch = lane; ch < c; ch += 32)
      acc = __fadd_rn(acc, __fmul_rn(gr[ch], fr[ch]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
    if (lane == 0) out[slot] = acc;
  }
}

unsigned grid_for(int64_t work) {
  int64_t blocks = (work + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;            // grid-stride beyond
  return (unsigned)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

}  // namespace

// op 0: a = feats (B, N, C), idx (rows * j), w (rows * j) or null, out
//       (rows, C); r rows a sample.
// op 1: a = g (B * R, C), idx = the slot ids grouped by source row, w
//       (B * R * j) or null, ptr (rows + 1), out (rows = B * N, C).
// op 2: a = g (B * R, C), b = feats (B, N, C), idx (rows * j), out
//       (rows * j); r rows a sample.
extern "C" int point_gather(int op, const void* a, const void* b,
                            const void* idx, const void* w, const void* ptr,
                            void* out, long long rows, long long j,
                            long long n, long long c, long long r,
                            void* stream) {
  if (rows <= 0 || c <= 0) return 0;
  if (j < 1 || j > INT_MAX || n <= 0 || n >= INT_MAX || r <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) {
    gather_kernel<<<grid_for(rows * c), THREADS, 0, st>>>(
        (const float*)a, (const int32_t*)idx, (const float*)w, (float*)out,
        rows, (int)j, n, c, r);
  } else if (op == 1) {
    scatter_kernel<<<grid_for(rows * c), THREADS, 0, st>>>(
        (const float*)a, (const int32_t*)idx, (const float*)w,
        (const int32_t*)ptr, (float*)out, rows, (int)j, c);
  } else if (op == 2) {
    weight_grad_kernel<<<grid_for(rows * j * 32), THREADS, 0, st>>>(
        (const float*)a, (const float*)b, (const int32_t*)idx, (float*)out,
        rows * j, (int)j, n, c, r);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
