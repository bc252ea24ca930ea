// Gaussian heatmap targets for Hopper (sm_90a) — K11.
//
// heat[s, y, x, c] for sample s, cell (y, x), class c: the function of
// isfusion_tpu/ops/gaussian.py:65 draw_heatmap_gaussian_batch, batched
// over samples and classes: the maximum over the valid objects of class c
// of exp(-((x - cx)^2 + (y - cy)^2) / (2 sigma^2)), cx = floor(centre x),
// cy = floor(centre y), sigma = (2 r + 1) / 6, where a cell counts only
// inside the object's square window |x - cx| <= r, |y - cy| <= r; every
// other cell is 0. CenterHead's targets (all tasks: their classes are
// contiguous channel ranges) and TransFusionHeadV2's dense heatmap target
// each make one launch per train step.
//
// Bound: bytes. The (B, H, W, C) float32 output is written once (5.2 MB
// for a CenterPoint step, B 4, 180 x 180, 10 classes: 1.5 us at 3.35
// TB/s); the windows are a few thousand cells of ~10 operations.
//
// Design: the output is zeroed (one memset), then one block per object
// and one thread per cell of its window clipped to the grid combine the
// gaussian with atomicMax on the int bits of the float. The values are
// non-negative, where the int order of the bits is the float order, so
// the result is the maximum whatever order the blocks run in.
//
// Exactness: the plain version (ops/gaussian.py:draw_heatmap_gaussian_
// batch_ref) evaluates the same float32 expression in the same order:
// sigma = (2 r + 1) / 6, den = 2 (sigma sigma), d2 = dx dx + dy dy,
// g = exp(-d2 / den), each step rounded (the _rn intrinsics keep nvcc from
// contracting into FMAs) and expf (not __expf), as PyTorch's CUDA exp. The
// peak is exp(-0) = 1 exactly: both heads count heat == 1 as positives.
// Objects with a non-finite centre or radius, or a negative radius, draw
// nothing (the heads' valid objects have neither).
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
    gaussian_heatmap_kernel(const float* __restrict__ centers,
                            const float* __restrict__ radii,
                            const uint8_t* __restrict__ valid,
                            const int64_t* __restrict__ labels,
                            float* __restrict__ heat, int64_t n, int h,
                            int w, int nc) {
  const int64_t obj = blockIdx.x;
  const int64_t s = obj / n;
  const int64_t label = labels[obj];
  const float r = radii[obj];
  const float cx = floorf(centers[2 * obj]);
  const float cy = floorf(centers[2 * obj + 1]);
  if (!valid[obj] || label < 0 || label >= nc || !isfinite(r) || r < 0.f ||
      !isfinite(cx) || !isfinite(cy))
    return;
  // the window clipped to the grid: integer cells with |x - cx| <= r
  const float fr = floorf(r);
  const float x0 = fmaxf(cx - fr, 0.f), x1 = fminf(cx + fr, (float)(w - 1));
  const float y0 = fmaxf(cy - fr, 0.f), y1 = fminf(cy + fr, (float)(h - 1));
  if (x0 > x1 || y0 > y1) return;
  const int xa = (int)x0, ya = (int)y0;
  const int nx = (int)x1 - xa + 1, ny = (int)y1 - ya + 1;
  const float sigma = __fdiv_rn(__fadd_rn(__fmul_rn(2.f, r), 1.f), 6.f);
  const float den = __fmul_rn(2.f, __fmul_rn(sigma, sigma));
  int* out = reinterpret_cast<int*>(heat) + s * (int64_t)h * w * nc + label;
  for (int e = threadIdx.x; e < nx * ny; e += THREADS) {
    const int x = xa + e % nx, y = ya + e / nx;
    const float dx = __fsub_rn((float)x, cx), dy = __fsub_rn((float)y, cy);
    if (!(fabsf(dx) <= r && fabsf(dy) <= r)) continue;
    const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float g = expf(__fdiv_rn(-d2, den));
    atomicMax(out + ((int64_t)y * w + x) * nc, __float_as_int(g));
  }
}

}  // namespace

// centers (B * N, 2) float32, radii (B * N,) float32, valid (B * N,) bool,
// labels (B * N,) int64, all contiguous; heat a contiguous (B, H, W, C)
// float32 output (zeroed here).
extern "C" int gaussian_heatmap(const void* centers, const void* radii,
                                const void* valid, const void* labels,
                                void* heat, long long batch, long long n,
                                long long h, long long w, long long nc,
                                void* stream) {
  if (batch <= 0 || h <= 0 || w <= 0 || nc <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      heat, 0, (size_t)(batch * h * w * nc) * sizeof(float), st);
  if (err != cudaSuccess || n <= 0) return (int)err;
  if (batch * n > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gaussian_heatmap_kernel<<<(unsigned)(batch * n), THREADS, 0, st>>>(
      (const float*)centers, (const float*)radii, (const uint8_t*)valid,
      (const int64_t*)labels, (float*)heat, (int64_t)n, (int)h, (int)w,
      (int)nc);
  return (int)cudaGetLastError();
}
