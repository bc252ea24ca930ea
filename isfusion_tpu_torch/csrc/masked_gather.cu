// Masked row gather for Hopper (sm_90a): out[i] = fmask[i] ? src[idx[i]] : 0.
//
// Replaces the repository's one Pallas TPU kernel,
// tools/analysis_tools/micro_dma_gather.py:make_dma_gather (pallas_call at
// :97), a run-descriptor DMA gather. In the port it forms the im2col rows of
// every sparse 3D conv (ops/sparse_conv.py): row i of the output is the
// input site that tap (i % 27) of output site (i / 27) reads, or zeros where
// that neighbour is not active.
//
// Bound: pure data movement. Each distinct kept source row must be read
// once and every output row written once, so the least time is
//   (n_distinct_kept * row_bytes + n * row_bytes + n * (4 + 1)) / 3.35 TB/s
// on an H100 SXM; the written output dominates. Masked rows read nothing
// from src.
//
// Design: the TPU kernel grouped aligned runs of consecutive source rows
// into one DMA. On the GPU the same locality becomes plain coalescing: the
// output is walked as a flat array of 16-byte vectors, thread t moving
// vector t, so neighbouring threads write neighbouring addresses and, where
// consecutive output rows read consecutive source rows (the near-monotone
// neighbour slots of a sorted site table), also read neighbouring
// addresses. 16-byte loads and stores need rows that are a multiple of
// 16 bytes (8 bf16 or 4 f32 values); the wrapper enforces it. The kernel
// moves bytes, so it serves every element type of that row width. It runs
// on the caller's stream, allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void masked_gather_kernel(const uint4* __restrict__ src,
                                     const int32_t* __restrict__ idx,
                                     const uint8_t* __restrict__ fmask,
                                     uint4* __restrict__ out,
                                     int64_t n_vec, int64_t vpr,
                                     int64_t v) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       t < n_vec; t += stride) {
    const int64_t row = t / vpr;
    const int64_t col = t - row * vpr;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (fmask[row]) {
      int64_t s = idx[row];
      s = s < 0 ? 0 : (s >= v ? v - 1 : s);
      val = __ldg(src + s * vpr + col);
    }
    out[t] = val;
  }
}

}  // namespace

extern "C" int masked_gather(const void* src, const void* idx,
                             const void* fmask, void* out, long long n,
                             long long v, long long row_bytes,
                             void* stream) {
  if (n <= 0) return 0;
  if (row_bytes <= 0 || row_bytes % 16 != 0 || v <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t vpr = row_bytes / 16;
  const int64_t n_vec = (int64_t)n * vpr;
  const int threads = 256;
  int64_t blocks = (n_vec + threads - 1) / threads;
  const int64_t max_blocks = 132 * 32;  // grid-stride beyond ~32 blocks/SM
  if (blocks > max_blocks) blocks = max_blocks;
  masked_gather_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
      (const uint4*)src, (const int32_t*)idx, (const uint8_t*)fmask,
      (uint4*)out, n_vec, vpr, (int64_t)v);
  return (int)cudaGetLastError();
}
