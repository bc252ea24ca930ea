// An empty kernel: the floor of one launch on the card (no TPU
// counterpart). chip_smoke.py times it beside the kernels whose bounds lie
// under one launch's latency (K10, K10-circle), through the same ctypes
// route as their wrappers: the practical target of such a kernel.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
