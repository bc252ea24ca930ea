// Dynamic scatter for Hopper (sm_90a) — K2: per-segment max (with its
// gradient) and mean of point rows, read through each segment's list of
// rows.
//
// Replaces the XLA compositions isfusion_tpu/ops/voxel.py:169
// dynamic_scatter, ops/scatter.py:28 segment_max and :33 segment_mean:
// for data (P, C) float32 and S segments, out[s] is the max (or mean) over
// the rows of segment s, 0 for an empty segment. The rows come as a CSR
// list: segment s holds rows order[ptr[s]:ptr[s + 1]] (int32), in
// increasing row order — K1 (dynamic_voxelize.cu) emits it with each
// voxelization, or builds it from segment ids for a caller that has none.
// DynamicVFE (the IS-Fusion flagship and MVX-Net) takes the voxel mean of
// xyz (C = 3) and the voxel max of every layer's point features (C = 64,
// 128) through it, on every request and train step.
//
// Bound: bytes. Each call reads the rows and ids once and writes the
// segments once: (P * C + P) * 4 + P * 8 + S * C * 4 bytes (the max's
// backward also reads the output and its gradient and writes the rows'
// gradient). The list takes the ids' place here: (P + S + 1) * 4 bytes.
//
// Design: a segmented reduction with no atomics. A group of G lanes (a
// power of two, up to a warp) takes one segment; lane l takes channels
// [l * V, l * V + V), then every G * V-th, with V = 4 (16-byte loads) when
// C is a multiple of 4 and the rows are 16-byte aligned, else 1. C = 64
// gives 16 lanes a segment, C = 128 a warp, C = 3 four lanes (three
// working). The group walks the segment's rows in list order, each row's
// channels read once through the list, and writes the segment's result
// straight to out.
// op 0, max: the largest order-preserving unsigned image of the float
// (f >= 0: bits | 2^31; f < 0: ~bits), 0 for an empty segment (-> 0.0f). A
// maximum does not depend on the order, so the result equals the plain
// version's (scatter_reduce amax) bit for bit.
// op 1, the max's backward: the same walk twice. The first counts the rows
// equal to out[s, c] (the ties); the second writes grad_in = eq * (grad_out
// / ties) with eq 1 or 0, rounded as the plain version rounds (_rn
// intrinsics; 0 times a negative share is -0, as in PyTorch).
// op 2, mean: the sum from 0 in list order — increasing row order, the
// CPU's index_add_ order — over the count, so the mean repeats from run to
// run and equals the plain version on the CPU bit for bit.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ uint32_t order_key(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t k) {
  if (k == 0u) return 0.f;               // empty segment
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

template <int V>
__device__ __forceinline__ void load(const float* __restrict__ p,
                                     float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* __restrict__ p,
                                      const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

// The group of 2^g lanes of thread t: its segment, or -1 past the last.
__device__ __forceinline__ int64_t group_segment(int g, int64_t s,
                                                 int* lane) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  *lane = (int)(t & ((1 << g) - 1));
  const int64_t seg = t >> g;
  return seg < s ? seg : -1;
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    max_kernel(const float* __restrict__ data, const int32_t* __restrict__ ptr,
               const int32_t* __restrict__ order, int64_t s, int64_t c, int g,
               float* __restrict__ out) {
  int lane;
  const int64_t seg = group_segment(g, s, &lane);
  if (seg < 0) return;
  const int32_t begin = ptr[seg], end = ptr[seg + 1];
  for (int64_t c0 = (int64_t)lane * V; c0 < c; c0 += (int64_t)V << g) {
    uint32_t key[V];
#pragma unroll
    for (int q = 0; q < V; ++q) key[q] = 0u;
    for (int32_t k = begin; k < end; ++k) {
      float v[V];
      load<V>(data + (int64_t)order[k] * c + c0, v);
#pragma unroll
      for (int q = 0; q < V; ++q) key[q] = max(key[q], order_key(v[q]));
    }
    float o[V];
#pragma unroll
    for (int q = 0; q < V; ++q) o[q] = key_value(key[q]);
    store<V>(out + seg * c + c0, o);
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    max_grad_kernel(const float* __restrict__ data,
                    const int32_t* __restrict__ ptr,
                    const int32_t* __restrict__ order, int64_t s, int64_t c,
                    int g, const float* __restrict__ out,
                    const float* __restrict__ grad_out,
                    float* __restrict__ grad_in) {
  int lane;
  const int64_t seg = group_segment(g, s, &lane);
  if (seg < 0) return;
  const int32_t begin = ptr[seg], end = ptr[seg + 1];
  for (int64_t c0 = (int64_t)lane * V; c0 < c; c0 += (int64_t)V << g) {
    float o[V], share[V];
    uint32_t ties[V];
    load<V>(out + seg * c + c0, o);
    load<V>(grad_out + seg * c + c0, share);
#pragma unroll
    for (int q = 0; q < V; ++q) ties[q] = 0u;
    for (int32_t k = begin; k < end; ++k) {
      float v[V];
      load<V>(data + (int64_t)order[k] * c + c0, v);
#pragma unroll
      for (int q = 0; q < V; ++q) ties[q] += v[q] == o[q];
    }
#pragma unroll
    for (int q = 0; q < V; ++q) share[q] = __fdiv_rn(share[q], (float)ties[q]);
    for (int32_t k = begin; k < end; ++k) {
      const int64_t row = (int64_t)order[k] * c + c0;
      float v[V];
      load<V>(data + row, v);
#pragma unroll
      for (int q = 0; q < V; ++q)
        v[q] = __fmul_rn(v[q] == o[q] ? 1.f : 0.f, share[q]);
      store<V>(grad_in + row, v);
    }
  }
}

template <int V>
__global__ void __launch_bounds__(THREADS)
    mean_kernel(const float* __restrict__ data,
                const int32_t* __restrict__ ptr,
                const int32_t* __restrict__ order, int64_t s, int64_t c,
                int g, float* __restrict__ out) {
  int lane;
  const int64_t seg = group_segment(g, s, &lane);
  if (seg < 0) return;
  const int32_t begin = ptr[seg], end = ptr[seg + 1];
  const float denom = (float)(end > begin ? end - begin : 1);
  for (int64_t c0 = (int64_t)lane * V; c0 < c; c0 += (int64_t)V << g) {
    float acc[V];
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = 0.f;
    for (int32_t k = begin; k < end; ++k) {
      float v[V];
      load<V>(data + (int64_t)order[k] * c + c0, v);
#pragma unroll
      for (int q = 0; q < V; ++q) acc[q] = __fadd_rn(acc[q], v[q]);
    }
#pragma unroll
    for (int q = 0; q < V; ++q) acc[q] = __fdiv_rn(acc[q], denom);
    store<V>(out + seg * c + c0, acc);
  }
}

template <int V>
int launch(int op, const float* data, const int32_t* ptr,
           const int32_t* order, int64_t s, int64_t c, float* out,
           const float* grad_out, float* grad_in, cudaStream_t st) {
  const int64_t lanes_wanted = V == 4 ? c / 4 : c;
  int g = 0;
  while ((1 << g) < lanes_wanted && g < 5) ++g;
  const unsigned blocks = (unsigned)(((s << g) + THREADS - 1) / THREADS);
  if (op == 0)
    max_kernel<V><<<blocks, THREADS, 0, st>>>(data, ptr, order, s, c, g, out);
  else if (op == 1)
    max_grad_kernel<V><<<blocks, THREADS, 0, st>>>(
        data, ptr, order, s, c, g, out, grad_out, grad_in);
  else
    mean_kernel<V><<<blocks, THREADS, 0, st>>>(data, ptr, order, s, c, g,
                                               out);
  return (int)cudaGetLastError();
}

}  // namespace

// op 0 (max): out (S, C).
// op 1 (max backward): out = the forward's output, grad_out (S, C),
//      grad_in (P, C), every row of which the list holds.
// op 2 (mean): out (S, C).
// ptr (S + 1) and order (P) int32: segment s holds the rows
// order[ptr[s]:ptr[s + 1]], in increasing order.
extern "C" int dynamic_scatter(int op, const void* data, const void* ptr,
                               const void* order, long long p, long long c,
                               long long s, void* out, const void* grad_out,
                               void* grad_in, void* stream) {
  if (op < 0 || op > 2 || p < 0 || c <= 0 || s < 0)
    return (int)cudaErrorInvalidValue;
  if (s == 0) return 0;
  const uintptr_t addr = (uintptr_t)data | (uintptr_t)out |
                         (uintptr_t)grad_out | (uintptr_t)grad_in;
  cudaStream_t st = (cudaStream_t)stream;
  if (c % 4 == 0 && addr % 16 == 0)
    return launch<4>(op, (const float*)data, (const int32_t*)ptr,
                     (const int32_t*)order, s, c, (float*)out,
                     (const float*)grad_out, (float*)grad_in, st);
  return launch<1>(op, (const float*)data, (const int32_t*)ptr,
                   (const int32_t*)order, s, c, (float*)out,
                   (const float*)grad_out, (float*)grad_in, st);
}
