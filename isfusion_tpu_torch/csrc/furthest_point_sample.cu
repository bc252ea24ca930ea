// Furthest-point sampling for Hopper (sm_90a) — K14-FPS.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:33 furthest_point_sample (an
// XLA fori_loop of dependent picks, vmapped over the batch): for points
// (B, N, 3) float32 and a validity mask (B, N), S indices a sample. The
// first pick is the first valid point (0 when none is); each running
// distance starts at 1e10 and takes the minimum of the squared distance to
// every new pick; the next pick is the largest running distance among the
// valid points (a masked point scores -1e10), the lowest index among equal
// ones. With exact duplicates, or more samples than valid points, the
// distances tie at 0 and the lowest index wins, as jnp.argmax picks it.
// The PointNet++ backbone calls it at every SA level (VoteNet: 40,000 ->
// 2,048, 2,048 -> 1,024, 1,024 -> 512, 512 -> 256) and the vote
// aggregation once (1,024 votes -> 256).
//
// Bound: the picks are serial. The work is S x N distance updates (about
// 12 float operations each) and the bytes are the points read once and the
// picks written once, both far below a millisecond on the card; what
// bounds the kernel is the chain of S dependent block-wide argmax
// reductions, each waiting for the one before.
//
// Design: one block of 1,024 threads a sample walks the S picks. A thread
// owns the points t, t + 1024, ...: each step it reads its points (the
// warp's 32 neighbouring points are 384 contiguous bytes), updates their
// running distances, kept in shared memory (up to 50,000 points: the
// entry point refuses more), and keeps its best (value, index). The warps
// reduce by shuffles, then warp 0 reduces the 32 warp results and
// publishes the pick: two barriers a step. At batch 1 one SM of 132
// works; a cluster that spreads a sample's points over several SMs is
// left for later. Squared distances are (dx*dx + dy*dy) + dz*dz
// rounded step by step (__fsub_rn, __fmul_rn, __fadd_rn), the plain
// version's float32 arithmetic with no FMA contraction, so the running
// distances and the picks are the plain version's bit for bit. Allocates
// nothing and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (v, i) becomes the better of itself and (v2, i2): the larger value, the
// lower index among equal values
__device__ __forceinline__ void better(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ void warp_best(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_down_sync(0xffffffffu, v, off);
    const int i2 = __shfl_down_sync(0xffffffffu, i, off);
    better(v, i, v2, i2);
  }
}

__global__ void __launch_bounds__(THREADS)
    fps_kernel(const float* __restrict__ xyz,
               const uint8_t* __restrict__ mask, int64_t n, int64_t s,
               int32_t* __restrict__ out) {
  extern __shared__ float dist[];
  __shared__ float warp_v[WARPS];
  __shared__ int warp_i[WARPS];
  __shared__ int pick;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = blockIdx.x;
  const float* p = xyz + b * n * 3;
  const uint8_t* m = mask + b * n;
  int32_t* o = out + b * s;

  // the first valid point: the lowest valid index (0 when none is valid)
  int first = INT_MAX;
  for (int64_t i = tid; i < n; i += THREADS) {
    dist[i] = 1e10f;
    if (m[i] && i < first) first = (int)i;
  }
  float fv = first == INT_MAX ? 0.f : 1.f;   // valid first beats none
  int fi = first == INT_MAX ? 0 : first;
  // a valid candidate wins over "none"; among valid, the lowest index
  // wins: rank (1, -i) by value 1 and lower index
  warp_best(fv, fi);
  if (lane == 0) {
    warp_v[warp] = fv;
    warp_i[warp] = fi;
  }
  __syncthreads();
  if (warp == 0) {
    fv = warp_v[lane];
    fi = warp_i[lane];
    warp_best(fv, fi);
    if (lane == 0) {
      pick = fv > 0.f ? fi : 0;
      o[0] = pick;
    }
  }
  __syncthreads();
  int last = pick;

  for (int64_t k = 1; k < s; ++k) {
    const float lx = p[3 * last], ly = p[3 * last + 1], lz = p[3 * last + 2];
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int64_t i = tid; i < n; i += THREADS) {
      const float d = fminf(dist[i], sqdist(p[3 * i], p[3 * i + 1],
                                            p[3 * i + 2], lx, ly, lz));
      dist[i] = d;
      better(bv, bi, m[i] ? d : -1e10f, (int)i);
    }
    warp_best(bv, bi);
    if (lane == 0) {
      warp_v[warp] = bv;
      warp_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = warp_v[lane];
      bi = warp_i[lane];
      warp_best(bv, bi);
      if (lane == 0) {
        pick = bi;
        o[k] = bi;
      }
    }
    __syncthreads();
    last = pick;
  }
}

}  // namespace

// xyz (b, n, 3) float32, mask (b, n) uint8, out (b, s) int32; n <= 50,000
// (the running distances live in shared memory).
extern "C" int furthest_point_sample(const void* xyz, const void* mask,
                                     long long b, long long n, long long s,
                                     void* out, void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n <= 0 || n > 50000) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  fps_kernel<<<(unsigned)b, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)xyz, (const uint8_t*)mask, (int64_t)n, (int64_t)s,
      (int32_t*)out);
  return (int)cudaGetLastError();
}
