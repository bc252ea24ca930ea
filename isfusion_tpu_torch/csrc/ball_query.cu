// Ball query for Hopper (sm_90a) — K14-ball.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:77 ball_query (an XLA
// composition that builds the whole (S, N) distance matrix, an integer key
// matrix over it and a top_k over N): for points (B, N, 3), a validity
// mask (B, N) and queries (B, S, 3), the first K points in index order
// whose squared distance to the query is <= r2 (the wrapper passes
// radius ** 2 rounded to float32, what JAX compares against), as (B, S, K)
// int32 indices and a (B, S, K) valid flag. Slots past the in-radius count
// repeat the first in-radius point (valid False); a query with no point in
// its ball takes the nearest point (masked points lie at 1e10; the lowest
// index among equal distances) in every slot, valid False. Each SA level
// of the PointNet++ backbone calls it once (VoteNet: 2,048 queries over
// 40,000 points, K 64, r 0.2; then 1,024 / 2,048, 512 / 1,024 and 256 /
// 512), the vote aggregation once (256 queries over 1,024 votes, K 16).
//
// Bound: the XLA version's (S, N) matrices are 2,048 x 40,000 x 4 bytes =
// 328 MB a sample at the first level; this kernel writes none. The least
// work is the distances a query needs before its K-th in-radius point (or
// all N for a ball with fewer than K points), 8 float operations each; the
// bytes are the points and queries read once and the outputs written once.
//
// Design: a warp a query scans the points in index order, 32 at a time
// (lane j tests point base + j: the warp reads 384 contiguous bytes), and
// stops as soon as it holds K in-radius points. The in-radius lanes of a
// chunk append their indices in lane order at the count so far plus the
// popcount of the lower lanes' ballot bits, so the list is in index order
// with no sort. Each lane also keeps its nearest point (lowest index among
// equal distances); only a warp that finds its ball empty after the whole
// scan reduces them by shuffles. A block holds 8 warps (8 queries of one
// sample); the warps of a sample read the same points from L1/L2. Squared
// distances are (dx*dx + dy*dy) + dz*dz of query minus point, rounded step
// by step (__fsub_rn, __fmul_rn, __fadd_rn): the plain version's float32
// arithmetic with no FMA contraction, so the in-radius tests, and the
// indices, are the plain version's. Allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

__global__ void __launch_bounds__(THREADS)
    ball_query_kernel(const float* __restrict__ xyz,
                      const float* __restrict__ query,
                      const uint8_t* __restrict__ mask, int64_t n,
                      int64_t s, int64_t total, int k, float r2,
                      int32_t* __restrict__ idx, uint8_t* __restrict__ valid) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (q >= total) return;                  // whole warps leave together
  const int64_t b = q / s;
  const float* p = xyz + b * n * 3;
  const uint8_t* m = mask + b * n;
  const float qx = query[3 * q], qy = query[3 * q + 1],
              qz = query[3 * q + 2];
  int32_t* o = idx + q * k;
  uint8_t* ov = valid + q * k;

  int cnt = 0, first = 0;
  float near_d = INFINITY;
  int near_i = INT_MAX;
  for (int64_t base = 0; base < n && cnt < k; base += 32) {
    const int64_t i = base + lane;
    bool in = false;
    if (i < n) {
      const float d = m[i] ? sqdist(qx, qy, qz, p[3 * i], p[3 * i + 1],
                                    p[3 * i + 2])
                           : 1e10f;
      in = d <= r2;
      if (d < near_d) {                    // points arrive in index order
        near_d = d;
        near_i = (int)i;
      }
    }
    const unsigned ballot = __ballot_sync(0xffffffffu, in);
    if (ballot != 0u && cnt == 0) first = (int)base + __ffs(ballot) - 1;
    if (in) {
      const int pos = cnt + __popc(ballot & ((1u << lane) - 1u));
      if (pos < k) o[pos] = (int32_t)i;
    }
    cnt += __popc(ballot);
  }
  const int found = cnt < k ? cnt : k;
  if (cnt == 0) {
    // an empty ball: the nearest point, the lowest index among equals
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float d2 = __shfl_down_sync(0xffffffffu, near_d, off);
      const int i2 = __shfl_down_sync(0xffffffffu, near_i, off);
      if (d2 < near_d || (d2 == near_d && i2 < near_i)) {
        near_d = d2;
        near_i = i2;
      }
    }
    first = __shfl_sync(0xffffffffu, near_i, 0);
  }
  for (int j = lane; j < k; j += 32) {
    if (j >= found) o[j] = first;
    ov[j] = j < found;
  }
}

}  // namespace

// xyz (b, n, 3), query (b, s, 3) float32, mask (b, n) uint8; idx (b, s, k)
// int32, valid (b, s, k) uint8 (torch.bool).
extern "C" int ball_query(const void* xyz, const void* query,
                          const void* mask, long long b, long long n,
                          long long s, long long k, float r2, void* idx,
                          void* valid, void* stream) {
  if (b <= 0 || s <= 0 || k <= 0) return 0;
  if (n <= 0 || n >= INT_MAX || k >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int64_t total = (int64_t)b * s;
  const int64_t blocks = (total + WARPS - 1) / WARPS;
  ball_query_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)xyz, (const float*)query, (const uint8_t*)mask,
      (int64_t)n, (int64_t)s, total, (int)k, r2, (int32_t*)idx,
      (uint8_t*)valid);
  return (int)cudaGetLastError();
}
