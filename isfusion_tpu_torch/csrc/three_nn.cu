// k nearest neighbours for Hopper (sm_90a) — K14-NN.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:66 knn (and :110 three_nn,
// which is knn with k = 3): for source points (B, N, 3), their validity
// mask (B, N) and queries (B, S, 3), the k smallest squared distances of
// each query and their indices, (B, S, k) int32 and float32, ordered by
// distance with equal distances in increasing index (lax.top_k of the
// negated distances); a masked point lies at 1e10. The wrapper takes the
// square root for three_nn. The PointNet++ backbone's feature propagation
// calls it with k = 3 (VoteNet: 512 targets over 256 sources, then 1,024
// over 512). The kernel takes k <= 16; no ported model asks for more.
//
// Bound: S x N distances of 8 float operations, and the comparisons that
// keep the k smallest; the bytes are the points and queries read once and
// the outputs written once.
//
// Design: a thread a query keeps its k best (distance, index) pairs sorted
// in registers (an array of KMAX entries, every access unrolled; k <= 4
// and k <= 16 are two instances). A block of 128 queries of one sample
// stages the sample's points in shared memory 1,024 at a time and every
// thread scans the tile in index order (the same address for all threads:
// a broadcast). A point enters the list only if strictly nearer than the
// k-th, and behind every entry at its distance, so equal distances keep
// increasing index as the stable top_k does. Squared distances are
// (dx*dx + dy*dy) + dz*dz of query minus point, rounded step by step
// (__fsub_rn, __fmul_rn, __fadd_rn), the plain version's float32
// arithmetic with no FMA contraction, so the distances and the indices are
// the plain version's bit for bit. Allocates nothing and does not
// synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int TILE = 1024;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
    knn_kernel(const float* __restrict__ xyz,
               const float* __restrict__ query,
               const uint8_t* __restrict__ mask, int64_t n, int64_t s,
               int k, int32_t* __restrict__ idx, float* __restrict__ dist) {
  __shared__ float tx[TILE], ty[TILE], tz[TILE];
  __shared__ uint8_t tm[TILE];
  const int64_t b = blockIdx.y;
  const int64_t q = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const bool active = q < s;
  const float* p = xyz + b * n * 3;
  const uint8_t* m = mask + b * n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qq = query + (b * s + q) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = INFINITY;
    bi[j] = 0;
  }
  float kth = INFINITY;                    // bd[k - 1], kept apart so that
                                           // bd is only indexed unrolled
  for (int64_t base = 0; base < n; base += TILE) {
    const int len = (int)(n - base < TILE ? n - base : TILE);
    __syncthreads();                       // the last tile is read
    for (int t = threadIdx.x; t < len; t += THREADS) {
      tx[t] = p[3 * (base + t)];
      ty[t] = p[3 * (base + t) + 1];
      tz[t] = p[3 * (base + t) + 2];
      tm[t] = m[base + t];
    }
    __syncthreads();
    if (!active) continue;
    for (int t = 0; t < len; ++t) {
      float cd = tm[t] ? sqdist(qx, qy, qz, tx[t], ty[t], tz[t]) : 1e10f;
      if (!(cd < kth)) continue;
      int ci = (int)(base + t);
      bool moved = false;
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        if (j < k && (moved || cd < bd[j])) {
          const float td = bd[j];
          const int ti = bi[j];
          bd[j] = cd;
          bi[j] = ci;
          cd = td;
          ci = ti;
          moved = true;
        }
        if (j == k - 1) kth = bd[j];
      }
    }
  }
  if (!active) return;
  int32_t* oi = idx + (b * s + q) * k;
  float* od = dist + (b * s + q) * k;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j < k) {
      oi[j] = bi[j];
      od[j] = bd[j];
    }
  }
}

}  // namespace

// xyz (b, n, 3), query (b, s, 3) float32, mask (b, n) uint8; idx (b, s, k)
// int32, dist (b, s, k) float32 squared distances; 1 <= k <= min(16, n).
extern "C" int three_nn(const void* xyz, const void* query,
                        const void* mask, long long b, long long n,
                        long long s, long long k, void* idx, void* dist,
                        void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n <= 0 || n >= INT_MAX || k < 1 || k > 16 || k > n || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s + THREADS - 1) / THREADS), (unsigned)b);
  if (k <= 4) {
    knn_kernel<4><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xyz, (const float*)query, (const uint8_t*)mask,
        (int64_t)n, (int64_t)s, (int)k, (int32_t*)idx, (float*)dist);
  } else {
    knn_kernel<16><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const float*)xyz, (const float*)query, (const uint8_t*)mask,
        (int64_t)n, (int64_t)s, (int)k, (int32_t*)idx, (float*)dist);
  }
  return (int)cudaGetLastError();
}
