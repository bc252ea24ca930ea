// k nearest neighbours for Hopper (sm_90a) — K14-NN.
//
// Replaces isfusion_tpu/ops/pointnet_ops.py:66 knn (and :110 three_nn,
// which is knn with k = 3): for source points (B, N, 3), their validity
// mask (B, N) and queries (B, S, 3), the k smallest squared distances of
// each query and their indices, (B, S, k) int32 and float32, ordered by
// distance with equal distances in increasing index (lax.top_k of the
// negated distances); a masked point lies at 1e10, a NaN distance (a NaN
// coordinate) after every number, NaNs in increasing index (the plain
// version's stable torch.sort). The wrapper takes the square root for
// three_nn. The PointNet++ backbone's feature propagation
// calls it with k = 3 (VoteNet: 512 targets over 256 sources, then 1,024
// over 512). Any 1 <= k <= N.
//
// Bound: S x N distances of 8 float operations, and the comparisons that
// keep the k smallest; the bytes are the points and queries read once and
// the outputs written once.
//
// Design: a warp a query, so that FP2's 1,024 queries take 1,024 warps (the
// first design took a thread a query: 8 blocks of 128 on 8 of the 132
// SMs, each thread walking all sources in series). A block of 4 warps (4
// queries of one sample) stages the sample's sources in shared memory,
// TILE at a time, as float4 (x, y, z, valid); lane j takes sources j, j +
// 32, ... (consecutive lanes on consecutive 16-byte words) and keeps the
// KMAX smallest keys (distance, index) of its share, sorted, in registers
// (an array indexed only in unrolled loops), each as one 64-bit key: the
// distance's bits ordered as floats (NaN last) over the index, so that
// one comparison orders (distance, index). A key enters only if it is
// below the lane's last. Then the warp merges the 32 lists: min(KMAX, k)
// rounds, each a butterfly of shuffles to the warp's smallest head,
// written by lane 0 and popped by its lane. k <= 4 and k <= 16 are two
// instances; a larger k takes rounds of 16: each round keeps only keys
// above the last one written (every smaller key is out already), so the k
// smallest come in order, ceil(k / 16) scans of the sources in all.
// Squared distances are (dx*dx + dy*dy) + dz*dz of query minus point,
// rounded step by step (__fsub_rn, __fmul_rn, __fadd_rn), the plain
// version's float32 arithmetic with no FMA contraction, so the distances
// and the indices are the plain version's bit for bit. Allocates nothing
// and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// a candidate as one 64-bit key that orders as the outputs do: its squared
// distance's bits (ordered as the float, every NaN above every number, as
// torch.sort puts NaN last) over its index, so that equal distances and
// NaNs come in increasing index
using Key = unsigned long long;
constexpr Key EMPTY = ~0ull;               // above every candidate

__device__ __forceinline__ Key make_key(float d, int64_t i) {
  unsigned u = __float_as_uint(d);
  u = d != d ? 0xffffffffu : (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((Key)u << 32) | (Key)(unsigned)i;
}

__device__ __forceinline__ float key_dist(Key k) {
  const unsigned u = (unsigned)(k >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

template <int KMAX>
__global__ void __launch_bounds__(THREADS)
    knn_kernel(const float* __restrict__ xyz,
               const float* __restrict__ query,
               const uint8_t* __restrict__ mask, int64_t n, int64_t s,
               int k, int32_t* __restrict__ idx, float* __restrict__ dist) {
  __shared__ float4 tile[TILE];
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.y;
  const int64_t q = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  const bool active = q < s;               // whole warps, block-uniform k
  const float* p = xyz + b * n * 3;
  const uint8_t* m = mask + b * n;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    const float* qq = query + (b * s + q) * 3;
    qx = qq[0];
    qy = qq[1];
    qz = qq[2];
  }
  int32_t* oi = idx + (b * s + q) * k;
  float* od = dist + (b * s + q) * k;
  // keys at or below last are written already (every key is above 0)
  Key last = 0;
  for (int done = 0; done < k; done += KMAX) {
    Key bk[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) bk[j] = EMPTY;
    for (int64_t base = 0; base < n; base += TILE) {
      const int len = (int)(n - base < TILE ? n - base : TILE);
      __syncthreads();                     // the last tile is read
      for (int t = threadIdx.x; t < len; t += THREADS) {
        const float* pt = p + 3 * (base + t);
        tile[t] = make_float4(pt[0], pt[1], pt[2], m[base + t] ? 1.f : 0.f);
      }
      __syncthreads();
      if (!active) continue;
      for (int t = lane; t < len; t += 32) {
        const float4 v = tile[t];
        Key ck = make_key(
            v.w != 0.f ? sqdist(qx, qy, qz, v.x, v.y, v.z) : 1e10f, base + t);
        if (ck <= last || ck >= bk[KMAX - 1]) continue;
        bool moved = false;
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
          if (moved || ck < bk[j]) {
            const Key tk = bk[j];
            bk[j] = ck;
            ck = tk;
            moved = true;
          }
        }
      }
    }
    if (!active) continue;
    const int take = k - done < KMAX ? k - done : KMAX;
    for (int r = 0; r < take; ++r) {
      Key h = bk[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const Key o = __shfl_xor_sync(0xffffffffu, h, off);
        h = o < h ? o : h;
      }
      if (lane == 0) {
        oi[done + r] = (int32_t)(unsigned)h;
        od[done + r] = key_dist(h);
      }
      if (bk[0] == h) {                    // the lane whose head it was
#pragma unroll
        for (int j = 0; j + 1 < KMAX; ++j) bk[j] = bk[j + 1];
        bk[KMAX - 1] = EMPTY;
      }
      last = h;
    }
  }
}

}  // namespace

// xyz (b, n, 3), query (b, s, 3) float32, mask (b, n) uint8; idx (b, s, k)
// int32, dist (b, s, k) float32 squared distances; 1 <= k <= n.
extern "C" int three_nn(const void* xyz, const void* query,
                        const void* mask, long long b, long long n,
                        long long s, long long k, void* idx, void* dist,
                        void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n <= 0 || n >= INT_MAX || k < 1 || k > n || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((s + WARPS - 1) / WARPS), (unsigned)b);
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
