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
// distances tie at 0 and the lowest index wins, as jnp.argmax picks it. On
// NaN coordinates the plain version's order holds: a running distance
// that meets a NaN stays NaN (torch.minimum), and a NaN ranks above every
// number, the lowest index among NaNs (torch.argmax, jnp.argmax).
// The PointNet++ backbone calls it at every SA level (VoteNet: 40,000 ->
// 2,048, 2,048 -> 1,024, 1,024 -> 512, 512 -> 256) and the vote
// aggregation once (1,024 votes -> 256).
//
// Bound. The operations bound is S x N distance updates (9 float
// operations each) over the card's float32 rate: 0.011 ms at SA1; the
// bytes (the points read once, the picks written once) are less. What
// bounds a walk is the chain of S dependent argmax reductions, each
// waiting for the one before: the chain floor, the time of one pick's
// exchange when every thread holds one point (chip_smoke.py --k14 times it
// as 2,048 picks over C x 1,024 points, divided by 2,048: 1.25-1.26 us a
// pick for C = 8, 1.27-1.28 for C = 16, on an H100 at 700 W; SA1's walk
// adds ~0.22 (C = 16) to 0.45 (C = 8) us a pick of point updates). The
// first design of this kernel, one 1,024-thread block a sample, re-read
// all of SA1's xyz and mask (480 KB) from L2 at every pick, with two block
// barriers: one SM's L2 bandwidth, ~7.3 us a pick.
//
// Design: up to C x 8,192 points a sample the cloud is read from device
// memory once and lives in registers for the whole walk; nothing is read
// from device memory inside the pick loop (past it, the tail route below).
// - Past FPS_BLOCK_MAX points (the SA1 walk) a sample is a thread-block
//   cluster of C blocks (C = 8, or 16 as a non-portable size where the
//   batch's clusters of 16 are resident at once: fps_cluster), launched
//   with cudaLaunchKernelEx on a grid of B x C blocks of 1,024 threads.
//   Block r owns the contiguous share [r * ceil(N / C), ...) of the
//   points; thread t of it the points share + t + 1,024 * j, j < PPT (a
//   template: 1-8 points a thread, so a cluster of 8 holds 65,536 points),
//   each as x, y, z and its running distance in registers, its valid and
//   present bits in two words.
// - Each pick: every thread updates its points and keeps its best (value,
//   index, xyz); the warp reduces by __reduce_max_sync on the value's
//   order-preserving bits and __reduce_min_sync on the index among the
//   largest, and takes the winner's xyz by shuffle. The candidates are
//   published through distributed shared memory (cluster.map_shared_rank)
//   into every block's candidate array, double-buffered by the pick's
//   parity, one a block: after one block barrier warp 0 reduces the
//   block's warps and stores the block's best into every block of the
//   cluster (publishing every warp's candidate instead, C x 32 of them,
//   measured ~0.5 us a pick slower). Then one cluster barrier
//   (barrier.cluster.arrive.release / wait.acquire), and every warp of
//   every block reduces the same candidates in its own order: the rule
//   (larger value, then lower index) is order-free, so each block reaches
//   the same pick with the winner's xyz in hand. Block 0 writes the pick.
//   The first pick (the lowest valid index, or 0 when none is valid) goes
//   through the same exchange with value 1 for a valid point and 0 for
//   point 0.
// - Up to FPS_BLOCK_MAX points (SA2-SA4 and the aggregation) a sample is
//   one block of 256 threads, 1-16 points a thread in registers, the same
//   reduction with the warps' candidates in its own shared memory: one
//   block barrier a pick.
// - Past what the cluster holds in registers (C x 8,192 points) a block
//   keeps the first 8,192 points of its share in registers and streams the
//   rest (the tail: points share + 8,192 + t + 1,024 * j) from device
//   memory at every pick: their xyz from the input, their running
//   distances from a (B, N) float32 scratch that the caller passes, which
//   the kernel fills in its prologue (1e10 a valid point, -1e10 a masked
//   one: a masked tail point's running distance is never updated, so it
//   scores -1e10 as in the registers, and the mask is not read again). Each
//   thread reads and writes only its own tail slots, so no barrier guards
//   them. The route has no cap on N (below 2^31); a tail point costs 20
//   bytes of L2 traffic a pick, so its cost grows with N past the
//   registers' 65,536 (C = 8) or 131,072 (C = 16) points.
// Squared distances are (dx*dx + dy*dy) + dz*dz rounded step by step
// (__fsub_rn, __fmul_rn, __fadd_rn), the plain version's float32
// arithmetic with no FMA contraction, so the running distances and the
// picks are the plain version's bit for bit. Allocates nothing and does
// not synchronise.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CLUSTER_THREADS = 1024;
constexpr int BLOCK_THREADS = 256;
constexpr int CLUSTER_PPT = 8;     // points a thread, cluster route
constexpr int BLOCK_PPT = 16;      // points a thread, one-block route

__device__ __forceinline__ float sqdist(float ax, float ay, float az,
                                        float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx), dy = __fsub_rn(ay, by),
              dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// a float's bits as an unsigned that orders as the float does (the running
// distances are never -0, so -0 and +0 never meet). The only NaN a
// running distance holds is nan_min's canonical 0x7fffffff, whose key
// 0xffffffff ranks above every number (torch.argmax ranks a NaN first)
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// the running minimum as torch.minimum takes it: a NaN on either side
// gives the canonical NaN (fminf would drop it), so a NaN distance stays
// NaN; one instruction, as fminf's
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// one candidate: the key of its value, its index, its point's xyz
struct Best {
  unsigned key, idx;
  float x, y, z;
};

// every lane ends with the warp's best candidate
__device__ __forceinline__ void warp_best(Best& b) {
  const unsigned key = __reduce_max_sync(FULL, b.key);
  const unsigned idx = __reduce_min_sync(FULL, b.key == key ? b.idx : ~0u);
  const int owner =
      __ffs(__ballot_sync(FULL, b.key == key && b.idx == idx)) - 1;
  b.x = __shfl_sync(FULL, b.x, owner);
  b.y = __shfl_sync(FULL, b.y, owner);
  b.z = __shfl_sync(FULL, b.z, owner);
  b.key = key;
  b.idx = idx;
}

// a candidate in the arrays: its (key, index) and its xyz apart, so that
// a reduction reads 8 bytes a candidate and the winner's xyz once
__device__ __forceinline__ void store(uint2* k, float4* p, const Best& b) {
  *k = make_uint2(b.key, b.idx);
  *p = make_float4(b.x, b.y, b.z, 0.f);
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the best of n candidates (key, index in ks, xyz in ps), every lane of
// the warp ending with it
__device__ __forceinline__ Best best_of(const uint2* ks, const float4* ps,
                                        int n, int lane) {
  unsigned key = 0u, idx = ~0u;
  int slot = 0;
  for (int c = lane; c < n; c += 32) {
    const uint2 v = ks[c];
    if (v.x > key || (v.x == key && v.y < idx)) {
      key = v.x;
      idx = v.y;
      slot = c;
    }
  }
  const unsigned wk = __reduce_max_sync(FULL, key);
  const unsigned wi = __reduce_min_sync(FULL, key == wk ? idx : ~0u);
  const int owner = __ffs(__ballot_sync(FULL, key == wk && idx == wi)) - 1;
  const float4 p = ps[__shfl_sync(FULL, slot, owner)];
  return Best{wk, wi, p.x, p.y, p.z};
}

// C blocks a sample (C = 1: one block, block barriers only), THREADS
// threads a block, PPT points a thread; past one block each block
// publishes its best after one block barrier. TAIL: the block's share
// holds more than THREADS x PPT points, the rest streamed through
// ``tail`` (the running distances, (B, N) float32)
template <int C, int THREADS, int PPT, bool TAIL>
__global__ void __launch_bounds__(THREADS, 1)
    fps_kernel(const float* __restrict__ xyz,
               const uint8_t* __restrict__ mask, int n, int s,
               int32_t* __restrict__ out, float* __restrict__ tail) {
  constexpr int WARPS = THREADS / 32;
  constexpr int SLOTS = C == 1 ? WARPS : C;
  __shared__ uint2 cand_k[2][SLOTS];
  __shared__ float4 cand_p[2][SLOTS];
  __shared__ uint2 block_k[C == 1 ? 1 : WARPS];
  __shared__ float4 block_p[C == 1 ? 1 : WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = C == 1 ? 0 : (int)(blockIdx.x % C);
  const int64_t b = blockIdx.x / C;
  const float* p = xyz + b * (int64_t)n * 3;
  const uint8_t* m = mask + b * (int64_t)n;
  int32_t* o = out + b * (int64_t)s;
  const int share = (n + C - 1) / C;
  const int begin = rank * share;
  const int end = min(n, begin + share);

  // the tail of the block's share (TAIL): point tail_begin + tid +
  // THREADS * j, its running distance at td[i]
  const int tail_begin = begin + THREADS * PPT;
  float* td = TAIL ? tail + b * (int64_t)n : nullptr;
  Best first{order_key(-INFINITY), ~0u, 0.f, 0.f, 0.f};
  if constexpr (TAIL) {
    for (int i = tail_begin + tid; i < end; i += THREADS) {
      const bool v = m[i] != 0;
      td[i] = v ? 1e10f : -1e10f;
      if (v && first.idx == ~0u) {      // up: the lowest valid tail point
        const float* q = p + 3 * (int64_t)i;
        first = Best{order_key(1.f), (unsigned)i, q[0], q[1], q[2]};
      }
    }
  }

  // the block's share, read once: point begin + tid + THREADS * j (below
  // every tail point of the thread, so a valid one takes the first pick)
  float px[PPT], py[PPT], pz[PPT], pd[PPT];
  unsigned here = 0u, valid = 0u;
#pragma unroll
  for (int j = PPT - 1; j >= 0; --j) {   // down: the lowest valid wins
    const int i = begin + tid + THREADS * j;
    px[j] = py[j] = pz[j] = 0.f;
    pd[j] = 1e10f;
    if (i < end) {
      px[j] = p[3 * i];
      py[j] = p[3 * i + 1];
      pz[j] = p[3 * i + 2];
      here |= 1u << j;
      if (m[i]) {
        valid |= 1u << j;
        first = Best{order_key(1.f), (unsigned)i, px[j], py[j], pz[j]};
      } else if (i == 0 && first.key != order_key(1.f)) {
        first = Best{order_key(0.f), 0u, px[j], py[j], pz[j]};
      }
    }
  }

  auto exchange = [&](Best best, int par) -> Best {
    warp_best(best);
    if constexpr (C == 1) {
      if (lane == 0) store(&cand_k[par][warp], &cand_p[par][warp], best);
      __syncthreads();
    } else {
      cg::cluster_group cluster = cg::this_cluster();
      if (lane == 0) store(&block_k[warp], &block_p[warp], best);
      __syncthreads();
      if (warp == 0) {
        const Best wb = best_of(block_k, block_p, WARPS, lane);
        if (lane < C)
          store(cluster.map_shared_rank(&cand_k[par][rank], lane),
                cluster.map_shared_rank(&cand_p[par][rank], lane), wb);
      }
      __syncwarp();
      cluster_barrier();
    }
    return best_of(cand_k[par], cand_p[par], SLOTS, lane);
  };

  Best pick = exchange(first, 0);
  if (rank == 0 && tid == 0) o[0] = (int32_t)pick.idx;
  const unsigned masked_key = order_key(-1e10f);
  const unsigned absent_key = order_key(-INFINITY);
  for (int k = 1; k < s; ++k) {
    Best best{absent_key, ~0u, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < PPT; ++j) {       // up: ties keep the lower index
      const float d = nan_min(pd[j], sqdist(px[j], py[j], pz[j], pick.x,
                                            pick.y, pick.z));
      pd[j] = d;
      const unsigned key = (valid >> j) & 1u ? order_key(d)
                           : (here >> j) & 1u ? masked_key : absent_key;
      if (key > best.key) {
        best = Best{key, (unsigned)(begin + tid + THREADS * j), px[j],
                    py[j], pz[j]};
      }
    }
    if constexpr (TAIL) {
      for (int i = tail_begin + tid; i < end; i += THREADS) {
        const float* q = p + 3 * (int64_t)i;
        const float x = q[0], y = q[1], z = q[2];
        const float old = td[i];
        unsigned key = masked_key;           // a masked point keeps -1e10
        if (old != -1e10f) {
          const float d = nan_min(old, sqdist(x, y, z, pick.x, pick.y,
                                              pick.z));
          td[i] = d;
          key = order_key(d);
        }
        if (key > best.key) best = Best{key, (unsigned)i, x, y, z};
      }
    }
    pick = exchange(best, k & 1);
    if (rank == 0 && tid == 0) o[k] = (int32_t)pick.idx;
  }
}

template <int C, int THREADS, int PPT, bool TAIL = false>
int launch(const float* xyz, const uint8_t* mask, int b, int n, int s,
           int32_t* out, float* tail, cudaStream_t st) {
  auto kern = fps_kernel<C, THREADS, PPT, TAIL>;
  if constexpr (C == 1) {
    kern<<<b, THREADS, 0, st>>>(xyz, mask, n, s, out, tail);
    return (int)cudaGetLastError();
  } else {
    if constexpr (C > 8) {
      static bool allowed = false;
      if (!allowed) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        allowed = true;
      }
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(b * C));
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e =
        cudaLaunchKernelEx(&cfg, kern, xyz, mask, n, s, out, tail);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
}

template <int C>
int launch_cluster(const float* xyz, const uint8_t* mask, int b, int n,
                   int s, int32_t* out, float* tail, cudaStream_t st) {
  const int share = (n + C - 1) / C;
  if (share > CLUSTER_THREADS * CLUSTER_PPT) {
    if (tail == nullptr) return (int)cudaErrorInvalidValue;
    return launch<C, CLUSTER_THREADS, CLUSTER_PPT, true>(xyz, mask, b, n, s,
                                                         out, tail, st);
  }
  switch ((share + CLUSTER_THREADS - 1) / CLUSTER_THREADS) {
#define FPS_CASE(P)                                                       \
  case P:                                                                 \
    return launch<C, CLUSTER_THREADS, P>(xyz, mask, b, n, s, out, nullptr, \
                                         st);
    FPS_CASE(1) FPS_CASE(2) FPS_CASE(3) FPS_CASE(4)
    FPS_CASE(5) FPS_CASE(6) FPS_CASE(7) FPS_CASE(8)
#undef FPS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_block(const float* xyz, const uint8_t* mask, int b, int n, int s,
                 int32_t* out, cudaStream_t st) {
  switch ((n + BLOCK_THREADS - 1) / BLOCK_THREADS) {
#define FPS_CASE(P)                                                      \
  case P:                                                                \
    return launch<1, BLOCK_THREADS, P>(xyz, mask, b, n, s, out, nullptr, \
                                       st);
    FPS_CASE(1) FPS_CASE(2) FPS_CASE(3) FPS_CASE(4)
    FPS_CASE(5) FPS_CASE(6) FPS_CASE(7) FPS_CASE(8)
    FPS_CASE(9) FPS_CASE(10) FPS_CASE(11) FPS_CASE(12)
    FPS_CASE(13) FPS_CASE(14) FPS_CASE(15) FPS_CASE(16)
#undef FPS_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The cluster size of the route past FPS_BLOCK_MAX for b samples: 16 when
// b clusters of 16 blocks are resident at once (cudaOccupancyMaxActive-
// Clusters, asked once), else 8, the portable size, whose clusters all fit
// at VoteNet's batch of 8. At one sample 16 walks SA1 faster (its
// threads hold 3 points, not 5); past the resident count a cluster of 16
// would wait for another to end.
extern "C" int fps_cluster(long long b) {
  static int resident16 = -1;
  if (resident16 < 0) {
    auto kern = fps_kernel<16, CLUSTER_THREADS, CLUSTER_PPT, false>;
    int count = 0;
    if (cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
        cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(16);
      cfg.blockDim = dim3(CLUSTER_THREADS);
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = 16;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      if (cudaOccupancyMaxActiveClusters(&count, kern, &cfg) != cudaSuccess)
        count = 0;
    }
    cudaGetLastError();        // a refused query leaves no error behind
    resident16 = count;
  }
  return b <= resident16 ? 16 : 8;
}

// xyz (b, n, 3) float32, mask (b, n) uint8, out (b, s) int32. cluster: 1
// (one 256-thread block a sample, n <= 4,096), 8 or 16 (a cluster of that
// many 1,024-thread blocks a sample; past cluster * 8,192 points the tail
// route, which needs tail: a (b, n) float32 scratch, else unused).
extern "C" int furthest_point_sample(const void* xyz, const void* mask,
                                     long long b, long long n, long long s,
                                     void* out, int cluster, void* tail,
                                     void* stream) {
  if (b <= 0 || s <= 0) return 0;
  if (n <= 0 || n >= ((long long)1 << 31) || b > 65535 ||
      s >= ((long long)1 << 31))
    return (int)cudaErrorInvalidValue;
  const float* x = (const float*)xyz;
  const uint8_t* m = (const uint8_t*)mask;
  int32_t* o = (int32_t*)out;
  float* t = (float*)tail;
  cudaStream_t st = (cudaStream_t)stream;
  if (cluster == 1) {
    if (n > (long long)BLOCK_THREADS * BLOCK_PPT)
      return (int)cudaErrorInvalidValue;
    return launch_block(x, m, (int)b, (int)n, (int)s, o, st);
  }
  if (cluster != 8 && cluster != 16) return (int)cudaErrorInvalidValue;
  if (cluster == 8)
    return launch_cluster<8>(x, m, (int)b, (int)n, (int)s, o, t, st);
  return launch_cluster<16>(x, m, (int)b, (int)n, (int)s, o, t, st);
}
