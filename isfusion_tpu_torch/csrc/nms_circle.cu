// Greedy circle NMS for Hopper (sm_90a) — K10-circle.
//
// keep[r, i] for box set r, box i: the function of
// isfusion_tpu/ops/box_ops.py:243 circle_nms_mask with :196
// _greedy_suppress (the reference's circle_nms, box3d_nms.py:181): walk
// the set's boxes by descending score (torch.sort(descending=True,
// stable=True): ties keep the lower index first); a box that is valid and
// not suppressed is kept, and it suppresses every later box whose squared
// centre distance to it is <= thr[r] (the squared distance against the
// threshold as it is, as the reference compares them). Invalid boxes
// neither keep nor suppress. The sets are independent: CenterHead.
// get_bboxes hands one launch every (sample, task) pair of a request or an
// eval batch, each with its task's min_radius.
//
// Bound: operations, and few of them. Each unordered pair of a set's K
// boxes needs one squared distance and a comparison (6 float32
// operations; box_ops.circle_nms_ops) and the score order ~K log2 K
// comparisons (box_ops.circle_order_ops): 0.77 M operations for a
// request's 6 sets of 500, ~0.01 us at 67 float32 TFLOP/s, far under one
// launch's latency. The greedy walk has an inherent serial length of K
// dependent steps, taken as K / 64 chunks on a register word.
//
// Design: one launch and no other device operation. One block of 1,024
// threads per set, everything in shared memory:
// (a) The score order. Each score becomes a key whose unsigned order is
//     torch.sort's: -0.0 is made +0.0 first (they tie), every NaN becomes
//     the largest key (torch.sort puts NaN first when descending; NaNs tie
//     among themselves), the rest the usual order-preserving image of the
//     float. When the valid boxes' keys do not increase along the index
//     (CenterHead's decode hands over top-k scores, masked boxes zeroed and
//     invalid), the index order is the score order and box i takes
//     position i. Otherwise a box's position is the number of boxes ahead
//     of it (a larger key, or an equal key and a lower index), counted by
//     a group of 1-32 lanes a box over the K keys in shared memory. Invalid
//     boxes take a position too: they start removed.
// (b) The suppression bits in score order, upper triangle only: bit
//     (p, q) for sorted positions p <= q is d2 <= thr. Chunk c (positions
//     64 c .. 64 c + 63) keeps its rows' words c .. W - 1 (W = ceil(K /
//     64)), word-major: word u of chunk c's row p lies at 64 (c W - c (c -
//     1) / 2 + u - c) + p % 64, so a warp writes 32 consecutive words and
//     reads each column centre once for all its lanes. d2 is
//     __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) with dx and dy
//     rounded first: without the intrinsics nvcc contracts the sum into an
//     FMA, and a pair exactly on the threshold would flip against the plain
//     version (box_ops.circle_nms_mask_ref). dx(p, q) is the exact negation
//     of dx(q, p), so a diagonal block is symmetric: row q of it is also
//     "who suppresses q". Positions past K hold NaN centres: no bit.
//     Warps 1-31 compute the words chunk by chunk and count each chunk's
//     finished words in shared memory, while warp 0 walks: it waits for a
//     chunk's count, so the walk overlaps the bits of later chunks.
// (c) The walk, one warp, chunk by chunk: the chunk's alive word is its
//     removed word (lane u holds removed word u, starting as the invalid
//     boxes) inverted; lane j reads diagonal-block rows j and 32 + j; the
//     chunk resolves on one 64-bit register word: a box is kept iff no kept
//     box before it suppresses it, applied to all boxes at once from "all
//     alive kept" until the word stops changing (round t settles position
//     t: at most 65 rounds, the longest chain of suppressions plus one);
//     the keep flags go to keep[r, index]; the kept rows' later words are
//     ORed into the removed words, a word at a time, by a warp reduction.
// Shared memory: 256 W (W + 1) bytes of bits and 704 W of sorted centres,
// indices and valid flags (the keys and positions reuse the bits' space),
// plus 16 W of removed words and chunk counts: 228,032 bytes at W = 28,
// so this launch takes K <= 1,792 (box_ops.CIRCLE_MAX_BOXES). The
// shared-memory attribute is set once per device.
//
// Past 1,792 boxes a set (entry nms_circle_pairwise; CenterPoint's sets of
// 500 never reach it), two launches: the wrapper sorts each set's scores
// with torch.sort(descending=True, stable=True), the order the plain
// version takes (torch's own NaN and signed-zero rules); the pairwise pass
// of csrc/nms_pairwise.cuh writes the bits d2 <= thr[r] in index order
// into a (R, K, ceil(K / 64)) scratch, d2 rounded as above, and the
// greedy pass of csrc/nms_greedy.cuh walks each set as one class. The
// mirror is exact: dx(j, i) is the exact negation of dx(i, j), so the
// squares, their sum and the comparison are the same numbers. Bound:
// operations, as above (6 a pair); refused only past 65,535 sets or the
// passes' own limits.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nms_greedy.cuh"
#include "nms_pairwise.cuh"

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_WORDS = 28;         // K <= 1,792
constexpr int MAX_DEVICES = 64;

struct CircleArgs {
  const float* centers;  // (R, K, 2), element strides cr, ck, cx
  int64_t cr, ck, cx;
  const float* scores;  // (R, K), strides sr, sk
  int64_t sr, sk;
  const uint8_t* valid;  // (R, K) bool, strides vr, vk; null: all valid
  int64_t vr, vk;
  const float* thr;  // (R,), stride tr; null: thr_value for every set
  int64_t tr;
  float thr_value;
  uint8_t* keep;  // contiguous (R, K)
  int k, w;
};

__host__ __device__ inline size_t circle_smem_bytes(int w) {
  return (size_t)256 * w * (w + 1) + (size_t)704 * w + (size_t)16 * w;
}

__device__ __forceinline__ uint32_t score_key(float s) {
  if (s != s) return 0xffffffffu;  // NaN: first, NaNs tie
  uint32_t u = __float_as_uint(s == 0.f ? 0.f : s);  // -0.0 ties +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// index (in 64-bit words) of word u of chunk c's block
__device__ __forceinline__ int block_word(int c, int u, int w) {
  return 64 * (c * w - c * (c - 1) / 2 + u - c);
}

__global__ void __launch_bounds__(THREADS)
    nms_circle_kernel(const CircleArgs a) {
  extern __shared__ uint64_t smem[];
  const int k = a.k, w = a.w, kp = 64 * w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t r = blockIdx.x;
  uint64_t* bits = smem;                              // 32 W (W + 1) words
  uint64_t* init = bits + 32 * w * (w + 1);           // W removed words
  int* done = (int*)(init + w);                       // W counts (8 bytes)
  float* sx = (float*)(done + 2 * w);                 // kp each
  float* sy = sx + kp;
  int16_t* sidx = (int16_t*)(sy + kp);
  uint8_t* sval = (uint8_t*)(sidx + kp);
  uint32_t* key = (uint32_t*)bits;                    // (a) only
  int16_t* pos = (int16_t*)(key + kp);                // (a) only

  // (a) each thread's boxes (K <= 1,792 < 2 x 1,024): centre, validity, key
  const float* cen = a.centers + r * a.cr;
  const float t = a.thr ? a.thr[r * a.tr] : a.thr_value;
  float bx[2], by[2];
  bool bv[2];
  uint32_t bk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * THREADS;
    bx[h] = by[h] = 0.f;
    bv[h] = false;
    bk[h] = 0u;
    if (i < k) {
      bx[h] = cen[i * a.ck];
      by[h] = cen[i * a.ck + a.cx];
      bv[h] = a.valid ? a.valid[r * a.vr + i * a.vk] != 0 : true;
      bk[h] = score_key(a.scores[r * a.sr + i * a.sk]);
      key[i] = bk[h];
    }
  }
  // the valid boxes as bit words in index order (init, as 32-bit halves)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * THREADS;
    const unsigned ok = __ballot_sync(FULL, bv[h]);
    if (lane == 0 && i < kp) ((uint32_t*)init)[i >> 5] = ok;
  }
  __syncthreads();
  // in index order already? each valid box's key >= the next valid box's
  bool ordered = true;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * THREADS;
    if (i < k && bv[h]) {
      int u = i >> 6;
      uint64_t m = (i & 63) == 63 ? 0ull : init[u] & (~0ull << ((i & 63) + 1));
      while (!m && ++u < w) m = init[u];
      if (m) ordered = ordered && key[64 * u + __ffsll((long long)m) - 1] <=
                                      bk[h];
    }
  }
  if (__syncthreads_and(ordered)) {
    for (int i = tid; i < k; i += THREADS) pos[i] = (int16_t)i;
  } else {
    // position = boxes ahead: a group of g lanes a box (g a power of two,
    // g K <= 1,024 when K <= 1,024), partial counts summed by shuffles
    int lg = 0;
    while (lg < 5 && (k << (lg + 1)) <= THREADS) ++lg;
    const int g = 1 << lg;
    const int rounds = (k * g + THREADS - 1) / THREADS;
    for (int q = 0; q < rounds; ++q) {
      const int e = q * THREADS + tid;
      const int i = e >> lg, sub = e & (g - 1);
      int cnt = 0;
      if (i < k) {
        const uint32_t ki = key[i];
        for (int j = sub; j < k; j += g) {
          const uint32_t kj = key[j];
          cnt += (kj > ki) | ((kj == ki) & (j < i));
        }
      }
      for (int off = g >> 1; off > 0; off >>= 1)
        cnt += __shfl_xor_sync(FULL, cnt, off);
      if (i < k && sub == 0) pos[i] = (int16_t)cnt;
    }
  }
  __syncthreads();
  // the sorted arrays (NaN centres past K: no bits)
  const float nan = __int_as_float(0x7fffffff);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = tid + h * THREADS;
    if (i < k) {
      const int p = pos[i];
      sx[p] = bx[h];
      sy[p] = by[h];
      sidx[p] = (int16_t)i;
      sval[p] = bv[h];
    } else if (i < kp) {
      sx[i] = sy[i] = nan;
      sval[i] = 0;
    }
  }
  __syncthreads();
  // the removed words start as the invalid boxes, in sorted positions
  for (int u = warp; u < w; u += THREADS / 32) {
    const uint64_t ok = ballot64(sval[64 * u + lane], sval[64 * u + lane + 32]);
    if (lane == 0) init[u] = ~ok;
  }
  if (tid < w) done[tid] = 0;
  __syncthreads();

  if (warp != 0) {
    // (b) warps 1-31: the upper triangle's words, word-major within each
    // chunk and chunk by chunk, each chunk's count of finished words
    // raised as a warp finishes 32 of them
    const int total = 32 * w * (w + 1);
    for (int e = tid - 32; e < total; e += THREADS - 32) {
      int q = e >> 6, c = 0;
      while (q >= w - c) {
        q -= w - c;
        ++c;
      }
      const int u = c + q, p = 64 * c + (e & 63);
      const float xp = sx[p], yp = sy[p];
      const float* cx = sx + 64 * u;
      const float* cy = sy + 64 * u;
      uint32_t lo = 0u, hi = 0u;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const float dx = __fsub_rn(cx[b], xp), dy = __fsub_rn(cy[b], yp);
        lo |= (uint32_t)(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <=
                         t)
              << b;
      }
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const float dx = __fsub_rn(cx[32 + b], xp);
        const float dy = __fsub_rn(cy[32 + b], yp);
        hi |= (uint32_t)(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <=
                         t)
              << b;
      }
      bits[e] = (uint64_t)lo | ((uint64_t)hi << 32);
      __threadfence_block();
      __syncwarp();
      if (lane == 0) atomicAdd(&done[c], 32);
    }
    return;
  }

  // (c) the walk
  uint64_t removed = lane < w ? init[lane] : ~0ull;
  uint8_t* kp8 = a.keep + r * k;
  const uint64_t before0 = (1ull << lane) - 1ull;
  const uint64_t before1 = (1ull << (lane + 32)) - 1ull;
  for (int c = 0; c < w; ++c) {
    // chunk c's words are ready once its 64 (W - c) words are counted
    if (lane == 0)
      while (atomicAdd(&done[c], 0) < 64 * (w - c)) __nanosleep(32);
    __syncwarp();
    __threadfence_block();
    const uint64_t alive = ~__shfl_sync(FULL, removed, c);
    uint64_t kept = 0ull;
    if (alive) {
      const uint64_t* diag = bits + block_word(c, c, w);
      const uint64_t r0 = diag[lane], r1 = diag[lane + 32];
      const bool a0 = (alive >> lane) & 1ull, a1 = (alive >> (lane + 32)) & 1ull;
      kept = alive;
      for (;;) {
        const uint64_t next = ballot64(a0 && !(r0 & kept & before0),
                                       a1 && !(r1 & kept & before1));
        if (next == kept) break;
        kept = next;
      }
      // the kept rows' later words into the removed words
#pragma unroll 4
      for (int u = c + 1; u < w; ++u) {
        const uint64_t* col = bits + block_word(c, u, w);
        uint64_t acc = ((kept >> lane) & 1ull) ? col[lane] : 0ull;
        acc |= ((kept >> (lane + 32)) & 1ull) ? col[lane + 32] : 0ull;
        const uint64_t word =
            (uint64_t)__reduce_or_sync(FULL, (unsigned)acc) |
            ((uint64_t)__reduce_or_sync(FULL, (unsigned)(acc >> 32)) << 32);
        if (lane == u) removed |= word;
      }
    }
    const int p0 = 64 * c + lane, p1 = p0 + 32;
    if (p0 < k) kp8[sidx[p0]] = (uint8_t)((kept >> lane) & 1ull);
    if (p1 < k) kp8[sidx[p1]] = (uint8_t)((kept >> (lane + 32)) & 1ull);
  }
}

bool attribute_set[MAX_DEVICES];

// squared centre distance <= the set's threshold
struct CirclePair {
  struct Box {
    float x, y;
  };
  using Ctx = float;  // the set's threshold
  const float* centers;  // (R, K, 2), element strides cr, ck, cx
  int64_t cr, ck, cx;
  const float* thr;  // (R,), stride tr; null: thr_value
  int64_t tr;
  float thr_value;

  __device__ Ctx ctx(int64_t r) const {
    return thr ? thr[r * tr] : thr_value;
  }
  __device__ Box load(int64_t r, int64_t i) const {
    const float* c = centers + r * cr + i * ck;
    return {c[0], c[cx]};
  }
  __device__ bool bit(Ctx t, const Box& a, const Box& b) const {
    const float dx = __fsub_rn(b.x, a.x), dy = __fsub_rn(b.y, a.y);
    return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) <= t;
  }
};

}  // namespace

// centers (R, K, 2) float32, scores (R, K) float32, valid (R, K) bool (or
// null: all valid) and thr (R,) float32 (or null: thr_value for all sets)
// read through their element strides: strides = (centers' three, scores'
// two, valid's two, thr's one); keep a contiguous (R, K) byte tensor.
extern "C" int nms_circle(const void* centers, const void* scores,
                          const void* valid, const void* thr, float thr_value,
                          void* keep, long long sets, long long k,
                          const long long* strides, void* stream) {
  if (sets <= 0 || k <= 0) return 0;
  const int w = (int)((k + 63) / 64);
  if (w > MAX_WORDS || sets > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t bytes = circle_smem_bytes(w);
  if (bytes > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
  if (!attribute_set[dev]) {
    err = cudaFuncSetAttribute(nms_circle_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    attribute_set[dev] = true;
  }
  const CircleArgs a{(const float*)centers, strides[0], strides[1],
                     strides[2], (const float*)scores, strides[3],
                     strides[4], (const uint8_t*)valid, strides[5],
                     strides[6], (const float*)thr, strides[7], thr_value,
                     (uint8_t*)keep, (int)k, w};
  nms_circle_kernel<<<(unsigned)sets, THREADS, bytes, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

// The route past K = 1,792: centers and thr as for nms_circle; order (R,
// K) int64, each set's stable descending score order, and valid (R, K)
// bool (or null) read through strides = (centers' three, order's two,
// valid's two, thr's one); mask a (R, K, ceil(K / 64)) 64-bit scratch;
// keep a contiguous (R, K) byte tensor.
extern "C" int nms_circle_pairwise(const void* centers, const void* order,
                                   const void* valid, const void* thr,
                                   float thr_value, void* mask, void* keep,
                                   long long sets, long long k,
                                   const long long* strides, void* stream) {
  if (sets <= 0 || k <= 0) return 0;
  if (!greedy_fits(sets, 1, k)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const CirclePair pair{(const float*)centers, strides[0], strides[1],
                        strides[2], (const float*)thr, strides[7],
                        thr_value};
  cudaError_t err = launch_pairwise(pair, (uint64_t*)mask, (int64_t)sets,
                                    (int64_t)k, st);
  if (err != cudaSuccess) return (int)err;
  const Strides sd{strides[3], 0, strides[4], strides[5], 0, strides[6]};
  return (int)launch_greedy((const uint64_t*)mask, (const int64_t*)order,
                            (const uint8_t*)valid, (uint8_t*)keep,
                            (int64_t)sets, 1, (int64_t)k, sd, st);
}
