// The greedy walk of K10-NMS (csrc/nms_bev.cu; K10-circle, csrc/
// nms_circle.cu, walks its own score-ordered bits): keep masks from
// a (K, ceil(K / 64)) 64-bit suppression bitmask per sample, bit (i, j) =
// box i suppresses box j, for C score orders of that sample — the
// function of isfusion_tpu/ops/box_ops.py:196 _greedy_suppress: walk the
// boxes by descending score (the wrapper's stable sort: ties keep the
// lower index first); a valid box that no kept box suppresses is kept.
// Invalid boxes neither keep nor suppress.
//
// One block per sample, one warp per score order (class). Each class has
// a removed-bitmask of ceil(K / 64) words in shared memory, which starts
// as the class's invalid boxes (so validity is read once). Where the
// sample's mask fits beside them (128 KB at K = 1,000), all 1,024 threads
// first copy it into shared memory; past that (K > 1,344 at any class count,
// such as a test-time merge of four views' 500 boxes) the walk reads the
// mask rows from global memory (K^2 / 8 bytes a sample: 500 KB at K =
// 2,000, held in L2), the same steps on the same words.
// The warp walks its class's sorted order 64 positions at a time:
// (a) the chunk's alive word: not removed (two ballots); the alive
//     positions are compacted, lane j holding the j-th and (32 + j)-th;
// (b) their submatrix in sorted order: lane j forms the row of alive box
//     j, bit i = mask bit (box i, box j), one mask row read by all lanes
//     at a time, fixed trip counts (32 columns, 64 when more than 32 are
//     alive), so the loads and shuffles pipeline;
// (c) the chunk resolved on one 64-bit register word: a box is kept iff
//     no kept box before it suppresses it. The warp applies that rule to
//     all boxes at once (one ballot a round) from "all kept" until the
//     word stops changing: round t settles box t, and the greedy walk's
//     result is the only word the rule leaves unchanged. Rounds: the
//     longest chain of suppressions in the chunk, plus one (at most 65),
//     each a few register operations;
// (d) the keep flags, and the kept boxes' mask rows ORed into the
//     removed-bitmask, one word a lane (32 words a pass).
// A box is suppressed only by a kept box earlier in the order: the same
// result as one step a box. Shared memory: (C + K) * ceil(K / 64) words
// with the mask, C * ceil(K / 64) without it; launch_greedy refuses more
// than 32 classes or C * ceil(K / 64) words over SMEM_MAX (K > 58,112 at
// 32 classes).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GREEDY_THREADS = 1024;  // greedy pass: all copy, C walk
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 227 * 1024;  // Hopper's opt-in shared memory/block

// element strides of the (B, C, K) order (int64) and valid (bool) tensors
struct Strides {
  int64_t ob, oc, ok, vb, vc, vk;
};

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return (uint64_t)__ballot_sync(FULL, lo) |
         ((uint64_t)__ballot_sync(FULL, hi) << 32);
}

__device__ __forceinline__ bool bit(const uint64_t* words, int i) {
  return (words[i >> 6] >> (i & 63)) & 1ull;
}

// position (0..63) of the j-th set bit of m (j from 0, j < popc(m)), by
// a branch-free binary search on popcounts
__device__ __forceinline__ int nth_set(uint64_t m, int j) {
  int pos = 0;
#pragma unroll
  for (int width = 32; width > 0; width >>= 1) {
    const int c = __popcll(m & ((1ull << width) - 1ull));
    const bool up = j >= c;
    j -= up ? c : 0;
    pos += up ? width : 0;
    m = up ? m >> width : m;
  }
  return pos;
}

// the box of chunk position a (per lane), held by lane a % 32 as o_lo
// (a < 32) or o_hi
__device__ __forceinline__ int box_at(int o_lo, int o_hi, int a) {
  const int x = __shfl_sync(FULL, o_lo, a & 31);
  const int y = __shfl_sync(FULL, o_hi, a & 31);
  return a < 32 ? x : y;
}

// bits FROM..FROM + 31 of the compact row of box qj: bit FROM + i is mask
// bit (q_i, qj) (q_i suppresses qj), q_i held by lane i as q; the lanes
// read one mask row at a time, conflict-free
template <int FROM>
__device__ __forceinline__ uint64_t row_bits(const uint64_t* rows, int w,
                                             int q, int qj) {
  uint64_t r = 0ull;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qi = __shfl_sync(FULL, q, i);
    r |= (uint64_t)bit(rows + (int64_t)qi * w, qj) << (FROM + i);
  }
  return r;
}

// removed word u (< w, one a lane) |= the mask rows of the boxes of set
// bits FROM..FROM + 31 of kept, q_i held by lane i as q
template <int FROM>
__device__ __forceinline__ uint64_t kept_rows(const uint64_t* rows, int w,
                                              int q, uint64_t kept, int u) {
  uint64_t acc = 0ull;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int qi = __shfl_sync(FULL, q, i);
    if (((kept >> (FROM + i)) & 1ull) && u < w)
      acc |= rows[(int64_t)qi * w + u];
  }
  return acc;
}

// SHARED: the sample's mask is copied into shared memory beside the
// removed-bitmasks; else its rows are read where they lie
template <bool SHARED>
__global__ void __launch_bounds__(GREEDY_THREADS)
    nms_greedy_kernel(const uint64_t* __restrict__ mask,
                      const int64_t* __restrict__ order,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int64_t nc, int64_t k,
                      int w, Strides st) {
  extern __shared__ uint64_t smem[];
  const int64_t s = blockIdx.x;
  const int tid = threadIdx.x;
  uint64_t* removed_all = smem;            // nc * w words
  const uint64_t* src = mask + s * k * w;  // the sample's k * w mask words
  const uint64_t* rows = src;
  if (SHARED) {
    uint64_t* copy = smem + nc * w;
    // every warp copies; warps past the classes then leave
#pragma unroll 4
    for (int64_t e = tid; e < k * w; e += GREEDY_THREADS) copy[e] = src[e];
    rows = copy;
  }

  const int c = tid >> 5, lane = tid & 31;
  uint64_t* removed = removed_all + c * w;
  if (c < nc) {
    // the class's invalid boxes start removed: they neither keep nor
    // suppress
    const uint8_t* val = valid + s * st.vb + c * st.vc;
#pragma unroll 4
    for (int u = 0; u < w; ++u) {
      const int64_t i = (int64_t)u * 64 + lane;
      const uint64_t ok = ballot64(i < k && val[i * st.vk],
                                   i + 32 < k && val[(i + 32) * st.vk]);
      if (lane == 0) removed[u] = ~ok;
    }
  }
  __syncthreads();
  if (c >= nc) return;

  const int64_t* ord = order + s * st.ob + c * st.oc;
  uint8_t* kp = keep + (s * nc + c) * k;
  int o_lo = lane < k ? (int)ord[lane * st.ok] : 0;
  int o_hi = lane + 32 < k ? (int)ord[(lane + 32) * st.ok] : 0;
  for (int64_t base = 0; base < k; base += 64) {
    const int n = k - base < 64 ? (int)(k - base) : 64;
    const bool in_lo = lane < n, in_hi = lane + 32 < n;
    // the next chunk's order, loaded while this one is resolved
    const int64_t nb = base + 64;
    const int p_lo = nb + lane < k ? (int)ord[(nb + lane) * st.ok] : 0;
    const int p_hi = nb + lane + 32 < k ? (int)ord[(nb + lane + 32) * st.ok]
                                        : 0;
    // (a) alive: in the chunk and not removed (or invalid); the alive
    // positions, in order, are compacted: lane j holds the boxes of the
    // j-th and (32 + j)-th (q0, q1)
    const uint64_t alive = ballot64(in_lo && !bit(removed, o_lo),
                                    in_hi && !bit(removed, o_hi));
    const int na = __popcll(alive);
    uint64_t kept = 0ull;  // over the compacted positions
    if (na) {
      const int q0 = box_at(o_lo, o_hi, nth_set(alive, lane));
      const int q1 = box_at(o_lo, o_hi, nth_set(alive, lane + 32));
      // (b) the submatrix of the alive boxes: lane j forms rows j and
      // 32 + j, bit i = "alive box i suppresses alive box j"
      uint64_t r0 = row_bits<0>(rows, w, q0, q0), r1 = 0ull;
      if (na > 32) {
        r0 |= row_bits<32>(rows, w, q1, q0);
        r1 = row_bits<0>(rows, w, q0, q1) | row_bits<32>(rows, w, q1, q1);
      }
      // (c) the walk on a register word: a box is kept iff no kept box
      // before it suppresses it. Start from all and apply that rule to
      // every box at once until the word stops changing: round t fixes
      // box t, and the greedy walk's result is the one word the rule
      // leaves unchanged, so the loop ends on it after at most 65 rounds
      kept = na == 64 ? ~0ull : (1ull << na) - 1ull;
      const uint64_t before0 = (1ull << lane) - 1ull;
      const uint64_t before1 = (1ull << (lane + 32)) - 1ull;
      for (;;) {
        const uint64_t next = ballot64(lane < na && !(r0 & kept & before0),
                                       lane + 32 < na &&
                                           !(r1 & kept & before1));
        if (next == kept) break;
        kept = next;
      }
      // (d) the kept boxes' mask rows into the removed-bitmask, 32 words
      // a pass (one pass for K <= 2,048)
      for (int u0 = 0; u0 < w; u0 += 32) {
        uint64_t acc = kept_rows<0>(rows, w, q0, kept, u0 + lane);
        if (kept >> 32) acc |= kept_rows<32>(rows, w, q1, kept, u0 + lane);
        if (u0 + lane < w) removed[u0 + lane] |= acc;
      }
    }
    // keep flags: each position once over the walk, no zeroing
    const int c_lo = __popcll(alive & ((1ull << lane) - 1ull));
    const int c_hi = __popcll(alive & ((1ull << (lane + 32)) - 1ull));
    if (in_lo) kp[o_lo] = ((alive >> lane) & 1ull) && ((kept >> c_lo) & 1ull);
    if (in_hi)
      kp[o_hi] = ((alive >> (lane + 32)) & 1ull) && ((kept >> c_hi) & 1ull);
    __syncwarp();  // the next chunk's (a) reads other lanes' words
    o_lo = p_lo;
    o_hi = p_hi;
  }
}

// whether the greedy pass takes nc classes of k boxes: one warp a class,
// the removed-bitmasks in shared memory
inline bool greedy_fits(int64_t nc, int64_t k) {
  return nc <= 32 &&
         (size_t)nc * ((k + 63) / 64) * sizeof(uint64_t) <= (size_t)SMEM_MAX;
}

// The greedy pass over `batch` samples' (k, w) mask words, nc score
// orders each, on `st`, the mask in shared memory where it fits; sets the
// kernel's shared-memory limit on every call (the attribute belongs to
// the current device).
inline cudaError_t launch_greedy(const uint64_t* mask, const int64_t* order,
                                 const uint8_t* valid, uint8_t* keep,
                                 int64_t batch, int64_t nc, int64_t k,
                                 const Strides& sd, cudaStream_t st) {
  if (!greedy_fits(nc, k)) return cudaErrorInvalidValue;
  const int w = (int)((k + 63) / 64);
  const size_t with_mask = (size_t)(nc + k) * w * sizeof(uint64_t);
  const bool shared = with_mask <= (size_t)SMEM_MAX;
  const size_t bytes = shared ? with_mask : (size_t)nc * w * sizeof(uint64_t);
  auto kernel = shared ? nms_greedy_kernel<true> : nms_greedy_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)batch, GREEDY_THREADS, bytes, st>>>(
      mask, order, valid, keep, nc, k, w, sd);
  return cudaGetLastError();
}

}  // namespace
