// The greedy walk of K10-NMS (csrc/nms_bev.cu), K10-normal (csrc/
// nms_normal_bev.cu) and K10-circle past its one-launch size (csrc/
// nms_circle.cu): keep masks from a (K, ceil(K / 64)) 64-bit suppression
// bitmask per sample, bit (i, j) = box i suppresses box j (nothing here
// assumes it symmetric), for C score orders of that sample — the function
// of isfusion_tpu/ops/box_ops.py:196 _greedy_suppress: walk the boxes by
// descending score (the wrapper's stable sort: ties keep the lower index
// first); a valid box that no kept box suppresses is kept. Invalid boxes
// neither keep nor suppress.
//
// Bound: the walk has an inherent serial length of K dependent steps per
// class, taken here as K / 64 chunks, each resolved on a 64-bit register
// word; the bits it reads are 64 x 64 blocks of the mask and the kept
// rows (bytes, held in L2: K^2 / 8 a sample, 500 KB at K = 2,000).
//
// Design: one block per (sample, class), so classes walk on their own SMs;
// warp 0 walks a chunk of 64 sorted positions a step, while helper warps
// in three roles prepare the next step and finish the last: warps 1-8
// gather blocks, 9-12 stage rows and sorted indices, 13-16 OR kept rows
// into the removed words. Each step's phases run side by side, one block
// barrier a step: each phase is a few dependent shared-memory round trips
// whatever its work, so phases done in turn by every helper add up.
// Shared memory holds the class's removed words (ceil(K / 64), original
// index order, starting as its invalid boxes), the sorted indices of eight
// chunks, two copies each of the gathered blocks and, where it fits (K <=
// 5,632), a ring of staged mask rows: five chunks' 64 rows, copied by
// cp.async (16 bytes a copy) three chunks ahead of the walk, 16 KB a chunk
// at K = 2,000, so the gathers and ORs read shared memory. Past 5,632
// boxes the rows are read from L2 through L1 (prefetched three chunks
// ahead), the same steps on the same words; shared memory is then 8
// ceil(K / 64) + 4,112 bytes, so a class of up to 1.8 M boxes fits (the
// (B, K, ceil(K / 64)) mask scratch runs out of device memory first).
// Step c:
// - the walker, the only serial path: chunk c's alive word is its
//   positions in the set that are not removed (read from the removed
//   words: as of chunk c - 2, and maybe some of chunk c - 1's rows, which
//   the OR warps add meanwhile; every bit there is a kept box's
//   suppression) and not suppressed by a kept box of chunk c - 1 (the
//   off-diagonal block ANDed with chunk c - 1's kept word, held in a
//   register); the chunk resolves on one word: a box is kept iff it is
//   alive and no kept box before it in the chunk suppresses it, the rule
//   applied to all 64 positions at once (one ballot a round) from "all
//   alive kept" until the word stops changing: round t settles position t,
//   and the greedy walk's result is the only word the rule leaves
//   unchanged, so at most 65 rounds (the longest suppression chain plus
//   one); then the keep flags, each position written once;
// - the gathering warps: chunk c + 1's diagonal block (word j bit i = its
//   i-th sorted box suppresses its j-th, i < j) and off-diagonal block
//   (bit i = chunk c's i-th box suppresses chunk c + 1's j-th), a thread
//   32 rows of a column, its 32 reads issued before any bit is taken;
// - the staging warps: chunk c + 3's row copies, chunk c + 4's sorted
//   indices (loaded a step before) stored and chunk c + 5's loaded, then a
//   wait for chunk c + 2's rows;
// - the OR warps: chunk c - 1's kept rows into the removed words, a thread
//   a word and a group of rows, 32-bit shared atomics.
// A box is suppressed only by a kept box earlier in the order: the same
// result as one step a box. launch_greedy refuses only more than 2^31 - 1
// (sample, class) pairs or a class whose removed words do not fit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int SMEM_MAX = 227 * 1024;  // Hopper's opt-in shared memory/block
// the helpers' roles: warps 1-8 gather blocks, 9-12 stage rows and sorted
// indices, 13-16 OR kept rows into the removed words
constexpr int GATHER_WARPS = 8, STAGE_WARPS = 4, KEPT_WARPS = 4;
constexpr int GREEDY_HELPERS = GATHER_WARPS + STAGE_WARPS + KEPT_WARPS;
constexpr int GATHER_ROWS = 32;  // rows of a gathering thread's column piece
constexpr int GREEDY_THREADS = 32 * (1 + GREEDY_HELPERS);
constexpr int GREEDY_RING = 8;    // sorted indices of chunks c - 1 .. c + 4
constexpr int GREEDY_STAGES = 5;  // staged rows of chunks c - 1 .. c + 3

// element strides of the (B, C, K) order (int64) and valid (bool) tensors
struct Strides {
  int64_t ob, oc, ok, vb, vc, vk;
};

// the fixed part of the greedy pass's shared memory (the class's removed
// words and the staged rows follow it); index [c & 1] is chunk c's copy
struct GreedyShared {
  uint64_t diag[2][64];  // word j bit i: sorted box i suppresses box j
  uint64_t prev[2][64];  // word j bit i: chunk c - 1's box i suppresses j
  uint64_t kept[2];      // chunk c's kept word
  int ord[GREEDY_RING][64];  // chunk's sorted box indices, -1 past K
};

__device__ __forceinline__ uint64_t ballot64(bool lo, bool hi) {
  return (uint64_t)__ballot_sync(FULL, lo) |
         ((uint64_t)__ballot_sync(FULL, hi) << 32);
}

// word u of the mask row of chunk `chunk`'s position p (box q): from the
// staged ring, or from global memory through L1
template <bool STAGED>
__device__ __forceinline__ uint64_t row_word(const uint64_t* ring,
                                             const uint64_t* rows, int w,
                                             int chunk, int p, int q,
                                             int u) {
  if (STAGED) return ring[((chunk % GREEDY_STAGES) * 64 + p) * w + u];
  return __ldg(rows + (int64_t)q * w + u);
}

// the staging threads (t = 0..127): chunk `chunk`'s 64 rows into the ring by
// cp.async, 16 bytes a copy where the rows are 16-byte aligned (an even
// word count) and 8 otherwise, consecutive threads on consecutive pieces
// of a row; or into L1 by prefetches, a 128-byte line at a time
template <bool STAGED>
__device__ __forceinline__ void stage_rows(uint64_t* ring,
                                           const uint64_t* rows,
                                           const GreedyShared& sh, int w,
                                           int chunk, int h) {
  const int* qs = sh.ord[chunk % GREEDY_RING];
  const int threads = 32 * STAGE_WARPS;
  if (STAGED) {
    uint64_t* dst = ring + (chunk % GREEDY_STAGES) * 64 * w;
    const int words = w & 1 ? 1 : 2;  // words a copy
    const int per_row = w / words;
    for (int e = h; e < 64 * per_row; e += threads) {
      const int p = e / per_row, u = (e - p * per_row) * words;
      const int q = qs[p];
      if (q < 0) continue;  // past K
      const unsigned d = (unsigned)__cvta_generic_to_shared(dst + p * w + u);
      const uint64_t* src = rows + (int64_t)q * w + u;
      if (words == 2)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                     "l"(src)
                     : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d),
                     "l"(src)
                     : "memory");
    }
  } else {
    for (int e = h; e < 64 * ((w + 15) / 16); e += threads) {
      const int p = e % 64, u = e / 64 * 16;
      if (qs[p] >= 0)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(rows +
                                                     (int64_t)qs[p] * w + u));
    }
  }
}

// gathering thread h (0..255): rows 32 ((h >> 6) & 1) .. + 31 of column
// h & 63 of chunk `chunk`'s diagonal block (h < 128, rows of the same
// chunk, i < j only) or off-diagonal block (rows of the chunk before; none
// for chunk 0). The 32 words are read first (32-bit halves, one per row,
// no branch), then their bits taken; a warp with no row to read skips
template <bool STAGED>
__device__ __forceinline__ void gather_block(GreedyShared& sh,
                                             const uint64_t* ring,
                                             const uint64_t* rows, int w,
                                             int64_t k, int chunk, int h) {
  const bool off = h >= 128;
  const int j = h & 63, lo = GATHER_ROWS * ((h >> 6) & 1);
  const int rc = off ? chunk - 1 : chunk;  // the rows' chunk
  const int qj = sh.ord[chunk % GREEDY_RING][j];
  uint32_t want = 0u;  // bit i: position lo + i of chunk rc is read
  if (rc >= 0 && qj >= 0) {
    const int64_t left = k - (int64_t)rc * 64;
    const int n = left < 64 ? (int)left : 64;
    const int cnt = (off ? n : min(n, j)) - lo;
    want = cnt <= 0 ? 0u : cnt >= GATHER_ROWS ? ~0u : (1u << cnt) - 1u;
  }
  uint32_t bits = 0u;
  if (__any_sync(FULL, want != 0u)) {
    const int word = qj >> 5, shift = qj & 31;  // qj's 32-bit half-word
    uint32_t v[GATHER_ROWS];
    if (STAGED) {
      const uint32_t* base = (const uint32_t*)ring +
                             ((rc % GREEDY_STAGES) * 64 + lo) * 2 * w + word;
#pragma unroll
      for (int i = 0; i < GATHER_ROWS; ++i)
        v[i] = want ? base[i * 2 * w] : 0u;
    } else {
      const int* qs = sh.ord[(rc + GREEDY_RING) % GREEDY_RING] + lo;
#pragma unroll
      for (int i = 0; i < GATHER_ROWS; ++i) {
        const int qi = qs[i] < 0 ? 0 : qs[i];
        v[i] = want ? __ldg((const uint32_t*)rows + (int64_t)qi * 2 * w +
                            word)
                    : 0u;
      }
    }
#pragma unroll
    for (int i = 0; i < GATHER_ROWS; ++i)
      bits |= ((v[i] >> shift) & 1u) << i;
    bits &= want;
  }
  uint32_t* dst = (uint32_t*)&(off ? sh.prev : sh.diag)[chunk & 1][j];
  dst[lo / GATHER_ROWS] = bits;
}

// the OR threads (h = 0..127): chunk `chunk`'s kept rows (kept word kw)
// ORed into the removed words, a thread a word: below 128 words the
// threads form 128 / w groups, group g taking rows g, g + 128 / w, ...;
// every row is read (no branch) and the kept ones ORed, by 32-bit atomics
// (a warp of several groups ORs them first)
template <bool STAGED>
__device__ __forceinline__ void or_kept_rows(const GreedyShared& sh,
                                             uint64_t* removed,
                                             const uint64_t* ring,
                                             const uint64_t* rows, int w,
                                             int chunk, uint64_t kw, int h) {
  if (!kw) return;
  const int* qs = sh.ord[chunk % GREEDY_RING];
  const int threads = 32 * KEPT_WARPS;
  const int groups = w < threads ? threads / w : 1;
  const int g = w < threads ? h / w : 0;
  if (g >= groups) return;
  for (int u = w < threads ? h - g * w : h; u < w; u += threads) {
    uint64_t acc = 0ull;
#pragma unroll 4
    for (int p = g; p < 64; p += groups) {
      const uint64_t v = row_word<STAGED>(ring, rows, w, chunk, p,
                                          STAGED ? 0 : max(qs[p], 0), u);
      acc |= ((kw >> p) & 1ull) ? v : 0ull;
    }
    if (32 % w == 0)
      for (int off = w; off < 32; off <<= 1)
        acc |= __shfl_xor_sync(FULL, acc, off);
    if (32 % w || (h & 31) < w) {
      unsigned* word = (unsigned*)&removed[u];
      if ((unsigned)acc) atomicOr(word, (unsigned)acc);
      if ((unsigned)(acc >> 32)) atomicOr(word + 1, (unsigned)(acc >> 32));
    }
  }
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// every copy group but the most recent one complete
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

template <bool STAGED>
__global__ void __launch_bounds__(GREEDY_THREADS)
    nms_greedy_kernel(const uint64_t* __restrict__ mask,
                      const int64_t* __restrict__ order,
                      const uint8_t* __restrict__ valid,
                      uint8_t* __restrict__ keep, int64_t nc, int64_t k,
                      int w, Strides st) {
  extern __shared__ uint64_t smem[];
  GreedyShared& sh = *reinterpret_cast<GreedyShared*>(smem);
  uint64_t* removed = smem + sizeof(GreedyShared) / sizeof(uint64_t);
  uint64_t* ring = removed + w;  // STAGED: GREEDY_STAGES x 64 x w words
  const int64_t job = blockIdx.x;  // sample * nc + class
  const int64_t s = job / nc, c = job % nc;
  const uint64_t* rows = mask + s * k * w;
  const int64_t* ord = order + s * st.ob + c * st.oc;
  uint8_t* kp = keep + job * k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // each role's own thread index
  const int gt = tid - 32, stt = tid - 32 * (1 + GATHER_WARPS),
            kt = tid - 32 * (1 + GATHER_WARPS + STAGE_WARPS);
  const bool gathers = warp >= 1 && warp <= GATHER_WARPS;
  const bool stages = stt >= 0 && kt < 0;
  const int chunks = (int)((k + 63) / 64);

  // the first four chunks' sorted indices (loaded first, stored below);
  // the removed words start as the invalid boxes (valid null: all valid)
  // gathering thread gt: position gt of chunks 0..3
  const int64_t q_first = gathers && gt < k ? ord[(int64_t)gt * st.ok] : -1;
  const uint8_t* val = valid ? valid + s * st.vb + c * st.vc : nullptr;
  for (int u = warp; u < w; u += 1 + GREEDY_HELPERS) {
    const int64_t i = (int64_t)u * 64 + lane;
    const bool ok0 = i < k && (!val || val[i * st.vk]);
    const bool ok1 = i + 32 < k && (!val || val[(i + 32) * st.vk]);
    const uint64_t ok = ballot64(ok0, ok1);
    if (lane == 0) removed[u] = ~ok;
  }
  if (gathers) sh.ord[gt >> 6][gt & 63] = (int)q_first;
  // chunk 4's sorted indices, stored at step 0 (each load is stored a step
  // after it is issued, so its latency is hidden)
  int64_t q_next = -1;
  if (stages && stt < 64 && 4 * 64 + stt < k)
    q_next = ord[(4 * 64 + stt) * st.ok];
  __syncthreads();
  // the first three chunks' rows; chunks 0 and 1 awaited
  if (stages) {
    for (int e = 0; e < 3; ++e) {
      if (e < chunks) stage_rows<STAGED>(ring, rows, sh, w, e, stt);
      commit_copies();
    }
    wait_copies();
  }
  __syncthreads();
  if (gathers) gather_block<STAGED>(sh, ring, rows, w, k, 0, gt);
  __syncthreads();

  // the walker's: chunk c - 1's kept word, chunk c's boxes (each chunk's
  // read a step ahead)
  uint64_t kept_prev = 0ull;
  int q0 = sh.ord[0][lane], q1 = sh.ord[0][lane + 32];
  for (int cc = 0; cc < chunks; ++cc) {
    if (warp == 0) {
      const int64_t base = (int64_t)cc * 64;
      const int n = k - base < 64 ? (int)(k - base) : 64;
      // removed as of chunk c - 2, and maybe some of chunk c - 1's rows,
      // which the helpers OR in now: every bit is a kept box's suppression,
      // and chunk c - 1's are taken from the off-diagonal block anyway
      const volatile uint64_t* rv = removed;
      const bool r0 = lane < n && ((rv[q0 >> 6] >> (q0 & 63)) & 1ull);
      const bool r1 = lane + 32 < n && ((rv[q1 >> 6] >> (q1 & 63)) & 1ull);
      const uint64_t d0 = sh.diag[cc & 1][lane], d1 = sh.diag[cc & 1][lane + 32];
      const uint64_t o0 = sh.prev[cc & 1][lane], o1 = sh.prev[cc & 1][lane + 32];
      const bool a0 = lane < n && !r0 && !(o0 & kept_prev);
      const bool a1 = lane + 32 < n && !r1 && !(o1 & kept_prev);
      const uint64_t alive = ballot64(a0, a1);
      // the diagonal block holds i < j only: no mask of earlier positions
      uint64_t kept = alive;
      for (;;) {
        const uint64_t next = ballot64(a0 && !(d0 & kept),
                                       a1 && !(d1 & kept));
        if (next == kept) break;
        kept = next;
      }
      kept_prev = kept;
      if (lane == 0) sh.kept[cc & 1] = kept;
      if (lane < n) kp[q0] = (uint8_t)((kept >> lane) & 1ull);
      if (lane + 32 < n) kp[q1] = (uint8_t)((kept >> (lane + 32)) & 1ull);
      q0 = sh.ord[(cc + 1) % GREEDY_RING][lane];
      q1 = sh.ord[(cc + 1) % GREEDY_RING][lane + 32];
    } else if (gathers) {
      if (cc + 1 < chunks)
        gather_block<STAGED>(sh, ring, rows, w, k, cc + 1, gt);
    } else if (stages) {
      if (cc + 3 < chunks)
        stage_rows<STAGED>(ring, rows, sh, w, cc + 3, stt);
      commit_copies();
      if (stt < 64) {
        // chunk c + 4's sorted indices (loaded a step ago); chunk c + 5's
        sh.ord[(cc + 4) % GREEDY_RING][stt] = (int)q_next;
        const int64_t p = (int64_t)(cc + 5) * 64 + stt;
        q_next = p < k ? ord[p * st.ok] : -1;
      }
      wait_copies();  // chunk c + 2's rows
    } else if (cc >= 1) {
      or_kept_rows<STAGED>(sh, removed, ring, rows, w, cc - 1,
                           sh.kept[(cc - 1) & 1], kt);
    }
    __syncthreads();
  }
}

// whether the greedy pass stages a class's rows in shared memory
inline bool greedy_staged(int64_t k) {
  const size_t w = (size_t)((k + 63) / 64);
  return sizeof(GreedyShared) + w * 8 * (1 + 64 * GREEDY_STAGES) <=
         (size_t)SMEM_MAX;
}

// shared memory of one (sample, class) block
inline size_t greedy_smem_bytes(int64_t k) {
  const size_t w = (size_t)((k + 63) / 64);
  return sizeof(GreedyShared) +
         w * 8 * (1 + (greedy_staged(k) ? 64 * GREEDY_STAGES : 0));
}

// whether the greedy pass takes batch samples of nc classes of k boxes
inline bool greedy_fits(int64_t batch, int64_t nc, int64_t k) {
  return batch <= 0x7fffffffLL / (nc > 0 ? nc : 1) &&
         greedy_smem_bytes(k) <= (size_t)SMEM_MAX;
}

// The greedy pass over `batch` samples' (k, w) mask words, nc score
// orders each (order (B, C, K) int64 and valid (B, C, K) bool read through
// their strides; valid null: all valid), on `st`; raises the kernel's
// shared-memory limit where a class needs more than 48 KB (the attribute
// belongs to the current device).
inline cudaError_t launch_greedy(const uint64_t* mask, const int64_t* order,
                                 const uint8_t* valid, uint8_t* keep,
                                 int64_t batch, int64_t nc, int64_t k,
                                 const Strides& sd, cudaStream_t st) {
  if (!greedy_fits(batch, nc, k)) return cudaErrorInvalidValue;
  const int w = (int)((k + 63) / 64);
  const size_t bytes = greedy_smem_bytes(k);
  auto kernel = greedy_staged(k) ? nms_greedy_kernel<true>
                                 : nms_greedy_kernel<false>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)(batch * nc), GREEDY_THREADS, bytes, st>>>(
      mask, order, valid, keep, nc, k, w, sd);
  return cudaGetLastError();
}

}  // namespace
