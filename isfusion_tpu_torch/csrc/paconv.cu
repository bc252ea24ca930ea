// PAConv's two contractions for Hopper (sm_90a) — K15.
//
// K15-bank replaces the weight-bank contraction of isfusion_tpu/ops/
// paconv.py:79 PAConv (the `feats @ bank` at :123 and the einsum at
// :125): for rows x (R, C) (the w_neighbor concatenation of every grouped
// point, C = 2 Cin), scores s (R, M) and the bank W (C, M O) in the
// reference's layout (column m O + o),
//     y[r, o] = sum_m s[r, m] sum_c x[r, c] W[c, m O + o],
// forward and backward. XLA writes the (R, M, O) product x @ W and keeps it
// for the backward; here it never exists. paconvseg's SA1 at batch 8
// has R = 262,144 rows, and its three layers' products would take 3.75 GiB.
// K15-score replaces isfusion_tpu/ops/paconv.py:21 assign_score_withk (the
// reference's assign_score_withk_cuda.cu op): for scores (B, S, K, M),
// point and centre features (B, N, M, O) and neighbour indices knn (B, S,
// K),
//     out[b, s, k, o] = sum_m scores[b, s, k, m] (pf[b, knn[b, s, k], m, o]
//                                                 - cf[b, knn[b, s, 0], m, o])
// (divided by M for aggregate 'avg'), forward and backward.
//
// K15-bank on the tensor cores.
// - Precision: inputs and outputs are float32, and every product runs on
//   wgmma (m64nNk8, .tf32) as 3xTF32. Each operand value v is split into
//   hi = tf32(v) and lo = tf32(v - hi) (cvt.rna), and a chunk of depth 32
//   sums hi lo + lo hi + hi hi (the small terms first; lo lo, ~2^-22 of the
//   product, is dropped) in float32 registers: 12 wgmma a chunk. The
//   chunk's sum is then added into the output's own float32 registers by
//   FMA / FADD, so the tensor cores never accumulate deeper than one chunk.
//   Within ~5e-7 of the float64 product's max on every test set.
// - Layout: wgmma takes TF32 operands K-major only (its transpose bits are
//   for f16 / bf16). A tile stores 8-row x 16-byte core matrices with the
//   depth inside the 16 bytes and no swizzle: 4 values of depth, LBO = 144
//   bytes between depth columns (128 + 16, so that a warp's 32 depths of
//   one row fall in 32 banks), SBO = 1,152 bytes between groups of 8 rows.
//   Sources that are not K-major (W's o, dY's and x's rows for dW) are
//   transposed as they are split.
// - Split tiles: W (forward: rows o, depth c; dX: rows c, depth o) and dY
//   (dW: rows o, depth r) are split once a call by bank_split_w /
//   bank_split_dy into the tiles' shared-memory image (hi, then lo) in a
//   scratch; a block then moves a tile by 16-byte cp.async copies, with no
//   arithmetic.
// - bank_forward: a block of two warpgroups takes 128 rows x an O tile (N =
//   32 or 64) and walks (c chunk, m). x's chunk is the threads' A fragments
//   in registers (the RS form of wgmma), reused over the M steps of the
//   chunk; W_m's tiles come through a ring of 4 stages, 3 steps ahead; the
//   block's rows of s are staged once. P = x_chunk W_m, then y += s[r, m] P.
// - bank_grad_x: dX and dS. A block takes 128 rows x a C tile and walks (o
//   chunk, m): dY's chunk split into shared memory once a chunk, W_m's
//   tiles through a ring of 3 stages; G = dY_chunk W_m^T, then dX +=
//   s[r, m] G by FMA and dS[r, m] += sum_c x[r, c] G (x in registers; a
//   thread's columns, then its quad's butterfly, into a (128, M) tile in
//   the walk's order). Its registers hold dX, the chunk and x, so both
//   operands come from shared memory.
// - bank_grad_w: dW = A^T dY, A[r, m C + c] = s[r, m] x[r, c], depth R: a
//   block takes 128 bank rows m C + c x an O tile over a range of rows; a
//   chunk's dY tile, raw x (its whole rows where C < 128) and rows of s
//   arrive by cp.async two chunks ahead, and the threads form A = s x as
//   their A fragments in registers.
// - Depth split: where row tiles x column tiles < the multiprocessors, the
//   walk (forward, dX / dS) or the rows (dW) are split over up to twice the
//   multiprocessors' count of blocks; each split writes its partial into
//   the scratch (paconv_bank_scratch floats, after the split tiles), and
//   sum_parts / bank_reduce add the partials in split order. No atomics:
//   two calls give the same bits. The grids are one-dimensional, so R and
//   the splits are limited only by int64 offsets (M <= 137 by dX's shared
//   memory).
// Bounds: 2 R C M O (+ 2 R M O for the scores' sum) operations forward and
// 4 R C M O + 4 R M C backward; on the float32 pipes (67 TFLOP/s) 0.521 ms
// at paconvseg-train's R 262,144 x C 64, M 16, O 64, and as 3xTF32 (three
// TF32 products an operation, 495 TFLOP/s) 0.21 ms; the bytes (x, s, W, y
// once) are far less. K15-score moves bytes: pf and cf rows read once a
// slot and the output written once.
//
// K15-score, float32 SIMT:
// - score_forward: a thread an output, its M products in order.
// - score_grad_scores: a warp a slot (b, s, k), its lanes over o, a
//   butterfly a score.
// - score_grad_feats: the gradients of pf and cf are sums over the slots
//   that name each row; the slots of each row are listed in increasing
//   order by stable_lists.cuh's builder (as K14-gather's backward lists
//   them), and a thread an element sums its row's slots in that order.
//   The centre's list holds the (b, s) whose slot 0 names the row; each
//   adds its K slots in order, negated.
// Allocates nothing and does not synchronise.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "stable_lists.cuh"

namespace {

constexpr int THREADS = 256;   // a block: K15-score's, and K15-bank's two
                               // warpgroups
constexpr int BM = 128;        // K15-bank: rows of a block's tile
constexpr int KC = 32;         // the depth of a chunk: 4 wgmma k-steps
constexpr int LBO = 144;       // bytes between a tile's depth columns
constexpr int SBO = KC / 4 * LBO;    // bytes between groups of 8 rows

// bytes of one part (hi or lo) of a tile of `rows` rows x KC
__host__ __device__ constexpr int tile_bytes(int rows) {
  return rows / 8 * SBO;
}

// byte offset of (row, depth k) in a tile
__device__ __forceinline__ int off(int row, int k) {
  return (row >> 3) * SBO + (k >> 2) * LBO + (row & 7) * 16 + (k & 3) * 4;
}

// v -> hi = tf32(v) and lo = tf32(v - hi)
__device__ __forceinline__ void to_tf32(float v, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));
  const float rest = __fsub_rn(v, __uint_as_float(hi));
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

// v split, stored at byte `o` of both parts of a tile
__device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo,
                                    int o, float v) {
  uint32_t h, l;
  to_tf32(v, h, l);
  *reinterpret_cast<uint32_t*>(hi + o) = h;
  *reinterpret_cast<uint32_t*>(lo + o) = l;
}

// depths 4 kq .. 4 kq + 3 of row n, split, one 16-byte store a part
__device__ __forceinline__ void put4(unsigned char* hi, unsigned char* lo,
                                     int n, int kq, const float (&v)[4]) {
  uint4 h, l;
  to_tf32(v[0], h.x, l.x);
  to_tf32(v[1], h.y, l.y);
  to_tf32(v[2], h.z, l.z);
  to_tf32(v[3], h.w, l.w);
  const int o = (n >> 3) * SBO + kq * LBO + (n & 7) * 16;
  *reinterpret_cast<uint4*>(hi + o) = h;
  *reinterpret_cast<uint4*>(lo + o) = l;
}

// a shared-memory matrix descriptor: no swizzle, K-major, LBO and SBO
__device__ __forceinline__ uint64_t desc_of(const unsigned char* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
         ((uint64_t)(SBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// this thread's shared-memory writes (stores, finished copies), seen by
// the tensor cores' reads
__device__ __forceinline__ void async_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// a 4-byte asynchronous copy into shared memory; zeros where !ok
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `n` of this thread's groups are pending
template <int n>
__device__ __forceinline__ void cp_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}
// a 16-byte asynchronous copy into shared memory, zeros past `bytes`
__device__ __forceinline__ void cp16(unsigned char* dst, const void* src,
                                     int bytes = 16) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
// keep the compiler from moving an accumulator across an asynchronous
// product's issue or wait
template <int K>
__device__ __forceinline__ void pin(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int K>
__device__ __forceinline__ void pin(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// D (64 x N, a warpgroup's registers) (+)= A (64 x 8) B^T (8 x N), both
// operands K-major in shared memory, TF32; scale_d 0 overwrites D
template <int N>
struct Mma;

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float (&d)[16], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

// P = A_hi B_lo + A_lo B_hi + A_hi B_hi over a chunk's depth (P
// overwritten); a_*: the warpgroup's 64 rows, b_*: the tile's N rows
template <int N>
__device__ __forceinline__ void chunk_mma(float (&p)[N / 2],
                                          const unsigned char* a_hi,
                                          const unsigned char* a_lo,
                                          const unsigned char* b_hi,
                                          const unsigned char* b_lo) {
  const uint64_t ah = desc_of(a_hi), al = desc_of(a_lo), bh = desc_of(b_hi),
                 bl = desc_of(b_lo);
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const uint64_t step = (uint64_t)(2 * ks * LBO) >> 4;
    Mma<N>::run(p, ah + step, bl + step, ks > 0);
    Mma<N>::run(p, al + step, bh + step, 1);
    Mma<N>::run(p, ah + step, bh + step, 1);
  }
}

// D (+)= A (64 x 8, this warpgroup's registers: the m64k8 TF32 fragment,
// a[e] at row 16 (warp % 4) + lane / 4 + 8 (e % 2), depth lane % 4 + 4 (e /
// 2)) B^T (8 x N, K-major in shared memory)
template <int N>
struct MmaRs;

template <>
struct MmaRs<32> {
  static __device__ __forceinline__ void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

template <>
struct MmaRs<64> {
  static __device__ __forceinline__ void run(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(scale_d));
  }
};

// chunk_mma with A's hi and lo fragments of the chunk's 4 k-steps in
// registers
template <int N>
__device__ __forceinline__ void chunk_mma_rs(float (&p)[N / 2],
                                             uint32_t (&a_hi)[KC / 8][4],
                                             uint32_t (&a_lo)[KC / 8][4],
                                             const unsigned char* b_hi,
                                             const unsigned char* b_lo) {
  const uint64_t bh = desc_of(b_hi), bl = desc_of(b_lo);
#pragma unroll
  for (int ks = 0; ks < KC / 8; ++ks) {
    const uint64_t step = (uint64_t)(2 * ks * LBO) >> 4;
    MmaRs<N>::run(p, a_hi[ks], bl + step, ks > 0);
    MmaRs<N>::run(p, a_lo[ks], bh + step, 1);
    MmaRs<N>::run(p, a_hi[ks], bh + step, 1);
  }
}

// The accumulator of a warpgroup's 64 x N: register 4 j + e holds row 16
// (warp % 4) + lane / 4 + 8 (e / 2) of the warpgroup's rows, column 8 j + 2
// (lane % 4) + e % 2.

// ------------------------------------------------------ the split tiles
// A source's hi and lo tiles in the tiles' shared-memory layout, a block a
// tile, a thread 4 depths of a row (one 16-byte store a part), tile t at
// byte t 2 tile_bytes(N), hi then lo. W (C, M O): tile (m, k chunk kc, n
// tile nt) = (m k_chunks + kc) n_tiles + nt; the forward's (depth_c 1)
// rows n = o and depths k = c, dX's (0) rows n = c and depths k = o. dY
// (R, O) for dW: tile (row chunk, o tile), rows n = o, depths k = r.
template <int N>
__global__ void __launch_bounds__(THREADS)
    bank_split_w(const float* __restrict__ w, unsigned char* __restrict__ wt,
                 int C, int M, int O, int k_chunks, int n_tiles,
                 int depth_c) {
  const int64_t tile = blockIdx.x;
  const int nt = (int)(tile % n_tiles);
  const int kc = (int)(tile / n_tiles % k_chunks);
  const int m = (int)(tile / n_tiles / k_chunks);
  unsigned char* hi = wt + tile * 2 * tile_bytes(N);
  const float* wm = w + (int64_t)m * O;
  const int64_t mo = (int64_t)M * O;
  constexpr int ITEMS = N * (KC / 4) / THREADS;   // (row, 4 depths) each
  float v[ITEMS][4];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {     // every load first
    // the forward's rows n over a warp (o contiguous in W); dX's depths
    const int e = threadIdx.x + u * THREADS;
    const int n = depth_c ? e % N : e / (KC / 4);
    const int kq = depth_c ? e / N : e % (KC / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = depth_c ? kc * KC + 4 * kq + j : nt * N + n;
      const int o = depth_c ? nt * N + n : kc * KC + 4 * kq + j;
      v[u][j] = c < C && o < O ? wm[c * mo + o] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    put4(hi, hi + tile_bytes(N), depth_c ? e % N : e / (KC / 4),
         depth_c ? e / N : e % (KC / 4), v[u]);
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
    bank_split_dy(const float* __restrict__ dy, unsigned char* __restrict__ yt,
                  int64_t R, int O, int o_tiles) {
  const int64_t tile = blockIdx.x;
  const int nt = (int)(tile % o_tiles);
  const int64_t r0 = tile / o_tiles * KC;
  unsigned char* hi = yt + tile * 2 * tile_bytes(N);
  constexpr int ITEMS = N * (KC / 4) / THREADS;
  float v[ITEMS][4];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {     // every load first
    const int e = threadIdx.x + u * THREADS;
    const int o = nt * N + e % N;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t r = r0 + 4 * (e / N) + j;
      v[u][j] = r < R && o < O ? dy[r * O + o] : 0.f;
    }
  }
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int e = threadIdx.x + u * THREADS;
    put4(hi, hi + tile_bytes(N), e % N, e / N, v[u]);
  }
}

constexpr int STAGES = 4;   // the forward's ring of W's tiles
constexpr int STAGES_X = 3;  // dX's

// ----------------------------------------------------------- bank forward
// block (row tile, o tile, split): the walk's steps [it0, it1) of (c chunk
// it / M, m it % M); y (splits 1) or part[split] (R, O). x's chunk is each
// thread's A fragments (registers, reused over the M steps of a chunk);
// W's split tiles (wt, bank_split_w) arrive by cp.async through a ring of
// STAGES stages, STAGES - 1 steps ahead; the block's rows of s are staged
// once.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
    bank_forward(const float* __restrict__ x, const float* __restrict__ s,
                 const unsigned char* __restrict__ wt, float* __restrict__ y,
                 int64_t R, int C, int M, int O, int o_tiles, int splits) {
  constexpr int TB = 2 * tile_bytes(N);          // a stage: hi, lo
  extern __shared__ __align__(128) unsigned char sm[];
  unsigned char* b = sm;                          // the ring
  float* ss = reinterpret_cast<float*>(b + STAGES * TB);   // s, BM x M
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wg = t >> 7;
  int64_t bid = blockIdx.x;
  const int split = (int)(bid % splits);
  bid /= splits;
  const int ot = (int)(bid % o_tiles), o0 = ot * N;
  const int64_t r0 = bid / o_tiles * BM;
  const int chunks = (C + KC - 1) / KC;
  const int64_t steps = (int64_t)chunks * M;
  const int64_t it0 = steps * split / splits,
                it1 = steps * (split + 1) / splits;
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int64_t ra = r0 + row, rb = ra + 8;

  uint32_t a_hi[KC / 8][4], a_lo[KC / 8][4];
  auto load_x = [&](int cc) {        // k-step ks: c = 8 ks + lane % 4 (+ 4)
#pragma unroll
    for (int ks = 0; ks < KC / 8; ++ks)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int64_t r = e & 1 ? rb : ra;
        const int c = cc * KC + 8 * ks + (lane & 3) + (e & 2 ? 4 : 0);
        to_tf32(r < R && c < C ? x[r * C + c] : 0.f, a_hi[ks][e],
                a_lo[ks][e]);
      }
  };
  auto fetch = [&](int64_t it) {     // step it's tile into its stage
    if (it < it1) {
      const unsigned char* src =
          wt + ((it % M * chunks + it / M) * o_tiles + ot) * TB;
      unsigned char* dst = b + (it - it0) % STAGES * TB;
      for (int i = t; i < TB / 16; i += THREADS)
        cp16(dst + i * 16, src + i * 16);
    }
    cp_commit();
  };

  float acc[N / 2], p[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = p[j] = 0.f;
  if (it0 < it1) {
    const int64_t s0 = r0 * M, s1 = R * M;
    for (int e = t; e < BM * M; e += THREADS)
      cp4(ss + e, s0 + e < s1 ? s + s0 + e : s, s0 + e < s1);
    for (int k = 0; k < STAGES - 1; ++k) fetch(it0 + k);
    int held = (int)(it0 / M);
    load_x(held);
    for (int64_t it = it0; it < it1; ++it) {
      const int cc = (int)(it / M), m = (int)(it % M);
      cp_wait_n<STAGES - 2>();       // this step's tile (and s) landed
      async_fence();
      __syncthreads();               // ... for every thread; the last
                                     // step's stage is read
      fetch(it + STAGES - 1);
      if (cc != held) {              // the last chunk's products are done
        load_x(cc);
        held = cc;
      }
      const float sa = ss[row * M + m], sb = ss[(row + 8) * M + m];
      unsigned char* bh = b + (it - it0) % STAGES * TB;
      pin(p);
      pin(a_hi);
      pin(a_lo);
      wg_fence();
      chunk_mma_rs<N>(p, a_hi, a_lo, bh, bh + tile_bytes(N));
      wg_commit();
      wg_wait();
      pin(p);
      pin(a_hi);
      pin(a_lo);
#pragma unroll
      for (int j = 0; j < N / 2; ++j)
        acc[j] = fmaf(j & 2 ? sb : sa, p[j], acc[j]);
    }
    cp_wait_n<0>();
  }
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int64_t r = j & 2 ? rb : ra;
    const int o = o0 + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
    if (r < R && o < O) y[(int64_t)split * R * O + r * O + o] = acc[j];
  }
}

// ---------------------------------------------------- bank backward: dX, dS
// block (row tile, c tile, split): the walk's steps of (o chunk it / M, m
// it % M); dx (splits 1) or part_dx[split] (R, C); dS summed in shared
// memory (128 x M), then written to ds (one part) or part_ds[split c_tiles
// + c tile] (R, M). dY's chunk is staged in shared memory once a chunk;
// W_m's split tiles (wt, bank_split_w) arrive by cp.async through a ring of
// STAGES_X stages; the block's rows of s are staged once.
template <int N>
__global__ void __launch_bounds__(THREADS, 2)
    bank_grad_x(const float* __restrict__ x, const float* __restrict__ s,
                const unsigned char* __restrict__ wt,
                const float* __restrict__ dy, float* __restrict__ dx,
                float* __restrict__ ds, int64_t R, int C, int M, int O,
                int c_tiles, int splits) {
  constexpr int TB = 2 * tile_bytes(N);
  extern __shared__ __align__(128) unsigned char sm[];
  unsigned char* a_hi = sm;                       // dY's chunk, 128 x KC
  unsigned char* a_lo = a_hi + tile_bytes(BM);
  unsigned char* b = a_lo + tile_bytes(BM);       // the ring of W_m's tiles
  float* ss = reinterpret_cast<float*>(b + STAGES_X * TB);  // s, BM x M
  float* ds_t = ss + BM * M;                                // dS, BM x M
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wg = t >> 7;
  int64_t bid = blockIdx.x;
  const int split = (int)(bid % splits);
  bid /= splits;
  const int ct = (int)(bid % c_tiles), c0 = ct * N;
  const int64_t r0 = bid / c_tiles * BM;
  const int chunks = (O + KC - 1) / KC;
  const int64_t steps = (int64_t)chunks * M;
  const int64_t it0 = steps * split / splits,
                it1 = steps * (split + 1) / splits;
  for (int e = t; e < BM * M; e += THREADS) ds_t[e] = 0.f;

  auto load_dy = [&](int oc) {       // a warp a row, a lane a depth
    const int o = oc * KC + lane;
#pragma unroll 4
    for (int i = 0; i < BM / 8; ++i) {
      const int row = warp + 8 * i;
      const int64_t r = r0 + row;
      put(a_hi, a_lo, off(row, lane),
          r < R && o < O ? dy[r * O + o] : 0.f);
    }
  };
  auto fetch = [&](int64_t it) {     // step it's tile into its stage
    if (it < it1) {
      const unsigned char* src =
          wt + ((it % M * chunks + it / M) * c_tiles + ct) * TB;
      unsigned char* dst = b + (it - it0) % STAGES_X * TB;
      for (int i = t; i < TB / 16; i += THREADS)
        cp16(dst + i * 16, src + i * 16);
    }
    cp_commit();
  };

  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int64_t ra = r0 + row, rb = ra + 8;
  float acc[N / 2], p[N / 2], xv[N / 2];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int64_t r = j & 2 ? rb : ra;
    const int c = c0 + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
    xv[j] = r < R && c < C ? x[r * C + c] : 0.f;
    acc[j] = p[j] = 0.f;
  }
  if (it0 < it1) {
    const int64_t s0 = r0 * M, s1 = R * M;
    for (int e = t; e < BM * M; e += THREADS)
      cp4(ss + e, s0 + e < s1 ? s + s0 + e : s, s0 + e < s1);
    for (int k = 0; k < STAGES_X - 1; ++k) fetch(it0 + k);
    int held = -1;
    for (int64_t it = it0; it < it1; ++it) {
      const int oc = (int)(it / M), m = (int)(it % M);
      cp_wait_n<STAGES_X - 2>();
      async_fence();
      __syncthreads();               // this step's tile landed everywhere;
                                     // the last step's tiles are read
      fetch(it + STAGES_X - 1);
      if (oc != held) {
        load_dy(oc);
        held = oc;
        async_fence();
        __syncthreads();
      }
      const float sa = ss[row * M + m], sb = ss[(row + 8) * M + m];
      unsigned char* bh = b + (it - it0) % STAGES_X * TB;
      pin(p);
      wg_fence();
      chunk_mma<N>(p, a_hi + wg * tile_bytes(64), a_lo + wg * tile_bytes(64),
                   bh, bh + tile_bytes(N));
      wg_commit();
      wg_wait();
      pin(p);
      float da = 0.f, db = 0.f;
#pragma unroll
      for (int j = 0; j < N / 2; ++j) {
        acc[j] = fmaf(j & 2 ? sb : sa, p[j], acc[j]);
        if (j & 2)
          db = fmaf(xv[j], p[j], db);
        else
          da = fmaf(xv[j], p[j], da);
      }
#pragma unroll
      for (int q = 1; q < 4; q <<= 1) {   // the quad that holds the rows
        da = __fadd_rn(da, __shfl_xor_sync(0xffffffffu, da, q));
        db = __fadd_rn(db, __shfl_xor_sync(0xffffffffu, db, q));
      }
      if ((lane & 3) == 0) {
        ds_t[row * M + m] = __fadd_rn(ds_t[row * M + m], da);
        ds_t[(row + 8) * M + m] = __fadd_rn(ds_t[(row + 8) * M + m], db);
      }
    }
    cp_wait_n<0>();
  }
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int64_t r = j & 2 ? rb : ra;
    const int c = c0 + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
    if (r < R && c < C) dx[(int64_t)split * R * C + r * C + c] = acc[j];
  }
  __syncthreads();
  float* out = ds + ((int64_t)split * c_tiles + ct) * R * M;
  for (int e = t; e < BM * M; e += THREADS) {
    const int64_t r = r0 + e / M;
    if (r < R) out[r * M + e % M] = ds_t[e];
  }
}

// ------------------------------------------------------ bank backward: dW
// block (bank-row tile, o tile, split): bank rows q = m C + c of its tile,
// the rows [k0, k1) of its split in chunks of KC; dW (splits 1, at [c, m O
// + o]) or part[split] (M C, O). A chunk's dY tile (yt, bank_split_dy), its
// raw x values (the chunk's whole rows where C < BM, else each thread's A
// fragment's) and rows of s arrive by cp.async into a ring of RAW_BUFS
// slots, RAW_BUFS - 1 chunks ahead; the threads form A = s x as their
// fragments in registers (the RS form).
constexpr int RAW_BUFS = 3;

template <int N>
__global__ void __launch_bounds__(THREADS, 2)
    bank_grad_w(const float* __restrict__ x, const float* __restrict__ s,
                const unsigned char* __restrict__ yt, float* __restrict__ dw,
                float* __restrict__ part, int64_t R, int C, int M, int O,
                int o_tiles, int splits, int64_t split_rows) {
  constexpr int TB = 2 * tile_bytes(N);
  constexpr int XE = BM * KC / THREADS;   // a thread's A values a chunk
  extern __shared__ __align__(128) unsigned char sm[];
  unsigned char* b = sm;                  // dY^T's ring
  float* raw = reinterpret_cast<float*>(b + RAW_BUFS * TB);
  const int raw_floats = XE * THREADS + KC * M;   // x [value][thread], s
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, wg = t >> 7;
  int64_t bid = blockIdx.x;
  const int split = (int)(bid % splits);
  bid /= splits;
  const int ot = (int)(bid % o_tiles);
  const int q0 = (int)(bid / o_tiles) * BM;
  const int mc = M * C;
  const int64_t k0 = split * split_rows;
  const int64_t k1 = k0 + split_rows < R ? k0 + split_rows : R;
  // this thread's fragment rows qa, qb = qa + 8 (bank rows m C + c); value
  // (ks, e) at row e & 1 ? qb : qa, depth 8 ks + lane % 4 + 4 (e / 2)
  const int qrow = wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int qa = q0 + qrow, qb = qa + 8;
  const bool ina = qa < mc, inb = qb < mc;
  const int ca = ina ? qa % C : 0, ma = ina ? qa / C : 0;
  const int cb = inb ? qb % C : 0, mb = inb ? qb / C : 0;
  // x's raw values as the chunk's whole rows (KC x C <= XE THREADS floats,
  // 16-byte copies) where C < BM, else each thread's own [value][thread]
  const bool rows = C < BM && ((uintptr_t)x & 15) == 0;

  auto fetch = [&](int64_t j) {      // chunk j into slot j % RAW_BUFS
    const int64_t rk = k0 + j * KC;
    if (rk < k1) {
      const int sl = (int)(j % RAW_BUFS);
      const unsigned char* src = yt + (rk / KC * o_tiles + ot) * TB;
      unsigned char* dst = b + sl * TB;
      for (int i = t; i < TB / 16; i += THREADS)
        cp16(dst + i * 16, src + i * 16);
      float* rx = raw + sl * raw_floats;
      float* rs = rx + XE * THREADS;
      if (rows) {
        const int64_t f0 = rk * C, f1 = k1 * C;
        for (int i = t; i < KC * C / 4; i += THREADS) {
          const int64_t f = f0 + 4 * i, left = f1 - f;
          const int bytes = left >= 4 ? 16 : left > 0 ? (int)left * 4 : 0;
          cp16(reinterpret_cast<unsigned char*>(rx + 4 * i),
               bytes ? x + f : x, bytes);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < KC / 8; ++ks)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int64_t r = rk + 8 * ks + (lane & 3) + (e & 2 ? 4 : 0);
            const bool ok = r < k1 && (e & 1 ? inb : ina);
            cp4(rx + (4 * ks + e) * THREADS + t,
                ok ? x + r * C + (e & 1 ? cb : ca) : x, ok);
          }
      }
      const int64_t s0 = rk * M, s1 = k1 * M;
      for (int e = t; e < KC * M; e += THREADS)
        cp4(rs + e, s0 + e < s1 ? s + s0 + e : s, s0 + e < s1);
    }
    cp_commit();
  };

  float acc[N / 2], p[N / 2];
  uint32_t a_hi[KC / 8][4], a_lo[KC / 8][4];
#pragma unroll
  for (int j = 0; j < N / 2; ++j) acc[j] = p[j] = 0.f;
  if (k0 < k1) {
    const int64_t steps = (k1 - k0 + KC - 1) / KC;
    for (int k = 0; k < RAW_BUFS - 1; ++k) fetch(k);
    for (int64_t j = 0; j < steps; ++j) {
      const int sl = (int)(j % RAW_BUFS);
      cp_wait_n<RAW_BUFS - 2>();     // chunk j landed
      async_fence();
      __syncthreads();               // ... everywhere; the last slot read
      fetch(j + RAW_BUFS - 1);
      const float* rx = raw + sl * raw_floats;
      const float* rs = rx + XE * THREADS;
#pragma unroll
      for (int ks = 0; ks < KC / 8; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 8 * ks + (lane & 3) + (e & 2 ? 4 : 0);
          const float xv = rows ? rx[rr * C + (e & 1 ? cb : ca)]
                                : rx[(4 * ks + e) * THREADS + t];
          to_tf32(__fmul_rn(rs[rr * M + (e & 1 ? mb : ma)], xv),
                  a_hi[ks][e], a_lo[ks][e]);
        }
      unsigned char* bh = b + sl * TB;
      pin(p);
      pin(a_hi);
      pin(a_lo);
      wg_fence();
      chunk_mma_rs<N>(p, a_hi, a_lo, bh, bh + tile_bytes(N));
      wg_commit();
      wg_wait();
      pin(p);
      pin(a_hi);
      pin(a_lo);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = __fadd_rn(acc[i], p[i]);
    }
    cp_wait_n<0>();
  }
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int qo = j & 2 ? qb : qa;
    const int o = ot * N + (j >> 2) * 8 + 2 * (lane & 3) + (j & 1);
    if (qo >= mc || o >= O) continue;
    if (splits == 1)
      dw[(int64_t)(qo % C) * M * O + (int64_t)(qo / C) * O + o] = acc[j];
    else
      part[((int64_t)split * mc + qo) * O + o] = acc[j];
  }
}

// out[e] = the parts' e-th values summed in order
__global__ void __launch_bounds__(THREADS)
    sum_parts(const float* __restrict__ part, float* __restrict__ out,
              int64_t total, int parts) {
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    float acc = part[e];
    for (int k = 1; k < parts; ++k) acc = __fadd_rn(acc, part[k * total + e]);
    out[e] = acc;
  }
}

// dW[c, m O + o] = the splits' partials of bank row m C + c summed in order
__global__ void __launch_bounds__(THREADS)
    bank_reduce(const float* __restrict__ part, float* __restrict__ dw,
                int C, int M, int O, int chunks) {
  const int64_t mc = (int64_t)M * C, total = mc * O;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t q = e / O;
    const int o = (int)(e % O);
    float acc = part[e];
    for (int k = 1; k < chunks; ++k) acc = __fadd_rn(acc, part[k * total + e]);
    const int m = (int)(q / C), c = (int)(q % C);
    dw[(int64_t)c * M * O + (int64_t)m * O + o] = acc;
  }
}

// ----------------------------------------------------------- K15-score
__device__ __forceinline__ int64_t checked(int32_t i, int64_t n) {
  if (i < 0 || i >= n) __trap();            // an index outside: a fault
  return i;
}

__global__ void __launch_bounds__(THREADS)
    score_forward(const float* __restrict__ sc, const float* __restrict__ pf,
                  const float* __restrict__ cf, const int32_t* __restrict__ knn,
                  float* __restrict__ out, int64_t B, int64_t N, int64_t S,
                  int K, int M, int O, int avg) {
  const int64_t total = B * S * K * O;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t slot = e / O, bs = slot / K, b = bs / S;
    const int o = (int)(e % O);
    const int64_t n = checked(knn[slot], N), n0 = checked(knn[bs * K], N);
    const float* p = pf + ((b * N + n) * M) * O + o;
    const float* c = cf + ((b * N + n0) * M) * O + o;
    const float* sv = sc + slot * M;
    float acc = 0.f;
    for (int m = 0; m < M; ++m)
      acc = fmaf(sv[m], __fsub_rn(p[(int64_t)m * O], c[(int64_t)m * O]), acc);
    out[e] = avg ? __fdiv_rn(acc, (float)M) : acc;
  }
}

// a warp a slot: dscores[slot, m] = sum_o dout[slot, o] (pf - cf)
__global__ void __launch_bounds__(THREADS)
    score_grad_scores(const float* __restrict__ dout,
                      const float* __restrict__ pf,
                      const float* __restrict__ cf,
                      const int32_t* __restrict__ knn,
                      float* __restrict__ dsc, int64_t B, int64_t N,
                      int64_t S, int K, int M, int O, int avg) {
  const int lane = threadIdx.x & 31;
  const int64_t slots = B * S * K;
  const int64_t warps = (int64_t)gridDim.x * (THREADS / 32);
  for (int64_t slot = (int64_t)blockIdx.x * (THREADS / 32) +
                      (threadIdx.x >> 5);
       slot < slots; slot += warps) {
    const int64_t bs = slot / K, b = bs / S;
    const int64_t n = checked(knn[slot], N), n0 = checked(knn[bs * K], N);
    const float* g = dout + slot * O;
    for (int m = 0; m < M; ++m) {
      const float* p = pf + ((b * N + n) * M + m) * O;
      const float* c = cf + ((b * N + n0) * M + m) * O;
      float acc = 0.f;
      for (int o = lane; o < O; o += 32)
        acc = fmaf(g[o], __fsub_rn(p[o], c[o]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, off));
      if (lane == 0) dsc[slot * M + m] = avg ? __fdiv_rn(acc, (float)M) : acc;
    }
  }
}

// the gradient of pf (centre = 0) or cf (centre = 1) at element (b, n, m,
// o): its row's slots in order; a centre slot is a (b, s) whose K slots
// are added in order, the sum negated
__global__ void __launch_bounds__(THREADS)
    score_grad_feats(const float* __restrict__ dout,
                     const float* __restrict__ sc,
                     const int32_t* __restrict__ ptr,
                     const int32_t* __restrict__ order,
                     float* __restrict__ out, int64_t B, int64_t N, int K,
                     int M, int O, int centre, int avg) {
  const int64_t total = B * N * M * O;
  for (int64_t e = (int64_t)blockIdx.x * THREADS + threadIdx.x; e < total;
       e += (int64_t)gridDim.x * THREADS) {
    const int64_t row = e / ((int64_t)M * O);
    const int m = (int)(e / O % M), o = (int)(e % O);
    float acc = 0.f;
    for (int32_t l = ptr[row]; l < ptr[row + 1]; ++l) {
      const int64_t id = order[l];
      if (centre) {
        for (int k = 0; k < K; ++k) {
          const int64_t slot = id * K + k;
          acc = fmaf(sc[slot * M + m], dout[slot * O + o], acc);
        }
      } else {
        acc = fmaf(sc[id * M + m], dout[id * O + o], acc);
      }
    }
    if (avg) acc = __fdiv_rn(acc, (float)M);
    out[e] = centre ? -acc : acc;
  }
}

inline unsigned grid_of(int64_t items) {
  const int64_t blocks = (items + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;
  return (unsigned)(blocks < 1 ? 1 : (blocks > cap ? cap : blocks));
}

int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

// the splits of a walk over `most` units for `tiles` output tiles: none
// when the tiles fill the multiprocessors, else up to twice their count of
// blocks
int64_t splits_of(int64_t tiles, int64_t most) {
  if (tiles >= sm_count()) return 1;
  int64_t s = (2 * sm_count() + tiles - 1) / tiles;
  if (s > most) s = most;
  return s < 1 ? 1 : s;
}

// K15-bank's launch plan for op on (R, C, M, O): the column tile N, the
// column tiles, the splits, dW's rows a split, W's split tiles (bytes) and
// the scratch floats (W's tiles, then the splits' partials)
struct Plan {
  int n;
  int64_t col_tiles, row_tiles, splits, split_rows, wt_bytes, scratch;
};

Plan plan_of(int op, int64_t R, int64_t C, int64_t M, int64_t O) {
  Plan p{};
  if (op == 0) {
    p.n = O <= 32 ? 32 : 64;
    p.col_tiles = (O + p.n - 1) / p.n;
    p.row_tiles = (R + BM - 1) / BM;
    p.splits = splits_of(p.row_tiles * p.col_tiles, (C + KC - 1) / KC * M);
    p.wt_bytes = M * ((C + KC - 1) / KC) * p.col_tiles * 2 * tile_bytes(p.n);
    p.scratch = p.wt_bytes / 4 + (p.splits > 1 ? p.splits * R * O : 0);
  } else if (op == 1) {
    p.n = C <= 32 ? 32 : 64;
    p.col_tiles = (C + p.n - 1) / p.n;
    p.row_tiles = (R + BM - 1) / BM;
    p.splits = splits_of(p.row_tiles * p.col_tiles, (O + KC - 1) / KC * M);
    p.wt_bytes = M * ((O + KC - 1) / KC) * p.col_tiles * 2 * tile_bytes(p.n);
    p.scratch = p.wt_bytes / 4 + (p.splits > 1 ? p.splits * R * C : 0) +
                (p.splits * p.col_tiles > 1 ? p.splits * p.col_tiles * R * M
                                            : 0);
  } else {
    p.n = O <= 32 ? 32 : 64;
    p.col_tiles = (O + p.n - 1) / p.n;
    p.row_tiles = (M * C + BM - 1) / BM;
    p.splits = splits_of(p.row_tiles * p.col_tiles, (R + 255) / 256);
    int64_t per = (R + p.splits - 1) / p.splits;
    per = (per + KC - 1) / KC * KC;
    p.split_rows = per;
    p.splits = (R + per - 1) / per;
    p.wt_bytes = (R + KC - 1) / KC * p.col_tiles * 2 * tile_bytes(p.n);
    p.scratch = p.wt_bytes / 4 + (p.splits > 1 ? p.splits * M * C * O : 0);
  }
  return p;
}

// dynamic shared memory of op's kernel at column tile n
int64_t smem_of(int op, int n, int64_t M) {
  if (op == 0) return STAGES * 2 * tile_bytes(n) + 4 * BM * M;
  if (op == 1)
    return 2 * tile_bytes(BM) + STAGES_X * 2 * tile_bytes(n) + 8 * BM * M;
  return RAW_BUFS * (2 * tile_bytes(n) + 4 * (BM * KC + KC * M));
}

template <typename K>
cudaError_t allow_smem(K kernel, int64_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int N>
cudaError_t launch_bank(int op, const Plan& p, const float* x, const float* s,
                        const float* w, const float* dy, float* out0,
                        float* out1, float* scratch, int64_t R, int C, int M,
                        int O, cudaStream_t st) {
  const int64_t bytes = smem_of(op, N, M);
  const int64_t blocks = p.row_tiles * p.col_tiles * p.splits;
  cudaError_t e;
  unsigned char* wt = reinterpret_cast<unsigned char*>(scratch);
  float* parts = scratch + p.wt_bytes / 4;
  if (op == 0) {
    if ((e = allow_smem(bank_forward<N>, bytes)) != cudaSuccess) return e;
    bank_split_w<N><<<(unsigned)(p.wt_bytes / (2 * tile_bytes(N))), THREADS,
                      0, st>>>(w, wt, C, M, O, (C + KC - 1) / KC,
                               (int)p.col_tiles, 1);
    bank_forward<N><<<(unsigned)blocks, THREADS, bytes, st>>>(
        x, s, wt, p.splits > 1 ? parts : out0, R, C, M, O, (int)p.col_tiles,
        (int)p.splits);
    if ((e = cudaGetLastError()) != cudaSuccess || p.splits == 1) return e;
    sum_parts<<<grid_of(R * O), THREADS, 0, st>>>(parts, out0, R * O,
                                                  (int)p.splits);
  } else if (op == 1) {
    if ((e = allow_smem(bank_grad_x<N>, bytes)) != cudaSuccess) return e;
    const int64_t parts_ds = p.splits * p.col_tiles;
    float* dx = p.splits > 1 ? parts : out0;
    float* ds = parts_ds > 1 ? parts + (p.splits > 1 ? p.splits * R * C : 0)
                             : out1;
    bank_split_w<N><<<(unsigned)(p.wt_bytes / (2 * tile_bytes(N))), THREADS,
                      0, st>>>(w, wt, C, M, O, (O + KC - 1) / KC,
                               (int)p.col_tiles, 0);
    bank_grad_x<N><<<(unsigned)blocks, THREADS, bytes, st>>>(
        x, s, wt, dy, dx, ds, R, C, M, O, (int)p.col_tiles, (int)p.splits);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (p.splits > 1)
      sum_parts<<<grid_of(R * C), THREADS, 0, st>>>(dx, out0, R * C,
                                                    (int)p.splits);
    if (parts_ds > 1)
      sum_parts<<<grid_of(R * M), THREADS, 0, st>>>(ds, out1, R * M,
                                                    (int)parts_ds);
  } else {
    if ((e = allow_smem(bank_grad_w<N>, bytes)) != cudaSuccess) return e;
    bank_split_dy<N><<<(unsigned)(p.wt_bytes / (2 * tile_bytes(N))),
                       THREADS, 0, st>>>(dy, wt, R, O, (int)p.col_tiles);
    bank_grad_w<N><<<(unsigned)blocks, THREADS, bytes, st>>>(
        x, s, wt, out0, parts, R, C, M, O, (int)p.col_tiles, (int)p.splits,
        p.split_rows);
    if ((e = cudaGetLastError()) != cudaSuccess || p.splits == 1) return e;
    bank_reduce<<<grid_of((int64_t)M * C * O), THREADS, 0, st>>>(
        parts, out0, C, M, O, (int)p.splits);
  }
  return cudaGetLastError();
}

}  // namespace

// the scratch floats K15-bank's op (0-2) takes on (R, C, M, O): W's split
// tiles (ops 0 and 1) and the depth splits' partials
extern "C" long long paconv_bank_scratch(long long op, long long r,
                                         long long c, long long m,
                                         long long o) {
  if (r <= 0 || c <= 0 || m <= 0 || o <= 0 || op < 0 || op > 2) return 0;
  return plan_of((int)op, r, c, m, o).scratch;
}

// args: twelve int64 (op, x, s, w, dy, out0, out1, scratch, R, C, M, O):
// op 0: y (R, O) = the contraction of x (R, C), s (R, M), w (C, M O): out0.
// op 1: dX (R, C) into out0 and dS (R, M) into out1, from dy (R, O).
// op 2: dW (C, M O) into out0, from dy.
// scratch: paconv_bank_scratch(op, R, C, M, O) floats (or none at 0).
extern "C" int paconv_bank(const long long* args, void* stream) {
  const int op = (int)args[0];
  const float* x = (const float*)args[1];
  const float* s = (const float*)args[2];
  const float* w = (const float*)args[3];
  const float* dy = (const float*)args[4];
  float* out0 = (float*)args[5];
  float* out1 = (float*)args[6];
  float* scratch = (float*)args[7];
  const long long R = args[8], C = args[9], M = args[10], O = args[11];
  if (R <= 0) return 0;
  if (op < 0 || op > 2 || C <= 0 || M <= 0 || O <= 0 || C >= INT_MAX ||
      M >= INT_MAX || O >= INT_MAX || M * C >= INT_MAX - BM)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(op, R, C, M, O);
  if (smem_of(op, p.n, M) > 227 * 1024 ||
      p.row_tiles * p.col_tiles * p.splits > INT_MAX ||
      p.wt_bytes / (2 * tile_bytes(p.n)) > INT_MAX ||
      (p.scratch > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(p.n == 32
                   ? launch_bank<32>(op, p, x, s, w, dy, out0, out1, scratch,
                                     R, (int)C, (int)M, (int)O, st)
                   : launch_bank<64>(op, p, x, s, w, dy, out0, out1, scratch,
                                     R, (int)C, (int)M, (int)O, st));
}

// args: seventeen int64 (op, scores, pf, cf, knn, knn0, dout, out,
// scratch, B, N, S, K, M, O, avg, unused):
// op 0: out (B, S, K, O) from scores (B, S, K, M), pf and cf (B, N, M, O),
//       knn (B, S, K) int32.
// op 1: the scores' gradient (B, S, K, M) into out, from dout (B, S, K, O).
// op 2: pf's gradient (B, N, M, O) into out: the list of the slots that
//       name each row (built in scratch, point_gather_scratch(B N, B S K)
//       words: the same stable_lists.cuh layout), then its sums.
// op 3: cf's gradient into out: the list of the (b, s) whose knn0 (B, S)
//       int32 (knn[..., 0], contiguous) names each row, then its sums.
// An index outside [0, N) stops the kernel (__trap).
extern "C" int paconv_score(const long long* args, void* stream) {
  const int op = (int)args[0];
  const float* sc = (const float*)args[1];
  const float* pf = (const float*)args[2];
  const float* cf = (const float*)args[3];
  const int32_t* knn = (const int32_t*)args[4];
  const int32_t* knn0 = (const int32_t*)args[5];
  const float* dout = (const float*)args[6];
  float* out = (float*)args[7];
  uint32_t* scratch = (uint32_t*)args[8];
  const long long B = args[9], N = args[10], S = args[11], K = args[12],
                  M = args[13], O = args[14];
  const int avg = (int)args[15];
  if (B <= 0 || S <= 0) return 0;
  if (op < 0 || op > 3 || N <= 0 || K <= 0 || M <= 0 || O <= 0 ||
      K >= INT_MAX || M >= INT_MAX || O >= INT_MAX || B * N >= INT_MAX ||
      B * S * K >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (op == 0) {
    score_forward<<<grid_of(B * S * K * O), THREADS, 0, st>>>(
        sc, pf, cf, knn, out, B, N, S, (int)K, (int)M, (int)O, avg);
  } else if (op == 1) {
    score_grad_scores<<<grid_of(B * S * K * 32), THREADS, 0, st>>>(
        dout, pf, cf, knn, out, B, N, S, (int)K, (int)M, (int)O, avg);
  } else {
    const bool centre = op == 3;
    const int64_t segs = B * N, slots = centre ? B * S : B * S * K;
    const int32_t* idx = centre ? knn0 : knn;
    int32_t* ptr = (int32_t*)(scratch + slist::list_layout(segs, slots).words);
    int32_t* order = ptr + segs + 1;
    const int err = slist::build_list(idx, slots, centre ? S : S * K, N, segs,
                                      scratch, ptr, order, st);
    if (err) return err;
    score_grad_feats<<<grid_of(B * N * M * O), THREADS, 0, st>>>(
        dout, sc, ptr, order, out, B, N, (int)K, (int)M, (int)O,
        centre ? 1 : 0, avg);
  }
  return (int)cudaGetLastError();
}
