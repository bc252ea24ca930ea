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
// Bound. K15-bank is a matrix product of depth M C: 2 R C M O float
// operations (and R M O for the scores), over the card's float32 rate
// outside the tensor cores (67 TFLOP/s at 700 W): 3.9 ms at SA1-SA4 of a
// batch-8 paconvseg forward, twice that for the backward; the bytes (x, s,
// W, y once) are far less. K15-score moves bytes: pf and cf rows read once
// a slot and the output written once.
//
// Design. This is a float32 SIMT kernel that is right first; tensor cores
// (wgmma, TMA, bf16) are later work.
// - bank_forward: the product as a GEMM of A (R, M C), A[r, m C + c] =
//   s[r, m] x[r, c], with B[m C + c, o] = W[c, m O + o]. A block takes 64
//   rows by 32 or 64 outputs; it stages a 64 x 16 tile of x once, then for
//   each m forms A's tile in shared memory (a product a value) beside W's
//   16 x BN tile of that m, and 256 threads each sum a 4 x 4 (or 4 x 2)
//   register tile. Rows are summed in the order (c tile, m, c), the same
//   for every call.
// - bank_grad_x: dX and dS. For a block's 64 rows, each c tile and each m,
//   G = dY W_m^T is summed in registers over O (W_m[c, o] = W[c, m O + o]);
//   dX[r, c] += s[r, m] G[r, c] and dS[r, m] += sum_c x[r, c] G[r, c], the
//   last summed over a thread's columns, then a butterfly over the 16
//   threads of its rows, then over the c tiles in order in shared memory.
// - bank_grad_w: dW = A^T dY with A formed as in the forward, split over
//   row chunks (enough blocks to fill the card): each chunk's partial sum
//   is written to a scratch, and bank_reduce sums the chunks in order. No
//   atomics: two calls give the same bits.
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

constexpr int THREADS = 256;
constexpr int BM = 64;    // rows (or bank rows m C + c) a tile
constexpr int BK = 16;    // the depth of a step

// a tile's float4 / float2 of columns in shared memory
template <int T>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[T]) {
  if constexpr (T == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

// ----------------------------------------------------------- bank forward
// thread (tx, ty) = (t % 16, t / 16): rows ty * 4 + i, columns tx * TN + j
template <int BN>
__global__ void __launch_bounds__(THREADS)
    bank_forward(const float* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ w, float* __restrict__ y,
                 int64_t R, int C, int M, int O) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float xs[BK][BM + 4];
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int64_t r0 = (int64_t)blockIdx.y * BM;
  const int o0 = blockIdx.x * BN;
  const int64_t mo = (int64_t)M * O;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int c0 = 0; c0 < C; c0 += BK) {
    __syncthreads();                        // the last tile is read
    for (int e = t; e < BM * BK; e += THREADS) {
      const int row = e / BK, kk = e % BK;
      const int64_t r = r0 + row;
      const int c = c0 + kk;
      xs[kk][row] = r < R && c < C ? x[r * C + c] : 0.f;
    }
    for (int m = 0; m < M; ++m) {
      __syncthreads();                      // xs written, as and bs read
      for (int e = t; e < BM * BK; e += THREADS) {
        const int row = e % BM, kk = e / BM;
        const int64_t r = r0 + row;
        as[kk][row] = r < R ? __fmul_rn(xs[kk][row], s[r * M + m]) : 0.f;
      }
      for (int e = t; e < BK * BN; e += THREADS) {
        const int kk = e / BN, col = e % BN;
        const int c = c0 + kk, o = o0 + col;
        bs[kk][col] = c < C && o < O ? w[c * mo + (int64_t)m * O + o] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[TN];
        load_cols<4>(&as[kk][ty * 4], a);
        load_cols<TN>(&bs[kk][tx * TN], b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t r = r0 + ty * 4 + i;
    if (r >= R) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < O) y[r * O + o] = acc[i][j];
    }
  }
}

// ---------------------------------------------------- bank backward: dX, dS
// a block's 64 rows, every c tile of BC columns in turn; dynamic shared
// memory: the rows' dS (64 x M)
template <int BC>
__global__ void __launch_bounds__(THREADS)
    bank_grad_x(const float* __restrict__ x, const float* __restrict__ s,
                const float* __restrict__ w, const float* __restrict__ dy,
                float* __restrict__ dx, float* __restrict__ ds, int64_t R,
                int C, int M, int O) {
  constexpr int TC = BC / 16;
  extern __shared__ float ds_rows[];        // [BM][M]
  __shared__ __align__(16) float dys[BK][BM + 4];
  __shared__ __align__(16) float ws[BK][BC + 4];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int64_t r0 = (int64_t)blockIdx.x * BM;
  const int64_t mo = (int64_t)M * O;
  for (int c0 = 0; c0 < C; c0 += BC) {
    float xr[4][TC], gx[4][TC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = c0 + tx * TC + j;
        xr[i][j] = r < R && c < C ? x[r * C + c] : 0.f;
        gx[i][j] = 0.f;
      }
    }
    for (int m = 0; m < M; ++m) {
      float g[4][TC];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) g[i][j] = 0.f;
      for (int o0 = 0; o0 < O; o0 += BK) {
        __syncthreads();                    // the last tiles are read
        for (int e = t; e < BM * BK; e += THREADS) {
          const int row = e / BK, kk = e % BK;
          const int64_t r = r0 + row;
          const int o = o0 + kk;
          dys[kk][row] = r < R && o < O ? dy[r * O + o] : 0.f;
        }
        for (int e = t; e < BK * BC; e += THREADS) {
          const int kk = e % BK, col = e / BK;
          const int c = c0 + col, o = o0 + kk;
          ws[kk][col] = c < C && o < O ? w[c * mo + (int64_t)m * O + o] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[4], b[TC];
          load_cols<4>(&dys[kk][ty * 4], a);
          load_cols<TC>(&ws[kk][tx * TC], b);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < TC; ++j) g[i][j] = fmaf(a[i], b[j], g[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int64_t r = r0 + ty * 4 + i;
        const float sv = r < R ? s[r * M + m] : 0.f;
        float p = 0.f;
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          gx[i][j] = fmaf(sv, g[i][j], gx[i][j]);
          p = fmaf(xr[i][j], g[i][j], p);
        }
        // the 16 threads of these rows (lanes of one half warp)
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          p = __fadd_rn(p, __shfl_xor_sync(0xffffffffu, p, off, 16));
        if (tx == 0) {
          float* d = &ds_rows[(ty * 4 + i) * M + m];
          *d = c0 == 0 ? p : __fadd_rn(*d, p);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + ty * 4 + i;
      if (r >= R) continue;
#pragma unroll
      for (int j = 0; j < TC; ++j) {
        const int c = c0 + tx * TC + j;
        if (c < C) dx[r * C + c] = gx[i][j];
      }
    }
  }
  if (tx == 0) {                            // the writer of these rows' dS
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int64_t r = r0 + ty * 4 + i;
      if (r >= R) continue;
      for (int m = 0; m < M; ++m) ds[r * M + m] = ds_rows[(ty * 4 + i) * M + m];
    }
  }
}

// ------------------------------------------------------ bank backward: dW
// block (o tile, bank-row tile, chunk): the chunk's rows [k0, k1) summed
// into part[chunk][m C + c][o]
template <int BN>
__global__ void __launch_bounds__(THREADS)
    bank_grad_w(const float* __restrict__ x, const float* __restrict__ s,
                const float* __restrict__ dy, float* __restrict__ part,
                int64_t R, int C, int M, int O, int64_t chunk_rows) {
  constexpr int TN = BN / 16;
  __shared__ __align__(16) float as[BK][BM + 4];
  __shared__ __align__(16) float bs[BK][BN];
  const int t = threadIdx.x, tx = t & 15, ty = t >> 4;
  const int o0 = blockIdx.x * BN;
  const int64_t mc = (int64_t)M * C;
  const int64_t q0 = (int64_t)blockIdx.y * BM;       // bank rows m C + c
  const int64_t k0 = (int64_t)blockIdx.z * chunk_rows;
  const int64_t k1 = k0 + chunk_rows < R ? k0 + chunk_rows : R;
  float acc[4][TN];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int64_t rk = k0; rk < k1; rk += BK) {
    __syncthreads();
    for (int e = t; e < BM * BK; e += THREADS) {
      const int kk = e / BM, qx = e % BM;
      const int64_t r = rk + kk, q = q0 + qx;
      float v = 0.f;
      if (r < k1 && q < mc) {
        const int m = (int)(q / C), c = (int)(q % C);
        v = __fmul_rn(x[r * C + c], s[r * M + m]);
      }
      as[kk][qx] = v;
    }
    for (int e = t; e < BK * BN; e += THREADS) {
      const int kk = e / BN, col = e % BN;
      const int64_t r = rk + kk;
      const int o = o0 + col;
      bs[kk][col] = r < k1 && o < O ? dy[r * O + o] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[TN];
      load_cols<4>(&as[kk][ty * 4], a);
      load_cols<TN>(&bs[kk][tx * TN], b);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  float* out = part + blockIdx.z * mc * O;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t q = q0 + ty * 4 + i;
    if (q >= mc) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = o0 + tx * TN + j;
      if (o < O) out[q * O + o] = acc[i][j];
    }
  }
}

// dW[c, m O + o] = the chunks' partials of bank row m C + c summed in order
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

// the row chunks of bank_grad_w: enough blocks for ~4 a multiprocessor,
// chunks of a multiple of BK rows, at least 256 rows a chunk
void bank_split(int64_t R, int64_t C, int64_t M, int64_t O, int64_t* chunks,
                int64_t* rows) {
  const int64_t bn = O <= 32 ? 32 : 64;
  const int64_t tiles = ((O + bn - 1) / bn) * ((M * C + BM - 1) / BM);
  int64_t want = (132 * 4 + tiles - 1) / tiles;
  const int64_t most = (R + 255) / 256;
  if (want > most) want = most;
  if (want < 1) want = 1;
  int64_t per = (R + want - 1) / want;
  per = (per + BK - 1) / BK * BK;
  *rows = per;
  *chunks = (R + per - 1) / per;
}

}  // namespace

// the row chunks of K15-bank's dW (op 2) for its scratch: chunks x M C x O
// floats
extern "C" long long paconv_bank_chunks(long long r, long long c,
                                        long long m, long long o) {
  if (r <= 0) return 0;
  int64_t chunks, rows;
  bank_split(r, c, m, o, &chunks, &rows);
  return chunks;
}

// args: twelve int64 (op, x, s, w, dy, out0, out1, scratch, R, C, M, O):
// op 0: y (R, O) = the contraction of x (R, C), s (R, M), w (C, M O): out0.
// op 1: dX (R, C) into out0 and dS (R, M) into out1, from dy (R, O).
// op 2: dW (C, M O) into out0, from dy, the chunks' partials in scratch
//       (paconv_bank_chunks x M C x O floats).
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
      M >= INT_MAX || O >= INT_MAX || M * C >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_tiles = (R + BM - 1) / BM;
  if (op == 0) {
    if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
    if (O <= 32) {
      bank_forward<32><<<dim3(1, (unsigned)row_tiles), THREADS, 0, st>>>(
          x, s, w, out0, R, (int)C, (int)M, (int)O);
    } else {
      bank_forward<64><<<dim3((unsigned)((O + 63) / 64), (unsigned)row_tiles),
                         THREADS, 0, st>>>(x, s, w, out0, R, (int)C, (int)M,
                                           (int)O);
    }
  } else if (op == 1) {
    const size_t smem = (size_t)BM * M * sizeof(float);
    if (smem > 160 * 1024) return (int)cudaErrorInvalidValue;
    if (C <= 32) {
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(bank_grad_x<32>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      bank_grad_x<32><<<(unsigned)row_tiles, THREADS, smem, st>>>(
          x, s, w, dy, out0, out1, R, (int)C, (int)M, (int)O);
    } else {
      if (smem > 48 * 1024)
        cudaFuncSetAttribute(bank_grad_x<64>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
      bank_grad_x<64><<<(unsigned)row_tiles, THREADS, smem, st>>>(
          x, s, w, dy, out0, out1, R, (int)C, (int)M, (int)O);
    }
  } else {
    int64_t chunks, rows;
    bank_split(R, C, M, O, &chunks, &rows);
    const long long q_tiles = (M * C + BM - 1) / BM;
    if (q_tiles > 65535 || chunks > 65535) return (int)cudaErrorInvalidValue;
    if (O <= 32) {
      bank_grad_w<32><<<dim3(1, (unsigned)q_tiles, (unsigned)chunks), THREADS,
                        0, st>>>(x, s, dy, scratch, R, (int)C, (int)M, (int)O,
                                 rows);
    } else {
      bank_grad_w<64><<<dim3((unsigned)((O + 63) / 64), (unsigned)q_tiles,
                             (unsigned)chunks),
                        THREADS, 0, st>>>(x, s, dy, scratch, R, (int)C,
                                          (int)M, (int)O, rows);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    bank_reduce<<<grid_of(M * C * O), THREADS, 0, st>>>(
        scratch, out0, (int)C, (int)M, (int)O, (int)chunks);
  }
  return (int)cudaGetLastError();
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
