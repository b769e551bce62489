// Grouped matmul for dropless MoE: the Hopper kernels behind
// paddle_tpu_torch/ops/kernels/grouped_matmul.py (`gmm`, `tgmm`).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/grouped_matmul.py:
// `_gmm_kernel` :60 / `_gmm_call` :69 (the forward, and dlhs on rhs^T) and
// `_tgmm_kernel` :98 / `_tgmm_call` :117 (the weight gradient).
//
// What they compute. lhs is [M, K] row-major, M a multiple of tile_m; row
// tile i (rows i * tile_m ...) belongs to expert tile_expert[i].
//   gmm:  out[rows of tile i] = lhs[rows of tile i] @ W_e, e = tile_expert[i],
//         with W_e = rhs[e] for rhs [E, K, N], or with `trans` W_e = rhs[e]^T
//         for rhs [E, N, K] (dlhs reads the forward's weight transposed in
//         place of a copy of it); every one of the M rows is written;
//   tgmm: out[e] = sum over the tiles i with tile_expert[i] == e, in
//         ascending i, of lhs[tile i]^T @ g[tile i]; out is [E, K, N] and an
//         expert that owns no tile gets zeros.
// Sums in f32, one rounding to the output dtype.
//
// What bounds them. At the dropless layer of Qwen1.5-MoE-A2.7B (2048 tokens,
// top-4, 60 experts, D 2048, F 1408) a gmm reads the whole expert stack
// (346 MB) for ~64 MB of activations: the weight stream, not the tensor
// cores, sets the least time (~0.14 ms at 3.35 TB/s against ~0.05 ms of
// bf16 math). tgmm writes the same 346 MB.
//
// Design. bf16 runs on tensor cores (mma.sync m16n8k16, f32 accumulate),
// 128 x 128 output tiles, 8 warps of 64 x 32, 32 reduction values a stage,
// a 3-stage ring filled by 16-byte cp.async (zero-fill at ragged edges).
// Fragments come from shared memory through ldmatrix; the .trans form reads
// an operand whose reduction axis is the tile's rows (the [K, N] weight, the
// lhs and g of tgmm), the plain form one whose reduction axis is contiguous
// (lhs of gmm, the [N, K] weight of dlhs). Rows are padded by 16 bytes, an
// odd number of 16-byte units, so the 8 row reads of an ldmatrix fall in
// distinct banks.
//   gmm: one block per (128-row tile, 128-column tile); its expert is
//     tile_expert[row tile]. A tile_expert entry outside [0, E) makes the
//     block write NaN (never an out-of-bounds read).
//   tgmm: one block per (expert, 128-row tile of K, 128-column tile of N).
//     Warp 0 lists the expert's tiles in ascending index (a ballot per 32
//     entries of tile_expert); the block then walks those tiles' rows in
//     that order, the sum held in registers, and writes once. The TPU kernel
//     accumulated into its output window on the premise of a sorted
//     tile_expert and a sequential grid, and zeroed absent experts after the
//     call; here no block depends on another or on the grid's order, there
//     are no atomics, and the result is the same bits from run to run and
//     for any interleaving of the tiles that keeps each expert's own tiles
//     in order.
// f32 (checks and CPU-sized tests; the model runs bf16 on the card) runs a
// plain FMA kernel of 64 x 64 tiles: each thread 4 x 4 outputs, each 16
// reduction values summed, then added to the running total in order.
//
// Known gaps: mma.sync, not wgmma; cp.async, not TMA; padding rows are
// multiplied like the others; tgmm reads lhs and g once per column / row
// tile of the output (from L2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kModeN = 0;  // gmm, rhs [E, K, N]
constexpr int kModeT = 1;  // gmm, rhs [E, N, K] read transposed (dlhs)
constexpr int kModeW = 2;  // tgmm

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int WN = 4;                 // warps along the columns (2 x 4 warps)
constexpr int MT = 4, NT = 4;         // a warp's 16-row and 8-column mma tiles
constexpr int LDK = BK + 8;           // a row of BK reduction values, padded
constexpr int LDW = BM + 8;           // a row of 128 output rows / columns
constexpr int kTileElems = BM * LDK;  // >= BK * LDW: either layout fits
static_assert(BM == BN && BM * LDK >= BK * LDW, "tile layout");
constexpr size_t kStageBytes = size_t(2) * kTileElems * 2;  // A and B, bf16
constexpr size_t kRingBytes = STAGES * kStageBytes;         // 61,440
constexpr int kMaxSmem = 232448;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 b16 matrices; lanes 8j .. 8j + 7 give the row addresses of
// matrix j. Plain: lane l holds row l / 4, columns 2 (l % 4) and + 1 of
// each. Trans: rows 2 (l % 4) and + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Shared-memory layouts of one stage:
//   A, modes N and T: [BM][LDK], an output row's BK reduction values;
//   A, mode W:        [BK][LDW], a reduction row (token) of 128 output rows;
//   B, modes N and W: [BK][LDW], a reduction row of 128 output columns;
//   B, mode T:        [BN][LDK], an output column's BK reduction values.
// One stage's products, BK deep, into the warp's 64 x 32 accumulators.
template <int MODE>
__device__ __forceinline__ void mma_stage(const bf16* a, const bf16* b,
                                          float (&acc)[MT][NT][4], int wm,
                                          int wn, int lane) {
  const int r = lane & 7, j = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t af[MT][4], bfr[NT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = wm * MT * 16 + i * 16;
      // a0..a3: (rows 0-7 | 8-15) x (k 0-7 | 8-15) of the 16 x 16 A tile
      if (MODE == kModeW)
        ldsm_x4_t(af[i], a + (kk + r + 8 * (j >> 1)) * LDW + m + 8 * (j & 1));
      else
        ldsm_x4(af[i], a + (m + r + 8 * (j & 1)) * LDK + kk + 8 * (j >> 1));
    }
#pragma unroll
    for (int jj = 0; jj < NT; jj += 2) {
      const int n = wn * NT * 8 + jj * 8;
      uint32_t t[4];
      // b0, b1 of column tile jj, then of jj + 1
      if (MODE == kModeT)
        ldsm_x4(t, b + (n + r + 8 * (j >> 1)) * LDK + kk + 8 * (j & 1));
      else
        ldsm_x4_t(t, b + (kk + r + 8 * (j & 1)) * LDW + n + 8 * (j >> 1));
      bfr[jj][0] = t[0];
      bfr[jj][1] = t[1];
      bfr[jj + 1][0] = t[2];
      bfr[jj + 1][1] = t[3];
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], af[i], bfr[jn]);
  }
}

// MODE N / T: lhs [M][R] (R = reduction), w the expert's weight ([R][N] or
// [N][R]), out [M][N]; grid (N tiles, M / BM). MODE W: lhs [M][R_out = K],
// rhs = g [M][N], out [E][K][N]; grid (N tiles, K tiles, E).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
                    const int* __restrict__ tile_expert,
                    bf16* __restrict__ out, int M, int R, int N, int E,
                    int tile_m, int n_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int n_mine;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;  // output rows: tokens (N, T) or K (W)

  int e;
  bool bad = false;
  const bf16* w = rhs;
  int steps;
  const int spt = tile_m / BK;  // stages per row tile (tgmm)
  int* list = reinterpret_cast<int*>(smem + kRingBytes);
  if (MODE == kModeW) {
    e = blockIdx.z;
    if (warp == 0) {
      int cnt = 0;
      for (int base = 0; base < n_tiles; base += 32) {
        const int i = base + lane;
        const bool mine = i < n_tiles && tile_expert[i] == e;
        const unsigned mask = __ballot_sync(0xffffffffu, mine);
        if (mine) list[cnt + __popc(mask & ((1u << lane) - 1u))] = i;
        cnt += __popc(mask);
      }
      if (lane == 0) n_mine = cnt;
    }
    __syncthreads();
    steps = n_mine * spt;
  } else {
    e = tile_expert[m0 / tile_m];
    bad = e < 0 || e >= E;
    if (bad) e = 0;
    w = rhs + size_t(e) * R * N;
    steps = (R + BK - 1) / BK;
  }

  auto load_stage = [&](int s, int st) {
    bf16* as = reinterpret_cast<bf16*>(smem + st * kStageBytes);
    bf16* bs = as + kTileElems;
    if (MODE == kModeW) {
      // BK token rows of lhs (columns m0.. of K) and of g (columns n0..)
      const int row0 = list[s / spt] * tile_m + (s % spt) * BK;
      for (int c = tid; c < BK * (BM / 8); c += THREADS) {
        const int rr = c / (BM / 8), x = (c % (BM / 8)) * 8;
        const size_t row = size_t(row0 + rr);
        const int k = m0 + x, n = n0 + x;
        cp_async16(as + rr * LDW + x, k < R ? lhs + row * R + k : lhs,
                   k < R ? 16 : 0);
        cp_async16(bs + rr * LDW + x, n < N ? rhs + row * N + n : rhs,
                   n < N ? 16 : 0);
      }
    } else {
      const int r0 = s * BK;
      for (int c = tid; c < BM * (BK / 8); c += THREADS) {
        const int row = c / (BK / 8), x = (c % (BK / 8)) * 8;
        const int r = r0 + x;
        cp_async16(as + row * LDK + x,
                   r < R ? lhs + size_t(m0 + row) * R + r : lhs,
                   r < R ? 16 : 0);
      }
      if (MODE == kModeN) {
        for (int c = tid; c < BK * (BN / 8); c += THREADS) {
          const int rr = c / (BN / 8), x = (c % (BN / 8)) * 8;
          const int r = r0 + rr, n = n0 + x;
          const bool ok = r < R && n < N;
          cp_async16(bs + rr * LDW + x, ok ? w + size_t(r) * N + n : w,
                     ok ? 16 : 0);
        }
      } else {
        for (int c = tid; c < BN * (BK / 8); c += THREADS) {
          const int col = c / (BK / 8), x = (c % (BK / 8)) * 8;
          const int n = n0 + col, r = r0 + x;
          const bool ok = n < N && r < R;
          cp_async16(bs + col * LDK + x, ok ? w + size_t(n) * R + r : w,
                     ok ? 16 : 0);
        }
      }
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int jn = 0; jn < NT; ++jn)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][jn][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1's readers are done
    {
      const int ns = s + STAGES - 1;
      if (ns < steps) load_stage(ns, ns % STAGES);
      cp_async_commit();
    }
    const bf16* as =
        reinterpret_cast<const bf16*>(smem + (s % STAGES) * kStageBytes);
    mma_stage<MODE>(as, as + kTileElems, acc, wm, wn, lane);
  }
  cp_async_wait<0>();

  // epilogue: one rounding to bf16; c0, c1 at (row g, columns 2t, 2t + 1),
  // c2, c3 at row g + 8
  bf16* o = MODE == kModeW ? out + size_t(e) * R * N : out;
  const int rows = MODE == kModeW ? R : M;
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int n = n0 + wn * NT * 8 + jn * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n and n + 1 are in or out together
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
        if (m < rows)
          *reinterpret_cast<__nv_bfloat162*>(o + size_t(m) * N + n) =
              bad ? __floats2bfloat162_rn(nan, nan)
                  : __floats2bfloat162_rn(acc[i][jn][2 * h],
                                          acc[i][jn][2 * h + 1]);
      }
  }
}

// f32: 64 x 64 output tiles, 256 threads of 4 x 4 outputs, 16 reduction
// values a step (summed, then added to the running total).
constexpr int kF = 64, kFK = 16, kFThreads = 256;

template <bool TRANS>
__global__ void __launch_bounds__(kFThreads)
    gmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ rhs,
                   const int* __restrict__ tile_expert, float* __restrict__ out,
                   int M, int R, int N, int E, int tile_m) {
  __shared__ float as[kFK][kF + 1];  // [reduction][row]
  __shared__ float bs[kFK][kF];      // [reduction][column]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF, n0 = blockIdx.x * kF;
  int e = tile_expert[m0 / tile_m];
  const bool bad = e < 0 || e >= E;
  if (bad) e = 0;
  const float* w = rhs + size_t(e) * R * N;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int r0 = 0; r0 < R; r0 += kFK) {
    for (int c = tid; c < kF * kFK; c += kFThreads) {
      {
        const int row = c / kFK, rr = c % kFK, r = r0 + rr;
        as[rr][row] = r < R ? lhs[size_t(m0 + row) * R + r] : 0.f;
      }
      if (TRANS) {
        const int col = c / kFK, rr = c % kFK, r = r0 + rr, n = n0 + col;
        bs[rr][col] = (r < R && n < N) ? w[size_t(n) * R + r] : 0.f;
      } else {
        const int rr = c / kF, col = c % kF, r = r0 + rr, n = n0 + col;
        bs[rr][col] = (r < R && n < N) ? w[size_t(r) * N + n] : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part = 0.f;
#pragma unroll
        for (int q = 0; q < kFK; ++q)
          part = fmaf(as[q][ty + 16 * i], bs[q][tx + 16 * j], part);
        acc[i][j] += part;
      }
    __syncthreads();
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;  // M % 64 == 0: always a row
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[size_t(m) * N + n] = bad ? nan : acc[i][j];
    }
  }
}

// block (column tile, K tile, expert): the expert's tiles in ascending index
__global__ void __launch_bounds__(kFThreads)
    tgmm_f32_kernel(const float* __restrict__ lhs, const float* __restrict__ g,
                    const int* __restrict__ tile_expert,
                    float* __restrict__ out, int K, int N, int tile_m,
                    int n_tiles) {
  __shared__ float as[kFK][kF + 1];  // [token][k]
  __shared__ float bs[kFK][kF];      // [token][n]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.y * kF, n0 = blockIdx.x * kF, e = blockIdx.z;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile_expert[tile] != e) continue;  // the same for the whole block
    for (int r0 = tile * tile_m; r0 < (tile + 1) * tile_m; r0 += kFK) {
      for (int c = tid; c < kF * kFK; c += kFThreads) {
        const int rr = c / kF, x = c % kF;
        const size_t row = size_t(r0 + rr);
        as[rr][x] = k0 + x < K ? lhs[row * K + k0 + x] : 0.f;
        bs[rr][x] = n0 + x < N ? g[row * N + n0 + x] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float part = 0.f;
#pragma unroll
          for (int q = 0; q < kFK; ++q)
            part = fmaf(as[q][ty + 16 * i], bs[q][tx + 16 * j], part);
          acc[i][j] += part;
        }
      __syncthreads();
    }
  }
  float* o = out + size_t(e) * K * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty + 16 * i;
    if (k >= K) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) o[size_t(k) * N + n] = acc[i][j];
    }
  }
}

template <int MODE>
int launch_bf16(const void* lhs, const void* rhs, const int* te, void* out,
                int M, int R, int N, int E, int tile_m, int n_tiles,
                cudaStream_t stream) {
  auto kernel = gmm_bf16_kernel<MODE>;
  const size_t smem =
      kRingBytes + (MODE == kModeW ? size_t(n_tiles) * sizeof(int) : 0);
  if (smem > size_t(kMaxSmem)) return -1;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // MODE W: rows of the output are K = R, one z per expert
  const dim3 grid((N + BN - 1) / BN,
                  MODE == kModeW ? (R + BM - 1) / BM : M / BM,
                  MODE == kModeW ? E : 1);
  if (grid.y > 65535 || grid.z > 65535) return -1;
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), te,
      static_cast<bf16*>(out), M, R, N, E, tile_m, n_tiles);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int M, int R, int N, int E, int tile_m) {
  return M >= tile_m && tile_m >= BM && tile_m % BM == 0 && M % tile_m == 0 &&
         R >= 8 && R % 8 == 0 && N >= 8 && N % 8 == 0 && E >= 1;
}

}  // namespace

// out [M, N] = per row tile lhs [M, R] @ rhs[e] ([E, R, N]; with trans,
// rhs [E, N, R] read as its transpose). dtype: 0 = float32, 1 = bfloat16
// (lhs, rhs, out). tile_expert int32 [M / tile_m]. Returns 0, a cudaError_t
// code when the launch was refused, or -1 for a shape or dtype the kernel
// does not take (tile_m a multiple of 128 dividing M; R and N multiples of
// 8). Launches on `stream`, never synchronises, allocates nothing.
extern "C" int paddle_gmm(const void* lhs, const void* rhs,
                          const void* tile_expert, void* out, int M, int R,
                          int N, int E, int tile_m, int trans, int dtype,
                          void* stream) {
  if (!shape_ok(M, R, N, E, tile_m)) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* te = static_cast<const int*>(tile_expert);
  if (dtype == 1)
    return trans ? launch_bf16<kModeT>(lhs, rhs, te, out, M, R, N, E, tile_m,
                                       0, st)
                 : launch_bf16<kModeN>(lhs, rhs, te, out, M, R, N, E, tile_m,
                                       0, st);
  if (dtype == 0) {
    const dim3 grid((N + kF - 1) / kF, M / kF);
    if (grid.y > 65535) return -1;
    const auto* l = static_cast<const float*>(lhs);
    const auto* r = static_cast<const float*>(rhs);
    auto* o = static_cast<float*>(out);
    if (trans)
      gmm_f32_kernel<true><<<grid, kFThreads, 0, st>>>(l, r, te, o, M, R, N, E,
                                                       tile_m);
    else
      gmm_f32_kernel<false><<<grid, kFThreads, 0, st>>>(l, r, te, o, M, R, N,
                                                        E, tile_m);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}

// out [E, K, N] = per expert e, the sum over its row tiles (ascending) of
// lhs[tile]^T @ g[tile]; lhs [M, K], g [M, N]; zeros for an expert with no
// tile. dtype, return codes and shape rules as paddle_gmm (K in R's place).
extern "C" int paddle_tgmm(const void* lhs, const void* g,
                           const void* tile_expert, void* out, int M, int K,
                           int N, int E, int tile_m, int dtype,
                           void* stream) {
  if (!shape_ok(M, K, N, E, tile_m)) return -1;
  const int n_tiles = M / tile_m;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* te = static_cast<const int*>(tile_expert);
  if (dtype == 1)
    return launch_bf16<kModeW>(lhs, g, te, out, M, K, N, E, tile_m, n_tiles,
                               st);
  if (dtype == 0) {
    const dim3 grid((N + kF - 1) / kF, (K + kF - 1) / kF, E);
    if (grid.y > 65535 || grid.z > 65535) return -1;
    tgmm_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(lhs), static_cast<const float*>(g), te,
        static_cast<float*>(out), K, N, tile_m, n_tiles);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
