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
// bf16 math). tgmm writes the same 346 MB, and its ~91 GFLOP (padding rows
// included) take ~0.09 ms of the tensor cores' peak: it needs both.
//
// gmm design (bf16). Tensor cores through mma.sync m16n8k16 (f32
// accumulate), 128 x 128 output tiles, 8 warps of 64 x 32, 32 reduction
// values a stage, a 3-stage ring filled by 16-byte cp.async (zero-fill at
// ragged edges). Fragments come from shared memory through ldmatrix; the
// .trans form reads the [K, N] weight (reduction axis along its rows), the
// plain form lhs and the [N, K] weight of dlhs. Rows are padded by 16
// bytes, an odd number of 16-byte units, so the 8 row reads of an ldmatrix
// fall in distinct banks. One block per (128-row tile, 128-column tile);
// its expert is tile_expert[row tile]. A tile_expert entry outside [0, E)
// makes the block write NaN (never an out-of-bounds read).
//
// tgmm design (bf16): the shared wgmma + TMA mainloop (gemm_sm90.cuh).
//   * Work items are (expert, 128-row tile of K, BN-column tile of N) of
//     the [E, K, N] output, BN = 256 (64 or 128 for narrow N), expert-major:
//     the SMs working at one time share one expert's lhs and g rows
//     (~1.7 MB at uniform routing) in L2, so HBM reads them about once.
//     Persistent blocks, one an SM, walk the list; the next item's loads
//     run under the current item's epilogue and TMA store.
//   * The reduction runs over rows, so A (lhs^T) and B (g) are both
//     MN-major: each stage is 64 rows of lhs (128 columns of K) and of g
//     (BN columns), loaded by TMA at row `tile * tile_m + 64 s`.
//   * An item walks its expert's row tiles in ascending tile index. The
//     block lists every expert's tiles once at its start, from
//     tile_expert on the device (counts, their prefix sum, then a warp
//     places each tile at its rank with __match_any_sync): no host sync.
//   * An expert with no tile gets zeros, stored by the same kernel. Entries
//     of tile_expert outside [0, E) belong to no expert.
//   * No atomics: each output element is summed by one thread, over its
//     expert's tiles in ascending order, 16 rows a wgmma. The result is
//     the same bits from run to run and for any interleaving of the tiles
//     that keeps each expert's own tiles in order. The TPU kernel
//     accumulated into its output window on the premise of a sorted
//     tile_expert and a sequential grid, and zeroed absent experts after
//     the call.
// f32 (checks and CPU-sized tests; the model runs bf16 on the card) runs a
// plain FMA kernel of 64 x 64 tiles: each thread 4 x 4 outputs, each 16
// reduction values summed, then added to the running total in order.
//
// Known gaps: gmm is still mma.sync and cp.async; padding rows are
// multiplied like the others (the kernels' interface carries no group
// sizes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

constexpr int kModeN = 0;  // gmm, rhs [E, K, N]
constexpr int kModeT = 1;  // gmm, rhs [E, N, K] read transposed (dlhs)

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int WN = 4;                 // warps along the columns (2 x 4 warps)
constexpr int MT = 4, NT = 4;         // a warp's 16-row and 8-column mma tiles
constexpr int LDK = BK + 8;           // a row of BK reduction values, padded
constexpr int LDW = BN + 8;           // a reduction row of 128 columns
constexpr int kTileElems = BM * LDK;  // >= BK * LDW: either layout fits
static_assert(BM == BN && BM * LDK >= BK * LDW, "tile layout");
constexpr size_t kStageBytes = size_t(2) * kTileElems * 2;  // A and B, bf16
constexpr size_t kRingBytes = STAGES * kStageBytes;         // 61,440

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
//   A:            [BM][LDK], an output row's BK reduction values;
//   B, mode N:    [BK][LDW], a reduction row of 128 output columns;
//   B, mode T:    [BN][LDK], an output column's BK reduction values.
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

// lhs [M][R] (R = reduction), w the expert's weight ([R][N], or [N][R] in
// mode T), out [M][N]; grid (N tiles, M / BM).
template <int MODE>
__global__ void __launch_bounds__(THREADS)
    gmm_bf16_kernel(const bf16* __restrict__ lhs, const bf16* __restrict__ rhs,
                    const int* __restrict__ tile_expert,
                    bf16* __restrict__ out, int M, int R, int N, int E,
                    int tile_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;

  int e = tile_expert[m0 / tile_m];
  const bool bad = e < 0 || e >= E;
  if (bad) e = 0;
  const bf16* w = rhs + size_t(e) * R * N;
  const int steps = (R + BK - 1) / BK;

  auto load_stage = [&](int s, int st) {
    bf16* as = reinterpret_cast<bf16*>(smem + st * kStageBytes);
    bf16* bs = as + kTileElems;
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
  // c2, c3 at row g + 8 (M % 128 == 0: every row is in)
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
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(m) * N + n) =
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
                int M, int R, int N, int E, int tile_m, cudaStream_t stream) {
  auto kernel = gmm_bf16_kernel<MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRingBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + BN - 1) / BN, M / BM);
  if (grid.y > 65535) return -1;
  kernel<<<grid, THREADS, kRingBytes, stream>>>(
      static_cast<const bf16*>(lhs), static_cast<const bf16*>(rhs), te,
      static_cast<bf16*>(out), M, R, N, E, tile_m);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- tgmm: wgmma + TMA --

struct TgmmArgs {
  CUtensorMap lhs;  // [M, K], boxes of 64 rows x 64 columns
  CUtensorMap g;    // [M, N], the same boxes
  CUtensorMap out;  // [E, K, N], boxes of 64 x 64 x 1
  const int* tile_expert;
  int K, N, E, tile_m, n_tiles;
  int kt, nt;       // 128-row tiles of K, BN-column tiles of N
};

// A block's list of every expert's row tiles: order[first[e] ..
// first[e + 1]) holds expert e's tiles in ascending index. Built by the
// whole block (the consumers use first[], the producer both).
__device__ __forceinline__ void list_tiles(const TgmmArgs& a, int* first,
                                           int* fill, int* order) {
  const int tid = threadIdx.x;
  for (int e = tid; e < a.E; e += blockDim.x) fill[e] = 0;
  __syncthreads();
  for (int i = tid; i < a.n_tiles; i += blockDim.x) {
    const int e = a.tile_expert[i];
    if (e >= 0 && e < a.E) atomicAdd(fill + e, 1);
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int e = 0; e < a.E; ++e) {
      first[e] = s;
      s += fill[e];
      fill[e] = 0;
    }
    first[a.E] = s;
  }
  __syncthreads();
  if (tid < 32) {  // one warp, 32 tiles at a time, in ascending index
    for (int base = 0; base < a.n_tiles; base += 32) {
      const int i = base + tid;
      int e = i < a.n_tiles ? a.tile_expert[i] : -1;
      const bool ok = e >= 0 && e < a.E;
      if (!ok) e = -1;
      const unsigned peers = __match_any_sync(0xffffffffu, e);
      const int rank = __popc(peers & ((1u << tid) - 1u));
      if (ok) order[first[e] + fill[e] + rank] = i;
      __syncwarp();
      if (ok && rank == 0) fill[e] += __popc(peers);
      __syncwarp();
    }
  }
  __syncthreads();
}

template <int BN>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    tgmm_wgmma_kernel(const __grid_constant__ TgmmArgs a) {
  using G = gemm90::Geo<BN>;
  using hopper::kPanelBytes;
  extern __shared__ unsigned char smem_raw[];
  const gemm90::Ring<BN> ring(smem_raw);
  int* first = reinterpret_cast<int*>(ring.extra());  // [E + 1]
  int* fill = first + a.E + 1;                         // [E]
  int* order = fill + a.E;                             // [n_tiles]
  if (threadIdx.x == 0) ring.init();
  list_tiles(a, first, fill, order);

  const int per_e = a.kt * a.nt;
  const int items = a.E * per_e;
  const int spt = a.tile_m / gemm90::BK;  // stages a row tile

  if (threadIdx.x >= gemm90::kConsumers) {
    hopper::regs_dec<gemm90::kProducerRegs>();
    if (threadIdx.x == gemm90::kConsumers) {
      hopper::prefetch_map(&a.lhs);
      hopper::prefetch_map(&a.g);
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int e = item / per_e, rem = item % per_e;
        const int k0 = rem / a.nt * gemm90::BM, n0 = rem % a.nt * BN;
        // panels inside K and N (a panel wholly outside is not loaded: it
        // feeds only outputs that are never stored)
        const int pa = min(2, (a.K - k0 + 63) / 64);
        const int pb = min(G::kPanelsB, (a.N - n0 + 63) / 64);
        const int steps = (first[e + 1] - first[e]) * spt;
        for (int s = 0; s < steps; ++s) {
          const int row =
              order[first[e] + s / spt] * a.tile_m + (s % spt) * 64;
          const int st = ring.acquire(it++, (pa + pb) * kPanelBytes);
          for (int w = 0; w < pa; ++w)
            hopper::tma_load_2d(ring.a(st) + w * kPanelBytes, &a.lhs,
                                ring.full(st), k0 + 64 * w, row);
          for (int p = 0; p < pb; ++p)
            hopper::tma_load_2d(ring.b(st) + p * kPanelBytes, &a.g,
                                ring.full(st), n0 + 64 * p, row);
        }
      }
    }
    return;
  }

  hopper::regs_inc<gemm90::kConsumerRegs>();
  const gemm90::Lane ln;
  if (gemm90::store_thread()) hopper::prefetch_map(&a.out);
  float acc[G::kAcc];
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int e = item / per_e, rem = item % per_e;
    const int k0 = rem / a.nt * gemm90::BM, n0 = rem % a.nt * BN;
    const int steps = (first[e + 1] - first[e]) * spt;
    if (steps > 0) gemm90::consume<BN, true>(acc, ring, it, steps, ln.wg);
    // an expert with no tile: zeros (acc is left to the wgmmas alone)
    gemm90::stage_out<BN>(ring, acc, ln, [steps](int, float v0, float v1) {
      return steps > 0 ? hopper::pack_bf16(v0, v1) : 0u;
    });
    if (gemm90::store_thread()) {
      const int k = k0 + 64 * ln.wg;
      if (k < a.K)
        for (int p = 0; p < G::kPanelsB && n0 + 64 * p < a.N; ++p)
          hopper::tma_store_3d(&a.out, ring.out(ln.wg) + p * kPanelBytes,
                               n0 + 64 * p, k, e);
      hopper::tma_store_commit();
    }
  }
  if (gemm90::store_thread()) hopper::tma_store_wait_read<0>();
}

template <int BN>
int launch_tgmm(TgmmArgs& a, cudaStream_t stream) {
  using G = gemm90::Geo<BN>;
  a.kt = (a.K + gemm90::BM - 1) / gemm90::BM;
  a.nt = (a.N + BN - 1) / BN;
  const size_t smem = G::kBytes + sizeof(int) * (2 * size_t(a.E) + 1 +
                                                 size_t(a.n_tiles));
  if (smem > size_t(gemm90::kSmemMax)) return -1;
  const int err = gemm90::allow_smem<tgmm_wgmma_kernel<BN>>();
  if (err != 0) return err;
  const long items = long(a.E) * a.kt * a.nt;
  const int grid = static_cast<int>(std::min<long>(items, gemm90::sm_count()));
  tgmm_wgmma_kernel<BN><<<grid, gemm90::kThreads, smem, stream>>>(a);
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
                                       st)
                 : launch_bf16<kModeN>(lhs, rhs, te, out, M, R, N, E, tile_m,
                                       st);
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
// tile. dtype, return codes and shape rules as paddle_gmm (K in R's place);
// bf16 also returns -1 when the block's tile lists (2 E + 1 + M / tile_m
// ints) do not fit in shared memory beside the ring.
extern "C" int paddle_tgmm(const void* lhs, const void* g,
                           const void* tile_expert, void* out, int M, int K,
                           int N, int E, int tile_m, int dtype,
                           void* stream) {
  if (!shape_ok(M, K, N, E, tile_m)) return -1;
  const int n_tiles = M / tile_m;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* te = static_cast<const int*>(tile_expert);
  if (dtype == 1) {
    TgmmArgs a;
    const uint64_t lhs_dims[2] = {uint64_t(K), uint64_t(M)};
    const uint64_t g_dims[2] = {uint64_t(N), uint64_t(M)};
    const uint64_t out_dims[3] = {uint64_t(N), uint64_t(K), uint64_t(E)};
    if (!hopper::encode_map(&a.lhs, lhs, 2, lhs_dims, 64, 64) ||
        !hopper::encode_map(&a.g, g, 2, g_dims, 64, 64) ||
        !hopper::encode_map(&a.out, out, 3, out_dims, 64, 64))
      return -1;
    a.tile_expert = te;
    a.K = K;
    a.N = N;
    a.E = E;
    a.tile_m = tile_m;
    a.n_tiles = n_tiles;
    // tile width from N alone: 256, or 64 / 128 for narrow N
    if (N <= 64) return launch_tgmm<64>(a, st);
    if (N <= 128) return launch_tgmm<128>(a, st);
    return launch_tgmm<256>(a, st);
  }
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
