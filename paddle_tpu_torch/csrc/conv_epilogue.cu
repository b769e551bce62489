// Matmul + bias (+ relu) epilogue: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/conv_epilogue.py (`matmul_bias_act`), the
// 1x1 / stride-1 convolution after the conv-bn fold.
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/conv_epilogue.py:
// `_kernel` :46 / `_call` :66 (entry `matmul_bias_act` :95).
//
// What it computes. x [M, K] row-major (an NHWC activation seen as rows of
// pixels), w [K, N] row-major (the folded 1x1 weight, stored once at fold
// time), bias f32 [N]:
//   out[m, n] = cast( act( sum_k x[m, k] * w[k, n]  +  bias[n] ) )
// with the sum in f32, the bias added to that f32 sum, act = relu or the
// identity, and one rounding to x's dtype. The conv output crosses device
// memory once, already biased and activated: that was the TPU kernel's
// point, and it is this one's.
//
// What bounds it. At ResNet-50's 1x1 shapes (K, N in 64 .. 2048, M = B x
// H x W) every call moves more bytes than the tensor cores need time for:
// e.g. (M, K, N) = (25088, 64, 256) at B 8 moves 16.1 MB (4.8 us at
// 3.35 TB/s) for 0.8 GFLOP (0.8 us at 989 TFLOP/s). Reading x once and
// writing the output once is the least it can do.
//
// Design. The grouped-matmul kernel (grouped_matmul.cu) with one group and
// the epilogue in registers: bf16 on tensor cores (mma.sync m16n8k16, f32
// accumulate), 128 x 128 output tiles, 8 warps of 64 x 32, 32 reduction
// values a stage in a 3-stage ring of 16-byte cp.async copies; fragments
// through ldmatrix (the [K, N] weight through its .trans form). Rows padded
// by 16 bytes so an ldmatrix's 8 row reads fall in distinct banks. Grid
// (column tiles, row tiles), columns fastest, so the blocks that share a
// row tile of x run together and read it from L2 after the first.
//   * One block per output tile walks all of K in ascending order: no split
//     of K, no atomics. A row's output depends on that row's inputs only,
//     so it is the same bits at any M and wherever the row sits.
//   * Ragged edges: rows past M, columns past N and reduction values past K
//     are zero-filled by cp.async (a K of 64 is two stages, fewer than the
//     ring holds; the ring's empty commit groups keep the waits uniform),
//     and stores are masked to m < M, n < N. N = 64 runs a half-empty
//     128-wide tile.
//   * Epilogue: f32 sum + f32 bias, relu, one rounding, a bf16x2 store.
// f32 (checks and CPU-sized tests; the model runs bf16 on the card) runs a
// plain FMA kernel of 64 x 64 tiles: each thread 4 x 4 outputs, 16
// reduction values summed at a time, then added to the running total.
//
// Known gaps: mma.sync, not wgmma; cp.async, not TMA; N = 64 wastes half a
// tile; no persistent blocks, so one tile's epilogue does not overlap the
// next one's loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 32, STAGES = 3, THREADS = 256;
constexpr int WN = 4;                 // warps along the columns (2 x 4 warps)
constexpr int MT = 4, NT = 4;         // a warp's 16-row and 8-column mma tiles
constexpr int LDK = BK + 8;           // a row of BK reduction values, padded
constexpr int LDW = BN + 8;           // a reduction row of 128 columns, padded
constexpr int kATile = BM * LDK;      // x: [BM][LDK]
constexpr int kBTile = BK * LDW;      // w: [BK][LDW]
constexpr size_t kStageBytes = size_t(kATile + kBTile) * 2;  // bf16
constexpr size_t kRingBytes = STAGES * kStageBytes;         // 56,832
constexpr int kMaxGridY = 65535;

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

// grid (N tiles, M tiles); x [M][K], w [K][N], bias [N], out [M][N]
__global__ void __launch_bounds__(THREADS)
    mba_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    const float* __restrict__ bias, bf16* __restrict__ out,
                    int M, int K, int N, int relu) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int steps = (K + BK - 1) / BK;

  auto load_stage = [&](int s, int st) {
    bf16* as = reinterpret_cast<bf16*>(smem + st * kStageBytes);
    bf16* bs = as + kATile;
    const int k0 = s * BK;
    for (int c = tid; c < BM * (BK / 8); c += THREADS) {
      const int row = c / (BK / 8), u = (c % (BK / 8)) * 8;
      const int m = m0 + row, k = k0 + u;
      const bool ok = m < M && k < K;
      cp_async16(as + row * LDK + u, ok ? x + size_t(m) * K + k : x,
                 ok ? 16 : 0);
    }
    for (int c = tid; c < BK * (BN / 8); c += THREADS) {
      const int rr = c / (BN / 8), u = (c % (BN / 8)) * 8;
      const int k = k0 + rr, n = n0 + u;
      const bool ok = k < K && n < N;
      cp_async16(bs + rr * LDW + u, ok ? w + size_t(k) * N + n : w,
                 ok ? 16 : 0);
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
  const int r = lane & 7, j = lane >> 3;
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed; stage s - 1's readers are done
    {
      const int ns = s + STAGES - 1;
      if (ns < steps) load_stage(ns, ns % STAGES);
      cp_async_commit();
    }
    const bf16* a =
        reinterpret_cast<const bf16*>(smem + (s % STAGES) * kStageBytes);
    const bf16* b = a + kATile;
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
        uint32_t q[4];
        // b0, b1 of column tile jj, then of jj + 1
        ldsm_x4_t(q, b + (kk + r + 8 * (j & 1)) * LDW + n + 8 * (j >> 1));
        bfr[jj][0] = q[0];
        bfr[jj][1] = q[1];
        bfr[jj + 1][0] = q[2];
        bfr[jj + 1][1] = q[3];
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[i][jn], af[i], bfr[jn]);
    }
  }
  cp_async_wait<0>();

  // epilogue: f32 sum + f32 bias, relu, one rounding; c0, c1 at (row g,
  // columns 2t, 2t + 1), c2, c3 at row g + 8
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    const int n = n0 + wn * NT * 8 + jn * 8 + 2 * t;
    if (n >= N) continue;  // N % 8 == 0: n and n + 1 are in or out together
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
        if (m >= M) continue;
        float v0 = acc[i][jn][2 * h] + b0, v1 = acc[i][jn][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + size_t(m) * N + n) =
            __floats2bfloat162_rn(v0, v1);
      }
  }
}

// f32: 64 x 64 output tiles, 256 threads of 4 x 4 outputs, 16 reduction
// values a step (summed, then added to the running total).
constexpr int kF = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    mba_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out,
                   int M, int K, int N, int relu) {
  __shared__ float as[kFK][kF + 1];  // [reduction][row]
  __shared__ float bs[kFK][kF];      // [reduction][column]
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kF, n0 = blockIdx.x * kF;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int c = tid; c < kF * kFK; c += kFThreads) {
      {
        const int row = c / kFK, kk = c % kFK, m = m0 + row, k = k0 + kk;
        as[kk][row] = (m < M && k < K) ? x[size_t(m) * K + k] : 0.f;
      }
      {
        const int kk = c / kF, col = c % kF, k = k0 + kk, n = n0 + col;
        bs[kk][col] = (k < K && n < N) ? w[size_t(k) * N + n] : 0.f;
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
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j] + bias[n];
      if (relu) v = fmaxf(v, 0.f);
      out[size_t(m) * N + n] = v;
    }
  }
}

}  // namespace

// out [M, N] = act(x [M, K] @ w [K, N] + bias [N]), the sum and the bias in
// f32, one rounding to x's dtype; act = relu when `relu` is non-zero.
// dtype: 0 = float32, 1 = bfloat16 (x, w, out); bias is float32. Returns 0,
// a cudaError_t code when the launch was refused, or -1 for a shape or
// dtype the kernel does not take (M >= 1; K and N positive multiples of 8;
// at most 65535 row tiles). Launches on `stream`, never synchronises,
// allocates nothing.
extern "C" int paddle_matmul_bias_act(const void* x, const void* w,
                                      const void* bias, void* out, int M,
                                      int K, int N, int relu, int dtype,
                                      void* stream) {
  if (M < 1 || K < 8 || K % 8 || N < 8 || N % 8) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    if (grid.y > kMaxGridY) return -1;
    cudaError_t err = cudaFuncSetAttribute(
        mba_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kRingBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    mba_bf16_kernel<<<grid, THREADS, kRingBytes, st>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), b,
        static_cast<bf16*>(out), M, K, N, relu);
    return static_cast<int>(cudaGetLastError());
  }
  if (dtype == 0) {
    const dim3 grid((N + kF - 1) / kF, (M + kF - 1) / kF);
    if (grid.y > kMaxGridY) return -1;
    mba_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), b,
        static_cast<float*>(out), M, K, N, relu);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
