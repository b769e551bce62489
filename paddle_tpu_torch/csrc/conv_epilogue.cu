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
// Design (bf16): the shared wgmma + TMA mainloop (gemm_sm90.cuh). A = x
// (K-major), B = w [K, N] (MN-major), 128-row output tiles of BN columns:
// BN = 64 for N <= 64 and where K >= 4 N, else 128 (`tile_n`: from N and
// K, never M). A narrow output with a long reduction has few column tiles,
// each streaming all of K; halving the width doubles the blocks at the
// cost of reading x's rows twice as often. 256-wide tiles lost at B 8
// (fewer blocks on few-row shapes) and gained nothing at B 128.
//   * The arithmetic is fixed by K alone. K is cut into chunks of 512
//     (kChunk); each chunk's sum over its K is an f32 partial computed from
//     zero in the wgmma accumulator (one wgmma m64nBNk16 per 16 values, in
//     order), copied (the first) or added (the rest) to a separate running
//     total: ((p0 + p1) + p2) + ... + bias in f32, relu, one rounding to
//     bf16. A row's output depends on that row's inputs only: the same
//     bits at any M and wherever the row sits.
//   * Persistent blocks, one an SM, walk the tiles (columns fastest, so the
//     blocks that share x's rows run together); one tile's TMA store
//     drains while the next one's loads and products run.
//   * Epilogue in registers: f32 sum + f32 bias, relu, one rounding, then
//     a TMA store of whole lines that clips rows past M and columns past
//     N. Reduction values past K arrive as zeros from the TMA load.
//   * The three tensor maps (x, w, out) are encoded on the host each call.
// f32 (checks and CPU-sized tests; the model runs bf16 on the card) runs a
// plain FMA kernel of 64 x 64 tiles: each thread 4 x 4 outputs, 16
// reduction values summed at a time, then added to the running total.
//
// Known gaps: no residual in the epilogue (the JAX kernel has none); on
// few tiles (M <= 1568 with K >= 1024) a block streams all of its K, and
// most SMs idle. A split of the chunks across blocks with an ordered
// combine through L2 was tried and cost what it saved (PERF.md §6).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::kPanelBytes;

constexpr int kChunk = 512;  // K values a chunk
constexpr int kMaxGridY = 65535;

struct ConvArgs {
  CUtensorMap x;    // [M, K], boxes of 128 rows x 64 columns
  CUtensorMap w;    // [K, N], boxes of 64 x 64
  CUtensorMap out;  // [M, N], boxes of 64 x 64
  const float* bias;
  int M, K, N, relu;
  int mt, nt, chunks;
};

__device__ __forceinline__ int chunk_steps(int K, int c) {
  return (min(K - c * kChunk, kChunk) + gemm90::BK - 1) / gemm90::BK;
}

template <int BN>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    mba_wgmma_kernel(const __grid_constant__ ConvArgs a) {
  using G = gemm90::Geo<BN>;
  extern __shared__ unsigned char smem_raw[];
  const gemm90::Ring<BN> ring(smem_raw);
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int tiles = a.mt * a.nt;

  if (threadIdx.x >= gemm90::kConsumers) {
    hopper::regs_dec<gemm90::kProducerRegs>();
    if (threadIdx.x == gemm90::kConsumers) {
      hopper::prefetch_map(&a.x);
      hopper::prefetch_map(&a.w);
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / a.nt * gemm90::BM, n0 = tile % a.nt * BN;
        // B panels inside N (one wholly outside feeds only columns that are
        // never stored, and is not loaded)
        const int pb = min(G::kPanelsB, (a.N - n0 + 63) / 64);
        for (int c = 0; c < a.chunks; ++c)
          for (int s = 0; s < chunk_steps(a.K, c); ++s) {
            const int k0 = c * kChunk + s * gemm90::BK;
            const int st = ring.acquire(it++, G::kABytes + pb * kPanelBytes);
            hopper::tma_load_2d(ring.a(st), &a.x, ring.full(st), k0, m0);
            for (int p = 0; p < pb; ++p)
              hopper::tma_load_2d(ring.b(st) + p * kPanelBytes, &a.w,
                                  ring.full(st), n0 + 64 * p, k0);
          }
      }
    }
    return;
  }

  hopper::regs_inc<gemm90::kConsumerRegs>();
  const gemm90::Lane ln;
  if (gemm90::store_thread()) hopper::prefetch_map(&a.out);
  // acc is written by wgmmas only (anything else writing it between two
  // of them makes ptxas serialize them); the running total is `tot`
  float acc[G::kAcc];
  float tot[G::kAcc];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / a.nt * gemm90::BM, n0 = tile % a.nt * BN;
    gemm90::consume<BN, false>(acc, ring, it, chunk_steps(a.K, 0), ln.wg);
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) tot[i] = acc[i];
    for (int c = 1; c < a.chunks; ++c) {
      gemm90::consume<BN, false>(acc, ring, it, chunk_steps(a.K, c), ln.wg);
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) tot[i] += acc[i];
    }
    const float* bias = a.bias;
    const int N = a.N, relu = a.relu;
    gemm90::stage_out<BN>(ring, tot, ln, [&](int col, float v0, float v1) {
      const int n = n0 + col;  // N % 8 == 0: n, n + 1 in or out together
      if (n < N) {
        v0 += bias[n];
        v1 += bias[n + 1];
      }
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      return hopper::pack_bf16(v0, v1);
    });
    if (gemm90::store_thread()) {
      const int m = m0 + 64 * ln.wg;
      if (m < a.M)
        for (int p = 0; p < G::kPanelsB && n0 + 64 * p < N; ++p)
          hopper::tma_store_2d(&a.out, ring.out(ln.wg) + p * kPanelBytes,
                               n0 + 64 * p, m);
      hopper::tma_store_commit();
    }
  }
  if (gemm90::store_thread()) hopper::tma_store_wait_read<0>();
}

// The bf16 tile width from N and K, never M (the header's Design).
int tile_n(int N, int K) { return N <= 64 || K >= 4 * N ? 64 : 128; }

template <int BN>
int launch_wgmma(ConvArgs& a, cudaStream_t stream) {
  a.mt = (a.M + gemm90::BM - 1) / gemm90::BM;
  a.nt = (a.N + BN - 1) / BN;
  const int err = gemm90::allow_smem<mba_wgmma_kernel<BN>>();
  if (err != 0) return err;
  const long tiles = long(a.mt) * a.nt;
  const int grid = static_cast<int>(std::min<long>(tiles, gemm90::sm_count()));
  mba_wgmma_kernel<BN><<<grid, gemm90::kThreads, gemm90::Geo<BN>::kBytes,
                         stream>>>(a);
  return static_cast<int>(cudaGetLastError());
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
// dtype: 0 = float32, 1 = bfloat16 (x, w, out); bias is float32. Returns
// 0, a cudaError_t code when the launch was refused, or -1 for a shape or
// dtype the kernel does not take (M >= 1; K and N positive multiples of
// 8). Launches on `stream`, never synchronises, allocates nothing.
extern "C" int paddle_matmul_bias_act(const void* x, const void* w,
                                      const void* bias, void* out, int M,
                                      int K, int N, int relu, int dtype,
                                      void* stream) {
  if (M < 1 || K < 8 || K % 8 || N < 8 || N % 8) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* b = static_cast<const float*>(bias);
  if (dtype == 1) {
    ConvArgs a;
    const uint64_t x_dims[2] = {uint64_t(K), uint64_t(M)};
    const uint64_t w_dims[2] = {uint64_t(N), uint64_t(K)};
    const uint64_t out_dims[2] = {uint64_t(N), uint64_t(M)};
    if (!hopper::encode_map(&a.x, x, 2, x_dims, 64, 128) ||
        !hopper::encode_map(&a.w, w, 2, w_dims, 64, 64) ||
        !hopper::encode_map(&a.out, out, 2, out_dims, 64, 64))
      return -1;
    a.bias = b;
    a.M = M;
    a.K = K;
    a.N = N;
    a.relu = relu;
    a.chunks = (K + kChunk - 1) / kChunk;
    return tile_n(N, K) == 64 ? launch_wgmma<64>(a, st)
                              : launch_wgmma<128>(a, st);
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
