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
// gmm design (bf16): the shared wgmma + TMA mainloop (gemm_sm90.cuh).
//   * A is lhs [M, K], K-major, loaded by TMA as 128-row x 64-column
//     boxes. B is the expert's weight: rhs[e] [K, N], MN-major (the conv
//     epilogue's w layout), or with `trans` rhs[e] [N, K] read as its
//     transpose, which is K-major B (BN rows of 64 reduction values a
//     stage): dlhs needs no copy of the weight. Both come through one 3-D
//     map over rhs, 64 x 64 boxes.
//   * Work items are (128-row block, BN-column tile) pairs, BN = 128 (64
//     for N <= 64: `launch_gmm_n`); block b's expert is
//     tile_expert[b * 128 / tile_m], so tile_m may be any multiple of
//     128. The bound is the weight stream (every expert's [K, N] once):
//     the items are ordered expert by expert, then column tile, then the
//     expert's row blocks, so the ~2 row blocks that read one weight
//     panel run side by side and the second read comes from L2. The
//     order is built by each block from tile_expert on the device (as
//     tgmm's lists), with no host sync; blocks whose tile_expert entry is
//     outside [0, E) form a last group, load nothing and store NaN.
//   * Persistent blocks, one an SM; one item's TMA store drains while
//     the next item's loads and products run. The K-chain of each output
//     is one f32 wgmma chain, rounded once to bf16 in the epilogue; a
//     row's bits depend on its row block alone, not on where the block
//     sits or what else is in the call.
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
// Known gaps: padding rows are multiplied like the others (the kernels'
// interface carries no group sizes); at N = 1408 gmm's 11 column tiles
// make 10.25 items a block, so its last round runs a quarter full.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::kPanelBytes;

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

// ------------------------------------------------- tgmm: wgmma + TMA --

struct TgmmArgs {
  CUtensorMap lhs;  // [M, K], boxes of 64 rows x 64 columns
  CUtensorMap g;    // [M, N], the same boxes
  CUtensorMap out;  // [E, K, N], boxes of 64 x 64 x 1
  const int* tile_expert;
  int K, N, E, tile_m, n_tiles;
  int kt, nt;       // 128-row tiles of K, BN-column tiles of N
};

// A block's list of the row tiles by expert: order[first[e] ..
// first[e + 1]) holds the tiles of expert e in ascending index. Tile i's
// expert is tile_expert[i / per]; an entry outside [0, E) belongs to no
// expert, or, with `spill`, to a last group e = E (first[] then has E + 2
// entries, fill[] E + 1). Built by the whole block (the consumers use it,
// the producer too).
__device__ __forceinline__ void list_tiles(const int* tile_expert, int n,
                                           int per, int E, bool spill,
                                           int* first, int* fill,
                                           int* order) {
  const int tid = threadIdx.x;
  const int groups = spill ? E + 1 : E;
  auto group = [&](int i) {
    const int e = tile_expert[i / per];
    return e >= 0 && e < E ? e : (spill ? E : -1);
  };
  for (int e = tid; e < groups; e += blockDim.x) fill[e] = 0;
  __syncthreads();
  for (int i = tid; i < n; i += blockDim.x) {
    const int e = group(i);
    if (e >= 0) atomicAdd(fill + e, 1);
  }
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int e = 0; e < groups; ++e) {
      first[e] = s;
      s += fill[e];
      fill[e] = 0;
    }
    first[groups] = s;
  }
  __syncthreads();
  if (tid < 32) {  // one warp, 32 tiles at a time, in ascending index
    for (int base = 0; base < n; base += 32) {
      const int i = base + tid;
      const int e = i < n ? group(i) : -1;
      const bool ok = e >= 0;
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
  list_tiles(a.tile_expert, a.n_tiles, 1, a.E, false, first, fill,
             order);

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

// -------------------------------------------------- gmm: wgmma + TMA --

struct GmmArgs {
  CUtensorMap lhs;  // [M, K], boxes of 64 columns x 128 rows
  CUtensorMap rhs;  // [E, K, N] (with trans [E, N, K]), boxes of 64 x 64 x 1
  CUtensorMap out;  // [M, N], boxes of 64 x 64
  const int* tile_expert;
  int K, N, E;
  int per;     // 128-row blocks a row tile (tile_m / 128)
  int blocks;  // 128-row blocks of M
  int nt;      // BN-column tiles of N
};

// Item `item` of the order (header): group e (an expert, or E for the
// blocks of no expert), 128-row block b and first column n0. `e` is the
// caller's cursor: a block's items ascend, so it only moves forward.
struct GmmItem {
  int e, b, n0;
};
template <int BN>
__device__ __forceinline__ GmmItem gmm_item(const GmmArgs& a,
                                            const int* first,
                                            const int* order, int item,
                                            int& e) {
  while (first[e + 1] * a.nt <= item) ++e;
  const int cnt = first[e + 1] - first[e];
  const int local = item - first[e] * a.nt;
  return {e, order[first[e] + local % cnt], local / cnt * BN};
}

template <int BN, bool TRANS>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    gmm_wgmma_kernel(const __grid_constant__ GmmArgs a) {
  using G = gemm90::Geo<BN>;
  extern __shared__ unsigned char smem_raw[];
  const gemm90::Ring<BN> ring(smem_raw);
  int* first = reinterpret_cast<int*>(ring.extra());  // [E + 2]
  int* fill = first + a.E + 2;                         // [E + 1]
  int* order = fill + a.E + 1;                         // [blocks]
  if (threadIdx.x == 0) ring.init();
  list_tiles(a.tile_expert, a.blocks, a.per, a.E, true, first, fill, order);

  const int items = a.blocks * a.nt;
  const int steps = (a.K + gemm90::BK - 1) / gemm90::BK;

  if (threadIdx.x >= gemm90::kConsumers) {
    hopper::regs_dec<gemm90::kProducerRegs>();
    if (threadIdx.x == gemm90::kConsumers) {
      hopper::prefetch_map(&a.lhs);
      hopper::prefetch_map(&a.rhs);
      int it = 0, e = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const GmmItem w = gmm_item<BN>(a, first, order, item, e);
        if (w.e == a.E) continue;  // no expert: nothing to load
        // weight panels inside N (one wholly outside feeds only columns
        // that are never stored, and is not loaded)
        const int pb = min(G::kPanelsB, (a.N - w.n0 + 63) / 64);
        for (int s = 0; s < steps; ++s) {
          const int k0 = s * gemm90::BK;
          const int st = ring.acquire(it++, G::kABytes + pb * kPanelBytes);
          hopper::tma_load_2d(ring.a(st), &a.lhs, ring.full(st), k0,
                              w.b * gemm90::BM);
          for (int p = 0; p < pb; ++p) {
            const int n = w.n0 + 64 * p;
            if (TRANS)
              hopper::tma_load_3d(ring.b(st) + p * kPanelBytes, &a.rhs,
                                  ring.full(st), k0, n, w.e);
            else
              hopper::tma_load_3d(ring.b(st) + p * kPanelBytes, &a.rhs,
                                  ring.full(st), n, k0, w.e);
          }
        }
      }
    }
    return;
  }

  hopper::regs_inc<gemm90::kConsumerRegs>();
  const gemm90::Lane ln;
  if (gemm90::store_thread()) hopper::prefetch_map(&a.out);
  float acc[G::kAcc];
  int it = 0, e = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const GmmItem w = gmm_item<BN>(a, first, order, item, e);
    const bool bad = w.e == a.E;
    if (!bad) gemm90::consume<BN, false, !TRANS>(acc, ring, it, steps, ln.wg);
    // a block of no expert: NaN (acc is left to the wgmmas alone)
    gemm90::stage_out<BN>(ring, acc, ln, [bad](int, float v0, float v1) {
      return bad ? 0x7fc07fc0u : hopper::pack_bf16(v0, v1);
    });
    if (gemm90::store_thread()) {
      const int row = w.b * gemm90::BM + 64 * ln.wg;
      for (int p = 0; p < G::kPanelsB && w.n0 + 64 * p < a.N; ++p)
        hopper::tma_store_2d(&a.out, ring.out(ln.wg) + p * kPanelBytes,
                             w.n0 + 64 * p, row);
      hopper::tma_store_commit();
    }
  }
  if (gemm90::store_thread()) hopper::tma_store_wait_read<0>();
}

template <int BN, bool TRANS>
int launch_gmm(GmmArgs& a, cudaStream_t stream) {
  a.nt = (a.N + BN - 1) / BN;
  const size_t smem = gemm90::Geo<BN>::kBytes +
                      sizeof(int) * (2 * size_t(a.E) + 3 + size_t(a.blocks));
  if (smem > size_t(gemm90::kSmemMax)) return -1;
  const int err = gemm90::allow_smem<gmm_wgmma_kernel<BN, TRANS>>();
  if (err != 0) return err;
  const long items = long(a.blocks) * a.nt;
  const int grid = static_cast<int>(std::min<long>(items, gemm90::sm_count()));
  gmm_wgmma_kernel<BN, TRANS><<<grid, gemm90::kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The column tile from N alone, never M: 128, or 64 for N <= 64. (256 at
// N = 2048 read the same bytes in fewer, larger items and lost a few
// percent to the last round of items on an H100: PERF.md §6.)
template <bool TRANS>
int launch_gmm_n(GmmArgs& a, cudaStream_t stream) {
  return a.N <= 64 ? launch_gmm<64, TRANS>(a, stream)
                   : launch_gmm<128, TRANS>(a, stream);
}

bool shape_ok(int M, int R, int N, int E, int tile_m) {
  return M >= tile_m && tile_m >= gemm90::BM && tile_m % gemm90::BM == 0 &&
         M % tile_m == 0 &&
         R >= 8 && R % 8 == 0 && N >= 8 && N % 8 == 0 && E >= 1;
}

}  // namespace

// out [M, N] = per row tile lhs [M, R] @ rhs[e] ([E, R, N]; with trans,
// rhs [E, N, R] read as its transpose). dtype: 0 = float32, 1 = bfloat16
// (lhs, rhs, out). tile_expert int32 [M / tile_m]; an entry outside
// [0, E) makes its rows NaN. Returns 0, a cudaError_t code when
// the launch was refused, or -1 for a shape or dtype the kernel does not
// take (tile_m a multiple of 128 dividing M; R and N multiples of 8; in
// bf16, the block's tile lists, 2 E + 3 + M / 128 ints, must fit in
// shared memory beside the ring). Launches on `stream`, never
// synchronises, allocates nothing.
extern "C" int paddle_gmm(const void* lhs, const void* rhs,
                          const void* tile_expert, void* out, int M, int R,
                          int N, int E, int tile_m, int trans, int dtype,
                          void* stream) {
  if (!shape_ok(M, R, N, E, tile_m)) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* te = static_cast<const int*>(tile_expert);
  if (dtype == 1) {
    GmmArgs a;
    const uint64_t lhs_dims[2] = {uint64_t(R), uint64_t(M)};
    const uint64_t rhs_dims[3] = {uint64_t(trans ? R : N),
                                  uint64_t(trans ? N : R), uint64_t(E)};
    const uint64_t out_dims[2] = {uint64_t(N), uint64_t(M)};
    if (!hopper::encode_map(&a.lhs, lhs, 2, lhs_dims, 64, gemm90::BM) ||
        !hopper::encode_map(&a.rhs, rhs, 3, rhs_dims, 64, 64) ||
        !hopper::encode_map(&a.out, out, 2, out_dims, 64, 64))
      return -1;
    a.tile_expert = te;
    a.K = R;
    a.N = N;
    a.E = E;
    a.per = tile_m / gemm90::BM;
    a.blocks = M / gemm90::BM;
    return trans ? launch_gmm_n<true>(a, st) : launch_gmm_n<false>(a, st);
  }
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
