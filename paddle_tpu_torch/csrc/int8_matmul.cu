// Weight-only int8 matmul: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/int8_matmul.py (`int8_matmul`).
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/int8_matmul.py
// (`_kernel` :48 / `_call` :65, entry `int8_matmul_pallas` :84).
//
// What it computes.
//   out[m, n] = round_to_x_dtype( (sum_k x[m, k] * float(q[k, n])) * scale[n] )
// x is [M, K] (bf16 or f32, row-major), q is int8 [K, N] in the JAX layout
// (row-major, n contiguous), scale is f32 [N]. The sum is f32, the scale is
// applied once to the f32 sum and the result is rounded once: the Pallas
// kernel's arithmetic. Any M >= 1; K a multiple of 8 and N a multiple of 16
// (16-byte rows for the tensor maps); the wrapper raises on anything else.
//
// What bounds it. Decode (M = batch, 1..64): the int8 weight stream, K*N
// bytes, is nearly all the traffic and the tensor cores idle, so the least
// time is K*N bytes over 3.35 TB/s. Prefill (M in the thousands): 2*M*K*N
// operations over the bf16 tensor-core rate.
//
// Design (bf16 x): the roles and the TMA ring of the shared mainloop
// (gemm_sm90.cuh: persistent blocks, one an SM, a producer warpgroup at
// 40 registers and two consumer warpgroups at 232, full / empty
// mbarriers), with the product turned around so that the weight never
// lands in shared memory as bf16:
//   out^T [n, m] = q^T [n, k] x^T [k, m]
// is a wgmma whose A (64 n x 16 k) comes from registers and whose B is
// x, K-major, in shared memory (x's [M, K] rows as TMA loads them).
//   * A stage is one TMA box of q (64 k x 128 n int8, 128-byte rows,
//     128-byte swizzle) and NM / 64 boxes of x (64 k x 64 rows bf16, rows
//     past M arrive as zeros). Decode (M <= 64) has NM = 64 rows an item
//     and a 14-stage ring (112 KB of weight in flight an SM); prefill NM =
//     128 and 9 stages.
//   * Consumer warpgroup w takes columns n0 + 64 w ..: each warp's 16
//     columns are one 16-byte chunk of the q rows. One ldmatrix.trans of
//     16-bit pairs gives a thread the bytes q[k .. k + 1][n .. n + 1] of 4
//     k-pairs; a byte permute into the f32 2^23 + (b ^ 0x80), one f32
//     subtract and a permute of the high halves widen them to the bf16
//     pairs of the wgmma's A fragment (exact: |q| <= 128). Fragment row r
//     of a warp is column n = 2 r (r < 8) or 2 (r - 8) + 1, so a thread's
//     two accumulator rows are neighbouring columns and the epilogue
//     writes bf16 pairs straight to out.
//   * K is cut into S parts fixed by the weight shape (K, N) alone
//     (`k_splits`). Each part's sum is a chain of wgmma m64nNMk16 from
//     zero; the parts are added in order 0, 1, ..., S - 1 in f32, times
//     the scale, one rounding. At decode sizes, and up to 256 rows where
//     that is the shorter walk (`spread_parts`), the parts are items of
//     their own, spread across blocks: each writes its f32 part to a
//     workspace [S, M, N] and the last warpgroup to finish a 64-column
//     slice (a counter per slice) adds the parts in order and stores.
//     Otherwise an item walks all of K and keeps the running total in
//     registers beside the wgmma accumulators (only wgmmas write those:
//     any other write between two of them makes ptxas serialize them).
//   * Items: spread parts of one tile are neighbours, so a tile's S
//     blocks finish together; otherwise tiles go 8 row blocks at a time
//     over all column tiles (x's rows stay in L2 while q streams).
// f32 x (tests and checks only; nothing on the decode path is f32 on the
// card) runs a plain FMA tile kernel.
//
// Known gap: prefill reaches about 57% of the bf16 peak. A 128 x 128
// item takes in 24 KB a stage (87 flop a byte); larger items need the
// registers the running total holds (ptxas allows 168 a thread here).
//
// Batch invariance. An output element is the same ordered sum at any M:
// each part's chain of k16 products from zero, the parts added in order,
// whatever the item shape, the instruction width NM (the card gives the
// same bits for a wgmma element at widths 64, 128 and 256:
// tools/torch_wgmma_probe.py) or whether the parts were spread; rows past
// M are zeros and never mix into another row. So a row's output is
// bitwise the same at M = 1, 8 or 4096 and wherever the row sits in x.
// The f32 kernel sums each 16-k chunk and then adds it to the running
// total, in k order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "gemm_sm90.cuh"

namespace {

using hopper::kPanelBytes;

constexpr int kSpreadRows = 256;  // parts may spread across blocks up to here
constexpr int kGroupRows = 8;     // row blocks a raster group (no spread)
constexpr int kTileN = 128;       // columns an item (two warpgroups of 64)

// The fixed split of K of one weight shape: S parts of K / S rows, S the
// least power of two that gives (N / 128) * S >= 128 items, as long as
// K / S stays a multiple of 64 and S <= K / 1024 (the f32 parts of up to
// 256 rows, 4 S M N bytes, stay within the weight's K N bytes). It
// depends on (K, N) only, never on M, which keeps every row's bits
// independent of M.
int k_splits(int K, int N) {
  const int n_tiles = (N + kTileN - 1) / kTileN;
  int s = 1;
  while (n_tiles * s < 128 && K % (2 * s * 64) == 0 && 2 * s * 1024 <= K)
    s *= 2;
  return s;
}

// a stage: q (64 k x 128 n int8) then x (NM rows x 64 k bf16); no staging
template <int NM>
struct I8Geo {
  static constexpr int kABytes = 64 * kTileN;
  static constexpr int kStageBytes = kABytes + NM * 128;
  static constexpr int kPanelsB = 0;
  static constexpr int kBarBytes = 256;
  static constexpr int kFlagBytes = 16;
  static constexpr int kStages0 =
      (gemm90::kSmemMax - 1024 - kBarBytes - kFlagBytes) / kStageBytes;
  static constexpr int kStages = kStages0 < 16 ? kStages0 : 16;  // 14, 9
  static constexpr int kAcc = NM / 2;  // f32 accumulators a thread
  static constexpr int kBytes =
      1024 + kStages * kStageBytes + kBarBytes + kFlagBytes;
  static_assert(2 * 8 * kStages <= kBarBytes, "barriers");
};

struct I8Args {
  CUtensorMap q;  // [K, N] int8, boxes of 128 columns x 64 rows
  CUtensorMap x;  // [M, K] bf16, boxes of 64 columns x 64 rows
  const float* scale;
  __nv_bfloat16* out;
  float* part;    // [S, M, N] when spread
  int* counters;  // one a (row block, 64 columns), zero between launches
  int M, K, N, S;
  int spread;     // the parts are items of their own
  int mt, nt;     // row blocks (NM rows), column tiles (128)
};

// the item's row block, column tile and part (-1: all parts in turn)
struct I8Item {
  int mb, nt, p;
};
__device__ __forceinline__ I8Item i8_item(const I8Args& a, int item) {
  int p = -1;
  if (a.spread) {
    p = item % a.S;
    item /= a.S;
  }
  const int per_group = kGroupRows * a.nt;
  const int g = item / per_group, r = item % per_group;
  const int rows = min(kGroupRows, a.mt - g * kGroupRows);
  return {g * kGroupRows + r % rows, r / rows, p};
}

// bf16 pairs (q[k][c], q[k + 1][c]) for c = the even and the odd column of
// r's bytes q[k][c0], q[k][c0 + 1], q[k + 1][c0], q[k + 1][c0 + 1]: each
// byte b becomes the f32 2^23 + (b ^ 0x80) by a byte permute, minus
// 2^23 + 128; the integer is exact in f32 and in bf16, whose bits are
// then the f32's high half.
__device__ __forceinline__ void widen2(uint32_t r, uint32_t& even,
                                       uint32_t& odd) {
  const uint32_t u = r ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    f[j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
           8388736.f;
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// Consumer helper: 32 k of the warp's 16 columns of q (rows 32 kb ..),
// widened to bf16, as the A fragments of two k16 steps.
__device__ __forceinline__ void i8_fragments(uint32_t (&a0)[4],
                                             uint32_t (&a1)[4], uint32_t qs,
                                             int kb, int chunk) {
  const int lane = threadIdx.x % 32;
  uint32_t r[4];  // lane l gives the address of row 32 kb + l
  hopper::ldsm_x4_t(r, qs + (32 * kb + lane) * 128 +
                           ((chunk ^ (lane % 8)) << 4));
  widen2(r[0], a0[0], a0[1]);
  widen2(r[1], a0[2], a0[3]);
  widen2(r[2], a1[0], a1[1]);
  widen2(r[3], a1[2], a1[3]);
}

// Consumer: `steps` (> 0) stages from ring position `it` (advanced) into
// acc, overwriting it (a part's chain from zero). A stage's first 32 k
// are widened and their products issued before the next 32 k are
// widened, so that widening runs under the products; the stage is waited
// for before the next (the other consumer warpgroup's products fill the
// tensor cores meanwhile). Fragments are fenced after the wait, so the
// compiler keeps their registers until the products reading them are
// done. (Two fragment sets, to run a whole stage's widening under the
// previous stage's products, spilled at the 168 registers a thread ptxas
// allows here and ran slower.) On return every product is done and every
// stage released.
template <int NM>
__device__ __forceinline__ void i8_consume(
    float (&acc)[I8Geo<NM>::kAcc], const gemm90::RingT<I8Geo<NM>>& ring,
    int& it, int steps, int chunk) {
  using G = I8Geo<NM>;
  for (int s = 0; s < steps; ++s, ++it) {
    const int st = it % G::kStages;
    hopper::mbar_wait(ring.full(st), (it / G::kStages) & 1);
    const uint32_t qs = hopper::smem_u32(ring.a(st));
    const uint32_t xs = hopper::smem_u32(ring.b(st));
    uint32_t a[4][4];
#pragma unroll
    for (int kb = 0; kb < 2; ++kb) {
      i8_fragments(a[2 * kb], a[2 * kb + 1], qs, kb, chunk);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 2 * kb; kk < 2 * kb + 2; ++kk)
        hopper::wgmma_rs<NM, 0>(acc, a[kk],
                                  hopper::desc_sw128(xs + kk * 32),
                                  !(s == 0 && kk == 0));
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) hopper::fence_regs(a[kk]);
    hopper::fence_regs(acc);
    hopper::mbar_arrive(ring.empty(st));
  }
}

template <int NM>
__global__ void __launch_bounds__(gemm90::kThreads, 1)
    int8_mm_wgmma_kernel(const __grid_constant__ I8Args a) {
  using G = I8Geo<NM>;
  extern __shared__ unsigned char smem_raw[];
  const gemm90::RingT<G> ring(smem_raw);
  int* flag = reinterpret_cast<int*>(ring.extra());  // a consumer's "last"
  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int items = a.mt * a.nt * (a.spread ? a.S : 1);
  const int part_steps = (a.K / a.S + 63) / 64;  // K / S % 64 == 0 if S > 1

  if (threadIdx.x >= gemm90::kConsumers) {
    hopper::regs_dec<gemm90::kProducerRegs>();
    if (threadIdx.x == gemm90::kConsumers) {
      hopper::prefetch_map(&a.q);
      hopper::prefetch_map(&a.x);
      int it = 0;
      for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const I8Item w = i8_item(a, item);
        const int s0 = w.p < 0 ? 0 : w.p * part_steps;
        const int s1 = w.p < 0 ? a.S * part_steps : s0 + part_steps;
        for (int s = s0; s < s1; ++s) {
          const int k0 = s * 64;
          const int st = ring.acquire(it++, G::kStageBytes);
          hopper::tma_load_2d(ring.a(st), &a.q, ring.full(st), w.nt * kTileN,
                              k0);
#pragma unroll
          for (int i = 0; i < NM / 64; ++i)
            hopper::tma_load_2d(ring.b(st) + i * kPanelBytes, &a.x,
                                ring.full(st), k0, w.mb * NM + 64 * i);
        }
      }
    }
    return;
  }

  hopper::regs_inc<gemm90::kConsumerRegs>();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int chunk = 4 * wg + threadIdx.x % 128 / 32;  // the warp's 16 columns
  const int g = lane / 4, t = lane % 4;
  float acc[G::kAcc];
  float tot[G::kAcc];
  int it = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const I8Item w = i8_item(a, item);
    const int n = w.nt * kTileN + 16 * chunk + 2 * g;  // and n + 1
    const int m0 = w.mb * NM + 2 * t;                  // + 8 j + h
    const bool live = n < a.N;  // N % 16 == 0: the warp is in or out
    const float2 sc = live ? make_float2(a.scale[n], a.scale[n + 1])
                           : make_float2(0.f, 0.f);
    if (w.p >= 0) {
      // one part: write it, and the last of the slice's S adds them up
      i8_consume<NM>(acc, ring, it, part_steps, chunk);
      if (w.nt * kTileN + 64 * wg >= a.N) continue;  // a slice past N
      float* mine = a.part + size_t(w.p) * a.M * a.N;
#pragma unroll
      for (int j = 0; j < NM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + h;
          if (live && m < a.M)
            *reinterpret_cast<float2*>(mine + size_t(m) * a.N + n) =
                make_float2(acc[4 * j + h], acc[4 * j + 2 + h]);
        }
      __threadfence();
      hopper::bar_sync(1 + wg, 128);
      int* counter = a.counters + w.mb * ((a.N + 63) / 64) +
                     (w.nt * kTileN) / 64 + wg;
      if (threadIdx.x % 128 == 0)
        flag[wg] = atomicAdd(counter, 1) == a.S - 1;
      hopper::bar_sync(1 + wg, 128);
      if (!flag[wg]) continue;
      __threadfence();
      // the parts in order, from the workspace (this one's own too), four
      // parts' loads in flight at a time
      const size_t stride = size_t(a.M) * a.N;
      for (int j = 0; j < NM / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + 8 * j + h;
          if (!live || m >= a.M) continue;
          const float* src = a.part + size_t(m) * a.N + n;
          float2 v = make_float2(0.f, 0.f);
          for (int p0 = 0; p0 < a.S; p0 += 4) {
            float2 u[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if (p0 + i < a.S)
                u[i] = __ldcg(
                    reinterpret_cast<const float2*>(src + (p0 + i) * stride));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if (p0 + i >= a.S) continue;
              if (p0 + i == 0) {
                v = u[i];
              } else {
                v.x += u[i].x;
                v.y += u[i].y;
              }
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(a.out + size_t(m) * a.N + n) =
              __floats2bfloat162_rn(v.x * sc.x, v.y * sc.y);
        }
      if (threadIdx.x % 128 == 0) *counter = 0;  // ready for the next launch
      continue;
    }
    // every part in turn, the running total beside the accumulators
    i8_consume<NM>(acc, ring, it, part_steps, chunk);
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) tot[i] = acc[i];
    for (int p = 1; p < a.S; ++p) {
      i8_consume<NM>(acc, ring, it, part_steps, chunk);
#pragma unroll
      for (int i = 0; i < G::kAcc; ++i) tot[i] += acc[i];
    }
    // times the scale, one rounding, bf16 pairs to out
#pragma unroll
    for (int j = 0; j < NM / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 8 * j + h;
        if (live && m < a.M)
          *reinterpret_cast<__nv_bfloat162*>(a.out + size_t(m) * a.N + n) =
              __floats2bfloat162_rn(tot[4 * j + h] * sc.x,
                                    tot[4 * j + 2 + h] * sc.y);
      }
  }
}

// f32 x: 64 x 64 output tiles, 256 threads of 4 x 4 outputs, 16 k a step.
constexpr int kFTile = 64, kFK = 16, kFThreads = 256;

__global__ void __launch_bounds__(kFThreads)
    int8_mm_f32_kernel(const float* __restrict__ x,
                       const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ out,
                       int M, int K, int N) {
  __shared__ float xs[kFK][kFTile + 1];
  __shared__ float ws[kFK][kFTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kFTile, n0 = blockIdx.x * kFTile;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kFK) {
    for (int c = tid; c < kFTile * kFK; c += kFThreads) {
      const int r = c / kFK, e = c % kFK;  // x tile: row r, k e
      const int m = m0 + r, k = k0 + e;
      xs[e][r] = (m < M && k < K) ? x[size_t(m) * K + k] : 0.f;
      const int kr = c / kFTile, n = n0 + c % kFTile;
      const int kq = k0 + kr;
      ws[kr][c % kFTile] =
          (kq < K && n < N) ? static_cast<float>(q[size_t(kq) * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // this step's 16 products first, then the running total
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kFK; ++e)
          part = fmaf(xs[e][ty + 16 * i], ws[e][tx + 16 * j], part);
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
      if (n < N) out[size_t(m) * N + n] = acc[i][j] * scale[n];
    }
  }
}

template <int NM>
int launch_wgmma(I8Args& a, cudaStream_t stream) {
  a.mt = (a.M + NM - 1) / NM;
  const int err = gemm90::allow_smem<int8_mm_wgmma_kernel<NM>>();
  if (err != 0) return err;
  const long items = long(a.mt) * a.nt * (a.spread ? a.S : 1);
  const int grid = static_cast<int>(std::min<long>(items, gemm90::sm_count()));
  int8_mm_wgmma_kernel<NM><<<grid, gemm90::kThreads, I8Geo<NM>::kBytes,
                             stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Whether a bf16 call of M rows spreads the S parts of K across blocks:
// always for decode (M <= 64: an item's rows are few); for 64 < M <= 256
// when the spread walk is the shorter, counting K a block in rounds of
// items over the SMs, plus 2560 values of K for writing and adding up
// the f32 parts (fitted to the five llama3_8b shapes at M = 256 on an
// H100: PERF.md §6). Either way a row's bits are the same.
bool spread_parts(int M, int K, int N, int S) {
  if (S == 1 || M > kSpreadRows) return false;
  if (M <= 64) return true;
  const long items = long((M + 127) / 128) * ((N + kTileN - 1) / kTileN);
  const long sms = gemm90::sm_count();
  const long whole = (items + sms - 1) / sms * K;
  const long spread = (items * S + sms - 1) / sms * (K / S) + 2560;
  return spread < whole;
}

}  // namespace

// The number of f32 parts a bf16 call of M rows writes through its
// workspace: S, the fixed split of K for (K, N), when the call spreads
// its parts across blocks (`spread_parts`), else 1 (none). The workspace
// is then S * M * N floats, plus ceil(M / 64) * ceil(N / 64) int counters,
// zero before the launch (the kernel leaves them zero).
extern "C" int paddle_int8_matmul_splits(int M, int K, int N) {
  const int S = k_splits(K, N);
  return spread_parts(M, K, N, S) ? S : 1;
}

// Returns 0 on success, a cudaError_t code when the launch was refused, -1
// for a dtype or shape the kernel does not take. dtype: 0 = float32,
// 1 = bfloat16 (x and out). `part` and `counters` as
// paddle_int8_matmul_splits says (unused when it says 1). Launches on
// `stream`, never synchronises, allocates nothing.
extern "C" int paddle_int8_matmul(const void* x, const void* q,
                                  const void* scale, void* out, void* part,
                                  void* counters, int M, int K, int N,
                                  int dtype, void* stream) {
  if (M < 1 || K < 8 || K % 8 != 0 || N < 16 || N % 16 != 0) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(scale);
  if (dtype == 1) {
    I8Args a;
    const uint64_t q_dims[2] = {uint64_t(N), uint64_t(K)};
    const uint64_t x_dims[2] = {uint64_t(K), uint64_t(M)};
    if (!hopper::encode_map(&a.q, q, 2, q_dims, kTileN, 64, 1) ||
        !hopper::encode_map(&a.x, x, 2, x_dims, 64, 64))
      return -1;
    a.scale = s;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.part = static_cast<float*>(part);
    a.counters = static_cast<int*>(counters);
    a.M = M;
    a.K = K;
    a.N = N;
    a.S = k_splits(K, N);
    a.spread = paddle_int8_matmul_splits(M, K, N) > 1;
    if (a.spread && (a.part == nullptr || a.counters == nullptr)) return -1;
    a.nt = (N + kTileN - 1) / kTileN;
    return M <= 64 ? launch_wgmma<64>(a, st) : launch_wgmma<128>(a, st);
  }
  if (dtype == 0) {
    const dim3 grid((N + kFTile - 1) / kFTile, (M + kFTile - 1) / kFTile);
    if (grid.y > 65535) return -1;
    int8_mm_f32_kernel<<<grid, kFThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q), s,
        static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  return -1;
}
