// Weight-only int8 matmul: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/int8_matmul.py (`int8_matmul`).
//
// Replaces the TPU kernel of paddle_tpu/ops/pallas/int8_matmul.py
// (`_kernel` :48 / `_call` :65, entry `int8_matmul_pallas` :85).
//
// What it computes.
//   out[m, n] = round_to_x_dtype( (sum_k x[m, k] * float(q[k, n])) * scale[n] )
// x is [M, K] (bf16 or f32, row-major), q is int8 [K, N] in the JAX layout
// (row-major, n contiguous), scale is f32 [N]. The sum is f32, the scale is
// applied once to the f32 sum and the result is rounded once: the Pallas
// kernel's arithmetic. Any M >= 1; K a multiple of 8 and N a multiple of 16
// (the 16-byte copies); the wrapper raises on anything else.
//
// What bounds it. Decode (M = batch, 1..64): the int8 weight stream, K*N
// bytes, is nearly all the traffic and the tensor cores idle, so the least
// time is K*N bytes over 3.35 TB/s. Prefill (M in the thousands): 2*M*K*N
// operations over the bf16 tensor-core rate.
//
// Design. bf16 x runs on tensor cores (mma.sync m16n8k16, f32 accumulate).
// Tiles of x and of q are copied into shared memory with 16-byte cp.async
// in a ring of stages, so the next tiles' loads overlap this tile's math;
// each q tile is widened from int8 to bf16 once per block (a byte permute
// and one f32 subtract per value, no conversion instructions), on its way
// from the ring into a [n][k] bf16 tile whose rows are the mma B fragments.
// K is cut into a fixed number S of parts that depends on the weight shape
// (K, N) only (`k_splits`). Two tile shapes of the same kernel:
//   * decode, M <= 64: a block takes 128 columns (full 128-byte rows of q)
//     of one part of K, 16/32/64 rows, 4 warps of 4 independent 16 x 8
//     accumulators, 64 k per stage, 4 stages; S parts multiply the blocks.
//     Each part is written in f32 and the last block of a column tile adds
//     the parts in order. Every weight byte is read once;
//   * prefill, M > 64: 128 x 128 output tiles, 8 warps of 64 x 32, 32 k
//     per stage, 2 stages; each block walks all of K and adds each closed
//     part, in the same order, to a running total kept in shared memory
//     (touched only at part boundaries: in registers it needs 255 of
//     them and spills) — 103 KB a block, two blocks an SM.
// f32 x (tests and checks only; nothing on the decode path is f32 on the
// card) runs a plain FMA tile kernel.
//
// Batch invariance. Every output element sums the k16 chunks of each part
// in order into one accumulator that starts at zero, then adds the parts
// in order 0, 1, ..., S - 1, in both tile shapes; padding rows are zeros
// and never mix into another row. So a row's output is bitwise the same
// at M = 1, 8 or 4096 and wherever the row sits in x. The f32 kernel sums
// each 16-k chunk and then adds it to the running total, in k order.
//
// Known gap: the ring is filled with cp.async, not TMA, and the products use
// mma.sync, not wgmma; decode reads x again in every block (from L2), and
// the parts travel through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// bf16 pairs (k, k + 1) of four columns from two int8 rows: out[j] holds
// q[k][n + j] in its low half and q[k + 1][n + j] in its high half. Each
// byte b becomes the f32 2^23 + (b ^ 0x80) by a byte permute, minus
// 2^23 + 128; the integer (|q| <= 128) is exact in f32 and in bf16, whose
// bits are then the f32's high half. Full-rate ALU work, no conversion unit.
__device__ __forceinline__ void widen4(uint32_t r0, uint32_t r1,
                                       uint32_t* out) {
  const uint32_t u0 = r0 ^ 0x80808080u, u1 = r1 ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f0 =
        __uint_as_float(__byte_perm(u0, 0x4B000000u, 0x7540 + j)) - 8388736.f;
    const float f1 =
        __uint_as_float(__byte_perm(u1, 0x4B000000u, 0x7540 + j)) - 8388736.f;
    out[j] = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }
}

// The fixed split of K of one weight shape: S parts of K / S rows, S the
// least power of two that gives n_tiles * S >= 256 decode blocks (128
// columns a tile), as long as K / S stays a multiple of 64 and S <=
// K / 1024 (so the f32 parts of M <= 64 rows, 4 * S * M * N bytes, stay
// within a quarter of the K * N weight bytes). It depends on (K, N) only,
// never on M: both tile shapes sum the parts in the same order, which
// keeps every row's bits independent of M.
int k_splits(int K, int N) {
  const int n_tiles = (N + 127) / 128;
  int s = 1;
  while (n_tiles * s < 256 && K % (2 * s * 64) == 0 && 2 * s * 1024 <= K)
    s *= 2;
  return s;
}

// Tile shape: each of WM x WN warps computes MT x NT mma tiles (16 x 8
// each); BK k per stage; STAGES-deep copy ring; FOLD adds a shared f32
// running total over closed parts of K, one slot per accumulator.
template <int MT, int NT, int WM, int WN, int BK, int STAGES, bool FOLD>
struct Tile {
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 8 * NT * WN;
  // bf16 rows of x and of the widened q, padded by 16 bytes: the fragment
  // reads of a warp (8 rows x 4 words) then fall in 32 distinct banks
  static constexpr int kLd = BK + 8;
  // int8 q rows, padded by 16 bytes (the widening reads of 4 k-pairs of a
  // warp fall in distinct banks)
  static constexpr int kQLd = BN + 16;
  static constexpr size_t kAStage = size_t(BM) * kLd * 2;
  static constexpr size_t kQStage = size_t(BK) * kQLd;
  static constexpr size_t kBs = size_t(BN) * kLd * 2;
  static constexpr size_t kTot = FOLD ? size_t(kThreads) * MT * NT * 4 * 4
                                      : 0;
  static constexpr size_t kBytes = STAGES * (kAStage + kQStage) + kBs + kTot;
  static_assert(BK % 16 == 0 && BN % 16 == 0, "tile");
  static_assert(kAStage % 16 == 0 && kQStage % 16 == 0, "alignment");
};

// One kernel, two tile shapes. DECODE: block (n tile, split s) sums the
// rows of part s only; with S > 1 it writes its f32 part to `part`
// [S][M][N], and the last block of its n tile to finish (an atomic count
// per tile) adds the parts in order 0, 1, ..., S - 1 and stores. Prefill:
// block (n tile, m tile) walks all of K, closing a part at every split
// boundary and adding it to the running total in the same order.
template <int MT, int NT, int WM, int WN, int BK, int STAGES, bool DECODE>
__global__ void __launch_bounds__(32 * WM * WN)
    int8_mm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                        const int8_t* __restrict__ q,
                        const float* __restrict__ scale,
                        __nv_bfloat16* __restrict__ out,
                        float* __restrict__ part, int* __restrict__ counters,
                        int M, int K, int N, int S) {
  constexpr bool kFold = !DECODE;
  using Tl = Tile<MT, NT, WM, WN, BK, STAGES, kFold>;
  constexpr int BM = Tl::BM, BN = Tl::BN, LD = Tl::kLd, QLD = Tl::kQLd;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + STAGES * Tl::kAStage);
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(
      smem + STAGES * (Tl::kAStage + Tl::kQStage));
  // the running total over closed parts (prefill with S > 1): slot e of
  // thread t at tot[e * kThreads + t], so a warp's accesses are contiguous
  float* tot = reinterpret_cast<float*>(
      smem + STAGES * (Tl::kAStage + Tl::kQStage) + Tl::kBs);
  __shared__ int last_block;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int ks = S > 1 ? K / S : K;          // rows of one part
  const int k_begin = DECODE ? blockIdx.z * ks : 0;
  const int k_rows = DECODE ? ks : K;

  auto load_stage = [&](int kt, int st) {
    const int k0 = k_begin + kt * BK;
    __nv_bfloat16* a = as + size_t(st) * BM * LD;
    for (int c = tid; c < BM * (BK / 8); c += Tl::kThreads) {
      const int r = c / (BK / 8), e = (c % (BK / 8)) * 8;
      const int m = m0 + r, k = k0 + e;
      const bool ok = m < M && k < K;
      cp_async16(a + r * LD + e, ok ? x + size_t(m) * K + k : x, ok ? 16 : 0);
    }
    int8_t* qq = qs + size_t(st) * Tl::kQStage;
    for (int c = tid; c < BK * (BN / 16); c += Tl::kThreads) {
      const int r = c / (BN / 16), e = (c % (BN / 16)) * 16;
      const int k = k0 + r, n = n0 + e;
      const bool ok = k < K && n < N;
      cp_async16(qq + r * QLD + e, ok ? q + size_t(k) * N + n : q,
                 ok ? 16 : 0);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int k_tiles = (k_rows + BK - 1) / BK;
  const int tiles_per_part = ks / BK;  // exact when S > 1
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();  // empty groups keep the wait count uniform
  }

  constexpr int kNQ = BN / 4;                 // 4-column groups
  constexpr int kItems = (BK / 2) * kNQ;      // (k-pair, 4 columns) items
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; last tile's readers are done
    {
      const int nk = kt + STAGES - 1;
      if (nk < k_tiles) load_stage(nk, nk % STAGES);
      cp_async_commit();
    }
    // widen q's stage into bs[n][k] (bf16 pairs along k)
    const int8_t* qq = qs + size_t(kt % STAGES) * Tl::kQStage;
    for (int i = tid; i < kItems; i += Tl::kThreads) {
      // a warp covers 8 column groups x 4 k-pairs: conflict-free reads
      const int kp = (i & 3) + 4 * (i / (4 * kNQ));
      const int nq = (i >> 2) % kNQ;
      const uint32_t r0 =
          *reinterpret_cast<const uint32_t*>(qq + (2 * kp) * QLD + 4 * nq);
      const uint32_t r1 = *reinterpret_cast<const uint32_t*>(
          qq + (2 * kp + 1) * QLD + 4 * nq);
      uint32_t w[4];
      widen4(r0, r1, w);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<uint32_t*>(bs + (4 * nq + j) * LD + 2 * kp) = w[j];
    }
    __syncthreads();

    const __nv_bfloat16* a = as + size_t(kt % STAGES) * BM * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MT][4], bf[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const __nv_bfloat16* p = a + (wm * MT * 16 + i * 16 + g) * LD + kk +
                                 2 * t;
        af[i][0] = *reinterpret_cast<const uint32_t*>(p);
        af[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        af[i][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        af[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const __nv_bfloat16* p = bs + (wn * NT * 8 + j * 8 + g) * LD + kk +
                                 2 * t;
        bf[j][0] = *reinterpret_cast<const uint32_t*>(p);
        bf[j][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], af[i], bf[j]);
    }
    if (kFold && S > 1 && (kt + 1) % tiles_per_part == 0) {
      // close a part: the total takes it (the first part as it is)
      const bool first = kt + 1 == tiles_per_part;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            float* slot = tot + ((i * NT + j) * 4 + r) * Tl::kThreads + tid;
            *slot = first ? acc[i][j][r] : *slot + acc[i][j][r];
            acc[i][j][r] = 0.f;
          }
    }
  }
  cp_async_wait<0>();
  if (kFold && S > 1) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          acc[i][j][r] = tot[((i * NT + j) * 4 + r) * Tl::kThreads + tid];
  }

  if (DECODE && S > 1) {
    // write this part; the last block of the n tile adds them in order
    float* mine = part + size_t(blockIdx.z) * M * N;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
      if (n >= N) continue;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * MT * 16 + i * 16 + g + 8 * h;
          if (m < M)
            *reinterpret_cast<float2*>(mine + size_t(m) * N + n) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
        }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last_block = atomicAdd(counters + blockIdx.x, 1) == S - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    const int rows = min(BM, M - m0);
    for (int c = tid; c < rows * (BN / 2); c += Tl::kThreads) {
      const int m = m0 + c / (BN / 2), n = n0 + 2 * (c % (BN / 2));
      if (n >= N) continue;
      const float* src = part + size_t(m) * N + n;
      float2 v = __ldcg(reinterpret_cast<const float2*>(src));
      for (int s = 1; s < S; ++s) {
        const float2 w = __ldcg(
            reinterpret_cast<const float2*>(src + size_t(s) * M * N));
        v.x += w.x;
        v.y += w.y;
      }
      *reinterpret_cast<__nv_bfloat162*>(out + size_t(m) * N + n) =
          __floats2bfloat162_rn(v.x * scale[n], v.y * scale[n + 1]);
    }
    if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
    return;
  }

  // epilogue: times the column's scale, one rounding to bf16
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int n = n0 + wn * NT * 8 + j * 8 + 2 * t;
    if (n >= N) continue;  // N % 16 == 0: n and n + 1 are in or out together
    const float s0 = scale[n], s1 = scale[n + 1];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = m0 + wm * MT * 16 + i * 16 + g;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int mm = m + 8 * h;
        if (mm < M) {
          *reinterpret_cast<__nv_bfloat162*>(out + size_t(mm) * N + n) =
              __floats2bfloat162_rn(acc[i][j][2 * h] * s0,
                                    acc[i][j][2 * h + 1] * s1);
        }
      }
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

template <int MT, int NT, int WM, int WN, int BK, int STAGES, bool DECODE>
int launch_bf16(const void* x, const void* q, const float* scale, void* out,
                float* part, int* counters, int M, int K, int N, int S,
                cudaStream_t stream) {
  using Tl = Tile<MT, NT, WM, WN, BK, STAGES, !DECODE>;
  auto kernel = int8_mm_bf16_kernel<MT, NT, WM, WN, BK, STAGES, DECODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + Tl::BN - 1) / Tl::BN, (M + Tl::BM - 1) / Tl::BM,
                  DECODE ? S : 1);
  if (grid.y > 65535) return -1;
  kernel<<<grid, Tl::kThreads, Tl::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      scale, static_cast<__nv_bfloat16*>(out), part, counters, M, K, N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The split of K the bf16 kernel uses for a (K, N) weight, and so the
// f32 workspace a call with M <= 64 rows needs: S * M * N floats when S > 1
// (none otherwise), plus one int counter per 128 columns, zero before the
// launch (the kernel leaves them zero).
extern "C" int paddle_int8_matmul_splits(int K, int N) {
  return k_splits(K, N);
}

// Returns 0 on success, a cudaError_t code when the launch was refused, -1
// for a dtype or shape the kernel does not take. dtype: 0 = float32,
// 1 = bfloat16 (x and out). `part` and `counters` as
// paddle_int8_matmul_splits says (bf16, M <= 64 and S > 1; else unused).
// Launches on `stream`, never synchronises, allocates nothing.
extern "C" int paddle_int8_matmul(const void* x, const void* q,
                                  const void* scale, void* out, void* part,
                                  void* counters, int M, int K, int N,
                                  int dtype, void* stream) {
  if (M < 1 || K < 8 || K % 8 != 0 || N < 16 || N % 16 != 0) return -1;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* s = static_cast<const float*>(scale);
  if (dtype == 1) {
    const int S = k_splits(K, N);
    auto* pt = static_cast<float*>(part);
    auto* ct = static_cast<int*>(counters);
    if (M <= 64 && S > 1 && (pt == nullptr || ct == nullptr)) return -1;
    if (M <= 16)
      return launch_bf16<1, 4, 1, 4, 64, 4, true>(x, q, s, out, pt, ct, M, K,
                                                  N, S, st);
    if (M <= 32)
      return launch_bf16<2, 4, 1, 4, 64, 4, true>(x, q, s, out, pt, ct, M, K,
                                                  N, S, st);
    if (M <= 64)
      return launch_bf16<4, 4, 1, 4, 64, 4, true>(x, q, s, out, pt, ct, M, K,
                                                  N, S, st);
    return launch_bf16<4, 4, 2, 4, 32, 2, false>(x, q, s, out, nullptr,
                                                 nullptr, M, K, N, S, st);
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
