// The bf16 GEMM mainloop shared by the port's Hopper GEMM kernels with a
// fused epilogue: tgmm (grouped_matmul.cu) and the conv epilogue
// (conv_epilogue.cu).
//
// Shape of a kernel built on it. 384 threads a block, one block an SM,
// persistent: the block walks a fixed list of work items (output tiles),
// items blockIdx.x, + gridDim.x, ... Three warpgroups:
//   * the producer (threads 256..383; only thread 256 works) issues every
//     TMA load into a ring of kStages stages, each an A tile of 128 output
//     rows x 64 reduction values and a B tile of 64 reduction values x BN
//     output columns, 128-byte-swizzled panels (hopper.cuh). A stage is
//     handed over with a full mbarrier (TMA bytes) and back with an empty
//     one (256 consumer arrivals). It runs ahead across items, so the next
//     item's loads are in flight under the current item's epilogue.
//   * two consumers (threads 0..255), 64 output rows each, issue one
//     wgmma m64nBNk16 per 16 reduction values, f32 accumulators in
//     registers, one group in flight (a stage is released once the next
//     stage's products are issued and the previous group is done).
// setmaxnreg hands registers from the producer (40) to the consumers
// (232); each role runs its own loop (a shared loop makes ptxas serialize
// the wgmmas). The producer and consumers agree on the ring's position by
// counting stages the same way: both walk the same items and steps.
//
// Operands. A is K-major (rows are output rows, 64 reduction values of
// 128 bytes each: the conv epilogue's x) or MN-major (rows are the
// reduction, 64 output rows wide a panel: tgmm's lhs^T); B is MN-major
// (rows are the reduction, BN / 64 panels of 64 columns: the conv
// epilogue's w [K, N], tgmm's g). Every wgmma is BN wide and reads B's
// BN / 64 panels through one descriptor whose leading offset (LBO) is the
// panel size, kPanelBytes.
//
// Epilogue. Each consumer warpgroup turns its 64 x BN accumulator into
// bf16 in registers (the kernel's own function of the column and the f32
// pair), writes it into its own staging panels in the TMA's 128-byte
// swizzle (conflict-free 4-byte stores), fences the writes to the async
// proxy and hands the panels to TMA stores issued by its first thread.
// The stores clip at the tensor's edges, so no kernel writes outside its
// output. A staging buffer is written again only after the previous
// stores from it have been read out (bulk-group wait), so a tile's store
// drains while the next tile computes.
#pragma once

#include "hopper.cuh"

namespace gemm90 {

using hopper::kPanelBytes;

constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;    // and a producer warpgroup
constexpr int kProducerRegs = 40;             // 40 x 128 + 232 x 256 fit
constexpr int kConsumerRegs = 232;            // the SM's 65536 registers
constexpr int BM = 128;                       // output rows a tile
constexpr int BK = 64;                        // reduction values a stage
constexpr int kSmemMax = 232448;              // a block's shared memory

template <int BN>
struct Geo {
  static_assert(BN == 64 || BN == 128 || BN == 256, "tile width");
  static constexpr int kPanelsB = BN / 64;
  static constexpr int kABytes = 2 * kPanelBytes;        // 128 x 64 bf16
  static constexpr int kBBytes = kPanelsB * kPanelBytes;  // 64 x BN bf16
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kOutBytes = 2 * kPanelsB * kPanelBytes;  // staging
  static constexpr int kBarBytes = 256;
  static constexpr int kReserve = 8192;  // left for the kernel's own bytes
  static constexpr int kStages0 =
      (kSmemMax - 1024 - kOutBytes - kBarBytes - kReserve) / kStageBytes;
  static constexpr int kStages = kStages0 < 8 ? kStages0 : 8;  // 3, 5, 8
  static constexpr int kAcc = BN / 2;  // f32 accumulators a thread
  // dynamic shared memory: 1024 bytes of alignment slack, the ring, the
  // staging panels, the barriers; the kernel's own bytes (`extra`) after
  static constexpr int kBytes =
      1024 + kStages * kStageBytes + kOutBytes + kBarBytes;
};

// the first 1024-byte boundary at or after p (a swizzle atom)
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// The block's shared memory: the ring, the staging panels, the full and
// empty barriers, then the kernel's own bytes (`extra()`).
template <int BN>
struct Ring {
  using G = Geo<BN>;
  unsigned char* base;
  __device__ explicit Ring(unsigned char* raw) : base(align_1k(raw)) {}
  __device__ unsigned char* a(int s) const {
    return base + s * G::kStageBytes;
  }
  __device__ unsigned char* b(int s) const { return a(s) + G::kABytes; }
  // warpgroup wg's staging panels; out(2) is the end of the staging
  __device__ unsigned char* out(int wg) const {
    return base + G::kStages * G::kStageBytes +
           wg * G::kPanelsB * kPanelBytes;
  }
  __device__ uint32_t full(int s) const {
    return hopper::smem_u32(out(2)) + 8 * s;
  }
  __device__ uint32_t empty(int s) const { return full(G::kStages) + 8 * s; }
  __device__ unsigned char* extra() const { return out(2) + G::kBarBytes; }

  // thread 0, before the role split (then __syncthreads)
  __device__ void init() const {
    for (int s = 0; s < G::kStages; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), kConsumers);
    }
    hopper::mbar_fence_init();
  }

  // producer: claim stage `it` (wait until its previous use was released)
  // and announce its bytes; returns the stage index
  __device__ int acquire(int it, uint32_t bytes) const {
    const int s = it % G::kStages;
    if (it >= G::kStages)
      hopper::mbar_wait(empty(s), (it / G::kStages - 1) & 1);
    hopper::mbar_expect_tx(full(s), bytes);
    return s;
  }
};

// Where a consumer thread sits in its warpgroup's 64 x BN accumulator:
// rows r and r + 8, columns 8 j + c and + 1 (j < BN / 8), registers
// 4 j + {0, 1} (row r) and 4 j + {2, 3} (row r + 8).
struct Lane {
  int wg, r, c;
  __device__ Lane()
      : wg(threadIdx.x / 128),
        r(16 * (threadIdx.x % 128 / 32) + threadIdx.x % 32 / 4),
        c(2 * (threadIdx.x % 4)) {}
};

// the products of one stage: acc[64 x BN] (+)= A[64 rows of wg] B over 64
// reduction values; `fresh` overwrites acc with the first product
template <int BN, bool A_MN>
__device__ __forceinline__ void mma_stage(float* acc, uint32_t a, uint32_t b,
                                          int wg, bool fresh) {
  const uint32_t aw = a + wg * kPanelBytes;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = A_MN ? hopper::desc_sw128(aw + kk * 2048)
                             : hopper::desc_sw128(aw + kk * 32);
    const uint64_t db = hopper::desc_sw128_mn(b + kk * 2048, kPanelBytes);
    hopper::wgmma_ss_t<BN, A_MN ? 1 : 0, 1>(acc, da, db,
                                            !(fresh && kk == 0));
  }
}

// Consumer: `steps` (> 0) stages from ring position `it` (advanced) into
// acc, overwriting it. On return every product is done and every stage
// released. Only wgmmas write acc: any other instruction writing it
// between two of them makes ptxas serialize every wgmma (C7515).
template <int BN, bool A_MN>
__device__ __forceinline__ void consume(float (&acc)[Geo<BN>::kAcc],
                                        const Ring<BN>& ring, int& it,
                                        int steps, int wg) {
  using G = Geo<BN>;
  for (int s = 0; s < steps; ++s, ++it) {
    const int st = it % G::kStages;
    hopper::mbar_wait(ring.full(st), (it / G::kStages) & 1);
    hopper::wgmma_fence();
    mma_stage<BN, A_MN>(acc, hopper::smem_u32(ring.a(st)),
                        hopper::smem_u32(ring.b(st)), wg, s == 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous stage's products are done
    if (s > 0) hopper::mbar_arrive(ring.empty((it - 1) % G::kStages));
  }
  hopper::wgmma_wait();
  hopper::fence_regs(acc);
  hopper::mbar_arrive(ring.empty((it - 1) % G::kStages));
}

// Consumer epilogue, first half: wait until the warpgroup's staging panels
// are free, then write f(col, v0, v1) -> bf16 pair for each of the
// thread's pairs into them. `f` gets the tile-local column of v0.
template <int BN, class F>
__device__ __forceinline__ void stage_out(const Ring<BN>& ring,
                                          const float (&acc)[Geo<BN>::kAcc],
                                          const Lane& ln, F f) {
  if (threadIdx.x % 128 == 0) hopper::tma_store_wait_read<0>();
  hopper::bar_sync(1 + ln.wg, 128);
  unsigned char* out = ring.out(ln.wg);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + ln.c;
    unsigned char* panel = out + (j / 8) * kPanelBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ln.r + 8 * h;
      const int chunk = (j % 8) ^ (row % 8);
      *reinterpret_cast<uint32_t*>(panel + row * 128 + chunk * 16 +
                                   2 * ln.c) =
          f(col, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  hopper::fence_async_smem();
  hopper::bar_sync(1 + ln.wg, 128);
}

// the warpgroup's thread that issues its TMA stores
__device__ __forceinline__ bool store_thread() {
  return threadIdx.x % 128 == 0;
}

// ---------------------------------------------------------------- host --

constexpr int kMaxDevices = 64;

// the current device's SM count (queried once a device)
inline int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        n <= 0)
      return 132;
    cached[dev] = n;
  }
  return cached[dev];
}

// let `Kernel` take all of a block's shared memory (once a device);
// returns 0 or the cudaError_t of the refusal
template <auto Kernel>
inline int allow_smem() {
  static bool done[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev >= kMaxDevices) return -1;
  if (!done[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  return 0;
}

}  // namespace gemm90
