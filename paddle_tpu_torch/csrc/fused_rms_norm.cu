// RMSNorm forward and backward for the train step: the Hopper kernels
// behind paddle_tpu_torch/ops/kernels/fused_norm_rope.py
// (`rms_norm_fwd`, `rms_norm_bwd`, under `fused_rms_norm`).
//
// Replaces paddle_tpu/ops/pallas/fused_norm_rope.py:
//   * `_rms_fwd_kernel` :127 / `_rms_fwd_call` :156:
//       y = x * rstd * w, rstd = 1 / sqrt(mean(x^2) + eps), in f32;
//       rstd [N, 1] f32 is written for the backward;
//   * `_rms_bwd_kernel` :136 / `_rms_bwd_call` :179:
//       dx = (g*w - xhat * mean(g*w*xhat)) * rstd, xhat = x * rstd;
//       dw = sum over rows of g * xhat, in f32.
//
// What bounds them. Bytes: one read of x (and g) and one write of y (dx),
// about one flop per byte, so the least time is those bytes over the
// card's 3.35 TB/s. Every reduction runs in a fixed order, so every
// output is deterministic.
//
// Forward: a 256-thread block a row, 16-byte vector loads, the row's sum
// of squares through a block reduction.
//
// Backward. A row is taken by a group of kG warps, kG = ceil(row bytes /
// 2 KB): a lane takes 4 pieces of 16 bytes of x and 4 of g (32 bf16 or 16
// f32 values), piece p of lane l of the group at column (p * 32 kG + l) *
// (16 / sizeof(T)), so a warp's loads are contiguous. A block is 16 warps,
// 16 / kG groups (bf16 D 4096: 4 groups of 4 warps), so several rows are
// in flight a block. Each thread copies its own pieces of the group's
// rows with cp.async into a 2-stage ring in shared memory, one row ahead
// of the one it works on, and reads back only what it copied: no thread
// waits for another's copies. The two passes over a row (the dot, then
// dx) read the ring, never L1/L2. The row's dot is reduced by warp
// shuffles and, for kG > 1, through shared memory behind one named
// barrier of the group's warps, in a fixed order. dx of a row depends on
// the row and D alone, whatever N. (1-D bulk copies on an mbarrier ring,
// and 3 or more stages, measured no faster on an H100.)
//
// dw. The TPU kernel adds each row tile's dw into one output block across
// its sequential grid; blocks here run in parallel and in no order, and
// atomics would make dw's bits depend on that order. The rows split into
// fixed chunks of kChunk rows, one block a chunk; the group of a row is
// fixed by its place in the chunk (row r0 + q + k * groups to group q).
// Each thread sums g * xhat over its group's rows in registers, the groups
// add their sums in group order through shared memory, and the block
// writes the chunk's f32 column sums to partial[chunk, :]. A second
// launch sums the partials without a serial tail: a block takes 32
// columns, its 8 warps each a fixed run of consecutive chunks, and the 8
// runs' sums are added in order. dw has the same bits from run to run.
// The second launch is a programmatic dependent launch: it is scheduled
// while the first one's last blocks run and waits at
// `griddepcontrol.wait` until their partials are written.

#include "hopper.cuh"

namespace {

using hopper::smem_u32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;       // elements per vector step

// backward
constexpr int kChunk = 16;      // rows per dw partial (RMS_DW_CHUNK)
constexpr int kBwdWarps = 16;   // warps a block
constexpr int kPieces = 4;      // 16-byte pieces a lane takes of x (and g)
constexpr int kWarpBytes = 32 * kPieces * 16;  // bytes of a row a warp takes
constexpr int kStages = 2;      // rows a group holds: this one, one ahead
constexpr int kMaxD = 8192;
// the groups' rings: kStages x (x row, g row) each, at most 64 KB a stage
// (a block's own static shared memory comes on top, so not the card's
// whole 227 KB)
constexpr int kSmemMax = kStages * 2 * kBwdWarps * kWarpBytes;
constexpr int kSumCols = 32;    // columns a dw-sum block takes
constexpr int kSumRuns = 8;     // runs of chunks a dw-sum block adds

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// Sum of `v` over the block, in a fixed order; every thread gets it.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[w];
  __syncthreads();  // red is reused by the next call
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rms_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   T* __restrict__ y, float* __restrict__ rstd, int D,
                   float eps) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const T* xr = x + row * D;
  T* yr = y + row * D;
  float ss = 0.f;
  for (int c = threadIdx.x * kVec; c < D; c += kThreads * kVec) {
    float v[kVec];
    load8(xr + c, v);
#pragma unroll
    for (int i = 0; i < kVec; ++i) ss = fmaf(v[i], v[i], ss);
  }
  const float r = 1.f / sqrtf(block_sum(ss, red) / D + eps);
  if (threadIdx.x == 0) rstd[row] = r;
  for (int c = threadIdx.x * kVec; c < D; c += kThreads * kVec) {
    float v[kVec], wv[kVec];
    load8(xr + c, v);
    load8(w + c, wv);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = v[i] * r * wv[i];
    store8(yr + c, v);
  }
}

// ------------------------------------------------------------ backward --

// A 16-byte piece: 4 f32 or 8 bf16 values, widened to f32 and back.
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  static constexpr int kN = 4;
  __device__ static void widen(const uint4& r, float* v) {
    v[0] = __uint_as_float(r.x);
    v[1] = __uint_as_float(r.y);
    v[2] = __uint_as_float(r.z);
    v[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 narrow(const float* v) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                      __float_as_uint(v[2]), __float_as_uint(v[3]));
  }
};
template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void widen(const uint4& r, float* v) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 narrow(const float* v) {
    uint4 r;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    return r;
  }
};

// 16 bytes from global to shared memory, bypassing L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Block b: the chunk rows [b*kChunk, min(N, (b+1)*kChunk)); dx of each,
// and the chunk's dw column sums into partial[b, :]. kG warps a row,
// blockDim.x / (32 kG) groups; dynamic shared memory: the groups' rings,
// kStages x (x row, g row) each, reused for the groups' dw at the end.
template <typename T>
__global__ void __launch_bounds__(kBwdWarps * 32, 1)
    rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ partial, int N,
                   int D, int kG) {
  using P = Piece<T>;
  constexpr int kN = P::kN;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float red[2][kBwdWarps];
  __shared__ float rs[kChunk];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int L = kG * 32;                  // threads a row
  const int groups = blockDim.x / L;
  const int q = warp / kG;                // this thread's group
  const int gl = threadIdx.x - q * L;     // its place in the group
  const int r0 = blockIdx.x * kChunk;
  const int rows = min(N - r0, kChunk);
  // rows of group q: r0 + q + k * groups, k < mine
  const int mine = rows > q ? (rows - q + groups - 1) / groups : 0;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  unsigned char* ring = smem + static_cast<size_t>(q) * kStages * 2 * row_bytes;

  // row k of the group into stage k % kStages: this thread's own pieces,
  // which only it reads, so no other thread waits for them
  auto issue = [&](int k) {
    const size_t off = static_cast<size_t>(r0 + q + k * groups) * D;
    unsigned char* st = ring + (k % kStages) * 2 * row_bytes;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int c = (p * L + gl) * kN;
      if (c < D) {
        cp_async16(st + c * sizeof(T), x + off + c);
        cp_async16(st + row_bytes + c * sizeof(T), g + off + c);
      }
    }
  };
  // the first rows go out before anything else is read
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < mine) issue(k);
    cp_async_commit();
  }

  uint4 wr[kPieces];
  float dw[kPieces * kN];
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = (p * L + gl) * kN;
    wr[p] = c < D ? *reinterpret_cast<const uint4*>(w + c)
                  : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < kPieces * kN; ++i) dw[i] = 0.f;
  if (threadIdx.x < rows) rs[threadIdx.x] = rstd[r0 + threadIdx.x];
  __syncthreads();

  for (int k = 0; k < mine; ++k) {
    // the stage refilled here is the one this thread read in the row
    // before
    if (k + kStages - 1 < mine) issue(k + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    const unsigned char* st = ring + (k % kStages) * 2 * row_bytes;
    const float r = rs[q + k * groups];
    float dot = 0.f;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int c = (p * L + gl) * kN;
      if (c < D) {
        float xv[kN], gv[kN], wv[kN];
        P::widen(*reinterpret_cast<const uint4*>(st + c * sizeof(T)), xv);
        P::widen(*reinterpret_cast<const uint4*>(st + row_bytes +
                                                 c * sizeof(T)),
                 gv);
        P::widen(wr[p], wv);
#pragma unroll
        for (int i = 0; i < kN; ++i) {
          const float xhat = xv[i] * r;
          dot = fmaf(gv[i] * wv[i], xhat, dot);
          dw[p * kN + i] = fmaf(gv[i], xhat, dw[p * kN + i]);
        }
      }
    }
    dot = warp_sum(dot);
    if (kG > 1) {
      // rows alternate between two slots: a slot is written again two
      // rows on, after the next barrier, which every reader has passed
      if (lane == 0) red[k & 1][warp] = dot;
      hopper::bar_sync(1 + q, L);
      dot = 0.f;
      for (int i = 0; i < kG; ++i) dot += red[k & 1][q * kG + i];
    }
    const float mean = dot / D;
    T* out = dx + static_cast<size_t>(r0 + q + k * groups) * D;
#pragma unroll
    for (int p = 0; p < kPieces; ++p) {
      const int c = (p * L + gl) * kN;
      if (c < D) {
        float xv[kN], gv[kN], wv[kN], o[kN];
        P::widen(*reinterpret_cast<const uint4*>(st + c * sizeof(T)), xv);
        P::widen(*reinterpret_cast<const uint4*>(st + row_bytes +
                                                 c * sizeof(T)),
                 gv);
        P::widen(wr[p], wv);
#pragma unroll
        for (int i = 0; i < kN; ++i)
          o[i] = (gv[i] * wv[i] - xv[i] * r * mean) * r;
        __stcs(reinterpret_cast<uint4*>(out + c), P::narrow(o));
      }
    }
  }
  // the dw sums follow; let the dependent launch be scheduled
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  cp_async_wait<0>();
  __syncthreads();  // the rings are read: they take the groups' dw now
  float* comb = reinterpret_cast<float*>(smem);  // [groups][D]
#pragma unroll
  for (int p = 0; p < kPieces; ++p) {
    const int c = (p * L + gl) * kN;
    if (c < D) {
#pragma unroll
      for (int i = 0; i < kN; i += 4)
        *reinterpret_cast<float4*>(comb + q * D + c + i) =
            make_float4(dw[p * kN + i], dw[p * kN + i + 1],
                        dw[p * kN + i + 2], dw[p * kN + i + 3]);
    }
  }
  __syncthreads();
  float* pr = partial + static_cast<size_t>(blockIdx.x) * D;
  for (int c = threadIdx.x * 4; c < D; c += blockDim.x * 4) {
    float4 s = *reinterpret_cast<const float4*>(comb + c);
    for (int j = 1; j < groups; ++j) {
      const float4 t = *reinterpret_cast<const float4*>(comb + j * D + c);
      s.x += t.x;
      s.y += t.y;
      s.z += t.z;
      s.w += t.w;
    }
    *reinterpret_cast<float4*>(pr + c) = s;
  }
}

// dw[d] = the sum of partial[:, d]: warp j adds the consecutive chunks
// [j * per, (j + 1) * per) in order, then the 8 runs are added in order.
__global__ void __launch_bounds__(kSumCols * kSumRuns)
    rms_dw_sum_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int chunks, int D) {
  __shared__ float run[kSumRuns][kSumCols];
  // the partials are the previous launch's: wait until they are written
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int lane = threadIdx.x & 31, j = threadIdx.x >> 5;
  const int d = blockIdx.x * kSumCols + lane;
  const int per = (chunks + kSumRuns - 1) / kSumRuns;
  const int c1 = min(chunks, (j + 1) * per);
  float s = 0.f;
  if (d < D) {
#pragma unroll 16
    for (int c = j * per; c < c1; ++c)
      s += partial[static_cast<size_t>(c) * D + d];
  }
  run[j][lane] = s;
  __syncthreads();
  if (j == 0 && d < D) {
    float t = run[0][lane];
#pragma unroll
    for (int i = 1; i < kSumRuns; ++i) t += run[i][lane];
    dw[d] = t;
  }
}

template <typename T>
int fwd(const void* x, const void* w, void* y, float* rstd, int N, int D,
        float eps, cudaStream_t stream) {
  rms_fwd_kernel<T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rstd, D, eps);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// let `Kernel` take kSmemMax bytes of dynamic shared memory (once a
// device); returns 0 or the cudaError_t of the refusal
template <auto Kernel>
int allow_smem() {
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

template <typename T>
int bwd(const void* x, const void* w, const float* rstd, const void* g,
        void* dx, float* partial, float* dw, int N, int D,
        cudaStream_t stream) {
  const int kG = (D * static_cast<int>(sizeof(T)) + kWarpBytes - 1) /
                 kWarpBytes;
  const int groups = kBwdWarps / kG;
  const int chunks = (N + kChunk - 1) / kChunk;
  if (chunks > 0) {
    constexpr auto kernel = rms_bwd_kernel<T>;
    const int err = allow_smem<kernel>();
    if (err != 0) return err;
    const size_t bytes =
        static_cast<size_t>(kStages) * groups * 2 * D * sizeof(T);
    kernel<<<chunks, groups * kG * 32, bytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), rstd,
        static_cast<const T*>(g), static_cast<T*>(dx), partial, N, D, kG);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((D + kSumCols - 1) / kSumCols);
  cfg.blockDim = dim3(kSumCols * kSumRuns);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, rms_dw_sum_kernel, static_cast<const float*>(partial), dw,
      chunks, D);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and y share it). Returns 0, a
// cudaError_t code when a launch was refused, or -1 for what the kernel is
// not built for. Launches on `stream`; never synchronises.
extern "C" int paddle_rms_norm_fwd(const void* x, const void* w, void* y,
                                   void* rstd, int N, int D, float eps,
                                   int dtype, void* stream) {
  if (D % kVec) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<float*>(rstd);
  if (dtype == 0) return fwd<float>(x, w, y, r, N, D, eps, s);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, w, y, r, N, D, eps, s);
  return -1;
}

// partial: f32 [max(ceil(N / 16), 1), D] scratch; dw: f32 [D]. x, w, g
// and dx 16-byte aligned; 0 < D <= 8192, D % 8 == 0.
extern "C" int paddle_rms_norm_bwd(const void* x, const void* w,
                                   const void* rstd, const void* g, void* dx,
                                   void* partial, void* dw, int N, int D,
                                   int dtype, void* stream) {
  if (D <= 0 || D % kVec || D > kMaxD || N < 0) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rstd);
  auto p = static_cast<float*>(partial);
  auto o = static_cast<float*>(dw);
  if (dtype == 0) return bwd<float>(x, w, r, g, dx, p, o, N, D, s);
  if (dtype == 1) return bwd<__nv_bfloat16>(x, w, r, g, dx, p, o, N, D, s);
  return -1;
}
