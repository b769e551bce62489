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
// dw. The TPU kernel adds each row tile's dw into one output block across
// its sequential grid. Blocks here run in parallel and in no order, and
// atomics would make dw's bits depend on that order. So the backward
// block b takes the fixed rows [b*kChunk, (b+1)*kChunk) and writes their
// f32 column sums to partial[b, :]; a second kernel sums partial[:, d]
// in chunk order. dw is the same bits from run to run.
//
// What bounds it. Bytes: one read of x (and g) and one write of y (dx),
// about one flop per byte, so the least time is those bytes over the
// card's 3.35 TB/s. Rows are read with 16-byte vector loads; a row of the
// 8B model (4096 bf16, 8 KB) is read twice by its block, the second time
// from L1/L2. Reductions run in a fixed order (thread, warp tree, warps in
// order), so every output is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 16;    // rows per dw partial (RMS_DW_CHUNK)
constexpr int kVec = 8;       // elements per vector step

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

// Block b: rows [b*kChunk, min(N, (b+1)*kChunk)); dx for each, and the
// chunk's dw column sums into partial[b, :]. Thread t owns the columns
// {t*kVec + j*kThreads*kVec + i}, at most kMaxCols of them.
template <typename T, int kMaxCols>
__global__ void __launch_bounds__(kThreads)
    rms_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ rstd, const T* __restrict__ g,
                   T* __restrict__ dx, float* __restrict__ partial, int N,
                   int D) {
  __shared__ float red[kWarps];
  constexpr int kSteps = kMaxCols / kVec;
  float dw[kMaxCols];
#pragma unroll
  for (int i = 0; i < kMaxCols; ++i) dw[i] = 0.f;
  const int r0 = blockIdx.x * kChunk;
  const int r1 = min(N, r0 + kChunk);
  for (int row = r0; row < r1; ++row) {
    const size_t off = static_cast<size_t>(row) * D;
    const float r = rstd[row];
    float dot = 0.f;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = (threadIdx.x + s * kThreads) * kVec;
      if (c < D) {
        float xv[kVec], gv[kVec], wv[kVec];
        load8(x + off + c, xv);
        load8(g + off + c, gv);
        load8(w + c, wv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const float xhat = xv[i] * r;
          dot = fmaf(gv[i] * wv[i], xhat, dot);
          dw[s * kVec + i] = fmaf(gv[i], xhat, dw[s * kVec + i]);
        }
      }
    }
    const float mean = block_sum(dot, red) / D;
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int c = (threadIdx.x + s * kThreads) * kVec;
      if (c < D) {
        float xv[kVec], gv[kVec], wv[kVec], out[kVec];
        load8(x + off + c, xv);
        load8(g + off + c, gv);
        load8(w + c, wv);
#pragma unroll
        for (int i = 0; i < kVec; ++i)
          out[i] = (gv[i] * wv[i] - xv[i] * r * mean) * r;
        store8(dx + off + c, out);
      }
    }
  }
  float* pr = partial + static_cast<size_t>(blockIdx.x) * D;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = (threadIdx.x + s * kThreads) * kVec;
    if (c < D) store8(pr + c, dw + s * kVec);
  }
}

// dw[d] = sum over chunks, in chunk order, of partial[chunk, d].
__global__ void __launch_bounds__(kThreads)
    rms_dw_sum_kernel(const float* __restrict__ partial,
                      float* __restrict__ dw, int chunks, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[static_cast<size_t>(c) * D + d];
  dw[d] = s;
}

template <typename T>
int fwd(const void* x, const void* w, void* y, float* rstd, int N, int D,
        float eps, cudaStream_t stream) {
  rms_fwd_kernel<T><<<N, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rstd, D, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int kMaxCols>
int bwd_cols(const void* x, const void* w, const float* rstd, const void* g,
             void* dx, float* partial, float* dw, int N, int D,
             cudaStream_t stream) {
  const int chunks = (N + kChunk - 1) / kChunk;
  if (chunks > 0) {
    rms_bwd_kernel<T, kMaxCols><<<chunks, kThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), rstd,
        static_cast<const T*>(g), static_cast<T*>(dx), partial, N, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rms_dw_sum_kernel<<<(D + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dw, chunks, D);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int bwd(const void* x, const void* w, const float* rstd, const void* g,
        void* dx, float* partial, float* dw, int N, int D,
        cudaStream_t stream) {
  // each thread keeps its columns' dw sums in registers: up to 16 (D <=
  // 4096) or 32 (D <= 8192) of them
  if (D <= 2 * kThreads * kVec)
    return bwd_cols<T, 16>(x, w, rstd, g, dx, partial, dw, N, D, stream);
  if (D <= 4 * kThreads * kVec)
    return bwd_cols<T, 32>(x, w, rstd, g, dx, partial, dw, N, D, stream);
  return -1;
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

// partial: f32 [ceil(N / 16), D] scratch; dw: f32 [D].
extern "C" int paddle_rms_norm_bwd(const void* x, const void* w,
                                   const void* rstd, const void* g, void* dx,
                                   void* partial, void* dw, int N, int D,
                                   int dtype, void* stream) {
  if (D % kVec) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto r = static_cast<const float*>(rstd);
  auto p = static_cast<float*>(partial);
  auto o = static_cast<float*>(dw);
  if (dtype == 0) return bwd<float>(x, w, r, g, dx, p, o, N, D, s);
  if (dtype == 1) return bwd<__nv_bfloat16>(x, w, r, g, dx, p, o, N, D, s);
  return -1;
}
