// Rotary embedding of q and k in one pass: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/fused_norm_rope.py (`rope_rotate`, under
// `fused_rope`).
//
// Replaces paddle_tpu/ops/pallas/fused_norm_rope.py `_rope_kernel` :45 /
// `_rope_call` :72. What it computes, as the TPU kernel does: for each
// token (b, t) at position p = positions[b, t], and each column j of a
// head of width Dh (half = Dh / 2),
//     inv_freq_j = exp(-log(theta) * (j mod half) / half)      (f32)
//     angle_j    = p * inv_freq_j
//     out[j]        = x[j] cos - x[j + half] sin     (j < half)
//     out[j + half] = x[j + half] cos + x[j] sin
// which is the TPU kernel's roll-based form x*cos + roll(x, half)*sign*sin
// written on the two halves. The backward is this kernel with -positions:
// the transpose of a rotation is the rotation by the negated angle.
//
// What bounds it. Bytes: q and k are read once and written once (42 MB
// for the 8B model at T = 2048 in bf16), a few flops per byte. One block
// per token computes that token's half angles once into shared memory and
// then rotates all H + Hkv heads with 16-byte vector loads and stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kVec = 8;
constexpr int kMaxHalf = 128;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rope_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const int* __restrict__ positions, T* __restrict__ oq,
                T* __restrict__ ok, int H, int Hkv, int Dh, float theta) {
  __shared__ float cs[kMaxHalf];
  __shared__ float sn[kMaxHalf];
  const size_t tok = blockIdx.x;   // b * T + t
  const int half = Dh / 2;
  const float pos = static_cast<float>(positions[tok]);
  // -log(theta) * exponent, rounded at the TPU kernel's points
  const float neg_log_theta = -logf(theta);
  for (int j = threadIdx.x; j < half; j += kThreads) {
    const float exponent = static_cast<float>(j) / static_cast<float>(half);
    const float ang = pos * expf(neg_log_theta * exponent);
    cs[j] = cosf(ang);
    sn[j] = sinf(ang);
  }
  __syncthreads();
  const int groups = half / kVec;            // vector groups per half head
  const int items = (H + Hkv) * groups;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int head = it / groups;
    const int j0 = (it % groups) * kVec;
    const T* src;
    T* dst;
    if (head < H) {
      const size_t base = (tok * H + head) * Dh;
      src = q + base;
      dst = oq + base;
    } else {
      const size_t base = (tok * Hkv + (head - H)) * Dh;
      src = k + base;
      dst = ok + base;
    }
    float lo[kVec], hi[kVec], olo[kVec], ohi[kVec];
    load8(src + j0, lo);
    load8(src + half + j0, hi);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float c = cs[j0 + i];
      const float s = sn[j0 + i];
      olo[i] = lo[i] * c + (-hi[i]) * s;
      ohi[i] = hi[i] * c + lo[i] * s;
    }
    store8(dst + j0, olo);
    store8(dst + half + j0, ohi);
  }
}

template <typename T>
int launch(const void* q, const void* k, const int* pos, void* oq, void* ok,
           int tokens, int H, int Hkv, int Dh, float theta,
           cudaStream_t stream) {
  rope_kernel<T><<<tokens, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), pos,
      static_cast<T*>(oq), static_cast<T*>(ok), H, Hkv, Dh, theta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, T, H, Dh], k [B, T, Hkv, Dh] (dtype 0 = float32, 1 = bfloat16),
// positions int32 [B, T]. Returns 0, a cudaError_t code when the launch
// was refused, or -1 for a shape or dtype the kernel is not built for.
extern "C" int paddle_rope(const void* q, const void* k,
                           const void* positions, void* oq, void* ok, int B,
                           int T, int H, int Hkv, int Dh, float theta,
                           int dtype, void* stream) {
  if (Dh % (2 * kVec) || Dh / 2 > kMaxHalf) return -1;
  auto s = static_cast<cudaStream_t>(stream);
  auto pos = static_cast<const int*>(positions);
  const int tokens = B * T;
  if (dtype == 0)
    return launch<float>(q, k, pos, oq, ok, tokens, H, Hkv, Dh, theta, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, pos, oq, ok, tokens, H, Hkv, Dh,
                                 theta, s);
  return -1;
}
