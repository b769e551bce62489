// Causal GQA flash attention, forward and backward: the Hopper kernels
// behind paddle_tpu_torch/ops/kernels/flash_attention.py
// (`flash_attention`).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_splash` :83 /
// `_splash_kernel` :60 (the splash forward, dq and dkv kernels).
//
// What it computes. q [B, T, H, Dh], k and v [B, S, Hkv, Dh], S >= T; the
// G = H / Hkv query heads of kv head h read it natively (no repeat). As
// splash does, q is pre-scaled by sm_scale and rounded to the input type;
// scores s = qs . k, the causal mask is aligned bottom-right (query row t
// sees keys 0 .. t + S - T), the softmax is f32. The forward writes o and
// lse = m + log(l), f32 [B, H, T]. The backward is FA2's algebra on the
// saved lse: p = exp(s - lse), dP = dO . v, dS = p (dP - delta) with
// delta = rowsum(dO o); dV = p^T dO, dK = dS^T qs, dq = sm_scale dS k.
//
// Determinism. No atomics: every output element is written once by one
// block, and every sum runs in an order fixed by the shapes alone.
//   * fwd: one block per (query tile of 64 rows, head, batch) walks the
//     visible 64-key tiles with an online softmax. Tiles that are fully
//     masked are never scheduled.
//   * dq: one block per (query tile, head, batch); it first computes delta
//     for its rows (the row pass) and writes it out, then walks the
//     visible key tiles and writes dq once.
//   * dkv: one block per (key tile, kv head, batch), launched after dq (it
//     reads delta); it loops over the G query heads and the query tiles
//     that see its keys, accumulates dK and dV in f32 registers and
//     writes them once. This is splash's separate dq / dkv split, not
//     FA2's atomic dq.
//
// What bounds it. Operations: at T = S = 2048 every tile of 64 x 64 x Dh
// is reused across 64 rows, far above the ~295 flops per byte at which
// the card stops being bound by memory. The products here run on FMA
// units in f32, 4 x 4 (scores) or 4 x 8 (outputs) per thread, with tiles
// kept in shared memory in the input type; wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16 threads, (ty, tx)
constexpr int kLdP = kTile + 4;    // f32 tile stride (16-byte rows)
constexpr float kMask = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// four consecutive elements of shared memory as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
  return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                     __bfloat162float(h[2]), __bfloat162float(h[3]));
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float* v) {
  uint2 raw;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __float2bfloat16_rn(v[i]);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <typename T, int DH>
struct Cfg {
  static constexpr int kLd = DH + 4;  // rows padded: conflict-free reads
  static constexpr size_t kTileBytes = size_t(kTile) * kLd * sizeof(T);
  static constexpr size_t kPBytes = size_t(kTile) * kLdP * sizeof(float);
  static constexpr int kGroups = DH / 64;   // float4 column groups a thread
  static constexpr int kCols = 4 * kGroups; // output columns a thread owns
};

// Copy `rows` rows (zero-filling up to 64) of width DH from global memory
// (row stride `gstride` elements) into a shared tile; with `scaled`, each
// element becomes round_T(x * scale), as splash pre-scales q.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t gstride, int rows,
                                          bool scaled, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      raw = *reinterpret_cast<const uint4*>(src + r * gstride + e);
    if (scaled) {
      T* vals = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        vals[u] = from_float<T>(to_float(vals[u]) * scale);
    }
    uint2* d = reinterpret_cast<uint2*>(dst + r * Cfg<T, DH>::kLd + e);
    d[0] = make_uint2(raw.x, raw.y);
    d[1] = make_uint2(raw.z, raw.w);
  }
}

// acc[i][j] += sum_d A[ty + 16 i][d] * B[tx + 16 j][d]   (64 x 64 tile)
template <typename T, int DH>
__device__ __forceinline__ void mma_nt(const T* A, const T* B,
                                       float acc[4][4], int ty, int tx) {
  constexpr int kLd = Cfg<T, DH>::kLd;
#pragma unroll 2
  for (int d = 0; d < DH; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = ld4(A + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ld4(B + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float part = a[i].x * b[j].x;
        part = fmaf(a[i].y, b[j].y, part);
        part = fmaf(a[i].z, b[j].z, part);
        part = fmaf(a[i].w, b[j].w, part);
        acc[i][j] += part;
      }
  }
}

// acc[i][4 g + c] += sum_k P[ty + 16 i][k] * B[k][4 (tx + 16 g) + c]
// P: f32 64 x 64 (stride kLdP); B: 64 x DH in the input type.
template <typename T, int DH>
__device__ __forceinline__ void mma_pv(const float* P, const T* B,
                                       float acc[4][Cfg<T, DH>::kCols],
                                       int ty, int tx) {
  constexpr int kLd = Cfg<T, DH>::kLd;
  constexpr int kGroups = Cfg<T, DH>::kGroups;
#pragma unroll 2
  for (int k = 0; k < kTile; k += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = ld4(P + (ty + 16 * i) * kLdP + k);
    float part[4][Cfg<T, DH>::kCols];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 v = ld4(B + (k + kk) * kLd + 4 * (tx + 16 * g));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pk = kk == 0 ? p[i].x : kk == 1 ? p[i].y
                         : kk == 2 ? p[i].z : p[i].w;
          float* o = part[i] + 4 * g;
          if (kk == 0) {
            o[0] = pk * v.x; o[1] = pk * v.y; o[2] = pk * v.z; o[3] = pk * v.w;
          } else {
            o[0] = fmaf(pk, v.x, o[0]); o[1] = fmaf(pk, v.y, o[1]);
            o[2] = fmaf(pk, v.z, o[2]); o[3] = fmaf(pk, v.w, o[3]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < Cfg<T, DH>::kCols; ++c) acc[i][c] += part[i][c];
  }
}

__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Shape {
  int T, S, H, Hkv;
  float scale;
  int causal;
  // last key query row t sees
  __device__ __forceinline__ int limit(int t) const {
    return causal ? t + (S - T) : S - 1;
  }
};

// ------------------------------------------------------------- forward --

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o,
                  float* __restrict__ lse, Shape sh) {
  using C = Cfg<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + C::kTileBytes);
  T* vs = reinterpret_cast<T*>(smem + 2 * C::kTileBytes);
  float* ps = reinterpret_cast<float*>(smem + 3 * C::kTileBytes);

  const int n_qt = gridDim.x;
  const int t0 = (n_qt - 1 - blockIdx.x) * kTile;  // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (sh.H / sh.Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_stride = size_t(sh.H) * DH;
  const size_t k_stride = size_t(sh.Hkv) * DH;
  const T* qb = q + (size_t(b) * sh.T * sh.H + h) * DH;
  const T* kb = k + (size_t(b) * sh.S * sh.Hkv + hk) * DH;
  const T* vb = v + (size_t(b) * sh.S * sh.Hkv + hk) * DH;

  load_tile<T, DH>(qs, qb + t0 * q_stride, q_stride, min(kTile, sh.T - t0),
                   true, sh.scale);
  const int t_last = min(t0 + kTile, sh.T) - 1;
  const int n_kt = min(sh.S - 1, sh.limit(t_last)) / kTile + 1;

  float m[4], l[4], acc[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMask;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int s0 = kt * kTile;
    const int rows = min(kTile, sh.S - s0);
    load_tile<T, DH>(ks, kb + s0 * k_stride, k_stride, rows, false, 1.f);
    load_tile<T, DH>(vs, vb + s0 * k_stride, k_stride, rows, false, 1.f);
    __syncthreads();
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    mma_nt<T, DH>(qs, ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lim = min(sh.S - 1, sh.limit(t0 + ty + 16 * i));
      float mx = kMask;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (s0 + tx + 16 * j > lim) s[i][j] = kMask;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            s0 + tx + 16 * j > lim ? 0.f : expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < C::kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mma_pv<T, DH>(ps, vs, acc, ty, tx);
    __syncthreads();  // the next tile overwrites ks, vs and ps
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= sh.T) continue;
    const float inv = 1.f / l[i];
    T* orow = o + (size_t(b) * sh.T + t) * q_stride + size_t(h) * DH;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = acc[i][4 * g + c] * inv;
      st4(orow + 4 * (tx + 16 * g), out);
    }
    if (tx == 0)
      lse[(size_t(b) * sh.H + h) * sh.T + t] = m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------------ dq --

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ o,
                     const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     float* __restrict__ delta, T* __restrict__ dq,
                     Shape sh) {
  using C = Cfg<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* dos = reinterpret_cast<T*>(smem + C::kTileBytes);
  T* ks = reinterpret_cast<T*>(smem + 2 * C::kTileBytes);
  T* vs = reinterpret_cast<T*>(smem + 3 * C::kTileBytes);
  float* dss = reinterpret_cast<float*>(smem + 4 * C::kTileBytes);
  float* lse_s = dss + kTile * kLdP;
  float* del_s = lse_s + kTile;

  const int n_qt = gridDim.x;
  const int t0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (sh.H / sh.Hkv);
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_stride = size_t(sh.H) * DH;
  const size_t k_stride = size_t(sh.Hkv) * DH;
  const size_t q_off = (size_t(b) * sh.T * sh.H + h) * DH;
  const T* kb = k + (size_t(b) * sh.S * sh.Hkv + hk) * DH;
  const T* vb = v + (size_t(b) * sh.S * sh.Hkv + hk) * DH;
  const size_t stat = (size_t(b) * sh.H + h) * sh.T;
  const int rows = min(kTile, sh.T - t0);

  load_tile<T, DH>(qs, q + q_off + t0 * q_stride, q_stride, rows, true,
                   sh.scale);
  load_tile<T, DH>(dos, dout + q_off + t0 * q_stride, q_stride, rows, false,
                   1.f);
  // the row pass: delta = rowsum(dO o), four threads a row
  {
    const int r = threadIdx.x / 4;
    const int part = threadIdx.x % 4;
    float d = 0.f;
    if (r < rows) {
      const T* orow = o + q_off + (t0 + r) * q_stride;
      const T* drow = dout + q_off + (t0 + r) * q_stride;
      for (int e = part * (DH / 4); e < (part + 1) * (DH / 4); e += 4) {
        const float4 a = ld4(orow + e);
        const float4 g = ld4(drow + e);
        d = fmaf(a.x, g.x, d);
        d = fmaf(a.y, g.y, d);
        d = fmaf(a.z, g.z, d);
        d = fmaf(a.w, g.w, d);
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (part == 0) {
      del_s[r] = d;
      lse_s[r] = r < rows ? lse[stat + t0 + r] : 0.f;
      if (r < rows) delta[stat + t0 + r] = d;
    }
  }
  __syncthreads();

  float lse_r[4], del_r[4], acc[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse_r[i] = lse_s[ty + 16 * i];
    del_r[i] = del_s[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) acc[i][c] = 0.f;
  }
  const int t_last = t0 + rows - 1;
  const int n_kt = min(sh.S - 1, sh.limit(t_last)) / kTile + 1;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s0 = kt * kTile;
    const int krows = min(kTile, sh.S - s0);
    load_tile<T, DH>(ks, kb + s0 * k_stride, k_stride, krows, false, 1.f);
    load_tile<T, DH>(vs, vb + s0 * k_stride, k_stride, krows, false, 1.f);
    __syncthreads();
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    mma_nt<T, DH>(qs, ks, s, ty, tx);
    mma_nt<T, DH>(dos, vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty + 16 * i;
      const int lim = t < sh.T ? min(sh.S - 1, sh.limit(t)) : -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p =
            s0 + tx + 16 * j > lim ? 0.f : expf(s[i][j] - lse_r[i]);
        dss[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - del_r[i]);
      }
    }
    __syncthreads();
    mma_pv<T, DH>(dss, ks, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= sh.T) continue;
    T* row = dq + q_off + t * q_stride;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      float out[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) out[c] = acc[i][4 * g + c] * sh.scale;
      st4(row + 4 * (tx + 16 * g), out);
    }
  }
}

// ----------------------------------------------------------------- dkv --

template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
    fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, Shape sh) {
  using C = Cfg<T, DH>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + C::kTileBytes);
  T* qs = reinterpret_cast<T*>(smem + 2 * C::kTileBytes);
  T* dos = reinterpret_cast<T*>(smem + 3 * C::kTileBytes);
  float* pts = reinterpret_cast<float*>(smem + 4 * C::kTileBytes);
  float* dsts = pts + kTile * kLdP;
  float* lse_s = dsts + kTile * kLdP;
  float* del_s = lse_s + kTile;

  const int s0 = blockIdx.x * kTile;  // key tiles seen by most rows first
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = sh.H / sh.Hkv;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;
  const size_t q_stride = size_t(sh.H) * DH;
  const size_t k_stride = size_t(sh.Hkv) * DH;
  const size_t k_off = (size_t(b) * sh.S * sh.Hkv + hk) * DH;
  const int krows = min(kTile, sh.S - s0);

  load_tile<T, DH>(ks, k + k_off + s0 * k_stride, k_stride, krows, false,
                   1.f);
  load_tile<T, DH>(vs, v + k_off + s0 * k_stride, k_stride, krows, false,
                   1.f);

  float dk_acc[4][C::kCols], dv_acc[4][C::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < C::kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // the first query row that sees key s0
  const int t_first = sh.causal ? max(0, s0 - (sh.S - sh.T)) : 0;
  const int n_qt = (sh.T + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t q_off = (size_t(b) * sh.T * sh.H + h) * DH;
    const size_t stat = (size_t(b) * sh.H + h) * sh.T;
    for (int qt = t_first / kTile; qt < n_qt; ++qt) {
      const int t0 = qt * kTile;
      const int rows = min(kTile, sh.T - t0);
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, DH>(qs, q + q_off + t0 * q_stride, q_stride, rows, true,
                       sh.scale);
      load_tile<T, DH>(dos, dout + q_off + t0 * q_stride, q_stride, rows,
                       false, 1.f);
      if (threadIdx.x < kTile) {
        const int r = threadIdx.x;
        lse_s[r] = r < rows ? lse[stat + t0 + r] : 0.f;
        del_s[r] = r < rows ? delta[stat + t0 + r] : 0.f;
      }
      __syncthreads();
      float st[4][4], dpt[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
      mma_nt<T, DH>(ks, qs, st, ty, tx);    // [key][query]
      mma_nt<T, DH>(vs, dos, dpt, ty, tx);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const int t = t0 + r;
        const int lim = t < sh.T ? min(sh.S - 1, sh.limit(t)) : -1;
        const float lse_t = lse_s[r];
        const float del_t = del_s[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p =
              s0 + ty + 16 * i > lim ? 0.f : expf(st[i][j] - lse_t);
          pts[(ty + 16 * i) * kLdP + r] = p;
          dsts[(ty + 16 * i) * kLdP + r] = p * (dpt[i][j] - del_t);
        }
      }
      __syncthreads();
      mma_pv<T, DH>(pts, dos, dv_acc, ty, tx);
      mma_pv<T, DH>(dsts, qs, dk_acc, ty, tx);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty + 16 * i;
    if (s >= sh.S) continue;
    T* krow = dk + k_off + s * k_stride;
    T* vrow = dv + k_off + s * k_stride;
#pragma unroll
    for (int g = 0; g < C::kGroups; ++g) {
      st4(krow + 4 * (tx + 16 * g), dk_acc[i] + 4 * g);
      st4(vrow + 4 * (tx + 16 * g), dv_acc[i] + 4 * g);
    }
  }
}

// ------------------------------------------------------------ launches --

struct Args {
  const void *q, *k, *v, *o, *dout, *lse, *delta;
  void *out0, *out1;
  int B, T, S, H, Hkv, Dh;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename Kern>
int launch(Kern kernel, dim3 grid, size_t bytes, cudaStream_t stream,
           void** params) {
  const void* fn = (const void*)kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(fn, grid, dim3(kThreads), params, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH>
int run(int which, const Args& a) {
  using C = Cfg<T, DH>;
  Shape sh{a.T, a.S, a.H, a.Hkv, a.scale, a.causal};
  const int n_qt = (a.T + kTile - 1) / kTile;
  const int n_kt = (a.S + kTile - 1) / kTile;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* o = static_cast<const T*>(a.o);
  const T* dout = static_cast<const T*>(a.dout);
  const float* lse = static_cast<const float*>(a.lse);
  if (which == 0) {
    T* out = static_cast<T*>(a.out0);
    float* lse_out = static_cast<float*>(a.out1);
    void* params[] = {&q, &k, &v, &out, &lse_out, &sh};
    return launch(fa_fwd_kernel<T, DH>, dim3(n_qt, a.H, a.B),
                  3 * C::kTileBytes + C::kPBytes, a.stream, params);
  }
  if (which == 1) {
    float* delta = const_cast<float*>(static_cast<const float*>(a.delta));
    T* dq = static_cast<T*>(a.out0);
    void* params[] = {&q, &k, &v, &o, &dout, &lse, &delta, &dq, &sh};
    return launch(fa_bwd_dq_kernel<T, DH>, dim3(n_qt, a.H, a.B),
                  4 * C::kTileBytes + C::kPBytes + 2 * kTile * sizeof(float),
                  a.stream, params);
  }
  const float* delta = static_cast<const float*>(a.delta);
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
  void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &sh};
  return launch(fa_bwd_dkv_kernel<T, DH>, dim3(n_kt, a.Hkv, a.B),
                4 * C::kTileBytes + 2 * C::kPBytes +
                    2 * kTile * sizeof(float),
                a.stream, params);
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.Hkv <= 0 || a.H % a.Hkv || a.T <= 0 || a.S < a.T) return -1;
  if (dtype == 0 && a.Dh == 64) return run<float, 64>(which, a);
  if (dtype == 0 && a.Dh == 128) return run<float, 128>(which, a);
  if (dtype == 1 && a.Dh == 64) return run<__nv_bfloat16, 64>(which, a);
  if (dtype == 1 && a.Dh == 128) return run<__nv_bfloat16, 128>(which, a);
  return -1;
}

}  // namespace

// All three return 0, a cudaError_t code when the launch was refused, or
// -1 for what the kernels are not built for (dtype 0 = float32,
// 1 = bfloat16; Dh 64 or 128; S >= T; H a multiple of Hkv). They launch on
// `stream`, never synchronise and allocate nothing. lse and delta are f32
// [B, H, T].
extern "C" int paddle_flash_fwd(const void* q, const void* k, const void* v,
                                void* o, void* lse, int B, int T, int S,
                                int H, int Hkv, int Dh, float scale,
                                int causal, int dtype, void* stream) {
  const Args a{q,  k,  v, nullptr, nullptr, nullptr, nullptr, o,     lse,
               B,  T,  S, H,       Hkv,     Dh,      scale,   causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(0, dtype, a);
}

// Writes delta = rowsum(dO o) for the dkv launch, which must follow it.
extern "C" int paddle_flash_bwd_dq(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const void* lse,
                                   void* delta, void* dq, int B, int T,
                                   int S, int H, int Hkv, int Dh,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  const Args a{q, k,   v,   o,  dout,  lse, delta,  dq,
               nullptr, B, T, S, H, Hkv, Dh, scale, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch(1, dtype, a);
}

extern "C" int paddle_flash_bwd_dkv(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dk, void* dv, int B, int T, int S,
                                    int H, int Hkv, int Dh, float scale,
                                    int causal, int dtype, void* stream) {
  const Args a{q,  k,  v, nullptr, dout, lse,   delta,  dk,
               dv, B,  T, S,       H,    Hkv,   Dh,     scale,
               causal, static_cast<cudaStream_t>(stream)};
  return dispatch(2, dtype, a);
}
