// Causal GQA flash attention, forward and backward: the Hopper kernels
// behind paddle_tpu_torch/ops/kernels/flash_attention.py
// (`flash_attention`).
//
// Replaces paddle_tpu/ops/pallas/flash_attention.py `_splash` :83 /
// `_splash_kernel` :60 (the splash forward, dq and dkv kernels).
//
// What it computes. q [B, T, H, Dh], k and v [B, S, Hkv, Dh], S >= T; the
// G = H / Hkv query heads of kv head h read it natively (no repeat). As
// splash does, q arrives pre-scaled by sm_scale and rounded to the input
// type (the wrapper does it, one elementwise op); scores s = qs . k, the
// causal mask is aligned bottom-right (query row t sees keys
// 0 .. t + S - T), the softmax is f32. The forward writes o and
// lse = m + log(l), f32 [B, H, T]. The backward is FA2's algebra on the
// saved lse: p = exp(s - lse), dP = dO . v, dS = p (dP - delta) with
// delta = rowsum(dO o); dV = p^T dO, dK = dS^T qs, dq = sm_scale dS k.
//
// Determinism. No atomics: every output element is written once by one
// block, and every sum runs in an order fixed by the shapes alone. Fully
// masked tiles are never scheduled.
//   * fwd: one block per (query rows, head, batch) walks the visible
//     64-key tiles with an online softmax, longest rows first.
//   * dq: one block per (query rows, head, batch); it first computes delta
//     for its rows (the row pass) and writes it out, then walks the
//     visible key tiles and writes dq once.
//   * dkv: one block per (64 keys, kv head, batch), launched after dq (it
//     reads delta); it loops over the G query heads and the query tiles
//     that see its keys, accumulates dK and dV in f32 registers and
//     writes them once. This is splash's separate dq / dkv split, not
//     FA2's atomic dq.
//
// What bounds it. Operations: at T = S = 2048 every tile of 64 x 64 x Dh
// is reused across 64 rows, far above the ~295 flops per byte at which
// the card stops being bound by memory; only the tensor cores reach the
// card's rate.
//
// bf16 (every main path): wgmma and TMA, FA3's shape kept simple. 384
// threads a block: two consumer warpgroups (64 rows or, in dkv, 64 keys
// each) and a producer warpgroup, one thread of which issues every TMA
// copy into 128-byte-swizzled tiles; setmaxnreg hands the producer's
// registers to the consumers (40 / 232 a thread: at the 168 that 384
// threads get otherwise, dq and dkv spilled). Stages are handed over
// with full / empty mbarriers, so the next tiles' copies are in flight
// while the current one computes. Every product is a wgmma m64n64k16 of
// one of two forms (hopper.cuh): both operands K-major in shared memory
// (S = Qs K^T, dP = dO V^T, and in dkv S^T = K Qs^T, dP^T = V dO^T), or
// A from registers, straight from the previous accumulator, and B
// MN-major in shared memory with the transpose bit (O += P V,
// dq += dS K, dV += P^T dO, dK += dS^T Qs). The softmax runs in
// registers on the accumulator layout (row max and sum over a quad).
// P and dS are f32: each goes into its product as hi = bf16(x) plus
// lo = bf16(x - hi), two wgmmas on the same B, which keeps the outputs
// within an ulp of the exact evaluation (one bf16 each would not, on
// dq). In dkv warpgroup 0 computes S^T and dV, warpgroup 1 S^T, dP^T
// and dK, so that each holds one 64 x Dh f32 accumulator. Products run:
// forward 3 for the minimal 2 (1.5x), backward 11 for 7 (dq 4 for 3,
// dkv 7 for 4). Later work: a persistent schedule, overlapping one
// warpgroup's softmax with its own next products, TMA stores.
//
// f32 (the precision checks' path, no main path): the FMA kernels, 4 x 4
// (scores) or 4 x 8 (outputs) products a thread, tiles kept in shared
// memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16 threads, (ty, tx)
constexpr int kLdP = kTile + 4;    // f32 tile stride (16-byte rows)
constexpr float kMask = -1e30f;

// four consecutive elements of shared memory as f32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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
// (row stride `gstride` elements) into a shared tile.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          size_t gstride, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DH / kVec;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int e = (c % kChunks) * kVec;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows)
      raw = *reinterpret_cast<const uint4*>(src + r * gstride + e);
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

  load_tile<T, DH>(qs, qb + t0 * q_stride, q_stride, min(kTile, sh.T - t0));
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
    load_tile<T, DH>(ks, kb + s0 * k_stride, k_stride, rows);
    load_tile<T, DH>(vs, vb + s0 * k_stride, k_stride, rows);
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

  load_tile<T, DH>(qs, q + q_off + t0 * q_stride, q_stride, rows);
  load_tile<T, DH>(dos, dout + q_off + t0 * q_stride, q_stride, rows);
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
    load_tile<T, DH>(ks, kb + s0 * k_stride, k_stride, krows);
    load_tile<T, DH>(vs, vb + s0 * k_stride, k_stride, krows);
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

  load_tile<T, DH>(ks, k + k_off + s0 * k_stride, k_stride, krows);
  load_tile<T, DH>(vs, v + k_off + s0 * k_stride, k_stride, krows);

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
      load_tile<T, DH>(qs, q + q_off + t0 * q_stride, q_stride, rows);
      load_tile<T, DH>(dos, dout + q_off + t0 * q_stride, q_stride, rows);
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

// ------------------------------------------- bf16: wgmma + TMA kernels --

using bf16 = __nv_bfloat16;
using hopper::kPanelBytes;

constexpr int kRows = 64;                     // rows a warpgroup, keys a tile
constexpr int kConsumers = 256;               // two consumer warpgroups
constexpr int kThreadsTC = kConsumers + 128;  // and a producer warpgroup
// registers a thread: 40 x 128 + 232 x 256 fit the SM's 65536
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kStages = 3;                    // depth of the streamed ring
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tile {
  static constexpr int kPanels = DH / 64;
  static constexpr int kBytes = kPanels * kPanelBytes;  // 64 rows x DH
  static constexpr int kAcc = 32 * kPanels;  // f32 output registers a thread
};

// the first 1024-byte boundary at or after p (the swizzle atom of a panel)
__device__ __forceinline__ unsigned char* align_1k(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 1023u) & ~1023u) - a);
}

// Where a consumer thread sits in the 64 x 64 accumulator of its
// warpgroup: rows r and r + 8, columns 8 j + c and 8 j + c + 1 (j < 8),
// registers 4 j + {0, 1} (row r) and 4 j + {2, 3} (row r + 8).
struct Lane {
  int wg, r, c;
  __device__ Lane()
      : wg(threadIdx.x / 128),
        r(16 * (threadIdx.x % 128 / 32) + threadIdx.x % 32 / 4),
        c(2 * (threadIdx.x % 4)) {}
};

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// issue s[64 x 64] = A B^T over DH, A and B 64-row tiles read K-major
template <int DH>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk / 4) * kPanelBytes + (kk % 4) * 32;
    hopper::wgmma_ss_t<64, 0, 0>(s, hopper::desc_sw128(a + off),
                                 hopper::desc_sw128(b + off), kk > 0);
  }
}

// acc[64 x DH] += X[64 x 64] B[64 x DH]. X is f32 in the accumulator
// layout of a previous product, which is the A-fragment layout once
// packed to bf16 pairs; each value goes in as hi = bf16(x) and
// lo = bf16(x - hi), two products on the same B, so X keeps ~16 bits.
// B is a 64-row tile read MN-major (rows are the reduction).
template <int DH>
__device__ __forceinline__ void accumulate(float (&acc)[Tile<DH>::kAcc],
                                           const float (&x)[32], uint32_t b) {
  uint32_t hi[4][4], lo[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hopper::split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e],
                         lo[kk][e]);
  hopper::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < Tile<DH>::kPanels; ++p) {
      const uint64_t d = hopper::desc_sw128(b + p * kPanelBytes + kk * 2048);
      hopper::wgmma_rs<64, 1>(acc + 32 * p, hi[kk], d, 1);
      hopper::wgmma_rs<64, 1>(acc + 32 * p, lo[kk], d, 1);
    }
  hopper::wgmma_commit();
  hopper::wgmma_wait();
  hopper::fence_regs(acc);
}

// one 64-row x DH tile (Tile<DH>::kPanels panels) of a [B, L, NH, DH]
// tensor map, rows from `row`, head `head`, batch `b`
template <int DH>
__device__ __forceinline__ void load_rows(unsigned char* dst,
                                          const CUtensorMap* map, uint32_t bar,
                                          int head, int row, int b) {
#pragma unroll
  for (int p = 0; p < Tile<DH>::kPanels; ++p)
    hopper::tma_load_4d(dst + p * kPanelBytes, map, bar, 64 * p, head, row,
                        b);
}

// the output rows of a thread, acc x scale rounded once to bf16; row
// stride `stride` elements, rows at or past `n` are not written
template <int DH>
__device__ __forceinline__ void store_rows(bf16* base, size_t stride, int ra,
                                           int n, const Lane& ln,
                                           const float (&acc)[Tile<DH>::kAcc],
                                           float sa, float sb) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = ra + 8 * half;
    if (row >= n) continue;
    const float sc = half ? sb : sa;
    bf16* out = base + size_t(row) * stride + ln.c;
#pragma unroll
    for (int p = 0; p < Tile<DH>::kPanels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float* a = acc + 32 * p + 4 * j + 2 * half;
        *reinterpret_cast<uint32_t*>(out + 64 * p + 8 * j) =
            hopper::pack_bf16(a[0] * sc, a[1] * sc);
      }
  }
}

// A block owns 128 query rows of one (head, batch): two consumer
// warpgroups of 64 rows and one producer thread that issues every TMA
// copy (Q once, then K and V tiles into a ring of kStages); the rest of
// the producer warpgroup only gives up its registers.
template <int DH>
__global__ void __launch_bounds__(kThreadsTC, 1)
    fa_fwd_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ o, float* __restrict__ lse,
                        Shape sh) {
  using C = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1k(smem_raw);         // 2 tiles
  unsigned char* k_s = q_s + 2 * C::kBytes;        // kStages tiles
  unsigned char* v_s = k_s + kStages * C::kBytes;  // kStages tiles
  const uint32_t q_full = hopper::smem_u32(v_s + kStages * C::kBytes);
  const uint32_t k_full = q_full + 8;              // 8 bytes a barrier
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;  // longest first
  const int hk = h / (sh.H / sh.Hkv);
  const int n_kt =
      min(sh.S - 1, sh.limit(min(t0 + 2 * kRows, sh.T) - 1)) / kRows + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(q_full, 2 * C::kBytes);
      for (int w = 0; w < 2; ++w)
        load_rows<DH>(q_s + w * C::kBytes, &tq, q_full, h, t0 + kRows * w, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        hopper::mbar_expect_tx(k_full + 8 * s, C::kBytes);
        load_rows<DH>(k_s + s * C::kBytes, &tk, k_full + 8 * s, hk,
                      kRows * kt, b);
        hopper::mbar_expect_tx(v_full + 8 * s, C::kBytes);
        load_rows<DH>(v_s + s * C::kBytes, &tv, v_full + 8 * s, hk,
                      kRows * kt, b);
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const Lane ln;
  const int tw = t0 + kRows * ln.wg;  // the warpgroup's first row
  const int ta = tw + ln.r;           // the thread's rows: ta, ta + 8
  const int lim_a = min(sh.S - 1, sh.limit(ta));
  const int lim_b = min(sh.S - 1, sh.limit(ta + 8));
  const int lim_lo = min(sh.S - 1, sh.limit(tw));
  const int n_kt_w =
      tw >= sh.T
          ? 0
          : min(sh.S - 1, sh.limit(min(tw + kRows, sh.T) - 1)) / kRows + 1;
  const uint32_t qa = hopper::smem_u32(q_s + ln.wg * C::kBytes);

  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  float m_a = kMask, m_b = kMask, l_a = 0.f, l_b = 0.f;
  hopper::mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    hopper::mbar_wait(k_full + 8 * st, ph);
    if (kt < n_kt_w) {
      float s[32];
      hopper::wgmma_fence();
      issue_scores<DH>(s, qa, hopper::smem_u32(k_s + st * C::kBytes));
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::fence_regs(s);
      const int s0 = kt * kRows;
      if (s0 + kRows - 1 > lim_lo) {  // the diagonal or the ragged end
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = s0 + 8 * j + ln.c + e;
            if (col > lim_a) s[4 * j + e] = kMask;
            if (col > lim_b) s[4 * j + 2 + e] = kMask;
          }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          mx_a = fmaxf(mx_a, s[4 * j + e]);
          mx_b = fmaxf(mx_b, s[4 * j + 2 + e]);
        }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      const float al_a = exp2f((m_a - mx_a) * kLog2e);
      const float al_b = exp2f((m_b - mx_b) * kLog2e);
      m_a = mx_a;
      m_b = mx_b;
      const float off_a = mx_a * kLog2e, off_b = mx_b * kLog2e;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(fmaf(s[4 * j + e], kLog2e, -off_a));
          s[4 * j + 2 + e] = exp2f(fmaf(s[4 * j + 2 + e], kLog2e, -off_b));
          sum_a += s[4 * j + e];
          sum_b += s[4 * j + 2 + e];
        }
      l_a = l_a * al_a + sum_a;
      l_b = l_b * al_b + sum_b;
#pragma unroll
      for (int i = 0; i < C::kAcc; i += 4) {
        acc[i] *= al_a;
        acc[i + 1] *= al_a;
        acc[i + 2] *= al_b;
        acc[i + 3] *= al_b;
      }
      hopper::mbar_wait(v_full + 8 * st, ph);
      accumulate<DH>(acc, s, hopper::smem_u32(v_s + st * C::kBytes));
    } else {
      hopper::mbar_wait(v_full + 8 * st, ph);  // the ring stays in step
    }
    hopper::mbar_arrive(empty + 8 * st);
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const size_t stride = size_t(sh.H) * DH;
  store_rows<DH>(o + size_t(b) * sh.T * stride + size_t(h) * DH, stride, ta,
                 sh.T, ln, acc, 1.f / l_a, 1.f / l_b);
  if (ln.c == 0) {
    float* row = lse + (size_t(b) * sh.H + h) * sh.T;
    if (ta < sh.T) row[ta] = m_a + logf(l_a);
    if (ta + 8 < sh.T) row[ta + 8] = m_b + logf(l_b);
  }
}

// rowsum(dO o) of row t over the quarter `part` of DH (a quad's lanes
// take the four quarters)
template <int DH>
__device__ __forceinline__ float row_dot(const bf16* o, const bf16* dout,
                                         int part) {
  float d = 0.f;
#pragma unroll
  for (int e = part * (DH / 4); e < (part + 1) * (DH / 4); e += 8) {
    const uint4 a = *reinterpret_cast<const uint4*>(o + e);
    const uint4 g = *reinterpret_cast<const uint4*>(dout + e);
    const bf16* av = reinterpret_cast<const bf16*>(&a);
    const bf16* gv = reinterpret_cast<const bf16*>(&g);
#pragma unroll
    for (int u = 0; u < 8; ++u)
      d = fmaf(__bfloat162float(av[u]), __bfloat162float(gv[u]), d);
  }
  return d;
}

// dq: a block owns 128 query rows (two warpgroups) and walks the key
// tiles they see; Q and dO arrive once, K and V through the ring.
template <int DH>
__global__ void __launch_bounds__(kThreadsTC, 1)
    fa_bwd_dq_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const bf16* __restrict__ o,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           float* __restrict__ delta, bf16* __restrict__ dq,
                           Shape sh) {
  using C = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = align_1k(smem_raw);         // 2 tiles
  unsigned char* do_s = q_s + 2 * C::kBytes;       // 2 tiles
  unsigned char* k_s = do_s + 2 * C::kBytes;       // kStages tiles
  unsigned char* v_s = k_s + kStages * C::kBytes;  // kStages tiles
  const uint32_t qd_full = hopper::smem_u32(v_s + kStages * C::kBytes);
  const uint32_t k_full = qd_full + 8;
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int t0 = (gridDim.y - 1 - blockIdx.y) * 2 * kRows;
  const int hk = h / (sh.H / sh.Hkv);
  const int n_kt =
      min(sh.S - 1, sh.limit(min(t0 + 2 * kRows, sh.T) - 1)) / kRows + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers) {
      hopper::mbar_expect_tx(qd_full, 4 * C::kBytes);
      for (int w = 0; w < 2; ++w) {
        load_rows<DH>(q_s + w * C::kBytes, &tq, qd_full, h, t0 + kRows * w,
                      b);
        load_rows<DH>(do_s + w * C::kBytes, &tdo, qd_full, h,
                      t0 + kRows * w, b);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages)
          hopper::mbar_wait(empty + 8 * s, (kt / kStages - 1) & 1);
        hopper::mbar_expect_tx(k_full + 8 * s, C::kBytes);
        load_rows<DH>(k_s + s * C::kBytes, &tk, k_full + 8 * s, hk,
                      kRows * kt, b);
        hopper::mbar_expect_tx(v_full + 8 * s, C::kBytes);
        load_rows<DH>(v_s + s * C::kBytes, &tv, v_full + 8 * s, hk,
                      kRows * kt, b);
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const Lane ln;
  const int tw = t0 + kRows * ln.wg;
  const int ta = tw + ln.r;
  const int lim_a = min(sh.S - 1, sh.limit(ta));
  const int lim_b = min(sh.S - 1, sh.limit(ta + 8));
  const int lim_lo = min(sh.S - 1, sh.limit(tw));
  const int n_kt_w =
      tw >= sh.T
          ? 0
          : min(sh.S - 1, sh.limit(min(tw + kRows, sh.T) - 1)) / kRows + 1;
  const size_t stride = size_t(sh.H) * DH;
  const size_t head = size_t(b) * sh.T * stride + size_t(h) * DH;
  const size_t stat = (size_t(b) * sh.H + h) * sh.T;

  // the row pass: delta = rowsum(dO o) for rows ta and ta + 8, written
  // out for the dkv launch
  float del_a = 0.f, del_b = 0.f;
  if (ta < sh.T)
    del_a = row_dot<DH>(o + head + ta * stride, dout + head + ta * stride,
                        ln.c / 2);
  if (ta + 8 < sh.T)
    del_b = row_dot<DH>(o + head + (ta + 8) * stride,
                        dout + head + (ta + 8) * stride, ln.c / 2);
  del_a = quad_sum(del_a);
  del_b = quad_sum(del_b);
  if (ln.c == 0) {
    if (ta < sh.T) delta[stat + ta] = del_a;
    if (ta + 8 < sh.T) delta[stat + ta + 8] = del_b;
  }
  const float lse_a = ta < sh.T ? lse[stat + ta] * kLog2e : 0.f;
  const float lse_b = ta + 8 < sh.T ? lse[stat + ta + 8] * kLog2e : 0.f;

  const uint32_t qa = hopper::smem_u32(q_s + ln.wg * C::kBytes);
  const uint32_t da = hopper::smem_u32(do_s + ln.wg * C::kBytes);
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  hopper::mbar_wait(qd_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int st = kt % kStages;
    const uint32_t ph = (kt / kStages) & 1;
    hopper::mbar_wait(k_full + 8 * st, ph);
    hopper::mbar_wait(v_full + 8 * st, ph);
    if (kt < n_kt_w) {
      const uint32_t kb = hopper::smem_u32(k_s + st * C::kBytes);
      float s[32], dp[32];
      hopper::wgmma_fence();
      issue_scores<DH>(s, qa, kb);
      issue_scores<DH>(dp, da, hopper::smem_u32(v_s + st * C::kBytes));
      hopper::wgmma_commit();
      hopper::wgmma_wait();
      hopper::fence_regs(s);
      hopper::fence_regs(dp);
      const int s0 = kt * kRows;
      const bool masked = s0 + kRows - 1 > lim_lo;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = s0 + 8 * j + ln.c + e;
          float pa = exp2f(fmaf(s[4 * j + e], kLog2e, -lse_a));
          float pb = exp2f(fmaf(s[4 * j + 2 + e], kLog2e, -lse_b));
          if (masked && col > lim_a) pa = 0.f;
          if (masked && col > lim_b) pb = 0.f;
          dp[4 * j + e] = pa * (dp[4 * j + e] - del_a);          // dS
          dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - del_b);
        }
      accumulate<DH>(acc, dp, kb);  // dq += dS K
    }
    hopper::mbar_arrive(empty + 8 * st);
  }
  store_rows<DH>(dq + head, stride, ta, sh.T, ln, acc, sh.scale, sh.scale);
}

// One consumer warpgroup of the dkv block over all its steps: S^T =
// K Qs^T, P^T, then dV += P^T dO, or (DK) also dP^T = V dO^T,
// dS^T = P^T (dP^T - delta) and dK += dS^T Qs; rows are the block's keys.
template <int DH, bool DK>
__device__ __forceinline__ void dkv_warpgroup(
    const Shape& sh, const Lane& ln, int s0, int qt0, int nq, int steps,
    unsigned char* k_s, unsigned char* v_s, unsigned char* q_s,
    unsigned char* do_s, const float* stat_s, uint32_t kv_full,
    uint32_t full, uint32_t empty, bf16* out, size_t stride) {
  using C = Tile<DH>;
  const int sa = s0 + ln.r;  // the thread's keys: sa, sa + 8
  const uint32_t ka = hopper::smem_u32(k_s);
  const uint32_t va = hopper::smem_u32(v_s);
  float acc[C::kAcc];
#pragma unroll
  for (int i = 0; i < C::kAcc; ++i) acc[i] = 0.f;
  hopper::mbar_wait(kv_full, 0);
  for (int it = 0; it < steps; ++it) {
    const int t0 = (qt0 + it % nq) * kRows;
    const int st = it % kStages;
    hopper::mbar_wait(full + 8 * st, (it / kStages) & 1);
    const uint32_t qb = hopper::smem_u32(q_s + st * C::kBytes);
    const uint32_t db = hopper::smem_u32(do_s + st * C::kBytes);
    const float* stat = stat_s + st * 2 * kRows;
    float s[32], dp[32];
    hopper::wgmma_fence();
    issue_scores<DH>(s, ka, qb);                     // S^T [key][query]
    if constexpr (DK) issue_scores<DH>(dp, va, db);  // dP^T
    hopper::wgmma_commit();
    hopper::wgmma_wait();
    hopper::fence_regs(s);
    if constexpr (DK) hopper::fence_regs(dp);
    // every (key, query) pair of the tile visible: no mask
    const bool masked = t0 + kRows > sh.T ||
                        s0 + kRows - 1 > min(sh.S - 1, sh.limit(t0));
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + ln.c + e;
        float pa = exp2f(fmaf(s[4 * j + e], kLog2e, -stat[c]));
        float pb = exp2f(fmaf(s[4 * j + 2 + e], kLog2e, -stat[c]));
        if (masked) {
          const int t = t0 + c;
          const int lim = t < sh.T ? min(sh.S - 1, sh.limit(t)) : -1;
          if (sa > lim) pa = 0.f;
          if (sa + 8 > lim) pb = 0.f;
        }
        if constexpr (DK) {
          const float dl = stat[kRows + c];
          dp[4 * j + e] = pa * (dp[4 * j + e] - dl);  // dS^T
          dp[4 * j + 2 + e] = pb * (dp[4 * j + 2 + e] - dl);
        } else {
          s[4 * j + e] = pa;
          s[4 * j + 2 + e] = pb;
        }
      }
    if constexpr (DK)
      accumulate<DH>(acc, dp, qb);  // dK += dS^T Qs
    else
      accumulate<DH>(acc, s, db);   // dV += P^T dO
    hopper::mbar_arrive(empty + 8 * st);
  }
  store_rows<DH>(out, stride, sa, sh.S, ln, acc, 1.f, 1.f);
}

// dkv: a block owns 64 keys of one (kv head, batch) and walks the query
// tiles of its G heads that see them; K and V arrive once, Q, dO and the
// tile's lse and delta through the ring. Warpgroup 0 computes
// S^T = K Qs^T and dV += P^T dO, warpgroup 1 S^T, dP^T = V dO^T and
// dK += dS^T Qs: each holds one 64 x DH accumulator.
template <int DH>
__global__ void __launch_bounds__(kThreadsTC, 1)
    fa_bwd_dkv_kernel_wgmma(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tdo,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            Shape sh) {
  using C = Tile<DH>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = align_1k(smem_raw);          // 1 tile
  unsigned char* v_s = k_s + C::kBytes;             // 1 tile
  unsigned char* q_s = v_s + C::kBytes;             // kStages tiles
  unsigned char* do_s = q_s + kStages * C::kBytes;  // kStages tiles
  // per stage: lse x log2(e), then delta, of the tile's 64 rows
  float* stat_s = reinterpret_cast<float*>(do_s + kStages * C::kBytes);
  const uint32_t kv_full = hopper::smem_u32(stat_s + kStages * 2 * kRows);
  const uint32_t full = kv_full + 8;
  const uint32_t empty = full + 8 * kStages;

  const int hk = blockIdx.x;
  const int b = blockIdx.z;
  const int s0 = blockIdx.y * kRows;  // key tiles seen by most rows first
  const int G = sh.H / sh.Hkv;
  // the first query row that sees key s0
  const int t_first = sh.causal ? max(0, s0 - (sh.S - sh.T)) : 0;
  const int qt0 = t_first / kRows;
  const int nq = (sh.T + kRows - 1) / kRows - qt0;
  const int steps = G * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(full + 8 * s, 32);
      hopper::mbar_init(empty + 8 * s, kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {  // the producer: one warp, all lanes
    hopper::regs_dec<kProducerRegs>();
    if (threadIdx.x >= kConsumers + 32) return;
    const int lane = threadIdx.x - kConsumers;
    if (lane == 0) {
      hopper::mbar_expect_tx(kv_full, 2 * C::kBytes);
      load_rows<DH>(k_s, &tk, kv_full, hk, s0, b);
      load_rows<DH>(v_s, &tv, kv_full, hk, s0, b);
    }
    for (int it = 0; it < steps; ++it) {
      const int h = hk * G + it / nq;
      const int t0 = (qt0 + it % nq) * kRows;
      const int s = it % kStages;
      if (it >= kStages)
        hopper::mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
      float* st = stat_s + s * 2 * kRows;
      const size_t stat = (size_t(b) * sh.H + h) * sh.T;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int r = lane + 32 * u;
        const bool in = t0 + r < sh.T;
        st[r] = in ? lse[stat + t0 + r] * kLog2e : 0.f;
        st[kRows + r] = in ? delta[stat + t0 + r] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(full + 8 * s, 2 * C::kBytes);
        load_rows<DH>(q_s + s * C::kBytes, &tq, full + 8 * s, h, t0, b);
        load_rows<DH>(do_s + s * C::kBytes, &tdo, full + 8 * s, h, t0, b);
      } else {
        hopper::mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  hopper::regs_inc<kConsumerRegs>();
  const Lane ln;
  const size_t stride = size_t(sh.Hkv) * DH;
  const size_t off = size_t(b) * sh.S * stride + size_t(hk) * DH;
  // one loop a role, so that no wgmma sits in a branch of the other's
  if (ln.wg == 0)
    dkv_warpgroup<DH, false>(sh, ln, s0, qt0, nq, steps, k_s, v_s, q_s, do_s,
                             stat_s, kv_full, full, empty, dv + off, stride);
  else
    dkv_warpgroup<DH, true>(sh, ln, s0, qt0, nq, steps, k_s, v_s, q_s, do_s,
                            stat_s, kv_full, full, empty, dk + off, stride);
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

constexpr int kEncodeFailed = -2;

template <typename Kern>
int launch(Kern kernel, dim3 grid, int threads, size_t bytes,
           cudaStream_t stream, void** params) {
  const void* fn = (const void*)kernel;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernel(fn, grid, dim3(threads), params, bytes, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// the f32 FMA kernels
template <int DH>
int run_f32(int which, const Args& a) {
  using T = float;
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
    return launch(fa_fwd_kernel<T, DH>, dim3(n_qt, a.H, a.B), kThreads,
                  3 * C::kTileBytes + C::kPBytes, a.stream, params);
  }
  if (which == 1) {
    float* delta = const_cast<float*>(static_cast<const float*>(a.delta));
    T* dq = static_cast<T*>(a.out0);
    void* params[] = {&q, &k, &v, &o, &dout, &lse, &delta, &dq, &sh};
    return launch(fa_bwd_dq_kernel<T, DH>, dim3(n_qt, a.H, a.B), kThreads,
                  4 * C::kTileBytes + C::kPBytes + 2 * kTile * sizeof(float),
                  a.stream, params);
  }
  const float* delta = static_cast<const float*>(a.delta);
  T* dk = static_cast<T*>(a.out0);
  T* dv = static_cast<T*>(a.out1);
  void* params[] = {&q, &k, &v, &dout, &lse, &delta, &dk, &dv, &sh};
  return launch(fa_bwd_dkv_kernel<T, DH>, dim3(n_kt, a.Hkv, a.B), kThreads,
                4 * C::kTileBytes + 2 * C::kPBytes +
                    2 * kTile * sizeof(float),
                a.stream, params);
}

// the bf16 tensor-core kernels
template <int DH>
int run_bf16(int which, const Args& a) {
  using C = Tile<DH>;
  Shape sh{a.T, a.S, a.H, a.Hkv, a.scale, a.causal};
  CUtensorMap tq, tk, tv, tdo;
  if (!hopper::encode_rows_map(&tq, a.q, a.B, a.T, a.H, DH) ||
      !hopper::encode_rows_map(&tk, a.k, a.B, a.S, a.Hkv, DH) ||
      !hopper::encode_rows_map(&tv, a.v, a.B, a.S, a.Hkv, DH))
    return kEncodeFailed;
  const size_t bars = 8 * (1 + 3 * kStages);
  const dim3 q_grid(a.H, (a.T + 2 * kRows - 1) / (2 * kRows), a.B);
  if (which == 0) {
    bf16* o = static_cast<bf16*>(a.out0);
    float* lse = static_cast<float*>(a.out1);
    void* params[] = {&tq, &tk, &tv, &o, &lse, &sh};
    return launch(fa_fwd_kernel_wgmma<DH>, q_grid, kThreadsTC,
                  1024 + (2 + 2 * kStages) * C::kBytes + bars, a.stream,
                  params);
  }
  if (!hopper::encode_rows_map(&tdo, a.dout, a.B, a.T, a.H, DH))
    return kEncodeFailed;
  const float* lse = static_cast<const float*>(a.lse);
  if (which == 1) {
    const bf16* o = static_cast<const bf16*>(a.o);
    const bf16* dout = static_cast<const bf16*>(a.dout);
    float* delta = const_cast<float*>(static_cast<const float*>(a.delta));
    bf16* dq = static_cast<bf16*>(a.out0);
    void* params[] = {&tq, &tk, &tv, &tdo, &o, &dout, &lse, &delta, &dq, &sh};
    return launch(fa_bwd_dq_kernel_wgmma<DH>, q_grid, kThreadsTC,
                  1024 + (4 + 2 * kStages) * C::kBytes + bars, a.stream,
                  params);
  }
  const float* delta = static_cast<const float*>(a.delta);
  bf16* dk = static_cast<bf16*>(a.out0);
  bf16* dv = static_cast<bf16*>(a.out1);
  void* params[] = {&tq, &tk, &tv, &tdo, &lse, &delta, &dk, &dv, &sh};
  return launch(fa_bwd_dkv_kernel_wgmma<DH>,
                dim3(a.Hkv, (a.S + kRows - 1) / kRows, a.B), kThreadsTC,
                1024 + (2 + 2 * kStages) * C::kBytes +
                    kStages * 2 * kRows * sizeof(float) + bars,
                a.stream, params);
}

int dispatch(int which, int dtype, const Args& a) {
  if (a.Hkv <= 0 || a.H % a.Hkv || a.T <= 0 || a.S < a.T) return -1;
  if (dtype == 0 && a.Dh == 64) return run_f32<64>(which, a);
  if (dtype == 0 && a.Dh == 128) return run_f32<128>(which, a);
  if (dtype == 1 && a.Dh == 64) return run_bf16<64>(which, a);
  if (dtype == 1 && a.Dh == 128) return run_bf16<128>(which, a);
  return -1;
}

}  // namespace

// All three return 0, a cudaError_t code when the launch was refused, -1
// for what the kernels are not built for (dtype 0 = float32,
// 1 = bfloat16; Dh 64 or 128; S >= T; H a multiple of Hkv) or -2 when the
// tensor-map encoder refuses a map (bf16). They launch on `stream`, never
// synchronise and allocate nothing. q is pre-scaled by sm_scale and
// rounded to its dtype by the caller; `scale` is read only by the dq
// launch, whose gradient is for the unscaled q. lse and delta are f32
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
