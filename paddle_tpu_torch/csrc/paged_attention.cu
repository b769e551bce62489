// Decode attention over a paged KV cache: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/paged_attention.py (`paged_attention` and
// `paged_attention_stats`).
//
// Replaces both TPU kernels of paddle_tpu/inference/paged_kv.py:
//   * `paged_attention` :182, the stock
//     jax.experimental.pallas.ops.tpu.paged_attention kernel called at :201;
//   * `_stats_call` :234 (pallas_call :285), the same kernel body
//     (`paged_flash_attention_kernel_inline_seq_dim`) re-plumbed to return
//     the softmax max m and denominator l it otherwise throws away.
// One kernel serves both; the template flag STATS writes m and l.
//
// What it computes. Block (b, h) computes sequence b's G = H / Hkv query
// heads of kv head h, one query token each, against the keys at positions
// 0 .. lengths[b] - 1, found through the page table row page_indices[b]
// (page_size a runtime argument). q is scaled by sm_scale and rounded to
// its own type first, as the TPU entry folds the scale into q; the score
// and PV products accumulate in f32; the softmax is an f32 online softmax
// whose running max starts at -1e30. Outputs: o = sum p v / l in the
// pools' type; with STATS also m = the max of the f32 scores and
// l = sum exp(s - m), both f32. A sequence of length 0 gives o = 0,
// m = -1e30, l = 0. Keys past the length are never read: their
// shared-memory rows are zero-filled by the copy itself, so the trash page,
// stale table entries and the padding slots of a last page (which may hold
// NaN) cannot reach an output. A table entry is clamped into [0, P).
//
// Batch invariance. KV tiles start at fixed key positions (0, 64, ...) and
// every reduction runs in an order fixed by the sequence alone, with no
// split of the KV axis across blocks: a sequence's o, m and l are bitwise
// the same whatever else shares the batch and wherever its pages lie.
//
// What bounds it. Memory: a decode row does ~2·G flops per K or V byte, far
// below the ~295 flops per byte at which an H100 becomes compute-bound, so
// the least time is the live K+V bytes over 3.35 TB/s. The design reads
// only live keys, once for the whole query group, with 16-byte cp.async
// copies double-buffered so the next tile's loads overlap this tile's math.
// Known gap: one block per (sequence, kv head) gives B·Hkv blocks (64 at
// the engine's 8 slots on 132 SMs), so a few long sequences leave most of
// the card idle; a fixed split of the pages with a fixed-order combine is
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kTile = 64;        // keys per KV tile
constexpr int kThreads = 128;    // four warps
constexpr int kSplit = kThreads / kTile;  // threads sharing one key's rows
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

// 16-byte global -> shared copy; src_bytes == 0 zero-fills the 16 bytes
// without reading global memory.
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

template <typename T, int DH, int G>
struct Layout {
  static constexpr int kChunk = 16 / sizeof(T);      // elements per copy
  static constexpr int kRowChunks = DH / kChunk;
  // K rows padded by 16 bytes: the score step reads 16 bytes of 8
  // consecutive rows per phase, which then fall in distinct banks
  static constexpr int kKLd = DH + kChunk;
  static constexpr size_t kK = size_t(2) * kTile * kKLd * sizeof(T);
  static constexpr size_t kV = size_t(2) * kTile * DH * sizeof(T);
  static constexpr size_t kQ = size_t(G) * DH * sizeof(float);
  static constexpr size_t kS = size_t(G) * kTile * sizeof(float);
  static constexpr size_t kBytes = kK + kV + kQ + kS + 3 * G * sizeof(float);
};

template <typename T, int DH, int G, bool STATS>
__global__ void __launch_bounds__(kThreads)
    paged_attention_kernel(const T* __restrict__ q,
                           const T* __restrict__ k_pages,
                           const T* __restrict__ v_pages,
                           const int* __restrict__ lengths,
                           const int* __restrict__ tables,
                           T* __restrict__ out, float* __restrict__ m_out,
                           float* __restrict__ l_out, int H, int P,
                           int page_size, int pps, float sm_scale) {
  using L = Layout<T, DH, G>;
  static_assert(DH <= kThreads && DH % 8 == 0, "head_dim");
  static_assert(kTile == 64, "the softmax step gives each lane two keys");
  extern __shared__ __align__(16) unsigned char smem[];
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + L::kK);
  float* qf = reinterpret_cast<float*>(smem + L::kK + L::kV);
  float* sc = qf + G * DH;     // [G][kTile] scores, then probabilities
  float* m_s = sc + G * kTile;  // running max
  float* l_s = m_s + G;         // running denominator
  float* a_s = l_s + G;         // this tile's rescale factor

  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t head0 = static_cast<size_t>(b) * H + static_cast<size_t>(h) * G;
  const size_t row0 = head0 * DH;
  T* o = out + row0;

  const int n_keys = min(lengths[b], pps * page_size);
  if (n_keys <= 0) {
    for (int i = tid; i < G * DH; i += kThreads) o[i] = from_float<T>(0.f);
    if (STATS && tid < G) {
      m_out[head0 + tid] = kMask;
      l_out[head0 + tid] = 0.f;
    }
    return;
  }

  for (int i = tid; i < G * DH; i += kThreads)
    qf[i] = to_float(from_float<T>(to_float(q[row0 + i]) * sm_scale));
  if (tid < G) {
    m_s[tid] = kMask;
    l_s[tid] = 0.f;
  }

  const size_t head = static_cast<size_t>(h) * P * page_size * DH;
  const T* kh = k_pages + head;
  const T* vh = v_pages + head;
  const int* tab = tables + static_cast<size_t>(b) * pps;

  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kTile;
    for (int c = tid; c < kTile * L::kRowChunks; c += kThreads) {
      const int r = c / L::kRowChunks;
      const int e = (c % L::kRowChunks) * L::kChunk;
      const int key = k0 + r;
      size_t src = e;  // a dead key copies nothing: zero fill
      int bytes = 0;
      if (key < n_keys) {
        const int page = min(max(tab[key / page_size], 0), P - 1);
        src += (static_cast<size_t>(page) * page_size + key % page_size) * DH;
        bytes = 16;
      }
      const size_t r_buf = static_cast<size_t>(buf) * kTile + r;
      cp_async16(ks + r_buf * L::kKLd + e, kh + src, bytes);
      cp_async16(vs + r_buf * DH + e, vh + src, bytes);
    }
    cp_async_commit();
  };

  constexpr int kRowsPerThread = (G + kSplit - 1) / kSplit;
  const int j = tid % kTile;   // the key this thread scores
  const int g0 = tid / kTile;  // its first query row; rows g0, g0+kSplit, ...
  const int warp = tid / 32;
  const int lane = tid % 32;
  float acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.f;

  const int n_tiles = (n_keys + kTile - 1) / kTile;
  load_tile(0, 0);
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {
      load_tile(tile + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = tile * kTile;

    // scores, f32 accumulation in a fixed order over Dh
    {
      float s[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) s[i] = 0.f;
      const T* krow = ks + (static_cast<size_t>(buf) * kTile + j) * L::kKLd;
#pragma unroll 4
      for (int e = 0; e < DH; e += L::kChunk) {
        const uint4 raw = *reinterpret_cast<const uint4*>(krow + e);
        const T* kv = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int g = g0 + kSplit * i;
          if (g < G) {
            // a 16-byte chunk's products first, then the running total
            const float* qg = qf + g * DH + e;
            float part = 0.f;
#pragma unroll
            for (int u = 0; u < L::kChunk; u += 4) {
              const float4 qq = *reinterpret_cast<const float4*>(qg + u);
              part = fmaf(qq.x, to_float(kv[u]), part);
              part = fmaf(qq.y, to_float(kv[u + 1]), part);
              part = fmaf(qq.z, to_float(kv[u + 2]), part);
              part = fmaf(qq.w, to_float(kv[u + 3]), part);
            }
            s[i] += part;
          }
        }
      }
      const bool live = k0 + j < n_keys;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int g = g0 + kSplit * i;
        if (g < G) sc[g * kTile + j] = live ? s[i] : kMask;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row, two keys per lane
    for (int g = warp; g < G; g += kThreads / 32) {
      float* row = sc + g * kTile;
      const float s0 = row[lane];
      const float s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = k0 + lane < n_keys ? expf(s0 - m_new) : 0.f;
      const float p1 = k0 + lane + 32 < n_keys ? expf(s1 - m_new) : 0.f;
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // PV: thread d owns output column d of every query row; the tile's
    // sum is formed on its own, then folded into the rescaled total
    if (tid < DH) {
      const T* vcol = vs + static_cast<size_t>(buf) * kTile * DH + tid;
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) part[g] = 0.f;
#pragma unroll 4
      for (int jj = 0; jj < kTile; jj += 4) {
        const float v0 = to_float(vcol[(jj + 0) * DH]);
        const float v1 = to_float(vcol[(jj + 1) * DH]);
        const float v2 = to_float(vcol[(jj + 2) * DH]);
        const float v3 = to_float(vcol[(jj + 3) * DH]);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 p =
              *reinterpret_cast<const float4*>(sc + g * kTile + jj);
          part[g] = fmaf(p.x, v0, part[g]);
          part[g] = fmaf(p.y, v1, part[g]);
          part[g] = fmaf(p.z, v2, part[g]);
          part[g] = fmaf(p.w, v3, part[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = fmaf(acc[g], a_s[g], part[g]);
    }
    __syncthreads();  // the next copies overwrite this tile's buffer
  }

  if (tid < DH) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float l = l_s[g];
      o[g * DH + tid] = from_float<T>(acc[g] / (l > 0.f ? l : 1.f));
    }
  }
  if (STATS && tid < G) {
    m_out[head0 + tid] = m_s[tid];
    l_out[head0 + tid] = l_s[tid];
  }
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* lengths;
  const int* tables;
  void* out;
  float* m;
  float* l;
  int B, H, Hkv, Dh, P, page_size, pps;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int DH, int G, bool STATS>
int launch(const Args& a) {
  auto kernel = paged_attention_kernel<T, DH, G, STATS>;
  const size_t bytes = Layout<T, DH, G>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.B, a.Hkv);
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k_pages),
      static_cast<const T*>(a.v_pages), a.lengths, a.tables,
      static_cast<T*>(a.out), a.m, a.l, a.H, a.P, a.page_size, a.pps,
      a.sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DH, int G>
int with_stats(const Args& a, int stats) {
  return stats ? launch<T, DH, G, true>(a) : launch<T, DH, G, false>(a);
}

#define PA_CASE(DH_, G_) \
  if (a.Dh == DH_ && g == G_) return with_stats<T, DH_, G_>(a, stats);

template <typename T>
int dispatch(const Args& a, int stats) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return -1;
  const int g = a.H / a.Hkv;
  PA_CASE(64, 1) PA_CASE(64, 2) PA_CASE(64, 4) PA_CASE(64, 8)
  PA_CASE(128, 1) PA_CASE(128, 2) PA_CASE(128, 4) PA_CASE(128, 8)
  return -1;
}

}  // namespace

// Returns 0 on success, a cudaError_t code when the launch was refused,
// -1 for a dtype / head_dim / group size the kernel is not built for.
// dtype: 0 = float32, 1 = bfloat16 (q, pools and o). stats != 0 also
// writes m and l (f32 [B, H]). Launches on `stream`, never synchronises,
// allocates nothing.
extern "C" int paddle_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, void* out, void* m, void* l,
    int B, int H, int Hkv, int Dh, int P, int page_size, int pps,
    float sm_scale, int dtype, int stats, void* stream) {
  if (B <= 0 || P <= 0 || page_size <= 0 || pps <= 0) return -1;
  const Args a{q,
               k_pages,
               v_pages,
               static_cast<const int*>(lengths),
               static_cast<const int*>(tables),
               out,
               static_cast<float*>(m),
               static_cast<float*>(l),
               B,
               H,
               Hkv,
               Dh,
               P,
               page_size,
               pps,
               sm_scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch<float>(a, stats);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, stats);
  return -1;
}
