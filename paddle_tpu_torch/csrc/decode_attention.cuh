// Decode attention over paged KV pools for Hopper: the kernel shared by
// csrc/paged_attention.cu (one query token per sequence, optional softmax
// stats) and csrc/ragged_paged_attention.cu (the packed stream of a
// serving tick: decode rows and prefill spans).
//
// Work split. A block takes a query tile, one kv head and one chunk of
// kChunk keys at a fixed position (keys c·kChunk .. c·kChunk + kChunk - 1):
// grid (tiles, Hkv, chunks), the chunk count set by the page table's
// width alone, never by the batch, the rows or the card. A query tile is
// one decode token (paged), or up to RT = 16·RG / G consecutive tokens of
// one slot's span (ragged), × the G query heads of the kv head: one to RG
// 16-row product tiles, whose K/V is read once for all of them. In the
// ragged stream a token leads a tile unless it continues its
// predecessor's span at an offset that is no multiple of RT. Each block
// finds the leading tokens with a scan of the stream and takes tiles
// blockIdx.x, + gridDim.x, ... (no host work, no sync; a grid sized for
// a serving tick holds one tile a block).
//
// The walk. K/V tiles of 64 keys stream through a ring of shared-memory
// stages (16-byte cp.async, keys past the tile's longest row zero-filled
// by the copy itself, so NaN in the trash page, in stale rows and past a
// length is never read), one barrier a stage. Warp (rg, kg) owns product
// rows 16 rg .. 16 rg + 15 and keys 16 kg .. 16 kg + 15 of every stage,
// and runs its own f32 online softmax on them in registers: no barrier
// between scores and PV. bf16: both products on tensor cores (mma.sync
// m16n8k16, ldmatrix fragments), P fed as bf16 hi + lo pairs (~16 bits;
// one bf16 for P reads ~1 bf16 ulp from the exact result at row scale).
// f32 (the precision checks' path): the same layout on FMA units.
//
// Combines, in fixed order. At the end of its chunk a block adds its four
// key groups' partials in order 0..3: M = max m_w, L = Σ l_w e_w,
// O = Σ O_w e_w with e_w = exp(m_w - M). A row whose keys fit one chunk
// (by its own key count) is written by the chunk-0 block: o = O / L.
// Other rows leave (m, l, O) of each chunk in an f32 workspace; the last
// block of the tile to finish (a per-(tile, kv head) counter, left zero)
// adds chunks 0, 1, ... in order by the same formula. A masked key, a
// tile or a chunk past a row's limit is an exact neutral element (p = 0,
// alpha = 1, e = 0), so a row's bits depend on its q, its keys and its
// own key count only: whatever shares its tile, its launch or its pages.
//
// Semantics (unchanged from the first kernels): q scaled by sm_scale and
// rounded to its own type first; scores, softmax and sums in f32, the
// running max starting at -1e30; o = Σ p v / l in the pools' type;
// stats m = max score, l = Σ exp(s - m); a row without keys gives o = 0,
// m = -1e30, l = 0; table entries clamped into [0, P).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "hopper.cuh"

namespace decode_attn {

constexpr int kChunk = 512;   // keys a block: the fixed split
constexpr int kTile = 64;     // keys a stage
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

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16-byte global -> shared copy; src_bytes == 0 zero-fills the 16 bytes
// without reading global memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
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

// four 8 x 8 b16 matrices; lanes 8j .. 8j + 7 give matrix j's row
// addresses. Plain: lane l gets row l / 4, columns 2 (l % 4) and + 1 of
// each; trans: rows 2 (l % 4) and + 1 of column l / 4.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hopper::smem_u32(p))
      : "memory");
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

// Shared memory of one block: a ring of K/V stages, the query tile, the
// chunk's page ids. Rows are padded by 16 bytes (conflict-free ldmatrix).
template <typename T, int DH, int RG>
struct Smem {
  static constexpr int kStages = sizeof(T) == 2 ? 3 : 2;
  static constexpr int kLd = DH + 16 / int(sizeof(T));
  static constexpr int kRows = 16 * RG;  // product rows a block
  static constexpr size_t kTileBytes = size_t(kTile) * kLd * sizeof(T);
  static constexpr size_t kRing = size_t(kStages) * 2 * kTileBytes;
  static constexpr size_t kQ = size_t(kRows) * kLd * sizeof(T);
  static constexpr size_t kPages = size_t(kChunk + 1) * sizeof(int);
  static constexpr size_t kBytes = kRing + kQ + kPages;
  // the key groups' partials, in the ring once the walk is done:
  // key groups 1..3 of each row group, O in lane order, then m and l
  static constexpr int kRegs = DH / 8 * 4;
  static constexpr int kPart = kRegs * 32 + 32;
  static_assert(size_t(RG) * 3 * kPart * sizeof(float) <= kRing,
                "combine scratch fits the ring");
};

// Scores of a warp's 16 rows x 16 keys, in the m16n8 accumulator layout:
// s[nt][e] row g, key 8 nt + 2 t + e; s[nt][2 + e] row g + 8 (g = lane / 4,
// t = lane % 4). q and k point at the warp's first row / key.
template <int DH>
__device__ __forceinline__ void scores(float (&s)[2][4],
                                       const __nv_bfloat16* q,
                                       const __nv_bfloat16* k, int lane) {
  constexpr int LD = DH + 8;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
  const __nv_bfloat16* qa =
      q + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
  const __nv_bfloat16* kb =
      k + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    uint32_t a[4], b[4];
    ldsm_x4(a, qa + 16 * kk);
    ldsm_x4(b, kb + 16 * kk);
    mma_bf16(s[0], a, b);
    mma_bf16(s[1], a, b + 2);
  }
}

template <int DH>
__device__ __forceinline__ void scores(float (&s)[2][4], const float* q,
                                       const float* k, int lane) {
  constexpr int LD = DH + 4;
  const int g = lane >> 2, t = lane & 3;
  const float* qa = q + g * LD;
  const float* qb = qa + 8 * LD;
  const float* kr[4] = {k + (2 * t) * LD, k + (2 * t + 1) * LD,
                        k + (8 + 2 * t) * LD, k + (9 + 2 * t) * LD};
  float acc[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[0][i] = acc[1][i] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; d += 4) {
    const float4 xa = *reinterpret_cast<const float4*>(qa + d);
    const float4 xb = *reinterpret_cast<const float4*>(qb + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 y = *reinterpret_cast<const float4*>(kr[i] + d);
      // four products first, then the running total
      float pa = xa.x * y.x;
      pa = fmaf(xa.y, y.y, pa);
      pa = fmaf(xa.z, y.z, pa);
      pa = fmaf(xa.w, y.w, pa);
      acc[0][i] += pa;
      float pb = xb.x * y.x;
      pb = fmaf(xb.y, y.y, pb);
      pb = fmaf(xb.z, y.z, pb);
      pb = fmaf(xb.w, y.w, pb);
      acc[1][i] += pb;
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      s[nt][e] = acc[0][2 * nt + e];
      s[nt][2 + e] = acc[1][2 * nt + e];
    }
}

// o += P V over the warp's 16 keys: o[j][0..1] row g, columns 8 j + 2 t
// and + 1; o[j][2..3] row g + 8. p in the layout of `scores`.
template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4],
                                   const float (&p)[2][4],
                                   const __nv_bfloat16* v, int lane) {
  constexpr int LD = DH + 8;
  // the accumulator layout of two n8 tiles is the A layout of one k16
  uint32_t hi[4], lo[4];
  hopper::split_bf16(p[0][0], p[0][1], hi[0], lo[0]);
  hopper::split_bf16(p[0][2], p[0][3], hi[1], lo[1]);
  hopper::split_bf16(p[1][0], p[1][1], hi[2], lo[2]);
  hopper::split_bf16(p[1][2], p[1][3], hi[3], lo[3]);
  const __nv_bfloat16* vb =
      v + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int jj = 0; jj < DH / 16; ++jj) {
    uint32_t b[4];
    ldsm_x4_t(b, vb + 16 * jj);
    mma_bf16(o[2 * jj], hi, b);
    mma_bf16(o[2 * jj], lo, b);
    mma_bf16(o[2 * jj + 1], hi, b + 2);
    mma_bf16(o[2 * jj + 1], lo, b + 2);
  }
}

template <int DH>
__device__ __forceinline__ void pv(float (&o)[DH / 8][4],
                                   const float (&p)[2][4], const float* v,
                                   int lane) {
  constexpr int LD = DH + 4;
  const int t = lane & 3;
  const int quad = lane & ~3;
#pragma unroll
  for (int kq = 0; kq < 16; ++kq) {
    const int nt = kq >> 3, e = kq & 1;
    const int src = quad | ((kq & 7) >> 1);  // the lane holding key kq
    const float pa = __shfl_sync(0xffffffffu, p[nt][e], src);
    const float pb = __shfl_sync(0xffffffffu, p[nt][2 + e], src);
    const float* vr = v + kq * LD + 2 * t;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(vr + 8 * j);
      o[j][0] = fmaf(pa, x.x, o[j][0]);
      o[j][1] = fmaf(pa, x.y, o[j][1]);
      o[j][2] = fmaf(pb, x.x, o[j][2]);
      o[j][3] = fmaf(pb, x.y, o[j][3]);
    }
  }
}

struct Params {
  const void* q;        // [tiles' tokens, H, DH]
  const void* k_pages;  // [Hkv, P, page_size, DH]
  const void* v_pages;
  const int* lengths;   // paged: [B]
  const int* tok_slot;  // ragged: [T]
  const int* tok_qoff;  // ragged: [T]
  const int* q_len;     // ragged: [S]
  const int* kv_len;    // ragged: [S]
  const int* tables;    // [S or B, pps]
  void* out;            // like q
  float* m_out;         // [tokens, H] (stats only)
  float* l_out;
  float* ws_o;          // [chunks, tokens * H, DH] (chunks > 1)
  float* ws_ml;         // [chunks, tokens * H, 2]
  int* counters;        // [tokens * Hkv], zero (chunks > 1)
  int n_tok;            // grid.x: B (paged) or T (ragged)
  int H, Hkv, P, page_size, S, pps;
  float sm_scale;
};

// Per-block state in static shared memory.
struct Shared {
  int nk[64];       // key count of each token of the tile
  int tiles[64];    // ragged: the leading tokens of this block's tiles
  int warp_sums[16];
  int ntok, last;
};

// Ragged: token u continues the tile of token u - 1 (the same slot's span,
// the next offset, not at a multiple of RT). Every other token leads one.
template <int RT>
__device__ __forceinline__ bool follows(const Params& p, int u) {
  if (u <= 0 || u >= p.n_tok) return false;
  const int s = p.tok_slot[u], qo = p.tok_qoff[u];
  return s >= 0 && s < p.S && qo > 0 && qo % RT != 0 &&
         p.tok_slot[u - 1] == s && p.tok_qoff[u - 1] == qo - 1;
}

// Ragged: the tiles of the stream in order, tile r to block r % gridDim.x.
// Every block counts the leading tokens of the whole stream (a block-wide
// scan), keeps its own in sh.tiles and returns how many. With gridDim.x >=
// T / RT a block has at most RT <= 64 tiles.
template <int RT, int NT>
__device__ int ragged_tiles(const Params& p, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (p.n_tok + NT - 1) / NT;
  const int u0 = min(tid * per, p.n_tok), u1 = min(u0 + per, p.n_tok);
  int cnt = 0;
  for (int u = u0; u < u1; ++u) cnt += !follows<RT>(p, u);
  int incl = cnt;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) sh.warp_sums[warp] = incl;
  __syncthreads();
  int rank = incl - cnt, total = 0;
  for (int w = 0; w < NT / 32; ++w) {
    const int x = sh.warp_sums[w];
    rank += w < warp ? x : 0;
    total += x;
  }
  const int nb = static_cast<int>(gridDim.x), b = blockIdx.x;
  for (int u = u0; u < u1; ++u) {
    if (follows<RT>(p, u)) continue;
    if (rank % nb == b && rank / nb < 64) sh.tiles[rank / nb] = u;
    ++rank;
  }
  __syncthreads();
  return total > b ? min((total - b + nb - 1) / nb, 64) : 0;
}

// One (query tile led by token t, kv head blockIdx.y, key chunk c).
template <typename T, int DH, int G, int RG, bool RAGGED, bool STATS>
__device__ __forceinline__ void tile_body(const Params& p, const int t,
                                          const int c, unsigned char* smem,
                                          Shared& sh) {
  using L = Smem<T, DH, RG>;
  constexpr int NT = 128 * RG;
  constexpr int NS = L::kStages;
  constexpr int LD = L::kLd;
  constexpr int RT = RAGGED ? 16 * RG / G : 1;  // tokens a tile at most
  constexpr int NJ = DH / 8;                      // n8 output tiles
  static_assert(16 % G == 0 && DH % 16 == 0 && RT <= 64, "shape");
  static_assert((kTile * DH * int(sizeof(T)) / 16) % NT == 0, "copies");
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + L::kRing);
  int* pg = reinterpret_cast<int*>(smem + L::kRing + L::kQ);

  const int h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int max_keys = p.pps * p.page_size;
  const T* q = static_cast<const T*>(p.q);
  T* out = static_cast<T*>(p.out);

  // --- the query tile: its tokens, each token's key count
  if (tid == 0) sh.ntok = RT;
  __syncthreads();
  int slot = t;
  if constexpr (RAGGED) {
    if (tid < RT) {
      const int u = t + tid;
      int nk = 0;
      if (u < p.n_tok) {
        const int s = p.tok_slot[u], qo = p.tok_qoff[u];
        if (s >= 0 && s < p.S && qo >= 0) {
          const int ql = p.q_len[s];
          if (qo < ql) nk = min(max(p.kv_len[s] - ql + qo + 1, 0), max_keys);
        }
      }
      sh.nk[tid] = nk;
      if (tid > 0 && !follows<RT>(p, u)) atomicMin(&sh.ntok, tid);
    }
    slot = p.tok_slot[t];
  } else {
    if (tid == 0) {
      sh.nk[0] = min(max(p.lengths[t], 0), max_keys);
      sh.ntok = 1;
    }
  }
  __syncthreads();
  const int* s_nk = sh.nk;
  const int n_tok = sh.ntok;
  const int n_rows = n_tok * G;
  int nk_tile = 0;
  for (int j = 0; j < n_tok; ++j) nk_tile = max(nk_tile, s_nk[j]);
  const int nc_tile = (nk_tile + kChunk - 1) / kChunk;
  if (c > 0 && c >= nc_tile) return;  // past every row of the tile

  // --- this chunk's page ids and the pre-scaled query tile
  const int ps = p.page_size;
  const int k_begin = c * kChunk;
  const int k_end = min(k_begin + kChunk, nk_tile);
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + kTile - 1) / kTile
                                      : 0;
  const int p0 = k_begin / ps;
  if (n_tiles > 0) {
    const int n_pages = (k_end - 1) / ps - p0 + 1;
    const int* tab = p.tables + static_cast<size_t>(slot) * p.pps;
    for (int i = tid; i < n_pages; i += NT)
      pg[i] = min(max(tab[p0 + i], 0), p.P - 1);
  }
  {
    // 16 bytes a copy, every load in flight before the first store
    constexpr int kEpc = 16 / int(sizeof(T));
    constexpr int kCpr = DH / kEpc;
    constexpr int kN = (L::kRows * kCpr + NT - 1) / NT;
    uint4 raw[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int ci = tid + n * NT, r = ci / kCpr;
      raw[n] = make_uint4(0u, 0u, 0u, 0u);
      if (r < n_rows && ci < L::kRows * kCpr)
        raw[n] = *reinterpret_cast<const uint4*>(
            q + (static_cast<size_t>(t + r / G) * p.H + h * G + r % G) * DH +
            (ci % kCpr) * kEpc);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int ci = tid + n * NT, r = ci / kCpr;
      if (ci >= L::kRows * kCpr) continue;
      const T* x = reinterpret_cast<const T*>(&raw[n]);
      uint4 y;
      T* yt = reinterpret_cast<T*>(&y);
#pragma unroll
      for (int u = 0; u < kEpc; ++u)
        yt[u] = from_float<T>(to_float(x[u]) * p.sm_scale);
      *reinterpret_cast<uint4*>(qs + r * LD + (ci % kCpr) * kEpc) = y;
    }
  }
  __syncthreads();

  const size_t head = static_cast<size_t>(h) * p.P * ps * DH;
  const T* kh = static_cast<const T*>(p.k_pages) + head;
  const T* vh = static_cast<const T*>(p.v_pages) + head;
  auto load_tile = [&](int i, int buf) {
    constexpr int kCpr = DH * int(sizeof(T)) / 16;  // copies a row
    constexpr int kEpc = 16 / int(sizeof(T));
    const int k0 = k_begin + i * kTile;
    T* kd = ring + static_cast<size_t>(buf) * 2 * kTile * LD;
    T* vd = kd + kTile * LD;
#pragma unroll
    for (int n = 0; n < kTile * kCpr / NT; ++n) {
      const int ci = tid + n * NT;
      const int r = ci / kCpr, e = (ci % kCpr) * kEpc;
      const int key = k0 + r;
      size_t src = e;  // a dead key copies nothing: zero fill
      int bytes = 0;
      if (key < k_end) {
        src += (static_cast<size_t>(pg[key / ps - p0]) * ps + key % ps) * DH;
        bytes = 16;
      }
      cp_async16(kd + r * LD + e, kh + src, bytes);
      cp_async16(vd + r * LD + e, vh + src, bytes);
    }
  };

  // --- the walk: warp (rg, kg) owns rows 16 rg.., keys 16 kg.. of a stage
  const int kg = warp & 3, rg = warp >> 2;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int row_a = 16 * rg + g8, row_b = row_a + 8;
  const bool has_rows = 16 * rg < n_rows;
  const int nk_a = row_a < n_rows ? s_nk[row_a / G] : 0;
  const int nk_b = row_b < n_rows ? s_nk[row_b / G] : 0;
  float o[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_a = kMask, m_b = kMask, l_a = 0.f, l_b = 0.f;

#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_tiles) load_tile(i, i);
    cp_async_commit();
  }
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // stage i landed; stage i - 1 is free
    if (i + NS - 1 < n_tiles) load_tile(i + NS - 1, (i + NS - 1) % NS);
    cp_async_commit();
    if (!has_rows) continue;
    const T* kt = ring + static_cast<size_t>(i % NS) * 2 * kTile * LD;
    const T* vt = kt + kTile * LD;
    float s[2][4];
    scores<DH>(s, qs + 16 * rg * LD, kt + 16 * kg * LD, lane);
    // masked by select: a dead score is replaced, never multiplied
    const int kb = k_begin + i * kTile + 16 * kg + 2 * t4;
    bool live[2][4];
    float mx_a = kMask, mx_b = kMask;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = kb + 8 * nt + e;
        live[nt][e] = key < nk_a;
        live[nt][2 + e] = key < nk_b;
        if (!live[nt][e]) s[nt][e] = kMask;
        if (!live[nt][2 + e]) s[nt][2 + e] = kMask;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = live[nt][e] ? expf(s[nt][e] - mn_a) : 0.f;
        s[nt][2 + e] = live[nt][2 + e] ? expf(s[nt][2 + e] - mn_b) : 0.f;
        sum_a += s[nt][e];
        sum_b += s[nt][2 + e];
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
    l_a = fmaf(l_a, al_a, sum_a);
    l_b = fmaf(l_b, al_b, sum_b);
    m_a = mn_a;
    m_b = mn_b;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      o[j][0] *= al_a;
      o[j][1] *= al_a;
      o[j][2] *= al_b;
      o[j][3] *= al_b;
    }
    pv<DH>(o, s, vt + 16 * kg * LD, lane);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it holds the key groups' partials

  // --- the block's partial: key groups 0, 1, 2, 3 in order
  float* xs = reinterpret_cast<float*>(smem) + rg * 3 * L::kPart;
  if (has_rows && kg > 0) {
    float* x = xs + (kg - 1) * L::kPart;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) x[(4 * j + r) * 32 + lane] = o[j][r];
    if (t4 == 0) {
      x[L::kRegs * 32 + g8] = m_a;
      x[L::kRegs * 32 + 8 + g8] = m_b;
      x[L::kRegs * 32 + 16 + g8] = l_a;
      x[L::kRegs * 32 + 24 + g8] = l_b;
    }
  }
  __syncthreads();
  const size_t R = static_cast<size_t>(p.n_tok) * p.H;  // output rows
  if (has_rows && kg == 0) {
    float M_a = m_a, M_b = m_b;
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* ml = xs + w * L::kPart + L::kRegs * 32;
      M_a = fmaxf(M_a, ml[g8]);
      M_b = fmaxf(M_b, ml[8 + g8]);
    }
    float e_a[4], e_b[4];
    e_a[0] = expf(m_a - M_a);
    e_b[0] = expf(m_b - M_b);
    float L_a = l_a * e_a[0], L_b = l_b * e_b[0];
#pragma unroll
    for (int w = 0; w < 3; ++w) {
      const float* ml = xs + w * L::kPart + L::kRegs * 32;
      e_a[w + 1] = expf(ml[g8] - M_a);
      e_b[w + 1] = expf(ml[8 + g8] - M_b);
      L_a = fmaf(ml[16 + g8], e_a[w + 1], L_a);
      L_b = fmaf(ml[24 + g8], e_b[w + 1], L_b);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float y = o[j][r] * (r < 2 ? e_a[0] : e_b[0]);
#pragma unroll
        for (int w = 0; w < 3; ++w)
          y = fmaf(xs[w * L::kPart + (4 * j + r) * 32 + lane],
                   r < 2 ? e_a[w + 1] : e_b[w + 1], y);
        o[j][r] = y;
      }

    // a row of one chunk is written here, by the chunk-0 block; a row of
    // several leaves this chunk's (m, l, O) for the combine
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? row_b : row_a;
      if (row >= n_rows) continue;
      const float M = half ? M_b : M_a;
      const float Ls = half ? L_b : L_a;
      const int nc = ((half ? nk_b : nk_a) + kChunk - 1) / kChunk;
      const size_t gr =
          static_cast<size_t>(t + row / G) * p.H + h * G + row % G;
      if (nc <= 1) {
        if (c != 0) continue;
        const float den = Ls > 0.f ? Ls : 1.f;
        T* dst = out + gr * DH + 2 * t4;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          store2(dst + 8 * j, o[j][2 * half] / den, o[j][2 * half + 1] / den);
        if (STATS && t4 == 0) {
          p.m_out[gr] = M;
          p.l_out[gr] = Ls;
        }
      } else if (c < nc) {
        const size_t w = c * R + gr;
        float* dst = p.ws_o + w * DH + 2 * t4;
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          store2(dst + 8 * j, o[j][2 * half], o[j][2 * half + 1]);
        if (t4 == 0) store2(p.ws_ml + 2 * w, M, Ls);
      }
    }
  }
  if (nc_tile <= 1) return;

  // --- the last block of the tile adds the chunks 0, 1, ... in order
  __threadfence();
  __syncthreads();
  int* counter = p.counters + static_cast<size_t>(t) * p.Hkv + h;
  if (tid == 0) sh.last = atomicAdd(counter, 1) == nc_tile - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();
  for (int idx = tid; idx < n_rows * (DH / 4); idx += NT) {
    const int row = idx / (DH / 4), d = (idx % (DH / 4)) * 4;
    const int nc = (s_nk[row / G] + kChunk - 1) / kChunk;
    if (nc <= 1) continue;
    const size_t gr =
        static_cast<size_t>(t + row / G) * p.H + h * G + row % G;
    float M = kMask;
    for (int cc = 0; cc < nc; ++cc)
      M = fmaxf(M, __ldcg(p.ws_ml + 2 * (cc * R + gr)));
    float Ls = 0.f;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int cc = 0; cc < nc; ++cc) {
      const size_t w = cc * R + gr;
      const float e = expf(__ldcg(p.ws_ml + 2 * w) - M);
      Ls = fmaf(__ldcg(p.ws_ml + 2 * w + 1), e, Ls);
      const float4 x =
          __ldcg(reinterpret_cast<const float4*>(p.ws_o + w * DH + d));
      acc.x = fmaf(x.x, e, acc.x);
      acc.y = fmaf(x.y, e, acc.y);
      acc.z = fmaf(x.z, e, acc.z);
      acc.w = fmaf(x.w, e, acc.w);
    }
    const float den = Ls > 0.f ? Ls : 1.f;
    store2(out + gr * DH + d, acc.x / den, acc.y / den);
    store2(out + gr * DH + d + 2, acc.z / den, acc.w / den);
    if (STATS && d == 0) {
      p.m_out[gr] = M;
      p.l_out[gr] = Ls;
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

template <typename T, int DH, int G, int RG, bool RAGGED, bool STATS>
__global__ void __launch_bounds__(128 * RG, RG == 1 ? 2 : 1)
    decode_attention_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ Shared sh;
  if constexpr (RAGGED) {
    const int n = ragged_tiles<16 * RG / G, 128 * RG>(p, sh);
    for (int i = 0; i < n; ++i) {
      const int t = sh.tiles[i];
      __syncthreads();  // the previous tile is done with shared memory
      tile_body<T, DH, G, RG, RAGGED, STATS>(p, t, blockIdx.z, smem, sh);
    }
  } else {
    tile_body<T, DH, G, RG, RAGGED, STATS>(p, blockIdx.x, blockIdx.z, smem,
                                           sh);
  }
}

// Chunks of a table `pps` pages of `page_size` keys wide: the grid's z.
inline int n_chunks(int pps, int page_size) {
  return (pps * page_size + kChunk - 1) / kChunk;
}

template <typename T, int DH, int G, int RG, bool RAGGED, bool STATS>
int launch(const Params& prm, cudaStream_t stream) {
  auto kernel = decode_attention_kernel<T, DH, G, RG, RAGGED, STATS>;
  const size_t bytes = Smem<T, DH, RG>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             100);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = n_chunks(prm.pps, prm.page_size);
  if (nc > 65535 || prm.Hkv > 65535) return -1;
  if (nc > 1 && (prm.ws_o == nullptr || prm.ws_ml == nullptr ||
                 prm.counters == nullptr))
    return -1;
  // ragged: enough blocks for the tiles of a serving tick's stream (a
  // decode row or padding token in each of the S first positions, then
  // spans of up to RT tokens a tile); more tiles wrap around the grid
  constexpr int RT = 16 * RG / G;
  const int nx = RAGGED ? std::min(prm.n_tok, 2 * prm.S + (prm.n_tok + RT - 1)
                                                          / RT)
                        : prm.n_tok;
  const dim3 grid(nx, prm.Hkv, nc);
  kernel<<<grid, 128 * RG, bytes, stream>>>(prm);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace decode_attn

// The fixed split: keys a block walks (the wrapper sizes its workspace
// with it).
extern "C" int paddle_decode_attention_key_chunk() {
  return decode_attn::kChunk;
}
