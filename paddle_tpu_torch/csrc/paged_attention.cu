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
// What it computes. Sequence b's G = H / Hkv query heads of kv head h,
// one query token each, against the keys at positions 0 .. lengths[b] - 1,
// found through the page table row page_indices[b] (page_size a runtime
// argument). q is scaled by sm_scale and rounded to its own type first,
// as the TPU entry folds the scale into q; the score and PV products
// accumulate in f32; the softmax is an f32 online softmax whose running
// max starts at -1e30. Outputs: o = sum p v / l in the pools' type; with
// STATS also m = the max of the f32 scores and l = sum exp(s - m), both
// f32. A sequence of length 0 gives o = 0, m = -1e30, l = 0. Keys past
// the length are never read: their shared-memory rows are zero-filled by
// the copy itself, so the trash page, stale table entries and the padding
// slots of a last page (which may hold NaN) cannot reach an output. A
// table entry is clamped into [0, P).
//
// Batch invariance. Keys are split into chunks of 512 at fixed positions
// and every partial is combined in a fixed order (decode_attention.cuh):
// a sequence's o, m and l are bitwise the same whatever else shares the
// batch and wherever its pages lie, and o is the same with and without
// STATS.
//
// What bounds it. Memory: a decode row does ~2·G flops per K or V byte,
// far below the ~295 flops per byte at which an H100 becomes
// compute-bound, so the least time is the live K+V bytes over 3.35 TB/s.
// Design (decode_attention.cuh): grid (B, Hkv, chunks), so one long
// sequence spreads over chunks / 512 blocks a kv head instead of one;
// 128 threads, a 3-stage cp.async ring of 64-key K/V tiles (two blocks an
// SM keep 4 tiles in flight each); each warp takes 16 keys of a tile with
// its own online softmax; bf16 products on tensor cores (mma.sync, P as
// hi + lo pairs); the last block of a sequence adds its chunks in order.
// Known gap: a decode row fills G of the 16 rows of an m16 product, and
// the K/V copies are per-thread cp.async, not TMA.

#include "decode_attention.cuh"

namespace {

using decode_attn::Params;

template <typename T, int DH, int G>
int with_stats(const Params& a, int stats, cudaStream_t st) {
  return stats ? decode_attn::launch<T, DH, G, 1, false, true>(a, st)
               : decode_attn::launch<T, DH, G, 1, false, false>(a, st);
}

#define PA_CASE(DH_, G_) \
  if (Dh == DH_ && g == G_) return with_stats<T, DH_, G_>(a, stats, st);

template <typename T>
int dispatch(const Params& a, int Dh, int stats, cudaStream_t st) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return -1;
  const int g = a.H / a.Hkv;
  PA_CASE(64, 1) PA_CASE(64, 2) PA_CASE(64, 4) PA_CASE(64, 8)
  PA_CASE(128, 1) PA_CASE(128, 2) PA_CASE(128, 4) PA_CASE(128, 8)
  return -1;
}

}  // namespace

// Returns 0 on success, a cudaError_t code when the launch was refused,
// -1 for a dtype / head_dim / group size the kernel is not built for or a
// missing workspace. dtype: 0 = float32, 1 = bfloat16 (q, pools and o).
// stats != 0 also writes m and l (f32 [B, H]). With more than one chunk
// of keys (paddle_decode_attention_key_chunk() keys each) in pps pages,
// ws is an f32 workspace of chunks * B * H * (Dh + 2) floats and counters
// B * Hkv ints, zero (the kernel leaves them zero); otherwise both may be
// null. Launches on `stream`, never synchronises, allocates nothing.
extern "C" int paddle_paged_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* lengths, const void* tables, void* out, void* m, void* l,
    void* ws, void* counters, int B, int H, int Hkv, int Dh, int P,
    int page_size, int pps, float sm_scale, int dtype, int stats,
    void* stream) {
  if (B <= 0 || P <= 0 || page_size <= 0 || pps <= 0) return -1;
  const int nc = decode_attn::n_chunks(pps, page_size);
  float* wo = static_cast<float*>(ws);
  Params a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.lengths = static_cast<const int*>(lengths);
  a.tables = static_cast<const int*>(tables);
  a.out = out;
  a.m_out = static_cast<float*>(m);
  a.l_out = static_cast<float*>(l);
  a.ws_o = wo;
  a.ws_ml = wo == nullptr ? nullptr
                          : wo + static_cast<size_t>(nc) * B * H * Dh;
  a.counters = static_cast<int*>(counters);
  a.n_tok = B;
  a.H = H;
  a.Hkv = Hkv;
  a.P = P;
  a.page_size = page_size;
  a.S = B;
  a.pps = pps;
  a.sm_scale = sm_scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, Dh, stats, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, Dh, stats, st);
  return -1;
}
