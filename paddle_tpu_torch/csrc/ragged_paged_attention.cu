// Ragged paged attention over the serving pools, read from the packed
// token stream: the Hopper kernel behind
// paddle_tpu_torch/ops/kernels/ragged_paged_attention.py
// (`ragged_paged_attention_packed`).
//
// Replaces both TPU kernels of paddle_tpu/ops/pallas/ragged_paged_attention.py:
//   * the one-shot walk, `_kernel` :301 / `_pallas_impl` :343, and
//   * the tiled flash-combine walk, `_tiled_kernel` :388 / `_pallas_tiled_impl` :456.
// The TPU switched from the one-shot to the tiled walk at a VMEM knee
// (`default_kv_tile_pages`): its one-shot scratch grows with the page
// table. Here one fixed-tile online-softmax walk serves every context
// length: a block holds a ring of 64-key K/V tiles in shared memory,
// O(tile) whatever the table width, so there is no knee and no second
// kernel.
//
// What it computes. Packed token t belongs to slot s = tok_slot[t] at span
// offset tok_qoff[t]; its G = H / Hkv query heads of each kv head attend
// keys 0 .. kv_len[s] - q_len[s] + tok_qoff[t] of the slot's pages
// (bottom-right causal). q is pre-scaled by sm_scale and rounded to the
// operand type, as the TPU path does; the score and PV products accumulate
// in f32; the softmax is f32 with the running max starting at -1e30.
// Padding tokens (tok_slot == S), span padding (tok_qoff >= q_len) and
// empty slots emit exact zeros. Keys past the tile's longest causal limit
// are never read: their shared-memory rows are zero-filled by the copy
// itself, so garbage or NaN in the trash page or in stale page rows
// cannot reach the output; a shorter row's keys are masked by select.
//
// Batch invariance. Keys are split into chunks of 512 at fixed positions,
// 64-key tiles inside them, and every partial is combined in a fixed
// order (decode_attention.cuh). An mma output row depends on its own q row
// only, and a key, tile or chunk past a row's limit is an exact neutral
// element, so a row's output is a function of its q, its slot's pages and
// its causal limit: bitwise the same whatever else shares the batch or
// its query tile, and a prefill attended in two chunks gives the bits of
// one whole span.
//
// What bounds it. A decode row does ~2·G flops per K or V byte it reads:
// memory, the live pages' K+V bytes over 3.35 TB/s. A prefill span does
// ~2·G·n per byte for n rows sharing it: operations, on tensor cores.
// Design (decode_attention.cuh): grid (T, Hkv, chunks); the block of a
// span's leading token takes up to 16·RG / G consecutive tokens of the
// span (RG = 4 row groups of 16 product rows when the stream holds more
// tokens than slots, so spans exist; 1 otherwise, which leaves two blocks
// an SM for decode) and reads each K/V tile once for all of them; the
// other tokens' blocks exit at once. 128·RG threads, a 3-stage cp.async
// ring, one online softmax a warp, bf16 products on tensor cores (mma.sync,
// P as hi + lo pairs), and the last block of a tile adds its chunks in
// order. Known gap: a decode row fills G of the 16 rows of an m16
// product; copies are per-thread cp.async, not TMA.

#include "decode_attention.cuh"

namespace {

using decode_attn::Params;

template <typename T, int DH, int G>
int with_rows(const Params& a, cudaStream_t st) {
  // row groups: a shape-only choice; a row's bits do not depend on it
  return a.n_tok > a.S ? decode_attn::launch<T, DH, G, 4, true, false>(a, st)
                       : decode_attn::launch<T, DH, G, 1, true, false>(a, st);
}

#define RPA_CASE(DH_, G_) \
  if (Dh == DH_ && g == G_) return with_rows<T, DH_, G_>(a, st);

template <typename T>
int dispatch(const Params& a, int Dh, cudaStream_t st) {
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return -1;
  const int g = a.H / a.Hkv;
  RPA_CASE(64, 1) RPA_CASE(64, 2) RPA_CASE(64, 4) RPA_CASE(64, 8)
  RPA_CASE(128, 1) RPA_CASE(128, 2) RPA_CASE(128, 4) RPA_CASE(128, 8)
  return -1;
}

}  // namespace

// Returns 0 on success, a cudaError_t code when the launch was refused,
// -1 for a dtype / head_dim / group size the kernel is not built for or a
// missing workspace. dtype: 0 = float32, 1 = bfloat16. With more than one
// chunk of keys (paddle_decode_attention_key_chunk() keys each) in pps
// pages, ws is an f32 workspace of chunks * T * H * (Dh + 2) floats and
// counters T * Hkv ints, zero (the kernel leaves them zero); otherwise
// both may be null. Launches on `stream`, never synchronises, allocates
// nothing.
extern "C" int paddle_rpa_packed(const void* q, const void* k_pages,
                                 const void* v_pages, const void* tok_slot,
                                 const void* tok_qoff, const void* q_len,
                                 const void* kv_len, const void* tables,
                                 void* out, void* ws, void* counters, int T,
                                 int H, int Hkv, int Dh, int P,
                                 int page_size, int S, int pps,
                                 float sm_scale, int dtype, void* stream) {
  if (T <= 0 || P <= 0 || page_size <= 0 || pps <= 0 || S <= 0) return -1;
  const int nc = decode_attn::n_chunks(pps, page_size);
  float* wo = static_cast<float*>(ws);
  Params a{};
  a.q = q;
  a.k_pages = k_pages;
  a.v_pages = v_pages;
  a.tok_slot = static_cast<const int*>(tok_slot);
  a.tok_qoff = static_cast<const int*>(tok_qoff);
  a.q_len = static_cast<const int*>(q_len);
  a.kv_len = static_cast<const int*>(kv_len);
  a.tables = static_cast<const int*>(tables);
  a.out = out;
  a.ws_o = wo;
  a.ws_ml = wo == nullptr ? nullptr
                          : wo + static_cast<size_t>(nc) * T * H * Dh;
  a.counters = static_cast<int*>(counters);
  a.n_tok = T;
  a.H = H;
  a.Hkv = Hkv;
  a.P = P;
  a.page_size = page_size;
  a.S = S;
  a.pps = pps;
  a.sm_scale = sm_scale;
  const auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, Dh, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(a, Dh, st);
  return -1;
}
