"""Llama-family decoder: the serving slice of the PyTorch port.

Port of ``paddle_tpu/models/llama.py``:

* ``LlamaConfig`` (``tiny``, ``llama3_8b``) and the params: a plain dict
  in the JAX layouts — weights ``[in, out]``, per-layer tensors stacked
  on a leading ``L`` axis — from ``init_params`` (seeded
  ``torch.Generator``) or ``params_from_jax`` (the JAX pytree as numpy
  arrays);
* the block math ``_block`` (rms_norm -> QKV -> rope -> attention ->
  o-proj + residual -> rms_norm -> SwiGLU + residual), dense weights,
  one device;
* the KV-cache oracle path ``init_kv_cache`` / ``forward_with_cache`` /
  ``generate`` (greedy), whose attention is plain causal GQA;
* the serving tick over the shared page pools ``init_serving_pages`` /
  ``serving_tick`` / ``serving_tick_block``, whose attention is the
  ragged paged-attention kernel (``ops/kernels/ragged_paged_attention``);
* paged decode: ``prefill_paged`` / ``generate_paged`` (prompt pages by
  pure reshape, a dense tail of generated tokens, attention through the
  paged-attention stats kernel) and the single-request serving steps
  ``serving_prefill`` / ``serving_prefill_chunk`` /
  ``serving_decode_step`` / ``serving_decode_block`` over shared pools
  (``ops/kernels/paged_attention``);
* weight-only int8 decode: every projection and ``lm_head`` goes through
  ``_mm``, which sends an ``Int8Weight`` (``quantization.decode``) to the
  int8 matmul kernel (``ops/kernels/int8_matmul``).

* the training path ``forward`` -> ``loss_fn`` -> ``make_train_step``
  (one device, no mesh): per-layer remat through
  ``torch.utils.checkpoint``, the fused RMSNorm / RoPE kernels
  (``ops/kernels/fused_norm_rope``) and the flash-attention kernels
  (``ops/kernels/flash_attention``) as ``LlamaConfig`` asks, the fused
  cross-entropy (``ops/fused``) and AdamW with optax's arithmetic.

PyTorch runs eagerly, so the layer scan is a Python loop and the pools,
params and optimizer state are updated in place instead of being
returned as new arrays.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..inference.paged_kv import (paged_attention,
                                  paged_attention_with_tail,
                                  prompt_pages_from_dense,
                                  write_prompt_pages, write_token_pages)
from ..ops.fused import fused_softmax_cross_entropy
from ..ops.fused.int8_matmul import Int8Weight
from ..ops.kernels.flash_attention import flash_attention
from ..ops.kernels.fused_norm_rope import fused_rms_norm, fused_rope
from ..ops.kernels.ragged_paged_attention import (
    ragged_paged_attention_packed)

__all__ = ["LlamaConfig", "init_params", "params_from_jax", "rms_norm",
           "rope", "init_kv_cache", "forward_with_cache", "generate",
           "init_serving_pages", "pack_tick", "serving_tick",
           "serving_tick_block", "prefill_paged", "generate_paged",
           "serving_prefill", "serving_prefill_chunk",
           "serving_decode_step", "serving_decode_block", "decoder_layer",
           "forward", "loss_fn", "AdamW", "default_train_optimizer", "make_train_step",
           "make_batch", "params_to_numpy", "normal_init",
           "one_device_trainer"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    # per-layer activation recompute in the training path
    remat: bool = True
    # the training path's kernels: True / "auto" — the Hopper kernel for
    # CUDA tensors, its plain version for CPU tensors; "kernel" — strict
    # (raises instead of any fallback); "reference" — the plain version.
    # use_fused_norm_rope=False runs the unfused rms_norm / rope instead.
    use_flash_attention: Any = True
    use_fused_norm_rope: Any = "auto"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=8, rope_theta=500000.0, **kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test config."""
        return LlamaConfig(
            vocab_size=256, hidden_size=64, intermediate_size=128,
            num_hidden_layers=4, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128, **kw)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def normal_init(shape, fan_in: int, dtype, generator: torch.Generator,
                dev) -> torch.Tensor:
    """A ``dtype`` tensor of normal · 1/sqrt(fan_in) draws from
    ``generator``, made one trailing matrix at a time, so the f32 draw
    never holds more than one matrix beside the result."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    flat = out.view(-1, *shape[-2:])
    std = 1.0 / math.sqrt(fan_in)
    for i in range(flat.shape[0]):
        flat[i] = (torch.randn(shape[-2:], generator=generator, device=dev,
                               dtype=torch.float32) * std).to(dtype)
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params, normal · 1/sqrt(fan_in) (norms at one), drawn
    from ``generator`` (which must live on ``device``) one matrix at a
    time (``normal_init``)."""
    dev = resolve_device(device)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    L = cfg.num_hidden_layers

    def init(shape, fan_in):
        return normal_init(shape, fan_in, cfg.dtype, generator, dev)

    layers = {
        "wq": init((L, D, H * Dh), D),
        "wk": init((L, D, Hkv * Dh), D),
        "wv": init((L, D, Hkv * Dh), D),
        "wo": init((L, H * Dh, D), H * Dh),
        "w_gate": init((L, D, Fi), D),
        "w_up": init((L, D, Fi), D),
        "w_down": init((L, Fi, D), Fi),
        "attn_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
        "mlp_norm": torch.ones((L, D), dtype=cfg.dtype, device=dev),
    }
    return {
        "embed": init((V, D), D),
        "layers": layers,
        "final_norm": torch.ones((D,), dtype=cfg.dtype, device=dev),
        "lm_head": init((D, V), D),
    }


_TORCH_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                 "float16": torch.float16}


def params_from_jax(np_tree, device=None) -> Dict:
    """The JAX params pytree (``paddle_tpu.models.llama.init_params``
    output with every leaf as a numpy array) as the port's params, in
    the same layouts and dtypes. bf16 goes through f32, which is exact.
    A weight-only int8 leaf pair (any object with ``.q`` and ``.scale``,
    such as the JAX ``Int8Weight`` with numpy leaves) becomes an
    ``Int8Weight`` with the same bits."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if hasattr(x, "q") and hasattr(x, "scale"):
            q, scale = np.asarray(x.q), np.asarray(x.scale)
            if q.dtype != np.int8 or scale.dtype != np.float32:
                raise TypeError(f"int8 weight must be int8 q and float32 "
                                f"scale, got {q.dtype}/{scale.dtype}")
            return Int8Weight(torch.from_numpy(q.copy()).to(dev),
                              torch.from_numpy(scale.copy()).to(dev))
        x = np.asarray(x)
        if x.dtype.name not in _TORCH_DTYPES:
            raise TypeError(f"unsupported param dtype {x.dtype}")
        return torch.from_numpy(np.array(x, np.float32)).to(
            device=dev, dtype=_TORCH_DTYPES[x.dtype.name])

    return conv(dict(np_tree))


def _select(tree, i: int):
    """Row ``i`` of every tensor of a (nested) dict of stacked tensors."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    return tree[i]


def _layer(params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s weights, from stacked layers (a dict, possibly
    nested, of ``[L, ...]`` tensors) or from per-layer leaves (a list of
    dicts, the trainer's)."""
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        return layers[i]
    return _select(layers, i)


# ---------------------------------------------------------------------------
# model math
# ---------------------------------------------------------------------------

def _mm(x, w):
    """``x @ w`` for a dense weight; an ``Int8Weight`` (weight-only int8
    decode, ``quantization/decode.py``) goes to the int8 matmul kernel
    (its plain version for CPU tensors), with the scale applied to the
    f32 sum."""
    if isinstance(w, Int8Weight):
        return w.dequant_matmul(x)
    return x @ w


def rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def rope(q, k, positions, theta, head_dim):
    """Rotary embedding (rotate-half layout) on ``[B, T, H, Dh]`` q/k;
    positions ``[B, T]``; angles in f32."""
    half = head_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=q.device) / half))
    angles = positions[..., None].float() * freqs          # [B, T, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def _kernel_impl(flag) -> str:
    """A ``LlamaConfig`` kernel switch as a kernel entry's ``impl``."""
    if flag is True or flag == "auto":
        return "auto"
    if flag is False or flag == "reference":
        return "reference"
    if flag == "kernel":
        return "kernel"
    raise ValueError(f"kernel switch must be True/'auto', 'kernel' or "
                     f"False/'reference', got {flag!r}")


def _fused_nr_on(cfg: LlamaConfig) -> Optional[str]:
    """The fused rmsnorm/rope kernels' ``impl`` for the training path, or
    None for the unfused formulation (``use_fused_norm_rope=False``)."""
    v = cfg.use_fused_norm_rope
    if v is False or v == "off":
        return None
    return _kernel_impl(v)


def _norm_fn(cfg: LlamaConfig, nr_impl: Optional[str]):
    if nr_impl is None:
        return lambda x, w: rms_norm(x, w, cfg.rms_norm_eps)
    return lambda x, w: fused_rms_norm(x, w, cfg.rms_norm_eps, nr_impl)


def _block(lp, h, positions, cfg: LlamaConfig, attn_fn,
           nr_impl: Optional[str] = None):
    """One transformer block on ``[B, T, D]``; ``attn_fn(q, k, v)`` is
    the only thing the oracle, serving and training paths vary, and
    ``nr_impl`` (training) routes rmsnorm/rope through the fused
    kernels."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    norm = _norm_fn(cfg, nr_impl)
    x = norm(h, lp["attn_norm"])
    q = _mm(x, lp["wq"]).reshape(B, T, H, Dh)
    k = _mm(x, lp["wk"]).reshape(B, T, Hkv, Dh)
    v = _mm(x, lp["wv"]).reshape(B, T, Hkv, Dh)
    if nr_impl is None:
        q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    else:
        q, k = fused_rope(q, k, positions, cfg.rope_theta, nr_impl)
    o = attn_fn(q, k, v)
    h = h + _mm(o.reshape(B, T, H * Dh), lp["wo"])
    x = norm(h, lp["mlp_norm"])
    return h + _mm(F.silu(_mm(x, lp["w_gate"])) * _mm(x, lp["w_up"]),
                   lp["w_down"])


# ---------------------------------------------------------------------------
# oracle: dense KV cache + generate
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: LlamaConfig, batch_size: int, max_len: int,
                  device=None):
    """Empty per-layer K/V cache ``[L, B, max_len, Hkv, Dh]``."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, batch_size, max_len,
             cfg.num_key_value_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _causal_attention(q, k, v):
    """Plain causal GQA over fresh keys (bottom-right mask): the flash
    entry's plain version, ``flash_attention._dense_reference``."""
    return flash_attention(q, k, v, causal=True, impl="reference")


def _cached_attention(q, ck, cv, pos0: int):
    """q ``[B, T, H, Dh]`` against the whole cache ``[B, S, Hkv, Dh]``;
    the query at position pos0 + t sees keys at positions <= pos0 + t.
    GQA as a grouped einsum against the un-repeated cache."""
    B, T, H, Dh = q.shape
    S, Hkv = ck.shape[1], ck.shape[2]
    qg = q.reshape(B, T, Hkv, H // Hkv, Dh)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, ck) / math.sqrt(Dh)
    key_pos = torch.arange(S, device=q.device)[None, :]
    q_pos = pos0 + torch.arange(T, device=q.device)[:, None]
    scores = torch.where(key_pos <= q_pos, scores.float(), -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    o = torch.einsum("bkgts,bskd->btkgd", probs, cv)
    return o.reshape(B, T, H, Dh)


@torch.no_grad()
def forward_with_cache(params, tokens, cache, pos0: int,
                       cfg: LlamaConfig):
    """tokens ``[B, T]`` at positions pos0 .. pos0+T-1 -> (f32 logits of
    the LAST position ``[B, V]``, cache). The cache is updated in place
    (and returned). pos0 == 0 is a prompt: plain causal attention over
    the fresh keys; otherwise attention over the cache."""
    B, T = tokens.shape
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = (pos0 + torch.arange(T, device=h.device)).expand(B, T)
    for i in range(cfg.num_hidden_layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attn_fn(q, k, v, ck=ck, cv=cv):
            ck[:, pos0:pos0 + T] = k.to(ck.dtype)
            cv[:, pos0:pos0 + T] = v.to(cv.dtype)
            if pos0 == 0:
                return _causal_attention(q, k, v)
            return _cached_attention(q, ck, cv, pos0)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, -1], params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"]).float(), cache


@torch.no_grad()
def generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int, *,
             eos_token_id: Optional[int] = None):
    """Greedy autoregressive decode with a dense KV cache, on the
    params' device. prompt: int ``[B, T0]``. Returns int32
    ``[B, T0 + max_new_tokens]`` (prompt + continuation; positions after
    EOS repeat EOS when ``eos_token_id`` is set)."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    dev = params["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    B, T0 = prompt.shape
    cache = init_kv_cache(cfg, B, T0 + max_new_tokens, dev)
    logits, cache = forward_with_cache(params, prompt, cache, 0, cfg)
    tok = logits.argmax(-1)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_token_id is None
            else tok == eos_token_id)
    out = [tok]
    for step in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, tok[:, None], cache,
                                           T0 + step, cfg)
        tok = logits.argmax(-1)
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1)], dim=1).int()


# ---------------------------------------------------------------------------
# serving: the ragged tick over a shared page pool
# ---------------------------------------------------------------------------

def init_serving_pages(cfg: LlamaConfig, total_pages: int, page_size: int,
                       device=None):
    """Layer-stacked page pools ``[L, Hkv, P, ps, Dh]`` (page 0 =
    trash)."""
    dev = resolve_device(device)
    shape = (cfg.num_hidden_layers, cfg.num_key_value_heads, total_pages,
             page_size, cfg.head_dim)
    return {"k_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v_pages": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def pack_tick(decode, spans, tables, page_size: int, device=None):
    """The packed stream and metadata of one ragged tick, as
    ``serving_tick`` takes them.

    tables: int ``[S, pps]``, one page-table row per slot. decode:
    ``[(slot, token, pos)]``, a decode row at packed index ``slot``
    whose token sits at position ``pos``. spans: ``[(slot, tokens,
    start)]``, prompt tokens at positions ``start, start + 1, ...``,
    packed in order after the ``S`` decode positions. Idle decode
    positions are padding (``tok_slot == S``); the KV of padding and of
    positions past the table lands on the trash page (page 0).

    Returns ``(tokens [T], meta)`` as int32 tensors on ``device``; the
    caller adds ``tail_live`` when it fuses a decode tail."""
    tables = np.asarray(tables, np.int32)
    S, pps = tables.shape
    T = S + sum(len(t) for _, t, _ in spans)
    tok = np.zeros((T,), np.int32)
    tok_slot = np.full((T,), S, np.int32)
    tok_pos = np.zeros((T,), np.int32)
    tok_qoff = np.zeros((T,), np.int32)
    q_len = np.zeros((S,), np.int32)
    kv_len = np.zeros((S,), np.int32)
    last = np.zeros((S,), np.int32)
    for slot, t, pos in decode:
        tok[slot], tok_slot[slot], tok_pos[slot] = t, slot, pos
        q_len[slot], kv_len[slot], last[slot] = 1, pos + 1, slot
    idx = S
    for slot, t, start in spans:
        take = len(t)
        tok[idx:idx + take] = t
        tok_slot[idx:idx + take] = slot
        tok_pos[idx:idx + take] = np.arange(start, start + take)
        tok_qoff[idx:idx + take] = np.arange(take)
        q_len[slot], kv_len[slot] = take, start + take
        last[slot] = idx + take - 1
        idx += take
    real = tok_slot < S
    page_i = tok_pos // page_size
    tok_page = np.where(real & (page_i < pps),
                        tables[np.minimum(tok_slot, S - 1),
                               np.minimum(page_i, pps - 1)], 0)
    tok_off = np.where(real, tok_pos % page_size, 0)
    dev = resolve_device(device)
    meta = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
            for k, v in dict(tok_slot=tok_slot, tok_pos=tok_pos,
                             tok_page=tok_page, tok_off=tok_off,
                             tok_qoff=tok_qoff, q_len=q_len, kv_len=kv_len,
                             last=last, tables=tables).items()}
    return torch.from_numpy(tok).to(dev), meta


@torch.no_grad()
def serving_tick(params, tokens, meta, k_pages, v_pages, cfg: LlamaConfig,
                 decode_tail: int = 0, attn_impl: str = "auto"):
    """ONE ragged serving tick: any mix of chunked prefills, warm-prefix
    attaches and decode steps over the packed token stream.

    tokens ``[T]`` int32 — the tick's packed stream. ``meta`` — int32
    tensors on the pools' device describing the packing, as in the JAX
    tick (``pack_tick`` builds both): ``tok_slot [T]`` (``S`` = padding token), ``tok_pos [T]``
    (absolute position), ``tok_page``/``tok_off [T]`` (where its KV
    lands; the trash page for padding), ``tok_qoff [T]`` (offset in its
    slot's span), ``q_len``/``kv_len [S]``, ``last [S]`` (packed index
    of each slot's last span token) and ``tables [S, pps]``; with
    ``decode_tail`` also ``tail_live [S]`` (bool).

    Each layer first scatters the span's K/V into ``k_pages``/
    ``v_pages`` IN PLACE (padding writes land on the trash page), then
    attends over the pages only, bottom-right causal, so a prefix's KV
    is a function of the prefix tokens alone and chunked, warm and
    whole prefills produce the same bits.

    ``decode_tail`` fuses that many extra greedy decode steps for the
    tail-live slots (decoding slots and spans completing their prompt);
    the others stay dead through the tail (q_len 0, KV to the trash
    page).

    attn_impl: ``"auto"`` (the kernel on CUDA tensors, the plain
    version on CPU tensors), ``"kernel"`` (strict) or ``"reference"``
    (the plain version; tests and the kernel's comparison only).

    Returns ``(toks, logits [S, V] f32, k_pages, v_pages)``: ``toks`` is
    each slot's greedy pick at its last position, ``[S]`` int32 when
    ``decode_tail == 0``, else ``[S, 1 + decode_tail]``; ``logits`` are
    the ragged pass's; the pools are the inputs, updated.
    """
    S = meta["q_len"].shape[0]
    tok_slot, tok_qoff = meta["tok_slot"], meta["tok_qoff"]
    tok_page, tok_off = meta["tok_page"].long(), meta["tok_off"].long()
    h = params["embed"].to(cfg.dtype)[tokens.long()][None]     # [1, T, D]
    positions = meta["tok_pos"][None]
    for i in range(cfg.num_hidden_layers):
        kp, vp = k_pages[i], v_pages[i]

        def attn_fn(q, k, v, kp=kp, vp=vp):
            kp[:, tok_page, tok_off] = k[0].transpose(0, 1).to(kp.dtype)
            vp[:, tok_page, tok_off] = v[0].transpose(0, 1).to(vp.dtype)
            o = ragged_paged_attention_packed(
                q[0].contiguous(), kp, vp, tok_slot, tok_qoff,
                meta["q_len"], meta["kv_len"], meta["tables"],
                impl=attn_impl)
            return o[None].to(q.dtype)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[0], params["final_norm"], cfg.rms_norm_eps)   # [T, D]
    logits = _mm(h[meta["last"].long()], params["lm_head"]).float()
    toks = logits.argmax(-1).int()
    if not decode_tail:
        return toks, logits, k_pages, v_pages

    tables = meta["tables"]
    ps = k_pages.shape[-2]
    pps = tables.shape[1]
    b_idx = torch.arange(S, dtype=torch.int32, device=toks.device)
    zeros = torch.zeros_like(b_idx)
    live = meta["tail_live"].bool()
    tok, lens, out = toks, meta["kv_len"], [toks]
    for _ in range(int(decode_tail)):
        slot = lens // ps
        # out-of-table rows (retiring overruns) and tail-dead slots land
        # on the trash page
        ok = live & (slot < pps)
        page = torch.where(
            ok, tables[b_idx.long(), slot.clamp(max=pps - 1).long()], 0)
        m = dict(tok_slot=torch.where(live, b_idx, S), tok_pos=lens,
                 tok_page=page, tok_off=torch.where(ok, lens % ps, 0),
                 tok_qoff=zeros, q_len=live.int(), kv_len=lens + 1,
                 last=b_idx, tables=tables)
        tok, _, _, _ = serving_tick(params, tok, m, k_pages, v_pages, cfg,
                                    attn_impl=attn_impl)
        lens = lens + 1
        out.append(tok)
    return torch.stack(out, dim=1), logits, k_pages, v_pages


def serving_tick_block(params, tok, lengths, tables, k_pages, v_pages,
                       cfg: LlamaConfig, num_steps: int,
                       attn_impl: str = "auto"):
    """``num_steps`` fused greedy decode steps built on the ragged tick:
    tok/lengths ``[S]`` int32, tables ``[S, pps]``; dead slots (all-trash
    rows) write to and read from the trash page. Returns
    ``(toks [S, num_steps] int32, k_pages, v_pages)``."""
    S = tok.shape[0]
    pps = tables.shape[1]
    ps = k_pages.shape[-2]
    b_idx = torch.arange(S, dtype=torch.int32, device=tok.device)
    slot = lengths // ps
    page = torch.where(
        slot < pps, tables[b_idx.long(), slot.clamp(max=pps - 1).long()], 0)
    meta = dict(tok_slot=b_idx, tok_pos=lengths, tok_page=page,
                tok_off=lengths % ps, tok_qoff=torch.zeros_like(b_idx),
                q_len=torch.ones_like(b_idx), kv_len=lengths + 1,
                last=b_idx, tables=tables,
                tail_live=torch.ones_like(b_idx, dtype=torch.bool))
    toks, _, k_pages, v_pages = serving_tick(
        params, tok, meta, k_pages, v_pages, cfg,
        decode_tail=num_steps - 1, attn_impl=attn_impl)
    if num_steps == 1:
        toks = toks[:, None]
    return toks, k_pages, v_pages


# ---------------------------------------------------------------------------
# paged decode: prompt pages + dense tail (generate_paged)
# ---------------------------------------------------------------------------

def _prefill_attn_impl(cfg: LlamaConfig, attn_impl: str) -> str:
    """The flash entry's ``impl`` for a prefill: an explicit
    ``attn_impl`` wins, else ``cfg.use_flash_attention``."""
    if attn_impl != "auto":
        return _kernel_impl(attn_impl)
    return _kernel_impl(cfg.use_flash_attention)


def _int32(x, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=torch.int32)
    return torch.as_tensor(np.asarray(x, np.int32), device=dev)


def _last_logits(params, h, lengths, cfg: LlamaConfig):
    """f32 logits ``[B, V]`` at each row's last valid position of
    ``h [B, T, D]``."""
    idx = (lengths.long() - 1).clamp(min=0)
    h_last = h[torch.arange(h.shape[0], device=h.device), idx]
    h_last = rms_norm(h_last, params["final_norm"], cfg.rms_norm_eps)
    return _mm(h_last, params["lm_head"]).float()


@torch.no_grad()
def prefill_paged(params, tokens, lengths, cfg: LlamaConfig,
                  max_new_tokens: int, page_size: int = 16,
                  attn_impl: str = "auto"):
    """Ragged prefill: ``tokens [B, T0]`` right-padded, ``lengths [B]``
    valid counts, on the params' device. Causal flash over the padded
    prompt; each layer's prompt KV becomes pages by pure reshape
    (``prompt_pages_from_dense``). Returns (f32 logits at each
    sequence's last valid position ``[B, V]``, cache): the cache holds
    the layer-stacked pages ``[L, Hkv, P, ps, Dh]``, the shared tables
    ``[B, pps]``, ``prompt_lens``, an empty dense tail
    ``[L, B, max_new_tokens, Hkv, Dh]`` per K and V, and ``n_tail``."""
    dev = params["embed"].device
    tokens = _int32(tokens, dev)
    lengths = _int32(lengths, dev)
    B, T0 = tokens.shape
    L, Hkv, Dh = cfg.num_hidden_layers, cfg.num_key_value_heads, \
        cfg.head_dim
    impl = _prefill_attn_impl(cfg, attn_impl)
    pps = -(-T0 // page_size)
    shape = (L, Hkv, 1 + B * pps, page_size, Dh)
    k_pages = torch.empty(shape, dtype=cfg.dtype, device=dev)
    v_pages = torch.empty(shape, dtype=cfg.dtype, device=dev)
    cell = {}
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(T0, device=dev).expand(B, T0)
    for i in range(L):
        def attn_fn(q, k, v, i=i):
            kp, vp, cell["tables"] = prompt_pages_from_dense(
                k.to(cfg.dtype), v.to(cfg.dtype), page_size)
            k_pages[i], v_pages[i] = kp, vp
            # causal flash over the fresh prompt keys; padding rows
            # compute values that no valid row or page read sees
            return flash_attention(q, k, v, causal=True, impl=impl)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    logits = _last_logits(params, h, lengths, cfg)
    nt = max(int(max_new_tokens), 1)
    tail = (L, B, nt, Hkv, Dh)
    cache = {"k_pages": k_pages, "v_pages": v_pages,
             "tables": cell["tables"], "prompt_lens": lengths,
             "k_tail": torch.zeros(tail, dtype=cfg.dtype, device=dev),
             "v_tail": torch.zeros(tail, dtype=cfg.dtype, device=dev),
             "n_tail": 0}
    return logits, cache


@torch.no_grad()
def _decode_paged_step(params, tok, cache, cfg: LlamaConfig,
                       attn_impl: str = "auto"):
    """One paged decode step: ``tok [B]`` -> f32 logits ``[B, V]``. The
    token's KV is appended to the dense tail IN PLACE (no page write);
    attention merges the paged prompt (the stats kernel) with the live
    tail (``paged_attention_with_tail``). Advances ``cache["n_tail"]``."""
    lens0, n = cache["prompt_lens"], cache["n_tail"]
    h = params["embed"].to(cfg.dtype)[tok.long()][:, None]      # [B, 1, D]
    positions = (lens0 + n)[:, None]
    for i in range(cfg.num_hidden_layers):
        kt, vt = cache["k_tail"][i], cache["v_tail"][i]

        def attn_fn(q, k, v, i=i, kt=kt, vt=vt):
            kt[:, n] = k[:, 0].to(kt.dtype)
            vt[:, n] = v[:, 0].to(vt.dtype)
            o = paged_attention_with_tail(
                q[:, 0].contiguous(), cache["k_pages"][i],
                cache["v_pages"][i], lens0, cache["tables"], kt, vt, n + 1,
                impl=attn_impl)
            return o[:, None].to(q.dtype)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps)
    cache["n_tail"] = n + 1
    return _mm(h, params["lm_head"]).float()


def _greedy_only(temperature: float) -> None:
    if temperature:
        raise NotImplementedError(
            "sampling (temperature > 0) is not ported yet: the fused "
            "sampler comes with a later slice of the port; this path "
            "decodes greedily")


@torch.no_grad()
def generate_paged(params, prompt, lengths, cfg: LlamaConfig,
                   max_new_tokens: int, *, page_size: int = 16,
                   temperature: float = 0.0,
                   eos_token_id: Optional[int] = None,
                   attn_impl: str = "auto"):
    """Batched greedy decode over the paged KV cache, on the params'
    device. prompt: int ``[B, T0]`` right-padded; lengths: valid counts
    ``[B]``. Returns the int32 ``[B, max_new_tokens]`` continuations
    (positions after EOS repeat EOS when ``eos_token_id`` is set).
    ``attn_impl`` (``"auto"`` | ``"kernel"`` | ``"reference"``) picks the
    paged attention and, when not ``"auto"``, the prefill's flash
    attention too."""
    _greedy_only(temperature)
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    logits, cache = prefill_paged(params, prompt, lengths, cfg,
                                  max_new_tokens, page_size, attn_impl)
    tok = logits.argmax(-1)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_token_id is None
            else tok == eos_token_id)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits = _decode_paged_step(params, tok, cache, cfg, attn_impl)
        tok = logits.argmax(-1)
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        out.append(tok)
    return torch.stack(out, dim=1).int()


# ---------------------------------------------------------------------------
# serving steps: one request's prefill, all slots' decode, shared pools
# ---------------------------------------------------------------------------

@torch.no_grad()
def serving_prefill(params, tokens, length, table, k_pages, v_pages,
                    cfg: LlamaConfig, attn_impl: str = "auto"):
    """Prefill ONE request into its allocated pages.

    tokens ``[1, Tb]`` right-padded; length: valid tokens; table
    ``[pps]`` int32, the slot's page-table row (trailing entries may be
    the trash page); k_pages/v_pages: the layer-stacked pools, updated
    IN PLACE (padding positions write to the trash page). Returns
    ``(logits [V] f32 at the last valid position, k_pages, v_pages)``."""
    dev = k_pages.device
    tokens = _int32(tokens, dev)
    lengths = _int32(length, dev).reshape(1)
    tables = _int32(table, dev).reshape(1, -1)
    B, T0 = tokens.shape
    impl = _prefill_attn_impl(cfg, attn_impl)
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(T0, device=dev).expand(B, T0)
    for i in range(cfg.num_hidden_layers):
        def attn_fn(q, k, v, kp=k_pages[i], vp=v_pages[i]):
            write_prompt_pages(kp, vp, k, v, lengths, tables)
            return flash_attention(q, k, v, causal=True, impl=impl)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    return _last_logits(params, h, lengths, cfg)[0], k_pages, v_pages


@torch.no_grad()
def serving_prefill_chunk(params, tokens, length, table, k_pages, v_pages,
                          cfg: LlamaConfig, prefix_pages: int,
                          attn_impl: str = "auto"):
    """Prefill ONE chunk of a request's prompt at a page-aligned offset.

    tokens ``[1, Tc]`` right-padded chunk; length: valid tokens IN the
    chunk; table ``[pps]`` the slot's whole row; ``prefix_pages`` pages
    already hold the request's earlier tokens, so the chunk starts at
    position ``prefix_pages * page_size``. Each layer attends the
    gathered prefix plus the chunk with the bottom-right causal flash
    (every chunk query sees the whole prefix and its own causal window),
    then the chunk's KV is written IN PLACE. Returns ``(logits [V] f32 at
    the chunk's last valid position, k_pages, v_pages)``."""
    dev = k_pages.device
    prefix_pages = int(prefix_pages)
    tokens = _int32(tokens, dev)
    lengths = _int32(length, dev).reshape(1)
    tables = _int32(table, dev).reshape(1, -1)
    B, Tc = tokens.shape
    Hkv, ps, Dh = k_pages.shape[1], k_pages.shape[-2], k_pages.shape[-1]
    off = prefix_pages * ps
    pref_ids = tables[0, :prefix_pages].long()
    impl = _prefill_attn_impl(cfg, attn_impl)
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = (off + torch.arange(Tc, device=dev)).expand(B, Tc)

    def gather_prefix(pages, dtype):
        # [Hkv, n_pre, ps, Dh] -> [1, n_pre * ps, Hkv, Dh]
        pre = pages[:, pref_ids].reshape(Hkv, off, Dh)
        return pre.transpose(0, 1)[None].to(dtype)

    for i in range(cfg.num_hidden_layers):
        def attn_fn(q, k, v, kp=k_pages[i], vp=v_pages[i]):
            if prefix_pages:
                kc = torch.cat([gather_prefix(kp, k.dtype), k], dim=1)
                vc = torch.cat([gather_prefix(vp, v.dtype), v], dim=1)
            else:
                kc, vc = k, v
            write_prompt_pages(kp, vp, k, v, lengths, tables, offset=off)
            return flash_attention(q, kc, vc, causal=True, impl=impl)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    return _last_logits(params, h, lengths, cfg)[0], k_pages, v_pages


@torch.no_grad()
def serving_decode_step(params, tok, lengths, tables, k_pages, v_pages,
                        cfg: LlamaConfig, attn_impl: str = "auto"):
    """One decode step for ALL slots: tok ``[S]`` each slot's current
    token, lengths ``[S]`` tokens already in its cache (0 for dead slots,
    whose all-trash table rows write to and read from the trash page;
    their logits are discarded), tables ``[S, pps]``. Each token's KV
    lands at position ``lengths[s]`` (IN PLACE), then the paged-attention
    kernel covers ``lengths + 1`` positions. Returns ``(logits [S, V]
    f32, k_pages, v_pages)``."""
    dev = k_pages.device
    tok = _int32(tok, dev)
    lengths = _int32(lengths, dev)
    tables = _int32(tables, dev)
    h = params["embed"].to(cfg.dtype)[tok.long()][:, None]       # [S, 1, D]
    positions = lengths[:, None]
    for i in range(cfg.num_hidden_layers):
        def attn_fn(q, k, v, kp=k_pages[i], vp=v_pages[i]):
            write_token_pages(kp, vp, k[:, 0], v[:, 0], lengths, tables)
            o = paged_attention(q[:, 0].contiguous(), kp, vp, lengths + 1,
                                tables, impl=attn_impl)
            return o[:, None].to(q.dtype)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"]).float(), k_pages, v_pages


def serving_decode_block(params, tok, lengths, tables, k_pages, v_pages,
                         cfg: LlamaConfig, num_steps: int,
                         attn_impl: str = "auto"):
    """``num_steps`` greedy ``serving_decode_step`` calls. Returns
    ``(toks [S, num_steps] int32, k_pages, v_pages)``; the host
    truncates a sequence at EOS / max_new_tokens (positions past a
    table's width land on the trash page)."""
    dev = k_pages.device
    tok = _int32(tok, dev)
    lens = _int32(lengths, dev)
    out = []
    for _ in range(int(num_steps)):
        logits, k_pages, v_pages = serving_decode_step(
            params, tok, lens, tables, k_pages, v_pages, cfg, attn_impl)
        tok = logits.argmax(-1).int()
        lens = lens + 1
        out.append(tok)
    return torch.stack(out, dim=1), k_pages, v_pages


# ---------------------------------------------------------------------------
# training: forward, loss, AdamW, the train step
# ---------------------------------------------------------------------------

def _train_attn_fn(cfg: LlamaConfig):
    impl = _kernel_impl(cfg.use_flash_attention)
    return lambda q, k, v: flash_attention(q, k, v, causal=True, impl=impl)


def decoder_layer(lp, h, cfg: LlamaConfig, positions=None):
    """One transformer block of the training path on ``[B, T, D]``;
    ``lp`` holds this layer's weights, ``positions`` defaults to
    ``arange(T)`` per row."""
    B, T, _ = h.shape
    if positions is None:
        positions = torch.arange(T, device=h.device).expand(B, T)
    return _block(lp, h, positions, cfg, _train_attn_fn(cfg),
                  nr_impl=_fused_nr_on(cfg))


def _scan_layers(params, h, cfg: LlamaConfig, remat: bool = False,
                 positions=None):
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        if remat:
            # per-layer remat: only each layer's input is kept for the
            # backward, which recomputes the layer first
            h = checkpoint(decoder_layer, lp, h, cfg, positions,
                           use_reentrant=False)
        else:
            h = decoder_layer(lp, h, cfg, positions)
    return h


def forward(params, tokens, cfg: LlamaConfig):
    """tokens ``[B, T]`` -> logits ``[B, T, V]`` in ``cfg.dtype`` (one
    device, one pipeline stage)."""
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    h = _scan_layers(params, h, cfg, remat=cfg.remat)
    h = _norm_fn(cfg, _fused_nr_on(cfg))(h, params["final_norm"])
    return h @ params["lm_head"]


def loss_fn(params, batch, cfg: LlamaConfig):
    """Mean next-token cross entropy through the fused op: the logits
    stay in the model dtype, no f32 log-softmax is saved."""
    logits = forward(params, batch["tokens"], cfg)
    return fused_softmax_cross_entropy(logits, batch["labels"]).mean()


def _tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, t) for t in tree]
    return fn(tree)


class AdamW:
    """AdamW with the arithmetic of optax 0.2.6's
    ``adamw(lr, b1, b2, eps, weight_decay)``: moments in the param dtype,
    the same order of operations, and Python constants rounded to the
    param dtype first, as JAX does with weak-typed scalars.

    ``update_(params, state)`` reads each leaf's ``.grad``, updates the
    leaf, its moments and ``state["count"]`` in place, and frees the
    gradient, one tensor at a time (never ``foreach``: at 8B that would
    hold temporaries for every parameter at once)."""

    def __init__(self, learning_rate: float = 3e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 1e-4):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params) -> Dict:
        zeros = lambda p: torch.zeros_like(p, requires_grad=False)
        return {"count": 0, "mu": _tree_map(zeros, params),
                "nu": _tree_map(zeros, params)}

    @torch.no_grad()
    def update_(self, params, state) -> None:
        count = state["count"] + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        # optax's 1 - decay**count, in f32
        bc1 = float(one - torch.tensor(self.b1) ** count)
        bc2 = float(one - torch.tensor(self.b2) ** count)
        for p, mu, nu in zip(_tree_leaves(params),
                             _tree_leaves(state["mu"]),
                             _tree_leaves(state["nu"])):
            g = p.grad
            if g is None:
                raise RuntimeError("AdamW.update_: a parameter has no grad")

            def c(x, dt=p.dtype):
                return float(torch.tensor(x, dtype=dt))

            # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
            mu.mul_(c(self.b1)).add_(g * c(1 - self.b1))
            nu.mul_(c(self.b2)).add_(g.square().mul_(c(1 - self.b2)))
            p.grad = None
            del g
            # mu_hat / (sqrt(nu_hat) + eps) + wd p, scaled by -lr
            u = mu / c(bc1)
            denom = (nu / c(bc2)).sqrt_().add_(c(self.eps))
            u.div_(denom)
            del denom
            u.add_(p * c(self.weight_decay)).mul_(c(-self.lr))
            p.add_(u)
        state["count"] = count


def default_train_optimizer() -> AdamW:
    """The optimizer ``make_train_step`` builds when none is given:
    ``optax.adamw(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)``."""
    return AdamW(3e-4, b1=0.9, b2=0.95, weight_decay=0.1)


def _train_params(params, dev) -> Dict:
    """Params as the trainer holds them: every tensor a leaf that needs
    a gradient, each layer's weights (nested dicts too) leaves of their
    own (rows of the stacked tensors, sharing their storage). A
    ``stacked[i]`` select of one stacked leaf would make autograd
    allocate a gradient of the whole stack for every layer."""
    def leaf(x):
        return x.detach().to(dev).requires_grad_(True)

    layers = params["layers"]
    if isinstance(layers, dict):
        n = _tree_leaves(layers)[0].shape[0]
        layers = [_select(layers, i) for i in range(n)]
    return {"embed": leaf(params["embed"]),
            "layers": [_tree_map(leaf, lp) for lp in layers],
            "final_norm": leaf(params["final_norm"]),
            "lm_head": leaf(params["lm_head"])}


def _stack(layers):
    """Per-layer (nested) dicts as one dict of ``[L, ...]`` stacks."""
    if isinstance(layers[0], dict):
        return {k: _stack([lp[k] for lp in layers]) for k in layers[0]}
    return torch.stack([x.detach() for x in layers])


def params_to_numpy(params) -> Dict:
    """Params (stacked or per-layer, nested layer dicts too) as the JAX
    pytree of numpy arrays: layers stacked on a leading ``L`` axis; bf16
    comes back as f32 (exact)."""
    def conv(x):
        x = x.detach().to("cpu")
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        layers = _stack(list(layers))
    return {"embed": conv(params["embed"]),
            "layers": _tree_map(conv, layers),
            "final_norm": conv(params["final_norm"]),
            "lm_head": conv(params["lm_head"])}


def make_train_step(cfg: LlamaConfig, *, device=None, optimizer=None,
                    mesh=None, zero_stage: int = 0):
    """The train step (forward, backward, AdamW) on one device.

    Returns ``(step_fn, init_fn)``. ``init_fn(source)`` builds the state
    ``{"params", "opt", "step"}`` from a ``torch.Generator`` (random init,
    ``init_params``) or from a params dict (``params_from_jax``, stacked
    or per layer). ``step_fn(state, batch)`` makes one update IN PLACE
    (params, moments and step are the state's own tensors, never doubly
    resident) and returns ``(state, loss)``, the loss of the params
    before the update as a 0-d f32 tensor.

    A mesh, ZeRO stages and pipeline stages belong to the parallel
    training slice and raise ``NotImplementedError``.
    """
    if mesh is not None or zero_stage:
        raise NotImplementedError(
            "the port's train step runs on one device: mesh, ZeRO and "
            "pipeline stages are not ported yet")
    return one_device_trainer(cfg, init_params, loss_fn, device, optimizer)


def one_device_trainer(cfg, init, loss, device=None, optimizer=None):
    """``(step_fn, init_fn)`` of a one-device train step for a model's
    ``init(cfg, generator, device)`` and ``loss(params, batch, cfg)``
    (see ``make_train_step``)."""
    dev = resolve_device(device)
    opt = default_train_optimizer() if optimizer is None else optimizer

    def init_fn(source):
        if isinstance(source, torch.Generator):
            source = init(cfg, source, dev)
        params = _train_params(source, dev)
        return {"params": params, "opt": opt.init(params), "step": 0}

    def step_fn(state, batch):
        value = loss(state["params"], batch, cfg)
        value.backward()
        opt.update_(state["params"], state["opt"])
        state["step"] += 1
        return state, value.detach()

    return step_fn, init_fn


def make_batch(cfg: LlamaConfig, batch_size: int, seq_len: int,
               device=None, generator: Optional[torch.Generator] = None):
    """Synthetic next-token batch: int32 tokens ``[B, T]`` and their
    labels (the tokens shifted by one), drawn from ``generator`` (seed 0
    on the device when none is given)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1),
                         generator=generator, device=dev,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}
