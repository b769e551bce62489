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
  ``generate``, whose attention is plain causal GQA (its loop
  ``_decode_loop`` and ``_forward_with_cache`` serve Qwen2-MoE's too);
* sampling: ``sample_logits`` (temperature, top-k, top-p, one key for
  the batch, as ``generate`` draws) and the serving tick's per-row
  sampler ``_fused_sample`` / ``sample_draw`` (token ``n`` of a request
  drawn with ``fold_in(key, n)``), on the threefry draws of ``prng``,
  which equal ``jax.random``'s bit for bit;
* the serving tick over the shared page pools ``init_serving_pages`` /
  ``serving_tick`` (with its speculative verify mode ``spec_k``) /
  ``serving_tick_block``, whose attention is the ragged paged-attention
  kernel (``ops/kernels/ragged_paged_attention``);
* paged decode: ``prefill_paged`` / ``generate_paged`` (prompt pages by
  pure reshape, a dense tail of generated tokens, attention through the
  paged-attention stats kernel) and the single-request serving steps
  ``serving_prefill`` / ``serving_prefill_chunk`` /
  ``serving_decode_step`` / ``serving_decode_block`` over shared pools
  (``ops/kernels/paged_attention``);
* every serving function above takes ``_block_fn``, the block math
  (``_block`` when None), so ``models.qwen2_moe`` serves through the
  same functions with its own block, as the JAX package does;
* weight-only int8 decode: every projection and ``lm_head`` goes through
  ``_mm``, which sends an ``Int8Weight`` (``quantization.decode``) to the
  int8 matmul kernel (``ops/kernels/int8_matmul``).

* the training path ``forward`` -> ``loss_fn`` -> ``make_train_step``
  (one device, or a dp x pp x cp x tp mesh over ``torch.distributed``:
  see ``param_specs`` and ``_mesh_trainer``; context parallelism under
  ring, zigzag or Ulysses attention, ``parallel/context_parallel``;
  pipelines under GPipe,
  lockstep 1F1B, rank-asymmetric 1F1B with interleaved VPP, or zero
  bubble, ``grads_1f1b``): per-layer remat through
  ``torch.utils.checkpoint``, the fused RMSNorm / RoPE kernels
  (``ops/kernels/fused_norm_rope``) and the flash-attention kernels
  (``ops/kernels/flash_attention``) as ``LlamaConfig`` asks, the fused
  cross-entropy (``ops/fused``) and AdamW with optax's arithmetic.

PyTorch runs eagerly, so the layer scan is a Python loop and the pools,
params and optimizer state are updated in place instead of being
returned as new arrays. ``jit.to_static`` captures ``loss_fn``,
``serving_tick`` (its page writes in place) and ``_decode_paged_step``
whole: every kernel entry is a PyTorch operator (``ops/kernels/_op.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import prng
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
from ..parallel.pipeline_async import PP_SCHEDULES, schedule_legality

__all__ = ["LlamaConfig", "init_params", "params_from_jax", "rms_norm",
           "rope", "init_kv_cache", "forward_with_cache", "sample_logits",
           "sample_draw", "generate",
           "init_serving_pages", "pack_tick", "serving_tick",
           "serving_tick_block", "prefill_paged", "generate_paged",
           "serving_prefill", "serving_prefill_chunk",
           "serving_decode_step", "serving_decode_block", "decoder_layer",
           "forward", "loss_fn", "AdamW", "default_train_optimizer",
           "make_train_step", "make_batch", "params_to_numpy", "normal_init",
           "one_device_trainer", "param_specs", "shard_params",
           "gather_params", "train_state_specs", "forward_pipelined",
           "grads_1f1b", "checkpoint_layout", "PIPE_SCHEDULES",
           "SERVING_KERNELS"]

# the kernel libraries serving_tick and serving_tick_block load on a CUDA
# device (ops/kernels/_build.py names); int8 weights add int8_matmul
SERVING_KERNELS = ("ragged_paged_attention",)


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
    # pipeline parallelism over a mesh's pp axis (the JAX fields):
    # "gpipe" — all forwards, then the backward through them (O(M) live
    # microbatch activations, parallel/pipeline_spmd); "1f1b" — the
    # lockstep fused forward+backward schedule (parallel/pipeline_1f1b);
    # "1f1b_async" — rank-asymmetric 1F1B and "zb" — its zero-bubble
    # W-deferral (parallel/pipeline_async). vpp_chunks: interleaved
    # chunks per rank under the 1f1b schedules.
    pp_stages: int = 1
    num_microbatches: int = 1
    pp_schedule: str = "gpipe"
    vpp_chunks: int = 1
    # per-layer activation recompute in the training path
    remat: bool = True
    # the training path's kernels: True / "auto" — the Hopper kernel for
    # CUDA tensors, its plain version for CPU tensors; "kernel" — strict
    # (raises instead of any fallback); "reference" — the plain version.
    # use_fused_norm_rope=False runs the unfused rms_norm / rope instead.
    use_flash_attention: Any = True
    use_fused_norm_rope: Any = "auto"
    # context parallelism over a mesh's cp axis: "none" | "ring" |
    # "zigzag" | "ulysses" (parallel/context_parallel). "zigzag" is the
    # causal-balanced ring: the tokens are laid out so every cp rank
    # holds one early and one late cell.
    context_parallel: str = "none"

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
                dev, rows=None) -> torch.Tensor:
    """A ``dtype`` tensor of normal · 1/sqrt(fan_in) draws from
    ``generator``, made one trailing matrix at a time, so the f32 draw
    never holds more than one matrix beside the result. ``rows`` keeps
    only those indices of a stacked ``[L, a, b]`` shape's leading axis;
    every matrix is still drawn, in order, so the kept ones are the
    whole draw's."""
    keep = range(shape[0]) if rows is None else list(rows)
    out = torch.empty((len(keep),) + tuple(shape[1:]) if rows is not None
                      else shape, dtype=dtype, device=dev)
    flat = out.view(-1, *shape[-2:])
    std = 1.0 / math.sqrt(fan_in)
    slot = {r: i for i, r in enumerate(keep)} if rows is not None else None
    for i in range(shape[0] if rows is not None else flat.shape[0]):
        m = (torch.randn(shape[-2:], generator=generator, device=dev,
                         dtype=torch.float32) * std).to(dtype)
        if slot is None:
            flat[i] = m
        elif i in slot:
            flat[slot[i]] = m
    return out


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None, layers=None) -> Dict:
    """Random params, normal · 1/sqrt(fan_in) (norms at one), drawn
    from ``generator`` (which must live on ``device``) one matrix at a
    time (``normal_init``). ``layers`` (global indices, ascending) keeps
    only those layers' rows of the stacked leaves, with the values the
    whole draw gives them (a pipeline rank's)."""
    dev = resolve_device(device)
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    L = cfg.num_hidden_layers

    def init(shape, fan_in):
        rows = layers if len(shape) == 3 else None
        return normal_init(shape, fan_in, cfg.dtype, generator, dev, rows)

    Lk = L if layers is None else len(layers)

    layers = {
        "wq": init((L, D, H * Dh), D),
        "wk": init((L, D, Hkv * Dh), D),
        "wv": init((L, D, Hkv * Dh), D),
        "wo": init((L, H * Dh, D), H * Dh),
        "w_gate": init((L, D, Fi), D),
        "w_up": init((L, D, Fi), D),
        "w_down": init((L, Fi, D), Fi),
        "attn_norm": torch.ones((Lk, D), dtype=cfg.dtype, device=dev),
        "mlp_norm": torch.ones((Lk, D), dtype=cfg.dtype, device=dev),
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
    v = getattr(cfg, "use_fused_norm_rope", False)   # Qwen2-MoE: plain
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
    return _forward_with_cache(params, tokens, cache, pos0, cfg, _block,
                               _causal_attention)


def _forward_with_cache(params, tokens, cache, pos0: int, cfg, block_fn,
                        prompt_attn):
    """``forward_with_cache`` for any block math ``block_fn`` (Llama's
    ``_block``, Qwen2-MoE's ``_decode_block``); ``prompt_attn(q, k, v)``
    is the causal attention of a prompt (pos0 == 0)."""
    B, T = tokens.shape
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = (pos0 + torch.arange(T, device=h.device)).expand(B, T)
    for i in range(cfg.num_hidden_layers):
        ck, cv = cache["k"][i], cache["v"][i]

        def attn_fn(q, k, v, ck=ck, cv=cv):
            ck[:, pos0:pos0 + T] = k.to(ck.dtype)
            cv[:, pos0:pos0 + T] = v.to(cv.dtype)
            if pos0 == 0:
                return prompt_attn(q, k, v)
            return _cached_attention(q, ck, cv, pos0)

        h = block_fn(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, -1], params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"]).float(), cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

_MASKED = -1e30     # a logit masked out by top-k / top-p


def _softmax(x):
    """``jax.nn.softmax`` over the last axis, in its order of
    operations."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def _top_p_cutoff(srt, top_p):
    """The smallest kept logit of each descending-sorted row ``srt``:
    the shortest prefix whose mass reaches ``top_p``, the top-1 token
    always kept (so top_p 0 degrades to greedy)."""
    probs = _softmax(srt)
    keep = (torch.cumsum(probs, dim=-1) - probs) < top_p
    keep[:, 0] = True
    return torch.where(keep, srt, math.inf).amin(-1)


def _key_tensor(key, dev) -> torch.Tensor:
    """A raw key (``prng.key``) on ``dev``; ``None`` is ``prng.key(0)``."""
    return prng.key(0, dev) if key is None else key.to(dev)


def _mask(scaled, top_k, top_p=None):
    """The one top-k -> top-p mask of both samplers, over temperature-
    scaled logits ``[S, V]``: top-k with k as data (``[S]`` int, 0 = off;
    a k above V masks nothing, as JAX's clamped index does), then top-p
    (``[S]`` f32; None = off) over the top-k-masked row, from ONE
    descending sort."""
    V = scaled.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k.clamp(max=V), V)
    kth = srt.gather(-1, (k_eff - 1).long()[:, None])
    masked = torch.where(scaled < kth, _MASKED, scaled)
    if top_p is None:
        return masked
    # the masked row's descending sort is srt with the positions under
    # the cutoff replaced (ties at the cutoff survive in both views)
    cutoff = _top_p_cutoff(torch.where(srt >= kth, srt, _MASKED),
                           top_p[:, None])
    return torch.where(masked < cutoff[:, None], _MASKED, masked)


def _sample_mask(logits, temperature: float, top_p: float, top_k: int):
    """``sample_logits``' logits before the draw: over ``temperature``,
    then ``_mask`` with the scalars broadcast; top-p is off from 1.0 up,
    as JAX's static ``top_p < 1.0`` branch."""
    def full(v, dtype):
        return torch.full((logits.shape[0],), v, dtype=dtype,
                          device=logits.device)

    return _mask(logits / temperature, full(top_k, torch.int32),
                 full(top_p, torch.float32) if top_p < 1.0 else None)


def sample_logits(logits, key, temperature: float = 1.0,
                  top_p: float = 1.0, top_k: int = 0):
    """``[B, V]`` f32 logits -> ``[B]`` int32 tokens: the argmax when
    ``temperature == 0``, else temperature, then top-k, then top-p, and
    one categorical draw over the whole batch from ``key`` (JAX
    ``sample_logits``)."""
    if temperature == 0.0:
        return logits.argmax(-1).int()
    masked = _sample_mask(logits, temperature, top_p, top_k)
    return prng.categorical(key.to(logits.device), masked).int()


def _draw_mask(logits, temp, top_p, top_k):
    """``sample_draw``'s logits before the draw: over ``max(temp,
    1e-6)`` per row, then ``_mask`` with top-p always on (JAX's
    ``_draw``)."""
    return _mask(logits / temp.clamp(min=1e-6)[:, None], top_k, top_p)


def sample_draw(logits, temp, top_p, top_k, keys, idx):
    """The per-row draw of the serving tick's sampler (JAX
    ``_fused_sample``'s ``_draw``): logits ``[S, V]`` f32 masked by
    ``_draw_mask``, then row ``s`` draws with ``fold_in(keys[s],
    idx[s])``. temp / top_p ``[S]`` f32, top_k ``[S]`` int, keys ``[S,
    2]`` int64, idx ``[S]`` int. Returns ``[S]`` int32.
    ``sample_draw.launches`` counts its calls."""
    sample_draw.launches += 1
    masked = _draw_mask(logits, temp, top_p, top_k)
    return prng.categorical(prng.fold_in(keys, idx), masked).int()


sample_draw.launches = 0


def _fused_sample(logits, temp, top_p, top_k, keys, idx):
    """The serving tick's token pick when some row samples: the argmax
    for greedy rows (temp <= 0, bitwise the plain pick) and
    ``sample_draw`` for the others. Token ``n`` of a request is always
    drawn with ``fold_in(key, n)``, so one seed gives one stream
    whatever shares the batch, whatever the fused block or speculation
    around it. Callers that know no row samples take the argmax and
    never call this (``serving_tick``)."""
    return torch.where(temp <= 0, logits.argmax(-1).int(),
                       sample_draw(logits, temp, top_p, top_k, keys, idx))


def _next_token(logits, key, temperature, top_p, top_k):
    """One step of ``generate``'s split chain: ``(key, token)``. A
    greedy decode takes the argmax and leaves the key as it is (its
    tokens do not depend on it)."""
    if temperature == 0.0:
        return key, logits.argmax(-1)
    key, sub = prng.split(key)
    return key, sample_logits(logits, sub, temperature, top_p, top_k)


def generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int, *,
             temperature: float = 0.0, top_p: float = 1.0, top_k: int = 0,
             key=None, eos_token_id: Optional[int] = None):
    """Autoregressive decode with a dense KV cache, on the params'
    device. prompt: int ``[B, T0]``. Every token is drawn with
    ``sample_logits`` from a sub-key split off ``key`` (``prng.key(0)``
    when None) before it, the chain of JAX ``generate``; temperature 0
    is greedy. Returns int32 ``[B, T0 + max_new_tokens]`` (prompt +
    continuation; positions after EOS repeat EOS when ``eos_token_id``
    is set)."""
    return _decode_loop(
        lambda p, t, c, pos: forward_with_cache(p, t, c, pos, cfg),
        lambda B, n, dev: init_kv_cache(cfg, B, n, dev),
        params, prompt, max_new_tokens, temperature, top_p, top_k, key,
        eos_token_id)


@torch.no_grad()
def _decode_loop(fwd_cache_fn, init_cache_fn, params, prompt,
                 max_new_tokens: int, temperature, top_p, top_k, key,
                 eos_token_id):
    """The autoregressive loop of every model's ``generate``: a
    prefill through ``fwd_cache_fn(params, tokens, cache, pos0)`` into
    ``init_cache_fn(B, max_len, device)``, then single-token steps, each
    token drawn by ``_next_token``, EOS latched. Returns the prompt and
    its continuation, int32."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    dev = params["embed"].device
    prompt = torch.as_tensor(np.asarray(prompt), device=dev).long()
    key = _key_tensor(key, dev)
    B, T0 = prompt.shape
    cache = init_cache_fn(B, T0 + max_new_tokens, dev)
    logits, cache = fwd_cache_fn(params, prompt, cache, 0)
    key, tok = _next_token(logits, key, temperature, top_p, top_k)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_token_id is None
            else tok == eos_token_id)
    out = [tok]
    for step in range(max_new_tokens - 1):
        logits, cache = fwd_cache_fn(params, tok[:, None], cache, T0 + step)
        key, tok = _next_token(logits, key, temperature, top_p, top_k)
        if eos_token_id is not None:
            tok = torch.where(done, eos_token_id, tok)
            done = done | (tok == eos_token_id)
        out.append(tok)
    return torch.cat([prompt, torch.stack(out, dim=1).long()], dim=1).int()


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


def pack_tick(decode, spans, tables, page_size: int, device=None, *,
              drafts=(), spec_k: int = 0):
    """The packed stream and metadata of one ragged tick, as
    ``serving_tick`` takes them.

    tables: int ``[S, pps]``, one page-table row per slot. decode:
    ``[(slot, token, pos)]``, a decode row at packed index ``slot``
    whose token sits at position ``pos``. drafts: ``[(slot, token, pos,
    draft_tokens)]``, a speculating slot's current token at ``pos`` and
    its ``k_s`` drafts after it, packed as a span of ``1 + k_s`` tokens.
    spans: ``[(slot, tokens, start)]``, prompt tokens at positions
    ``start, start + 1, ...``. Drafted spans, then prompt spans, follow
    the ``S`` decode positions in order. Idle decode positions are
    padding (``tok_slot == S``); the KV of padding and of positions past
    the table lands on the trash page (page 0).

    ``spec_k`` (the verify mode's draft cap) adds the verify geometry
    of JAX's engine: ``ver_idx [S, 1 + spec_k]``, the packed index of
    each drafted slot's span tokens (the last one repeated past ``k_s``;
    every other slot points every entry at its ``last``), ``draft_tok
    [S, spec_k]`` and ``draft_len [S]`` (0 where nothing was drafted).

    Returns ``(tokens [T], meta)`` as int32 tensors on ``device``; the
    caller adds ``tail_live`` when it fuses a decode tail, and the
    sampling arrays when a row samples."""
    tables = np.asarray(tables, np.int32)
    S, pps = tables.shape
    T = S + sum(1 + len(d) for _, _, _, d in drafts) \
        + sum(len(t) for _, t, _ in spans)
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
    packed = [(slot, np.concatenate([[t], d]), pos)
              for slot, t, pos, d in drafts] + list(spans)
    idx = S
    for slot, t, start in packed:
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
    arrays = dict(tok_slot=tok_slot, tok_pos=tok_pos, tok_page=tok_page,
                  tok_off=tok_off, tok_qoff=tok_qoff, q_len=q_len,
                  kv_len=kv_len, last=last, tables=tables)
    if spec_k:
        ver_idx = np.tile(last[:, None], (1, 1 + spec_k))
        draft_tok = np.zeros((S, spec_k), np.int32)
        draft_len = np.zeros((S,), np.int32)
        for slot, _, _, d in drafts:
            k_s = len(d)
            ver_idx[slot, :1 + k_s] = np.arange(last[slot] - k_s,
                                                last[slot] + 1)
            draft_tok[slot, :k_s] = d
            draft_len[slot] = k_s
        arrays.update(ver_idx=ver_idx, draft_tok=draft_tok,
                      draft_len=draft_len)
    dev = resolve_device(device)
    meta = {k: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(dev)
            for k, v in arrays.items()}
    return torch.from_numpy(tok).to(dev), meta


@torch.no_grad()
def serving_tick(params, tokens, meta, k_pages, v_pages, cfg: LlamaConfig,
                 decode_tail: int = 0, spec_k: int = 0,
                 attn_impl: str = "auto", _block_fn=None):
    """ONE ragged serving tick: any mix of chunked prefills, warm-prefix
    attaches, decode steps and speculative verify spans over the packed
    token stream.

    tokens ``[T]`` int32 — the tick's packed stream. ``meta`` — int32
    tensors on the pools' device describing the packing, as in the JAX
    tick (``pack_tick`` builds both): ``tok_slot [T]`` (``S`` = padding
    token), ``tok_pos [T]`` (absolute position), ``tok_page``/``tok_off
    [T]`` (where its KV lands; the trash page for padding), ``tok_qoff
    [T]`` (offset in its slot's span), ``q_len``/``kv_len [S]``, ``last
    [S]`` (packed index of each slot's last span token) and ``tables
    [S, pps]``; with ``decode_tail`` also ``tail_live [S]`` (bool).

    Sampling: when some row samples, ``meta`` also carries ``temp`` /
    ``top_p [S]`` f32, ``top_k [S]`` int32 (0 = off), ``key [S, 2]``
    int64 (each slot's constant raw key) and ``produced [S]`` int32 (the
    continuation index of the token this tick emits), and every token
    pick goes through ``_fused_sample``: token ``n`` is drawn with
    ``fold_in(key, n)``, greedy rows keep the bitwise argmax. Their
    presence is the host's flag that some row samples: without them the
    tick launches nothing of the sampler.

    Each layer first scatters the span's K/V into ``k_pages``/
    ``v_pages`` IN PLACE (padding writes land on the trash page), then
    attends over the pages only, bottom-right causal, so a prefix's KV
    is a function of the prefix tokens alone and chunked, warm and
    whole prefills produce the same bits.

    ``decode_tail`` fuses that many extra decode steps for the tail-live
    slots (decoding slots and spans completing their prompt); the others
    stay dead through the tail (q_len 0, KV to the trash page). Tail
    step ``j`` samples continuation index ``produced + 1 + j``.

    ``spec_k`` turns the tick into the speculative verify pass (JAX
    ``serving_tick``'s ``spec_k`` mode): speculating slots carry their
    current token plus up to ``spec_k`` drafts as an ordinary span, and
    ``meta`` adds ``ver_idx [S, 1 + spec_k]``, ``draft_tok [S, spec_k]``
    and ``draft_len [S]`` (``pack_tick`` builds them). The tick picks a
    token at every span position (span position ``j`` draws index
    ``produced + j``) and accepts the longest prefix of drafts equal to
    those picks. ``spec_k`` and ``decode_tail`` exclude each other.

    attn_impl: ``"auto"`` (the kernel on CUDA tensors, the plain
    version on CPU tensors), ``"kernel"`` (strict) or ``"reference"``
    (the plain version; tests and the kernel's comparison only).

    ``_block_fn`` is the block math (``_block`` when None); Qwen2-MoE's
    serving functions pass theirs, as every serving function here takes.

    Returns ``(toks, logits [S, V] f32, k_pages, v_pages)``: ``toks`` is
    each slot's pick at its last position, ``[S]`` int32 when
    ``decode_tail == 0``, else ``[S, 1 + decode_tail]``; ``logits`` are
    the ragged pass's; the pools are the inputs, updated. With
    ``spec_k`` it is ``(toks [S, 1 + spec_k], accept [S], logits [S,
    1 + spec_k, V] f32, k_pages, v_pages)``: ``toks[s, j]`` is the pick
    after span tokens ``0..j``, ``accept[s]`` the count of leading
    drafts equal to it (``toks[s, accept[s]]`` is the bonus or
    correction token), and ``logits[:, j]`` are those at ``ver_idx[:,
    j]`` (JAX returns row 0's, ``logits[:, 0]``). Rejected drafts' KV
    stays past the slot's length, masked until overwritten.
    """
    spec_k, decode_tail = int(spec_k), int(decode_tail)
    if spec_k and decode_tail:
        raise ValueError("spec_k and decode_tail are mutually exclusive "
                         "(speculation replaces the fused decode tail)")
    block_fn = _block if _block_fn is None else _block_fn
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

        h = block_fn(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[0], params["final_norm"], cfg.rms_norm_eps)   # [T, D]
    samp = "temp" in meta

    if spec_k:
        kk = 1 + spec_k
        # logits at every span position: one launch prices 1 + spec_k
        # predictions
        logits_ver = _mm(h[meta["ver_idx"].long()],
                         params["lm_head"]).float()          # [S, kk, V]
        if samp:
            idx = (meta["produced"][:, None] + torch.arange(
                kk, dtype=torch.int32, device=h.device)).reshape(-1)
            rep = {n: meta[n].repeat_interleave(kk, dim=0)
                   for n in ("temp", "top_p", "top_k", "key")}
            toks = _fused_sample(
                logits_ver.reshape(S * kk, -1), rep["temp"], rep["top_p"],
                rep["top_k"], rep["key"], idx).reshape(S, kk)
        else:
            toks = logits_ver.argmax(-1).int()
        # draft j is accepted iff drafts 0..j all equal the picks at
        # their span positions and j is a real draft
        j = torch.arange(spec_k, device=h.device)
        match = ((toks[:, :spec_k] == meta["draft_tok"])
                 & (j[None, :] < meta["draft_len"][:, None]))
        accept = torch.cumprod(match.int(), dim=1).sum(dim=1).int()
        return toks, accept, logits_ver, k_pages, v_pages

    logits = _mm(h[meta["last"].long()], params["lm_head"]).float()
    if samp:
        toks = _fused_sample(logits, meta["temp"], meta["top_p"],
                             meta["top_k"], meta["key"], meta["produced"])
    else:
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
    idx = meta["produced"] + 1 if samp else None
    for _ in range(decode_tail):
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
        if samp:
            # tail step j samples continuation index produced + 1 + j
            m.update({n: meta[n] for n in ("temp", "top_p", "top_k",
                                           "key")}, produced=idx)
            idx = idx + 1
        tok, _, _, _ = serving_tick(params, tok, m, k_pages, v_pages, cfg,
                                    attn_impl=attn_impl, _block_fn=_block_fn)
        lens = lens + 1
        out.append(tok)
    return torch.stack(out, dim=1), logits, k_pages, v_pages


def serving_tick_block(params, tok, lengths, tables, k_pages, v_pages,
                       cfg: LlamaConfig, num_steps: int,
                       attn_impl: str = "auto", sampling=None,
                       _block_fn=None):
    """``num_steps`` fused decode steps built on the ragged tick:
    tok/lengths ``[S]`` int32, tables ``[S, pps]``; dead slots (all-trash
    rows) write to and read from the trash page. ``sampling``: the
    tick's sampling arrays (``temp``, ``top_p``, ``top_k``, ``key``,
    ``produced``; see ``serving_tick``) when some row samples, step
    ``j`` drawing index ``produced + j``; None is all greedy. Returns
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
    if sampling:
        meta.update(sampling)
    toks, _, k_pages, v_pages = serving_tick(
        params, tok, meta, k_pages, v_pages, cfg,
        decode_tail=num_steps - 1, attn_impl=attn_impl, _block_fn=_block_fn)
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
    ``[L, B, max_new_tokens, Hkv, Dh]`` per K and V, and ``n_tail``
    (the live tail slots, a 0-d int32 tensor)."""
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
             "n_tail": torch.zeros((), dtype=torch.int32, device=dev)}
    return logits, cache


@torch.no_grad()
def _decode_paged_step(params, tok, cache, cfg: LlamaConfig,
                       attn_impl: str = "auto"):
    """One paged decode step: ``tok [B]`` -> f32 logits ``[B, V]``. The
    token's KV is appended to the dense tail IN PLACE (no page write);
    attention merges the paged prompt (the stats kernel) with the live
    tail (``paged_attention_with_tail``). Advances ``cache["n_tail"]``,
    a 0-d int32 tensor on the params' device as in the JAX package's
    cache, so a step captured by ``jit.to_static`` is one program for
    every step."""
    lens0, n = cache["prompt_lens"], cache["n_tail"]
    h = params["embed"].to(cfg.dtype)[tok.long()][:, None]      # [B, 1, D]
    positions = (lens0 + n)[:, None]
    at, n1 = n.reshape(1).long(), n + 1
    for i in range(cfg.num_hidden_layers):
        kt, vt = cache["k_tail"][i], cache["v_tail"][i]

        def attn_fn(q, k, v, i=i, kt=kt, vt=vt):
            kt.index_copy_(1, at, k.to(kt.dtype))
            vt.index_copy_(1, at, v.to(vt.dtype))
            o = paged_attention_with_tail(
                q[:, 0].contiguous(), cache["k_pages"][i],
                cache["v_pages"][i], lens0, cache["tables"], kt, vt, n1,
                impl=attn_impl)
            return o[:, None].to(q.dtype)

        h = _block(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps)
    cache["n_tail"] = n1
    return _mm(h, params["lm_head"]).float()


@torch.no_grad()
def generate_paged(params, prompt, lengths, cfg: LlamaConfig,
                   max_new_tokens: int, *, page_size: int = 16,
                   temperature: float = 0.0, top_p: float = 1.0,
                   top_k: int = 0, key=None,
                   eos_token_id: Optional[int] = None,
                   attn_impl: str = "auto"):
    """Batched decode over the paged KV cache, on the params' device.
    prompt: int ``[B, T0]`` right-padded; lengths: valid counts ``[B]``.
    Tokens are drawn as ``generate`` draws them (the split chain from
    ``key``; temperature 0 is greedy). Returns the int32 ``[B,
    max_new_tokens]`` continuations (positions after EOS repeat EOS when
    ``eos_token_id`` is set). ``attn_impl`` (``"auto"`` | ``"kernel"`` |
    ``"reference"``) picks the paged attention and, when not
    ``"auto"``, the prefill's flash attention too."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, "
                         f"got {max_new_tokens}")
    logits, cache = prefill_paged(params, prompt, lengths, cfg,
                                  max_new_tokens, page_size, attn_impl)
    key = _key_tensor(key, logits.device)
    key, tok = _next_token(logits, key, temperature, top_p, top_k)
    done = (torch.zeros_like(tok, dtype=torch.bool) if eos_token_id is None
            else tok == eos_token_id)
    out = [tok]
    for _ in range(max_new_tokens - 1):
        logits = _decode_paged_step(params, tok, cache, cfg, attn_impl)
        key, tok = _next_token(logits, key, temperature, top_p, top_k)
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
                    cfg: LlamaConfig, attn_impl: str = "auto",
                    _block_fn=None):
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
    block_fn = _block if _block_fn is None else _block_fn
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(T0, device=dev).expand(B, T0)
    for i in range(cfg.num_hidden_layers):
        def attn_fn(q, k, v, kp=k_pages[i], vp=v_pages[i]):
            write_prompt_pages(kp, vp, k, v, lengths, tables)
            return flash_attention(q, k, v, causal=True, impl=impl)

        h = block_fn(_layer(params, i), h, positions, cfg, attn_fn)
    return _last_logits(params, h, lengths, cfg)[0], k_pages, v_pages


@torch.no_grad()
def serving_prefill_chunk(params, tokens, length, table, k_pages, v_pages,
                          cfg: LlamaConfig, prefix_pages: int,
                          attn_impl: str = "auto", _block_fn=None):
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
    block_fn = _block if _block_fn is None else _block_fn
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

        h = block_fn(_layer(params, i), h, positions, cfg, attn_fn)
    return _last_logits(params, h, lengths, cfg)[0], k_pages, v_pages


@torch.no_grad()
def serving_decode_step(params, tok, lengths, tables, k_pages, v_pages,
                        cfg: LlamaConfig, attn_impl: str = "auto",
                        _block_fn=None):
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
    block_fn = _block if _block_fn is None else _block_fn
    h = params["embed"].to(cfg.dtype)[tok.long()][:, None]       # [S, 1, D]
    positions = lengths[:, None]
    for i in range(cfg.num_hidden_layers):
        def attn_fn(q, k, v, kp=k_pages[i], vp=v_pages[i]):
            write_token_pages(kp, vp, k[:, 0], v[:, 0], lengths, tables)
            o = paged_attention(q[:, 0].contiguous(), kp, vp, lengths + 1,
                                tables, impl=attn_impl)
            return o[:, None].to(q.dtype)

        h = block_fn(_layer(params, i), h, positions, cfg, attn_fn)
    h = rms_norm(h[:, 0], params["final_norm"], cfg.rms_norm_eps)
    return _mm(h, params["lm_head"]).float(), k_pages, v_pages


def serving_decode_block(params, tok, lengths, tables, k_pages, v_pages,
                         cfg: LlamaConfig, num_steps: int,
                         attn_impl: str = "auto", _block_fn=None):
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
            params, tok, lens, tables, k_pages, v_pages, cfg, attn_impl,
            _block_fn)
        tok = logits.argmax(-1).int()
        lens = lens + 1
        out.append(tok)
    return torch.stack(out, dim=1), k_pages, v_pages


# ---------------------------------------------------------------------------
# training: forward, loss, AdamW, the train step
# ---------------------------------------------------------------------------

def _cp_on(cfg: LlamaConfig, mesh) -> bool:
    return mesh is not None and mesh.cp_degree > 1 \
        and cfg.context_parallel != "none"


def _train_attn_fn(cfg: LlamaConfig, mesh=None):
    """The training path's attention: over the cp line of ``mesh``
    (``cfg.context_parallel``) when it has one, else the flash kernel on
    this rank's heads."""
    impl = _kernel_impl(cfg.use_flash_attention)
    if _cp_on(cfg, mesh):
        from ..parallel.context_parallel import context_parallel_attention
        return lambda q, k, v: context_parallel_attention(
            q, k, v, mesh, impl=cfg.context_parallel, attn_impl=impl)
    return lambda q, k, v: flash_attention(q, k, v, causal=True, impl=impl)


def decoder_layer(lp, h, cfg: LlamaConfig, positions=None, mesh=None):
    """One transformer block of the training path on ``[B, T, D]``;
    ``lp`` holds this layer's weights, ``positions`` defaults to
    ``arange(T)`` per row (a cp part passes its global positions, the
    zigzag layout's included); ``mesh`` with a cp axis runs the
    attention over its cp line."""
    B, T, _ = h.shape
    if positions is None:
        positions = torch.arange(T, device=h.device).expand(B, T)
    return _block(lp, h, positions, cfg, _train_attn_fn(cfg, mesh),
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


def forward(params, tokens, cfg: LlamaConfig, mesh=None):
    """tokens ``[B, T]`` -> logits ``[B, T, V]`` in ``cfg.dtype`` (one
    device, one pipeline stage). With ``mesh`` (a dp x pp x cp x tp
    ``HybridMesh``), ``params`` are this rank's shards, ``tokens`` its
    dp rows, and the logits ``[B/dp, T/cp, V/tp]`` its vocab shard's
    over its cp part of the sequence (under zigzag, of the sequence laid
    out by ``zigzag_global_perm``; ``loss_fn`` lays the labels out
    alike); under a pipeline see ``forward_pipelined``."""
    if mesh is not None:
        _check_mesh(cfg, mesh)
        if mesh.pp_degree > 1:
            return forward_pipelined(params, tokens, cfg, mesh)
        return _mesh_logits(params, tokens, cfg, mesh)
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    h = _scan_layers(params, h, cfg, remat=cfg.remat)
    h = _norm_fn(cfg, _fused_nr_on(cfg))(h, params["final_norm"])
    return h @ params["lm_head"]


def loss_fn(params, batch, cfg: LlamaConfig, mesh=None):
    """Mean next-token cross entropy through the fused op: the logits
    stay in the model dtype, no f32 log-softmax is saved.

    ``jit.to_static(loss_fn)`` captures the loss and its forward whole
    (remat included), each kernel one operator node; ``.backward()`` on
    its value runs the captured graph's backward. The train step's
    ``AdamW.update_`` stays eager (the JAX step jits the optimizer too;
    a captured optimizer is not built here).

    With ``mesh``: the mean over this rank's dp rows of ``batch`` and its
    cp part of the sequence (the same on every tp rank), through the
    vocab-parallel cross entropy at tp > 1; the mesh step averages it
    over dp and cp. Under a pipeline, GPipe
    (whatever ``pp_schedule``, as in the JAX package) over the rows of
    ``_pipe_rows``: the value on the last pp rank, a 0-d zero that
    carries the backward on the others."""
    if mesh is not None:
        _check_mesh(cfg, mesh)
        return _mesh_loss(params, batch, cfg, mesh)
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

    def advance(self, state) -> tuple:
        """``(count, bc1, bc2)`` of the next update: optax's
        ``1 - decay**count`` in f32."""
        count = state["count"] + 1
        one = torch.tensor(1.0, dtype=torch.float32)
        bc1 = float(one - torch.tensor(self.b1) ** count)
        bc2 = float(one - torch.tensor(self.b2) ** count)
        return count, bc1, bc2

    @torch.no_grad()
    def update_(self, params, state) -> None:
        count, bc1, bc2 = self.advance(state)
        for p, mu, nu in zip(_tree_leaves(params),
                             _tree_leaves(state["mu"]),
                             _tree_leaves(state["nu"])):
            if p.grad is None:
                raise RuntimeError("AdamW.update_: a parameter has no grad")
            self.update_leaf_(p, _pop_grad(p), mu, nu, bc1, bc2)
        state["count"] = count

    def update_leaf_(self, p, g, mu, nu, bc1: float, bc2: float) -> None:
        """One tensor's update in place, under ``torch.no_grad()``: ``p``
        (a parameter or a view of one, such as a ZeRO slice), its
        gradient ``g`` and moments, all of one shape; elementwise, so a
        slice updates to the same bits as the whole. Pass ``g`` with no
        other reference to it: it is freed before the update's
        temporaries are made (so no decorator holds it)."""
        def c(x, dt=p.dtype):
            return float(torch.tensor(x, dtype=dt))

        # mu = (1 - b1) g + b1 mu ; nu = (1 - b2) g^2 + b2 nu
        mu.mul_(c(self.b1)).add_(g * c(1 - self.b1))
        nu.mul_(c(self.b2)).add_(g.square().mul_(c(1 - self.b2)))
        del g
        # mu_hat / (sqrt(nu_hat) + eps) + wd p, scaled by -lr
        u = mu / c(bc1)
        denom = (nu / c(bc2)).sqrt_().add_(c(self.eps))
        u.div_(denom)
        del denom
        u.add_(p * c(self.weight_decay)).mul_(c(-self.lr))
        p.add_(u)


def _pop_grad(p):
    g, p.grad = p.grad, None
    return g


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
    return _ordered({k: leaf(v) for k, v in params.items()
                     if k != "layers"},
                    [_tree_map(leaf, lp) for lp in layers])


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


def make_train_step(cfg: LlamaConfig, *, mesh=None, zero_stage: int = 0,
                    device=None, optimizer=None):
    """The train step (forward, backward, AdamW).

    Returns ``(step_fn, init_fn)``. ``init_fn(source)`` builds the state
    ``{"params", "opt", "step"}`` from a ``torch.Generator`` (random init,
    ``init_params``) or from a params dict (``params_from_jax``, stacked
    or per layer). ``step_fn(state, batch)`` makes one update IN PLACE
    (params, moments and step are the state's own tensors, never doubly
    resident) and returns ``(state, loss)``, the loss of the params
    before the update as a 0-d f32 tensor.

    With no mesh the step runs on one device. With ``mesh``
    (``parallel.init_hybrid_mesh(dp=..., pp=..., cp=..., tp=...)``) it
    runs on this rank's part of a dp x pp x cp x tp layout over
    ``torch.distributed``, one process a rank: see ``_mesh_trainer``;
    a pp axis must equal
    ``cfg.pp_stages`` and runs ``cfg.pp_schedule`` over
    ``cfg.num_microbatches``; a cp axis splits the sequence and runs
    ``cfg.context_parallel``'s attention over it. ``zero_stage`` (0-3)
    needs a mesh; a mesh with an expert axis, or cp with a pipeline,
    raises ``NotImplementedError``.
    """
    if zero_stage not in (0, 1, 2, 3):
        raise ValueError(f"zero_stage must be 0..3, got {zero_stage}")
    if cfg.pp_schedule not in PIPE_SCHEDULES:
        raise ValueError(f"pp_schedule must be one of {PIPE_SCHEDULES}, "
                         f"got {cfg.pp_schedule!r}")
    if mesh is None and cfg.pp_stages > 1:
        raise ValueError("pp_stages > 1 pipelines over a mesh's pp axis: "
                         "pass mesh=parallel.init_hybrid_mesh(pp=...)")
    if mesh is None:
        if zero_stage:
            raise ValueError("ZeRO stages shard over a mesh's dp axis: "
                             "pass mesh=parallel.init_hybrid_mesh(...)")
        return one_device_trainer(cfg, init_params, loss_fn, device,
                                  optimizer)
    return _mesh_trainer(cfg, mesh, zero_stage, device, optimizer)


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
               device=None, generator: Optional[torch.Generator] = None,
               mesh=None):
    """Synthetic next-token batch: int32 tokens ``[B, T]`` and their
    labels (the tokens shifted by one), drawn from ``generator`` (seed 0
    on the device when none is given). With ``mesh`` the batch is still
    the global one (every rank draws the same), as a mesh step takes it;
    B must divide over dp (over dp · ``num_microbatches`` under a
    pipeline) and T over cp · tp (2 · cp · tp under zigzag)."""
    if mesh is not None:
        rows = mesh.dp_degree * (cfg.num_microbatches
                                 if mesh.pp_degree > 1 else 1)
        parts = mesh.cp_degree * mesh.tp_degree * (
            2 if _zigzag_on(cfg, mesh) else 1)
        if batch_size % rows or seq_len % parts:
            raise ValueError(
                f"batch [{batch_size}, {seq_len}] does not split over "
                f"{rows} rows (dp={mesh.dp_degree}, "
                f"M={cfg.num_microbatches}) and {parts} sequence parts "
                f"(cp={mesh.cp_degree}, tp={mesh.tp_degree}"
                f"{', zigzag' if _zigzag_on(cfg, mesh) else ''})")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    toks = torch.randint(0, cfg.vocab_size, (batch_size, seq_len + 1),
                         generator=generator, device=dev,
                         dtype=torch.int32)
    return {"tokens": toks[:, :-1].contiguous(),
            "labels": toks[:, 1:].contiguous()}


# ---------------------------------------------------------------------------
# parallel training: a dp x cp x tp mesh over torch.distributed (context
# parallelism over cp: each rank its part of the sequence), Megatron tensor
# parallelism with sequence parallelism, vocab-parallel cross entropy and
# ZeRO stages 0-3 (one process a rank)
# ---------------------------------------------------------------------------

def param_specs(cfg: LlamaConfig) -> Dict[str, Any]:
    """The params' partition specs over the mesh, as the JAX
    ``param_specs``: column-parallel over tp ``wq`` / ``wk`` / ``wv`` /
    ``w_gate`` / ``w_up``, row-parallel ``wo`` / ``w_down``, the
    embedding vocab-parallel ``P("tp", None)`` and ``lm_head``
    ``P(None, "tp")``; a stacked layer leaf's leading axis is the
    layer's, on ``pp`` when ``cfg.pp_stages > 1`` (each pipeline rank
    holds its stage's layers, ``_stage_layers``; the embedding lives on
    the first rank and the head on the last). Every leaf is replicated
    over dp (but ZeRO's slices, ``train_state_specs``) and over cp."""
    from ..parallel.mesh import P
    pp = "pp" if getattr(cfg, "pp_stages", 1) > 1 else None
    layers = {
        "wq": P(pp, None, "tp"),
        "wk": P(pp, None, "tp"),
        "wv": P(pp, None, "tp"),
        "wo": P(pp, "tp", None),
        "w_gate": P(pp, None, "tp"),
        "w_up": P(pp, None, "tp"),
        "w_down": P(pp, "tp", None),
        "attn_norm": P(pp, None),
        "mlp_norm": P(pp, None),
    }
    return {"embed": P("tp", None), "layers": layers,
            "final_norm": P(None), "lm_head": P(None, "tp")}


def _layer_spec(spec):
    """A stacked leaf's spec for one layer's leaf (the layer axis off)."""
    from ..parallel.mesh import P
    return P(*tuple(spec)[1:])


#: ``LlamaConfig.pp_schedule``'s values, the JAX ``make_train_step``'s
PIPE_SCHEDULES = ("gpipe",) + tuple(PP_SCHEDULES)


def _pipe_chunks(cfg: LlamaConfig) -> int:
    """Chunks a pipeline rank holds: ``vpp_chunks`` under the 1f1b
    schedules, one under GPipe (which, as in the JAX package, does not
    interleave)."""
    return 1 if cfg.pp_schedule == "gpipe" else int(cfg.vpp_chunks)


def _split_stages(layer_params, cfg: LlamaConfig):
    """Layers (stacked ``[L, ...]`` tensors or a list of L) -> ``S``
    stages of ``L/S`` consecutive layers: GPipe's partition."""
    from ..parallel.pipeline_1f1b import split_chunks_round_robin
    S, L = cfg.pp_stages, cfg.num_hidden_layers
    if L % S:
        raise ValueError(f"layers {L} not divisible by pp_stages {S}")
    return split_chunks_round_robin(layer_params, L, S, 1)


def _stage_layers(cfg: LlamaConfig, s: int) -> list:
    """The global layers pipeline rank ``s`` holds, ascending: its stage
    under GPipe (``_split_stages``), chunks ``v·S + s`` of the ``[V·S]``
    chunk-major split under the 1f1b schedules
    (``split_chunks_round_robin``)."""
    from ..parallel.pipeline_1f1b import split_chunks_round_robin
    S, V, L = cfg.pp_stages, _pipe_chunks(cfg), cfg.num_hidden_layers
    if V == 1:
        return _split_stages(list(range(L)), cfg)[s]
    chunks = split_chunks_round_robin(list(range(L)), L, S, V)
    return [i for v in range(V) for i in chunks[v * S + s]]


def _check_pipeline(cfg: LlamaConfig, mesh) -> None:
    S = mesh.pp_degree
    if cfg.pp_schedule not in PIPE_SCHEDULES:
        raise ValueError(f"pp_schedule must be one of {PIPE_SCHEDULES}, "
                         f"got {cfg.pp_schedule!r}")
    if S == 1 and cfg.pp_stages == 1:
        return
    if cfg.pp_stages == 1:
        raise NotImplementedError(
            f"pipeline axis pp={S} with LlamaConfig.pp_stages=1: the JAX "
            f"step replicates the model over pp, the port does not; set "
            f"pp_stages={S}")
    if cfg.pp_stages != S:
        raise ValueError(f"LlamaConfig.pp_stages={cfg.pp_stages} but the "
                         f"mesh's pp axis is {S}")
    if mesh.cp_degree > 1 or cfg.context_parallel != "none":
        raise NotImplementedError(
            "context_parallel with pp_stages > 1 is not supported yet: the "
            "pipeline stage loop would need the cp exchange nested inside "
            "it; use cp with pp=1 (ring attention already gives the "
            "long-sequence memory scaling pipelining would)")
    V = _pipe_chunks(cfg)
    if cfg.num_hidden_layers % (S * V):
        raise ValueError(f"layers {cfg.num_hidden_layers} not divisible by "
                         f"stages*chunks {S * V}")
    if cfg.pp_schedule in PP_SCHEDULES:
        reason = schedule_legality(
            cfg.pp_schedule, num_stages=S,
            num_microbatches=cfg.num_microbatches, virtual_chunks=V,
            dp=mesh.dp_degree, tp=mesh.tp_degree)
        if reason is not None:
            raise ValueError(reason)


def _check_mesh(cfg: LlamaConfig, mesh) -> None:
    from ..parallel.context_parallel import CP_KINDS
    if cfg.context_parallel not in ("none",) + CP_KINDS:
        raise ValueError(f"context_parallel must be 'none' or one of "
                         f"{CP_KINDS}, got {cfg.context_parallel!r}")
    _check_pipeline(cfg, mesh)
    if mesh.ep_degree > 1:
        raise NotImplementedError(
            "expert (ep) parallelism shards experts, and Llama has none "
            "(qwen2_moe.make_train_step trains over ep); this step trains "
            "over dp x pp x cp x tp")
    if mesh.cp_degree > 1 and cfg.context_parallel == "none":
        raise ValueError(
            f"a cp={mesh.cp_degree} axis splits the sequence: set "
            f"LlamaConfig.context_parallel to one of {CP_KINDS}")
    tp = mesh.tp_degree
    bad = {k: n for k, n in dict(
        heads=cfg.num_attention_heads, kv_heads=cfg.num_key_value_heads,
        ffn=cfg.intermediate_size, vocab=cfg.vocab_size).items() if n % tp}
    if bad:
        raise ValueError(
            f"tp={tp} does not divide {bad} — heads/ffn/vocab shard over "
            f"tp inside the block")


def _shard(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's part of the global ``x`` laid out by ``spec``."""
    for dim, ax in enumerate(spec):
        n = mesh.degree(ax) if ax is not None else 1
        if n > 1:
            size = x.shape[dim] // n
            x = x.narrow(dim, mesh.axis_index(ax) * size, size)
    return x


def _held(cfg: LlamaConfig, mesh) -> tuple:
    """``(keys, layers)`` this rank holds: every top-level leaf and
    layer without a pipeline; on pipeline rank ``s``, its stage's layers
    (``_stage_layers``), the embedding on the first and ``final_norm``
    / ``lm_head`` on the last."""
    S = mesh.pp_degree if mesh is not None else 1
    if S == 1:
        return (("embed", "final_norm", "lm_head"),
                list(range(cfg.num_hidden_layers)))
    s = mesh.axis_index("pp")
    keys = (("embed",) if s == 0 else ()) + (
        ("final_norm", "lm_head") if s == S - 1 else ())
    return keys, _stage_layers(cfg, s)


def _ordered(keys, layers) -> Dict:
    """A params dict in the trainer's key order from what it holds."""
    out = {k: keys[k] for k in ("embed",) if k in keys}
    out["layers"] = layers
    out.update({k: keys[k] for k in ("final_norm", "lm_head") if k in keys})
    return out


def shard_params(params, cfg: LlamaConfig, mesh, device=None) -> Dict:
    """The rank's local shards, by ``param_specs``, of the global params
    (stacked layers: ``init_params`` or ``params_from_jax`` output), as
    new contiguous tensors on ``device`` (default: where they are).
    Under a pipeline: only what this rank holds (``_held``), its layers
    stacked in ascending order (given all L layers, or only those, as
    ``init_params(layers=)`` draws them)."""
    specs = param_specs(cfg)
    keys, own = _held(cfg, mesh)
    every = own == list(range(cfg.num_hidden_layers))

    def conv(x, sp, layered=False):
        x = x.detach()
        if layered and not every:
            if x.shape[0] == cfg.num_hidden_layers:
                x = x[torch.as_tensor(own, device=x.device)]
            sp = _layer_spec(sp)
            sp = type(sp)(None, *sp)
        out = _shard(x, sp, mesh).clone()
        return out if device is None else out.to(device)

    return _ordered({k: conv(params[k], specs[k]) for k in keys},
                    {k: conv(v, specs["layers"][k], True)
                     for k, v in params["layers"].items()})


def _global_shapes(cfg: LlamaConfig) -> Dict:
    """One layer's global leaf shapes, and the rest."""
    D, Fi, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    qd = cfg.num_attention_heads * cfg.head_dim
    kd = cfg.num_key_value_heads * cfg.head_dim
    layer = {"wq": (D, qd), "wk": (D, kd), "wv": (D, kd), "wo": (qd, D),
             "w_gate": (D, Fi), "w_up": (D, Fi), "w_down": (Fi, D),
             "attn_norm": (D,), "mlp_norm": (D,)}
    return {"embed": (V, D), "layer": layer, "final_norm": (D,),
            "lm_head": (D, V)}


def train_state_specs(cfg: LlamaConfig, mesh, optimizer=None,
                      zero_stage: int = 0) -> Dict:
    """Partition specs of the mesh step's state ``{"params", "opt",
    "step"}``, computed without allocating anything; the trainer places
    by them. Leaves are per layer (the trainer's layout), so ``zero_spec``
    sees one layer's shape where the JAX specs see the stacked one.
    Moments inherit their param's (tp) spec; ``zero_stage >= 1`` adds dp
    on the first free dp-divisible dim of each moment, ``>= 3`` of each
    param too (``distributed.sharding.zero_spec``), inside each pipeline
    stage: under pp the tree is this rank's (``_held``). ``optimizer``
    is taken as in the JAX signature: the state is AdamW's (count, mu,
    nu) for any."""
    from ..distributed.sharding import zero_spec
    from ..parallel.mesh import P
    dp = mesh.dp_degree
    specs, shapes = param_specs(cfg), _global_shapes(cfg)
    keys, own = _held(cfg, mesh)
    base = _ordered({k: (specs[k], shapes[k]) for k in keys},
                    [{k: (_layer_spec(sp), shapes["layer"][k])
                      for k, sp in specs["layers"].items()} for _ in own])

    def place(on: bool):
        def leaf(pair):
            sp, shape = pair
            zs = zero_spec(sp, shape, dp) if on and dp > 1 else None
            return sp if zs is None else zs
        return _map_trees(leaf, base)

    moments = place(zero_stage >= 1)
    return {"params": place(zero_stage >= 3),
            "opt": {"count": P(), "mu": moments, "nu": moments},
            "step": P()}


def _map_trees(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists;
    a tuple, such as a partition spec, is a leaf)."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: _map_trees(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, list):
        return [_map_trees(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


class _GatherParam(torch.autograd.Function):
    """ZeRO-3: this rank's slice -> the whole (tp-local) parameter,
    all-gathered over dp; the backward reduce-scatters its gradient into
    the slice (the sum over dp)."""

    @staticmethod
    def forward(ctx, piece, dim, g):
        from ..distributed.communication import all_gather_cat
        ctx.dim, ctx.g = dim, g
        return all_gather_cat(piece, dim, g)

    @staticmethod
    def backward(ctx, ct):
        from ..distributed.communication import reduce_scatter_dim
        return reduce_scatter_dim(ct, ctx.dim, ctx.g), None, None


class _ZeroShard:
    """A ZeRO-3 parameter in a forward's params tree: ``full()`` gathers
    it at its use (again in the remat recompute), and nothing keeps the
    whole tensor after its last use."""

    __slots__ = ("piece", "dim", "group")

    def __init__(self, piece, dim, group):
        self.piece, self.dim, self.group = piece, dim, group

    def full(self):
        return _GatherParam.apply(self.piece, self.dim, self.group)


def _full(x):
    return x.full() if isinstance(x, _ZeroShard) else x


def _sp_norm(cfg: LlamaConfig, nr_impl, x, w, mesh):
    """RMSNorm on this rank's rows of the sequence-sharded stream; the
    weight's gradient is all-reduced over tp (the sharded kernel entry,
    or the "f" op on the weight for the unfused norm)."""
    from ..ops.kernels.fused_norm_rope import fused_rms_norm_sharded
    from ..parallel.mesh import P
    from ..parallel.mp_ops import identity_fwd_psum_bwd
    if nr_impl is None:
        return rms_norm(x, identity_fwd_psum_bwd(w, mesh.group("tp")),
                        cfg.rms_norm_eps)
    return fused_rms_norm_sharded(x, w, P(None, "tp", None),
                                  cfg.rms_norm_eps, nr_impl, mesh=mesh)


def _sp_attention(lp, h, cfg, mesh, positions):
    """The attention half of ``_sp_layer`` on tp-local weights (``lp``
    with ``attn_norm``, ``wq``, ``wk``, ``wv``, ``wo``): norm (local rows)
    -> all-gather the sequence -> q/k/v on the local heads -> rope ->
    flash attention -> ``wo`` -> reduce-scatter the sequence, added to
    the stream; the unfused norm and rope where ``_fused_nr_on`` says
    so (Qwen2-MoE's block, as in the JAX package)."""
    from ..distributed.sequence_parallel import (all_gather_sequence,
                                                 reduce_scatter_sequence)
    from ..ops.kernels.fused_norm_rope import fused_rope_sharded
    from ..parallel.mesh import P
    g = mesh.group("tp")
    B, T = positions.shape
    Dh = cfg.head_dim
    Hl, Hkvl = lp["wq"].shape[-1] // Dh, lp["wk"].shape[-1] // Dh
    nr = _fused_nr_on(cfg)
    x = all_gather_sequence(_sp_norm(cfg, nr, h, lp["attn_norm"], mesh), g)
    q = (x @ lp["wq"]).reshape(B, T, Hl, Dh)
    k = (x @ lp["wk"]).reshape(B, T, Hkvl, Dh)
    v = (x @ lp["wv"]).reshape(B, T, Hkvl, Dh)
    if nr is None:
        q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    else:
        spec = P(None, None, "tp", None)
        q, k = fused_rope_sharded(q, k, positions, spec, spec,
                                  cfg.rope_theta, nr)
    o = _train_attn_fn(cfg, mesh)(q, k, v)
    return h + reduce_scatter_sequence(o.reshape(B, T, Hl * Dh) @ lp["wo"],
                                       g)


def _sp_layer(lp, h, cfg: LlamaConfig, mesh, positions):
    """One block on tp-local weights over the sequence-sharded stream
    ``[B, T/tp, D]``: ``_sp_attention``, then the MLP the same way (norm
    -> all-gather -> column-parallel ``w_gate`` / ``w_up`` -> row-parallel
    ``w_down`` -> reduce-scatter). Under cp, T is this rank's cp part
    (``positions`` its global positions) and the attention runs over the
    cp line: sequence parallelism inside each cp part."""
    from ..distributed.sequence_parallel import (all_gather_sequence,
                                                 reduce_scatter_sequence)
    lp = {k: _full(v) for k, v in lp.items()}
    h = _sp_attention(lp, h, cfg, mesh, positions)
    g = mesh.group("tp")
    nr = _fused_nr_on(cfg)
    x = all_gather_sequence(_sp_norm(cfg, nr, h, lp["mlp_norm"], mesh), g)
    return h + reduce_scatter_sequence(
        (F.silu(x @ lp["w_gate"]) * (x @ lp["w_up"])) @ lp["w_down"], g)


def _dp_layer(lp, h, cfg: LlamaConfig, mesh, positions):
    """One block of the tp = 1 mesh step: the one-device block on this
    rank's rows (ZeRO-3 slices gathered at use), its attention over the
    cp line under cp."""
    return decoder_layer({k: _full(v) for k, v in lp.items()}, h, cfg,
                         positions, mesh)


def _mesh_embed(embed, tokens, cfg: LlamaConfig, mesh):
    """This rank's rows ``[B', T]`` -> the stream ``[B', T/tp, D]``: the
    lookup at tp = 1; above, the vocab-parallel lookup (rows outside this
    rank's shard are zeros) reduce-scattered into sequence parts, which
    sums the ranks' rows."""
    tp = mesh.tp_degree
    T = tokens.shape[1]
    if T % tp:
        raise ValueError(f"sequence length {T} does not divide over "
                         f"tp={tp} (the stream is sequence-sharded)")
    embed = _full(embed).to(cfg.dtype)
    if tp == 1:
        return embed[tokens.long()]
    from ..distributed.sequence_parallel import reduce_scatter_sequence
    g = mesh.group("tp")
    vl = embed.shape[0]
    ids = tokens.long() - g.rank * vl
    inside = (ids >= 0) & (ids < vl)
    e = torch.where(inside[..., None], embed[ids.clamp(0, vl - 1)], 0)
    del embed
    return reduce_scatter_sequence(e, g)


def _mesh_block(lp, h, cfg: LlamaConfig, mesh, positions):
    """One block on this rank's stream: ``_dp_layer`` at tp = 1,
    ``_sp_layer`` above; checkpointed (per-layer remat) under
    ``cfg.remat`` while autograd records."""
    if mesh.tp_degree == 1:
        fn, args = _dp_layer, (lp, h, cfg, mesh, positions)
    else:
        fn, args = _sp_layer, (lp, h, cfg, mesh, positions)
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _mesh_head_logits(final_norm, lm_head, h, cfg: LlamaConfig, mesh):
    """The stream -> logits ``[B', T, V/tp]`` of this rank's vocab
    shard: the final norm (on this rank's rows of the sequence at tp >
    1, then all-gathered) and ``lm_head``."""
    nr = _fused_nr_on(cfg)
    if mesh.tp_degree == 1:
        return _norm_fn(cfg, nr)(h, _full(final_norm)) @ _full(lm_head)
    from ..distributed.sequence_parallel import all_gather_sequence
    h = _sp_norm(cfg, nr, h, _full(final_norm), mesh)
    return all_gather_sequence(h, mesh.group("tp")) @ _full(lm_head)


def _mesh_nll(logits, labels, mesh):
    """Mean NLL of this rank's rows: the fused cross entropy at tp = 1,
    the vocab-parallel one (three ``[B', T]`` all-reduces over tp)
    above."""
    from ..ops.fused.cross_entropy import vocab_parallel_cross_entropy
    if mesh.tp_degree == 1:
        return fused_softmax_cross_entropy(logits, labels).mean()
    return vocab_parallel_cross_entropy(logits, labels,
                                        mesh.group("tp")).mean()


def _zigzag_on(cfg: LlamaConfig, mesh) -> bool:
    return cfg.context_parallel == "zigzag" and mesh.cp_degree > 1


def _cp_part(x, cfg: LlamaConfig, mesh):
    """This rank's cp part ``[B', T/cp, ...]`` of rows ``[B', T, ...]``
    of the sequence (laid out by ``zigzag_global_perm`` first under
    zigzag); the rows themselves at cp 1."""
    cp = mesh.cp_degree
    if cp == 1:
        return x
    T = x.shape[1]
    if T % cp:
        raise ValueError(f"sequence length {T} does not divide over "
                         f"cp={cp}")
    if _zigzag_on(cfg, mesh):
        from ..parallel.context_parallel import zigzag_global_perm
        x = x[:, torch.as_tensor(zigzag_global_perm(T, cp),
                                 device=x.device)]
    n, i = T // cp, mesh.axis_index("cp")
    return x[:, i * n:(i + 1) * n]


def _cp_positions(cfg: LlamaConfig, mesh, B: int, Tl: int, device):
    """Global positions ``[B, Tl]`` of this rank's cp part (``arange``
    at cp 1)."""
    if mesh.cp_degree == 1:
        return torch.arange(Tl, device=device).expand(B, Tl)
    from ..parallel.context_parallel import chunk_positions
    pos = chunk_positions(mesh.axis_index("cp"), mesh.cp_degree, Tl,
                          "zigzag" if _zigzag_on(cfg, mesh)
                          else "contiguous")
    return torch.as_tensor(pos, device=device).long().expand(B, Tl)


def _mesh_logits(params, tokens, cfg: LlamaConfig, mesh):
    """This rank's rows ``[B/dp, T]`` -> logits ``[B/dp, T/cp, V/tp]``
    over its cp part, the classes of this rank's vocab shard."""
    tokens = _cp_part(tokens, cfg, mesh)
    h = _mesh_embed(params["embed"], tokens, cfg, mesh)
    B, T = tokens.shape
    positions = _cp_positions(cfg, mesh, B, T, h.device)
    for i in range(cfg.num_hidden_layers):
        h = _mesh_block(_layer(params, i), h, cfg, mesh, positions)
    return _mesh_head_logits(params["final_norm"], params["lm_head"], h,
                             cfg, mesh)


def _mesh_loss(params, batch, cfg: LlamaConfig, mesh):
    """Mean NLL over this rank's rows and cp part (every tp rank of them
    gets the same value). Under a pipeline: GPipe (``_gpipe``), the value
    on the last pp rank and a 0-d zero carrying the backward on the
    others."""
    if mesh.pp_degree > 1:
        return _gpipe(params, batch, cfg, mesh)
    logits = _mesh_logits(params, batch["tokens"], cfg, mesh)
    return _mesh_nll(logits, _cp_part(batch["labels"], cfg, mesh), mesh)


# ---------------------------------------------------------------------------
# pipeline parallelism: each pp rank holds its stage's layers (the
# embedding on the first, the head on the last); the schedules of
# parallel/pipeline_spmd (GPipe), pipeline_1f1b (lockstep) and
# pipeline_async (rank-asymmetric 1F1B, zero bubble)
# ---------------------------------------------------------------------------

def _async_stage_head_fns(cfg: LlamaConfig, mesh):
    """``(stage_fn, head_fn)`` of the pipeline executors. The stage runs
    its chunk's layers with ``_mesh_block`` (the one-device block at tp
    = 1, ``_sp_layer`` on the sequence-sharded stream above: the fused
    kernels, not the JAX stage's jnp norm and rope); the head is the
    final norm, ``lm_head`` and the cross entropy (vocab-parallel at tp
    > 1) of one microbatch, its mean NLL."""
    tp = mesh.tp_degree

    def stage_fn(chunk, h):
        T = h.shape[1] * tp
        positions = torch.arange(T, device=h.device).expand(h.shape[0], T)
        for lp in chunk:
            h = _mesh_block(lp, h, cfg, mesh, positions)
        return h

    def head_fn(hp, y, labels):
        return _mesh_nll(_mesh_head_logits(hp["final_norm"], hp["lm_head"],
                                           y, cfg, mesh), labels, mesh)
    return stage_fn, head_fn


def _async_shard_specs(cfg: LlamaConfig, mesh):
    """``(stage_specs, head_specs, x_spec, aux_specs)`` as the JAX
    function lays them out, with the stream sequence-sharded over tp
    (the port's stage is sequence-parallel): each layer leaf's spec
    without its layer axis, the head's, the microbatched stream's
    ``[M, mb, T, D]`` and the labels' ``[M, mb, T]`` (rows over dp)."""
    from ..parallel.mesh import P
    dp_ax = "dp" if mesh.dp_degree > 1 else None
    tp_on = mesh.tp_degree > 1
    stage_specs = {k: _layer_spec(sp)
                   for k, sp in param_specs(cfg)["layers"].items()}
    head_specs = {"final_norm": P(None),
                  "lm_head": P(None, "tp") if tp_on else P(None, None)}
    x_spec = P(None, dp_ax, "tp" if tp_on else None, None)
    aux_specs = P(None, dp_ax, None)
    return stage_specs, head_specs, x_spec, aux_specs


def _pipe_rows(batch, cfg: LlamaConfig, mesh) -> Dict:
    """This rank's rows of the global batch under a pipeline, flat and
    microbatch-major ``[M · B/(M·dp), T]``: the batch split into M
    microbatches, each microbatch's rows over dp (``aux_specs``)."""
    from ..parallel.pipeline_spmd import microbatch
    spec = _async_shard_specs(cfg, mesh)[3]
    M = cfg.num_microbatches
    out = {}
    for k, v in batch.items():
        if v.shape[0] % (M * mesh.dp_degree):
            raise ValueError(f"batch of {v.shape[0]} rows does not split "
                             f"into {M} microbatches over "
                             f"dp={mesh.dp_degree}")
        part = _shard(microbatch(v, M), spec, mesh)
        out[k] = part.reshape((-1,) + tuple(v.shape[1:]))
    return out


def _pipe_input(params, tokens, cfg: LlamaConfig, mesh, embed=None):
    """The stage-0 input ``[M, mb, T/tp, D]`` and the embedding output
    it views (the first pp rank); elsewhere a ``meta`` tensor of its
    shape and dtype, and None."""
    M = cfg.num_microbatches
    mb, T = tokens.shape[0] // M, tokens.shape[1]
    shape = (M, mb, T // mesh.tp_degree, cfg.hidden_size)
    if mesh.axis_index("pp") != 0:
        return torch.empty(shape, dtype=cfg.dtype, device="meta"), None
    e = _mesh_embed(params["embed"] if embed is None else embed, tokens,
                    cfg, mesh)
    return e.reshape(shape), e


def forward_pipelined(params, tokens, cfg: LlamaConfig, mesh):
    """GPipe's forward over this rank's rows (``_pipe_rows``): the logits
    ``[B', T, V/tp]`` on the last pp rank, a 0-d zero carrying the
    backward on the others."""
    from ..parallel.pipeline_spmd import pipeline_spmd
    _check_mesh(cfg, mesh)
    S = mesh.pp_degree
    x, _ = _pipe_input(params, tokens, cfg, mesh)
    stage_fn, _ = _async_stage_head_fns(cfg, mesh)
    out = pipeline_spmd(stage_fn, params["layers"], x, num_stages=S,
                        mesh=mesh, remat=False)
    if mesh.axis_index("pp") != S - 1:
        return out
    h = out.reshape((-1,) + tuple(out.shape[2:]))
    return _mesh_head_logits(params["final_norm"], params["lm_head"], h,
                             cfg, mesh)


def _gpipe(params, batch, cfg: LlamaConfig, mesh):
    """GPipe over this rank's rows (``_pipe_rows``): the loss on the last
    pp rank; on the others a 0-d zero; ``.backward()`` on either runs
    this rank's part of the reverse pipeline."""
    out = forward_pipelined(params, batch["tokens"], cfg, mesh)
    if mesh.axis_index("pp") != mesh.pp_degree - 1:
        return out
    return _mesh_nll(out, batch["labels"], mesh)


def _pipe_grads(params, rows, cfg: LlamaConfig, mesh):
    """``(loss, sums)`` of a fused-schedule step (``cfg.pp_schedule``
    "1f1b", "1f1b_async" or "zb") over this rank's rows (``_pipe_rows``):
    the loss the global mean (on every rank), ``sums`` aligned with
    ``_tree_leaves(params)``, each the f32 sum over this rank's
    microbatches, not yet reduced over dp nor scaled. The embedding's
    comes from its lookup in f32 with the unscaled ``dx``."""
    from ..parallel.pipeline_1f1b import pipeline_train_1f1b
    from ..parallel.pipeline_async import pipeline_train_async
    _check_mesh(cfg, mesh)
    S, V = mesh.pp_degree, _pipe_chunks(cfg)
    r = mesh.axis_index("pp")
    first, last = r == 0, r == S - 1
    emb = params["embed"].detach().float().requires_grad_(True) \
        if first else None
    x, e = _pipe_input(params, rows["tokens"], cfg, mesh, embed=emb)
    if first:
        x = x.detach()
    n = len(params["layers"]) // V
    chunks = [params["layers"][v * n:(v + 1) * n] for v in range(V)]
    head = {k: params[k] for k in ("final_norm", "lm_head")} if last \
        else None
    labels = rows["labels"].reshape((cfg.num_microbatches, -1)
                                    + tuple(rows["labels"].shape[1:]))
    stage_fn, head_fn = _async_stage_head_fns(cfg, mesh)
    kw = dict(num_stages=S, virtual_chunks=V, mesh=mesh)
    variant = PP_SCHEDULES[cfg.pp_schedule][1]
    if variant is None:
        loss, gch, gh, dx = pipeline_train_1f1b(
            stage_fn, head_fn, chunks, head, x, labels, **kw)
    else:
        loss, gch, gh, dx = pipeline_train_async(
            stage_fn, head_fn, chunks, head, x, labels, variant=variant,
            **kw)
    sums = _tree_leaves(gch)
    if first:
        (ge,) = torch.autograd.grad(e, emb, dx.reshape(e.shape))
        sums = [ge] + sums
    if last:
        sums += _tree_leaves(gh)
    return loss, sums


def grads_1f1b(params, batch, cfg: LlamaConfig, mesh):
    """``(loss, grads)`` through an explicit fused forward + backward
    schedule, as the JAX ``grads_1f1b``: ``params`` this rank's
    (``shard_params`` output or a trainer's), ``batch`` the global one.
    The loss is the global mean; ``grads`` the tree of this rank's
    params (layers per layer) with each gradient reduced over dp,
    scaled by ``1/(M·dp)`` and cast to its leaf's dtype."""
    from ..distributed import communication as C
    _check_mesh(cfg, mesh)
    if cfg.pp_schedule == "gpipe":
        raise ValueError("grads_1f1b runs the fused schedules; GPipe is "
                         "loss_fn's backward")
    leaves = _train_params(params, _tree_leaves(params["layers"])[0].device)
    rows = _pipe_rows(batch, cfg, mesh)
    loss, sums = _pipe_grads(leaves, rows, cfg, mesh)
    inv = 1.0 / (cfg.num_microbatches * mesh.dp_degree)
    done = []
    for p, g in zip(_tree_leaves(leaves), sums):
        if mesh.dp_degree > 1:
            C.all_reduce(g, C.ReduceOp.SUM, mesh.group("dp"))
        done.append(g.mul_(inv).to(p.dtype))
    it = iter(done)
    return loss, _tree_map(lambda _: next(it), leaves)


def _zero_dims(specs) -> Any:
    """Each leaf's dp-sharded dim in a spec tree (None: whole)."""
    return _map_trees(lambda sp: list(sp).index("dp") if "dp" in sp
                      else None, specs)


def _mesh_trainer(cfg: LlamaConfig, mesh, zero_stage: int, device,
                  optimizer):
    """``(step_fn, init_fn)`` of the dp x pp x cp x tp step on this
    rank.

    ``init_fn(source)`` shards the global params (a ``torch.Generator``
    draws them as ``init_params`` does, on every rank alike) by
    ``param_specs`` into this rank's tp shards (per-layer leaves; under
    a pipeline only its stage's, ``_held``) and places the state by
    ``train_state_specs``. ``step_fn(state, batch)`` takes the GLOBAL
    batch, reads this rank's dp rows (and cp part of the sequence), and
    returns the global mean loss, the same on every rank. The params are
    replicated over cp, and each cp rank's tokens are separate loss
    terms: gradients of the local mean are reduced over dp and over cp
    (an all-reduce of the gradient, or of its dp slice at ZeRO 2-3,
    after the dp treatment below) and scaled by 1/(dp·cp):

    * stage 0: all-reduced, each rank updates the whole tp shard;
    * stage 1: all-reduced; the moments are this rank's ``zero_spec``
      slice, each rank updates its slice of every parameter
      (``AdamW.update_leaf_``, elementwise, so bitwise the whole
      update's), then all-gathers the parameter over dp;
    * stage 2: as 1, but each gradient is reduce-scattered into the
      slice as it lands in backward (a post-accumulate hook frees the
      whole one), never all-reduced;
    * stage 3: the parameters are their slices between steps; a layer's
      are all-gathered at use, in forward and again in the remat
      recompute (``_ZeroShard``), and freed after; the gather's backward
      reduce-scatters the gradient into the slice.

    Under a pipeline (``mesh.pp_degree > 1``) the step runs
    ``cfg.pp_schedule``: GPipe's gradients land in ``.grad`` as above;
    the fused schedules' are f32 sums over the microbatches, reduced
    over dp once after the schedule (all-reduced, or reduce-scattered
    into the slice at stages 2-3), scaled by ``1/(M·dp)`` and cast, as
    the JAX executors do. Stage 3 gathers the stage's parameters at the
    step's start (the JAX step's layout) and reduce-scatters the
    gradients after.

    ``state["zero"]`` holds the stage and each leaf's sharded dim.
    """
    from ..distributed import communication as C
    _check_mesh(cfg, mesh)
    dev = resolve_device(device)
    opt = default_train_optimizer() if optimizer is None else optimizer
    dp, dp_g = mesh.dp_degree, mesh.group("dp")
    cp, cp_g = mesh.cp_degree, mesh.group("cp")
    pipe = mesh.pp_degree > 1
    specs = train_state_specs(cfg, mesh, zero_stage=zero_stage)
    dims = _zero_dims(specs["opt"]["mu"])

    def stage2_hook(d):
        def hook(p):
            p.zero_grad_piece = C.reduce_scatter_dim(_pop_grad(p), d, dp_g)
        return hook

    def init_fn(source):
        if isinstance(source, torch.Generator):
            # a pipeline rank keeps its stage's layers only
            source = init_params(cfg, source, dev, layers=(
                _held(cfg, mesh)[1] if pipe else None))
        params = _train_params(shard_params(source, cfg, mesh), dev)
        del source
        # the dims in the params' own key order, so leaves zip
        pdims = _map_trees(lambda p, d: d, params, dims)
        if zero_stage >= 3:
            params = _map_trees(
                lambda p, d: p if d is None else
                C.rank_part(p.detach(), d, dp_g).clone().requires_grad_(True),
                params, dims)

        def moment(p, d):
            if d is not None and zero_stage in (1, 2):
                p = C.rank_part(p.detach(), d, dp_g)
            return torch.zeros_like(p, requires_grad=False)

        if zero_stage == 2 and not pipe:
            for p, d in zip(_tree_leaves(params), _tree_leaves(pdims)):
                if d is not None:
                    p.register_post_accumulate_grad_hook(stage2_hook(d))
        return {"params": params,
                "opt": {"count": 0,
                        "mu": _map_trees(moment, params, pdims),
                        "nu": _map_trees(moment, params, pdims)},
                "step": 0, "zero": {"stage": zero_stage, "dims": pdims}}

    def rows(batch):
        if pipe:
            return {k: v.to(dev) for k, v in
                    _pipe_rows(batch, cfg, mesh).items()}
        r, n = mesh.axis_index("dp"), batch["tokens"].shape[0] // dp
        return {k: v[r * n:(r + 1) * n].to(dev) for k, v in batch.items()}

    @torch.no_grad()
    def update(state, grad_of):
        params, st = state["params"], state["opt"]
        count, bc1, bc2 = opt.advance(st)
        for i, (p, mu, nu, d) in enumerate(zip(
                _tree_leaves(params), _tree_leaves(st["mu"]),
                _tree_leaves(st["nu"]),
                _tree_leaves(state["zero"]["dims"]))):
            g = grad_of(i, p, d)
            target = p.data
            if d is not None and zero_stage in (1, 2):
                target = C.rank_part(p.data, d, dp_g)
                if zero_stage == 1:
                    g = C.rank_part(g, d, dp_g)
            opt.update_leaf_(target, g, mu, nu, bc1, bc2)
            if d is not None and zero_stage in (1, 2):
                parts = C.all_gather(None, target.contiguous(), dp_g)
                n = target.shape[d]
                for j, part in enumerate(parts):
                    p.data.narrow(d, j * n, n).copy_(part)
        st["count"] = count

    def mesh_grad(i, p, d):
        scale = float(torch.tensor(1.0 / (dp * cp), dtype=p.dtype))
        if zero_stage == 2 and d is not None:
            g = p.__dict__.pop("zero_grad_piece")
        else:
            g = _pop_grad(p)
            if g is None:
                raise RuntimeError("a parameter has no grad")
            if dp > 1 and (d is None or zero_stage < 3):
                C.all_reduce(g, C.ReduceOp.SUM, dp_g)
        if cp > 1:
            C.all_reduce(g, C.ReduceOp.SUM, cp_g)
        if dp * cp > 1:
            g.mul_(scale)
        return g

    def pipe_step(state, batch):
        params = state["params"]
        if zero_stage >= 3:
            params = _map_trees(
                lambda p, d: p if d is None else C.all_gather_cat(
                    p.detach(), d, dp_g).requires_grad_(True),
                params, state["zero"]["dims"])
        gpipe = cfg.pp_schedule == "gpipe"
        if gpipe:
            value = _gpipe(params, rows(batch), cfg, mesh)
            value.backward()
            grads = [_pop_grad(p) for p in _tree_leaves(params)]
            loss = value.detach().float().clone()
            C.all_reduce(loss, C.ReduceOp.SUM, mesh.group("pp"))
            if dp > 1:
                C.all_reduce(loss, C.ReduceOp.AVG, dp_g)
        else:
            loss, grads = _pipe_grads(params, rows(batch), cfg, mesh)
        del params
        inv = 1.0 / (cfg.num_microbatches * dp)

        def pipe_grad(i, p, d):
            g, grads[i] = grads[i], None
            if dp > 1:
                if d is not None and zero_stage >= 2:
                    g = C.reduce_scatter_dim(g, d, dp_g)
                else:
                    C.all_reduce(g, C.ReduceOp.SUM, dp_g)
            if not gpipe:
                return g.mul_(inv).to(p.dtype)
            if dp > 1:
                g.mul_(float(torch.tensor(1.0 / dp, dtype=p.dtype)))
            return g

        update(state, pipe_grad)
        state["step"] += 1
        return state, loss

    def step_fn(state, batch):
        if pipe:
            return pipe_step(state, batch)
        params = state["params"]
        if zero_stage >= 3:
            params = _map_trees(
                lambda p, d: p if d is None else _ZeroShard(p, d, dp_g),
                params, dims)
        value = _mesh_loss(params, rows(batch), cfg, mesh)
        value.backward()
        update(state, mesh_grad)
        loss = value.detach().clone()
        if dp > 1:
            C.all_reduce(loss, C.ReduceOp.AVG, dp_g)
        if cp > 1:
            C.all_reduce(loss, C.ReduceOp.AVG, cp_g)
        state["step"] += 1
        return state, loss

    return step_fn, init_fn


def checkpoint_layout(state, cfg: LlamaConfig, mesh=None) -> Dict:
    """``distributed.checkpoint``'s layout of a train state
    (``make_train_step``'s ``init_fn``): none for one device (every leaf
    whole); on a mesh each param and moment leaf's slice by
    ``train_state_specs`` at the state's ZeRO stage, a pipeline rank's
    layers under their global indices (``_held``), and
    ``state["zero"]`` the rank's own (not saved). Global names are the
    one-device state's paths, so a checkpoint loads on any mesh."""
    from ..distributed.checkpoint import spec_layout
    if mesh is None:
        return {}
    specs = train_state_specs(cfg, mesh,
                              zero_stage=state["zero"]["stage"])
    own = _held(cfg, mesh)[1]

    def global_name(path):
        parts = path.split("/")
        if "layers" in parts:
            i = parts.index("layers")
            parts[i + 1] = str(own[int(parts[i + 1])])
        return "/".join(parts)

    tree = {"params": state["params"], "opt": {k: state["opt"][k]
                                               for k in ("mu", "nu")}}
    spec_tree = {"params": specs["params"],
                 "opt": {k: specs["opt"][k] for k in ("mu", "nu")}}
    out = spec_layout(tree, spec_tree, mesh, global_name)
    out["zero"] = None
    return out


def _pipe_assemble(mine, cfg: LlamaConfig, mesh) -> Dict:
    """Every rank's whole (tp- and dp-gathered) leaves -> the global
    params on every rank: each leaf broadcast over pp from the rank that
    holds it (``_held``)."""
    from ..distributed.communication import broadcast
    S, g = mesh.pp_degree, mesh.group("pp")
    me = mesh.axis_index("pp")
    shapes = _global_shapes(cfg)
    ref = _tree_leaves(mine)[0]

    def get(owner, have, shape):
        t = have.contiguous() if owner == me else torch.empty(
            shape, dtype=ref.dtype, device=ref.device)
        broadcast(t, src=g.ranks[owner], group=g)
        return t

    owner = {i: s for s in range(S) for i in _stage_layers(cfg, s)}
    owned = dict(zip(_stage_layers(cfg, me), mine["layers"]))
    layers = [{k: get(owner[i], owned.get(i, {}).get(k), shape)
               for k, shape in shapes["layer"].items()}
              for i in range(cfg.num_hidden_layers)]
    return {"embed": get(0, mine.get("embed"), shapes["embed"]),
            "layers": layers,
            "final_norm": get(S - 1, mine.get("final_norm"),
                              shapes["final_norm"]),
            "lm_head": get(S - 1, mine.get("lm_head"), shapes["lm_head"])}


def gather_params(state_or_params, cfg: LlamaConfig, mesh) -> Dict:
    """The global params, as numpy in the JAX pytree layout
    (``params_to_numpy``), from a mesh step's state (ZeRO-3 slices
    gathered over dp) or from tp-local params (``shard_params`` output,
    stacked or per layer, or a gradient tree of the same layout). A
    collective: every rank of the mesh calls it, and every rank gets
    the whole (under a pipeline, each leaf broadcast from the pp rank
    that holds it)."""
    from ..distributed.communication import all_gather_cat
    src = state_or_params
    dims = None
    if "params" in src and "zero" in src:
        params = src["params"]
        if src["zero"]["stage"] >= 3:
            dims = src["zero"]["dims"]
    else:
        params = src
    specs = param_specs(cfg)
    keys, _ = _held(cfg, mesh)
    pipe = mesh.pp_degree > 1
    if pipe and isinstance(params["layers"], dict):
        n = _tree_leaves(params["layers"])[0].shape[0]
        params = dict(params, layers=[_select(params["layers"], i)
                                      for i in range(n)])
    stacked = isinstance(params["layers"], dict)
    lspecs = specs["layers"] if stacked else [
        {k: _layer_spec(sp) for k, sp in specs["layers"].items()}
        for _ in params["layers"]]
    spec_tree = _ordered({k: specs[k] for k in keys}, lspecs)
    if dims is None:
        dims = _map_trees(lambda _: None, spec_tree)

    def whole(x, sp, d):
        x = x.detach()
        if d is not None:
            x = all_gather_cat(x.contiguous(), d, mesh.group("dp"))
        for dim, ax in enumerate(sp):
            if ax is not None and mesh.degree(ax) > 1:
                x = all_gather_cat(x.contiguous(), dim, mesh.group(ax))
        return x

    mine = _map_trees(whole, _ordered({k: params[k] for k in keys},
                                      params["layers"]), spec_tree, dims)
    return params_to_numpy(_pipe_assemble(mine, cfg, mesh) if pipe
                           else mine)
