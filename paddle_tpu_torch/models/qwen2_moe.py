"""Qwen2-MoE decoder: training, cached decode and serving.

Port of ``paddle_tpu/models/qwen2_moe.py``: ``Qwen2MoeConfig`` (the
defaults are Qwen1.5-MoE-A2.7B's published widths; ``tiny`` for tests),
``init_params`` (seeded ``torch.Generator``; the router in f32),
``decoder_layer`` (Llama attention, then a routed MoE FFN plus a gated
shared expert), ``forward``, ``loss_fn`` and ``make_train_step`` on one
device, and ``make_batch`` / ``params_from_jax`` (the Llama ones, as are
``init_kv_cache`` and ``init_serving_pages``).

Decode and serving: ``init_kv_cache`` / ``forward_with_cache`` /
``generate`` (dense KV cache; the prompt's attention on the flash
kernels as ``use_flash_attention`` says) and the serving functions
``init_serving_pages``, ``serving_prefill``, ``serving_prefill_chunk``,
``serving_decode_step``, ``serving_decode_block``, ``serving_tick`` and
``serving_tick_block``: the Llama functions (``models/llama.py``) with
this model's block, ``_decode_block``, so the same ragged and paged
attention kernels run under it and ``ServingEngine`` serves it
(``model="qwen2_moe"`` or inferred from the config). ``_decode_block``
routes DROP-FREE: the einsum ``moe_ffn`` at capacity factor
``num_experts / num_experts_per_tok`` makes each expert's capacity the
cohort size, so no token is dropped and a token's FFN does not depend
on what shares its tick. Its projections go through ``llama._mm``, so
weight-only int8 params (``quantization.quantize_for_decode``) run q, k,
v, o, the shared expert and ``lm_head`` on the int8 matmul kernel; the
routed experts are dequantized to ``cfg.dtype`` for the einsum on every
call, as the JAX block's ``_dense_w`` does (XLA fuses that cast into
the einsum; eager PyTorch makes a dense copy of the layer's experts).

The params are a plain dict in the JAX layouts: weights ``[in, out]``,
per-layer tensors stacked on a leading ``L`` axis, the routed experts
under ``layers["experts"]`` (``w_gate`` / ``w_up [L, E, D, F]``,
``w_down [L, E, F, D]``) and the shared expert under ``layers["shared"]``.
The trainer (``llama.one_device_trainer``) splits them into per-layer
leaves, nested dicts included, and updates them in place with ``AdamW``.

Attention runs through the flash-attention kernels (``use_flash_attention``,
as ``LlamaConfig``'s switch); rmsnorm and rope are the plain ones, as in
the JAX block. ``moe_impl="dropless"`` runs the MoE FFN on the
grouped-matmul kernels (``use_grouped_matmul`` is their switch: True /
"auto", "kernel", False / "reference"); ``"einsum"`` runs the capacity
dispatch in plain PyTorch. On one device dropless always engages (the
JAX package falls back to einsum only on sharded layouts).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..incubate.moe.functional import moe_ffn, moe_ffn_dropless
from ..ops.fused.int8_matmul import Int8Weight
from ..ops.kernels.flash_attention import flash_attention
from . import llama
from .llama import _kernel_impl, _layer, _mm, rms_norm, rope

__all__ = ["Qwen2MoeConfig", "init_params", "params_from_jax",
           "decoder_layer", "forward", "loss_fn", "make_train_step",
           "make_batch", "init_kv_cache", "forward_with_cache", "generate",
           "init_serving_pages", "serving_prefill", "serving_prefill_chunk",
           "serving_decode_step", "serving_decode_block", "serving_tick",
           "serving_tick_block", "SERVING_KERNELS"]

params_from_jax = llama.params_from_jax
# the serving ticks' kernel libraries: the routed experts run as plain
# einsums in the decode block, so only the ragged attention kernel
SERVING_KERNELS = ("ragged_paged_attention",)
make_batch = llama.make_batch
# the dense K/V cache and the serving page pools: the Llama layouts
init_kv_cache = llama.init_kv_cache
init_serving_pages = llama.init_serving_pages


@dataclasses.dataclass
class Qwen2MoeConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    max_position_embeddings: int = 8192
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1000000.0
    # MoE
    num_experts: int = 60
    num_experts_per_tok: int = 4
    moe_intermediate_size: int = 1408
    shared_expert_intermediate_size: int = 5632
    capacity_factor: float = 2.0
    router_aux_loss_coef: float = 0.001
    # "einsum": capacity dispatch (drops overflow tokens); "dropless": the
    # grouped-matmul kernels, nothing dropped
    moe_impl: str = "einsum"
    dtype: torch.dtype = torch.bfloat16
    remat: bool = True
    # kernel switches: True / "auto" — the Hopper kernel for CUDA tensors,
    # its plain version for CPU tensors; "kernel" — strict; False /
    # "reference" — the plain version
    use_flash_attention: Any = True
    use_grouped_matmul: Any = True

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def tiny(**kw) -> "Qwen2MoeConfig":
        return Qwen2MoeConfig(
            vocab_size=256, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=128, num_experts=4,
            num_experts_per_tok=2, moe_intermediate_size=32,
            shared_expert_intermediate_size=64, **kw)


def init_params(cfg: Qwen2MoeConfig, generator: torch.Generator,
                device=None) -> Dict:
    """Random params, normal · 1/sqrt(fan_in) (norms at one; the router
    f32 normal · 0.02), drawn from ``generator`` (which must live on
    ``device``) one matrix at a time."""
    dev = resolve_device(device)
    D, V = cfg.hidden_size, cfg.vocab_size
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    L, E = cfg.num_hidden_layers, cfg.num_experts
    Fm, Fs = cfg.moe_intermediate_size, cfg.shared_expert_intermediate_size

    def init(shape, fan_in):
        return llama.normal_init(shape, fan_in, cfg.dtype, generator, dev)

    def ones(shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    layers = {
        "wq": init((L, D, H * Dh), D),
        "wk": init((L, D, Hkv * Dh), D),
        "wv": init((L, D, Hkv * Dh), D),
        "wo": init((L, H * Dh, D), H * Dh),
        "attn_norm": ones((L, D)),
        "mlp_norm": ones((L, D)),
        "router": torch.randn((L, D, E), generator=generator, device=dev,
                              dtype=torch.float32) * 0.02,
        "experts": {
            "w_gate": init((L, E, D, Fm), D),
            "w_up": init((L, E, D, Fm), D),
            "w_down": init((L, E, Fm, D), Fm),
        },
        "shared": {
            "w_gate": init((L, D, Fs), D),
            "w_up": init((L, D, Fs), D),
            "w_down": init((L, Fs, D), Fs),
            "gate": init((L, D, 1), D),   # shared-expert gate projection
        },
    }
    return {"embed": init((V, D), D), "layers": layers,
            "final_norm": ones((D,)), "lm_head": init((D, V), D)}


def decoder_layer(lp, h, cfg: Qwen2MoeConfig, positions,
                  use_dropless: bool = False):
    """One block on ``[B, T, D]`` -> (h, the MoE aux loss)."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = (x @ lp["wq"]).reshape(B, T, H, Dh)
    k = (x @ lp["wk"]).reshape(B, T, Hkv, Dh)
    v = (x @ lp["wv"]).reshape(B, T, Hkv, Dh)
    q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    o = flash_attention(q, k, v, causal=True,
                        impl=_kernel_impl(cfg.use_flash_attention))
    h = h + o.reshape(B, T, H * Dh) @ lp["wo"]

    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    ex = lp["experts"]
    if use_dropless:
        routed, aux = moe_ffn_dropless(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            impl=_kernel_impl(cfg.use_grouped_matmul))
    else:
        routed, aux = moe_ffn(
            x, lp["router"], ex["w_gate"], ex["w_up"], ex["w_down"],
            top_k=cfg.num_experts_per_tok,
            capacity_factor=cfg.capacity_factor)
    sh = lp["shared"]
    shared = (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) @ sh["w_down"]
    shared = torch.sigmoid(x @ sh["gate"]) * shared
    return h + routed + shared, aux


def forward(params, tokens, cfg: Qwen2MoeConfig, mesh=None):
    """tokens ``[B, T]`` -> (logits ``[B, T, V]`` in ``cfg.dtype``, the
    summed f32 aux loss), one device, per-layer remat as ``cfg.remat``
    says."""
    if cfg.moe_impl not in ("einsum", "dropless"):
        raise ValueError(f"moe_impl must be 'einsum' or 'dropless', "
                         f"got {cfg.moe_impl!r}")
    if mesh is not None:
        raise NotImplementedError(
            "the port's Qwen2-MoE runs on one device: its mesh layouts "
            "(expert parallelism) come in a later slice of the port")
    use_dropless = cfg.moe_impl == "dropless"
    B, T = tokens.shape
    h = params["embed"].to(cfg.dtype)[tokens.long()]
    positions = torch.arange(T, device=h.device).expand(B, T)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_hidden_layers):
        lp = _layer(params, i)
        if cfg.remat:
            # only each layer's input is kept for the backward, which
            # recomputes the layer first
            h, a = checkpoint(decoder_layer, lp, h, cfg, positions,
                              use_dropless, use_reentrant=False)
        else:
            h, a = decoder_layer(lp, h, cfg, positions, use_dropless)
        aux = aux + a
    h = rms_norm(h, params["final_norm"], cfg.rms_norm_eps)
    return h @ params["lm_head"], aux


def loss_fn(params, batch, cfg: Qwen2MoeConfig):
    """Mean next-token NLL of the f32 log-softmax, plus
    ``router_aux_loss_coef`` times the summed aux loss. With
    ``moe_impl="dropless"``, ``jit.to_static`` captures it whole (gmm
    and tgmm one operator node each; ``m_pad`` is a Python int of the
    shapes), as ``llama.loss_fn``."""
    logits, aux = forward(params, batch["tokens"], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, batch["labels"].long()[..., None])[..., 0]
    return nll.mean() + cfg.router_aux_loss_coef * aux


def make_train_step(cfg: Qwen2MoeConfig, device=None, optimizer=None,
                    mesh=None):
    """The train step (forward, backward, AdamW) on one device, as
    ``llama.make_train_step``: ``(step_fn, init_fn)``, ``init_fn`` from a
    ``torch.Generator`` or a params dict, ``step_fn(state, batch)``
    updating the state in place and returning ``(state, loss)``. A mesh
    raises ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "the port's Qwen2-MoE train step runs on one device: its mesh "
            "layouts (expert parallelism) come in a later slice of the "
            "port")
    return llama.one_device_trainer(cfg, init_params, loss_fn, device,
                                    optimizer)


# ---------------------------------------------------------------------------
# decode: dense KV cache + generate
# ---------------------------------------------------------------------------

def _dense_w(w, dtype):
    """A dense view of an expert weight that may be an ``Int8Weight``:
    the einsum MoE FFN takes whole expert tensors, so quantized experts
    are dequantized (``Int8Weight.dequant``, JAX's bits) for each call."""
    return w.dequant(dtype) if isinstance(w, Int8Weight) else w


def _decode_block(lp, h, positions, cfg: Qwen2MoeConfig, attn_fn):
    """The block of every cached-decode and serving path, with the
    signature of ``llama._block``: rms_norm -> QKV -> rope -> ``attn_fn``
    -> o-proj + residual -> rms_norm -> the routed MoE FFN, DROP-FREE
    (capacity factor E / top_k makes the capacity the cohort size), plus
    the gated shared expert, + residual. Projections through ``_mm``
    (dense or ``Int8Weight``); the routed experts through ``_dense_w``."""
    B, T, _ = h.shape
    H, Hkv, Dh = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    x = rms_norm(h, lp["attn_norm"], cfg.rms_norm_eps)
    q = _mm(x, lp["wq"]).reshape(B, T, H, Dh)
    k = _mm(x, lp["wk"]).reshape(B, T, Hkv, Dh)
    v = _mm(x, lp["wv"]).reshape(B, T, Hkv, Dh)
    q, k = rope(q, k, positions, cfg.rope_theta, Dh)
    o = attn_fn(q, k, v)
    h = h + _mm(o.reshape(B, T, H * Dh), lp["wo"])

    x = rms_norm(h, lp["mlp_norm"], cfg.rms_norm_eps)
    ex = lp["experts"]
    routed, _ = moe_ffn(
        x, lp["router"], _dense_w(ex["w_gate"], cfg.dtype),
        _dense_w(ex["w_up"], cfg.dtype), _dense_w(ex["w_down"], cfg.dtype),
        top_k=cfg.num_experts_per_tok,
        capacity_factor=cfg.num_experts / cfg.num_experts_per_tok)
    sh = lp["shared"]
    shared = _mm(F.silu(_mm(x, sh["w_gate"])) * _mm(x, sh["w_up"]),
                 sh["w_down"])
    shared = torch.sigmoid(x @ sh["gate"]) * shared
    return h + routed + shared


@torch.no_grad()
def forward_with_cache(params, tokens, cache, pos0: int,
                       cfg: Qwen2MoeConfig):
    """tokens ``[B, T]`` at positions pos0 .. pos0+T-1 -> (f32 logits of
    the LAST position ``[B, V]``, cache), the cache updated in place.
    pos0 == 0 is a prompt: causal flash attention over the fresh keys
    (``use_flash_attention`` picks kernel or plain version); otherwise
    plain attention over the cache (``llama._cached_attention``)."""
    impl = _kernel_impl(cfg.use_flash_attention)
    return llama._forward_with_cache(
        params, tokens, cache, pos0, cfg, _decode_block,
        lambda q, k, v: flash_attention(q, k, v, causal=True, impl=impl))


def generate(params, prompt, cfg: Qwen2MoeConfig, max_new_tokens: int,
             *, temperature: float = 0.0, top_p: float = 1.0,
             top_k: int = 0, key=None, eos_token_id: Optional[int] = None):
    """Autoregressive MoE decode with a dense KV cache, on the params'
    device: ``llama.generate``'s contract (the same split chain of keys,
    EOS latch; returns int32 prompt + continuation), drop-free routing."""
    return llama._decode_loop(
        lambda p, t, c, pos: forward_with_cache(p, t, c, pos, cfg),
        lambda B, n, dev: init_kv_cache(cfg, B, n, dev),
        params, prompt, max_new_tokens, temperature, top_p, top_k, key,
        eos_token_id)


# ---------------------------------------------------------------------------
# serving: the Llama serving functions with this model's block
# ---------------------------------------------------------------------------

def serving_prefill(params, tokens, length, table, k_pages, v_pages, cfg,
                    attn_impl: str = "auto"):
    """``llama.serving_prefill`` with the MoE block."""
    return llama.serving_prefill(params, tokens, length, table, k_pages,
                                 v_pages, cfg, attn_impl=attn_impl,
                                 _block_fn=_decode_block)


def serving_prefill_chunk(params, tokens, length, table, k_pages, v_pages,
                          cfg, prefix_pages: int, attn_impl: str = "auto"):
    """``llama.serving_prefill_chunk`` with the MoE block."""
    return llama.serving_prefill_chunk(
        params, tokens, length, table, k_pages, v_pages, cfg, prefix_pages,
        attn_impl=attn_impl, _block_fn=_decode_block)


def serving_decode_step(params, tok, lengths, tables, k_pages, v_pages,
                        cfg, attn_impl: str = "auto"):
    """``llama.serving_decode_step`` with the MoE block."""
    return llama.serving_decode_step(params, tok, lengths, tables, k_pages,
                                     v_pages, cfg, attn_impl=attn_impl,
                                     _block_fn=_decode_block)


def serving_decode_block(params, tok, lengths, tables, k_pages, v_pages,
                         cfg, num_steps: int, attn_impl: str = "auto"):
    """``llama.serving_decode_block`` with the MoE block."""
    return llama.serving_decode_block(
        params, tok, lengths, tables, k_pages, v_pages, cfg, num_steps,
        attn_impl=attn_impl, _block_fn=_decode_block)


def serving_tick(params, tokens, meta, k_pages, v_pages, cfg,
                 decode_tail: int = 0, spec_k: int = 0,
                 attn_impl: str = "auto"):
    """``llama.serving_tick`` (decode tail, speculative verify, in-tick
    sampling) with the MoE block."""
    return llama.serving_tick(params, tokens, meta, k_pages, v_pages, cfg,
                              decode_tail=decode_tail, spec_k=spec_k,
                              attn_impl=attn_impl, _block_fn=_decode_block)


def serving_tick_block(params, tok, lengths, tables, k_pages, v_pages,
                       cfg, num_steps: int, attn_impl: str = "auto",
                       sampling=None):
    """``llama.serving_tick_block`` with the MoE block."""
    return llama.serving_tick_block(
        params, tok, lengths, tables, k_pages, v_pages, cfg, num_steps,
        attn_impl=attn_impl, sampling=sampling, _block_fn=_decode_block)
