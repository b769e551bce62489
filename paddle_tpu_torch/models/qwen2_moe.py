"""Qwen2-MoE decoder: the training slice of the PyTorch port.

Port of ``paddle_tpu/models/qwen2_moe.py``: ``Qwen2MoeConfig`` (the
defaults are Qwen1.5-MoE-A2.7B's published widths; ``tiny`` for tests),
``init_params`` (seeded ``torch.Generator``; the router in f32),
``decoder_layer`` (Llama attention, then a routed MoE FFN plus a gated
shared expert), ``forward``, ``loss_fn`` and ``make_train_step`` on one
device, and ``make_batch`` / ``params_from_jax`` (the Llama ones).

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
JAX package falls back to einsum only on sharded layouts). The decode and
serving half of the JAX module is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..incubate.moe.functional import moe_ffn, moe_ffn_dropless
from ..ops.kernels.flash_attention import flash_attention
from . import llama
from .llama import _kernel_impl, _layer, rms_norm, rope

__all__ = ["Qwen2MoeConfig", "init_params", "params_from_jax",
           "decoder_layer", "forward", "loss_fn", "make_train_step",
           "make_batch"]

params_from_jax = llama.params_from_jax
make_batch = llama.make_batch


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
        raise NotImplementedError("the port's Qwen2-MoE runs on one device: "
                                  "mesh layouts are not ported yet")
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
    ``router_aux_loss_coef`` times the summed aux loss."""
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
            "the port's train step runs on one device: mesh layouts "
            "(expert, tensor and data parallel) are not ported yet")
    return llama.one_device_trainer(cfg, init_params, loss_fn, device,
                                    optimizer)
