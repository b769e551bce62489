"""Post-training weight-only int8 quantization of the Llama decode params.

Port of ``paddle_tpu/quantization/decode.py`` for the Llama family
(the MoE branch comes with the Qwen2-MoE slice).
``quantize_for_decode(params, cfg)`` replaces the projections that
dominate decode's weight stream with ``Int8Weight`` (symmetric int8 and
one f32 scale per (layer, out channel)): ``wq wk wv wo w_gate w_up
w_down`` and ``lm_head``. Not quantized: ``embed`` (a row lookup, one
row per token) and the norms (vectors).

The quantized params drop into every decode entry point unchanged —
``generate``, ``generate_paged``, the serving steps and
``ServingEngine`` — because the model dispatches each projection
through ``llama._mm``, which sends an ``Int8Weight`` to the int8 matmul
kernel. Training paths take dense weights only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.fused.int8_matmul import Int8Weight

__all__ = ["quantize_for_decode", "dequantize_for_decode",
           "is_quantized_params", "decode_weight_bytes"]

_LLAMA_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def quantize_for_decode(params: Dict[str, Any], cfg) -> Dict[str, Any]:
    """Llama params -> a new params dict whose projection weights are
    ``Int8Weight``s, on the params' device (the dense tensors it keeps
    are shared, not copied). Quantizing already-quantized params raises:
    re-quantizing int8 through f32 would silently add error. ``cfg`` is
    taken for the JAX signature; a config with experts raises."""
    if hasattr(cfg, "num_experts"):
        raise NotImplementedError("MoE quantization comes with the "
                                  "Qwen2-MoE slice of the port")
    if is_quantized_params(params):
        raise ValueError("params are already weight-only quantized")
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        raise ValueError("quantize_for_decode takes layer-stacked params "
                         "(a dict of [L, ...] tensors)")
    layers = dict(layers)
    for k in _LLAMA_LAYER_KEYS:
        layers[k] = Int8Weight.quantize(layers[k])
    return dict(params, layers=layers,
                lm_head=Int8Weight.quantize(params["lm_head"]))


def dequantize_for_decode(params: Dict[str, Any],
                          dtype=torch.bfloat16) -> Dict[str, Any]:
    """Every ``Int8Weight`` becomes its dense ``dtype`` approximation
    (for numerics comparisons, not a bit-exact undo)."""
    def walk(node):
        if isinstance(node, Int8Weight):
            return node.dequant(dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def is_quantized_params(params) -> bool:
    if isinstance(params, Int8Weight):
        return True
    if isinstance(params, dict):
        return any(is_quantized_params(v) for v in params.values())
    return False


def decode_weight_bytes(params) -> int:
    """Device bytes one decode step streams for weights: every leaf's
    size (int8 q plus f32 scales for quantized weights), except the
    embedding table, of which one row per token is read."""
    def leaf_bytes(node) -> int:
        if isinstance(node, Int8Weight):
            return node.q.numel() + node.scale.numel() * 4
        if isinstance(node, dict):
            return sum(leaf_bytes(v) for v in node.values())
        if isinstance(node, torch.Tensor):
            return node.numel() * node.element_size()
        return 0

    total = sum(leaf_bytes(v) for k, v in params.items() if k != "embed")
    emb = params.get("embed")
    if emb is not None:
        total += emb.shape[-1] * emb.element_size()
    return total
