"""Post-training weight-only int8 quantization of the decode params.

Port of ``paddle_tpu/quantization/decode.py``.
``quantize_for_decode(params, cfg)`` replaces the projections that
dominate decode's weight stream with ``Int8Weight`` (symmetric int8 and
one f32 scale per (layer[, expert], out channel)):

  llama:     ``wq wk wv wo w_gate w_up w_down``, ``lm_head``
  qwen2_moe: ``wq wk wv wo``, the routed experts' ``w_gate w_up
             w_down`` (``[L, E, D, F]``, scales ``[L, E, F]``), the
             shared expert's ``w_gate w_up w_down``, ``lm_head``

``lm_head`` stays dense with ``quantize_lm_head=False``. Not quantized:
``embed`` (a row lookup, one row per token), the norms (vectors), the
MoE router (kept f32 for a stable top-k softmax; a flipped route is a
larger event than a logit's wobble) and the shared expert's sigmoid
gate (``[D, 1]``).

The quantized params drop into every decode entry point unchanged —
``generate``, ``generate_paged``, the serving steps and
``ServingEngine`` — because the models dispatch each projection through
``llama._mm``, which sends an ``Int8Weight`` to the int8 matmul kernel
(Qwen2-MoE's routed experts are dequantized for its einsum FFN, see
``models/qwen2_moe.py``). Training paths take dense weights only.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..ops.fused.int8_matmul import Int8Weight

__all__ = ["quantize_for_decode", "dequantize_for_decode",
           "is_quantized_params", "decode_weight_bytes"]

_LLAMA_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_QWEN_ATTN_KEYS = ("wq", "wk", "wv", "wo")
_FFN_KEYS = ("w_gate", "w_up", "w_down")


def _quantized(tree: Dict[str, Any], keys) -> Dict[str, Any]:
    """A copy of ``tree`` with ``keys`` quantized."""
    return dict(tree, **{k: Int8Weight.quantize(tree[k]) for k in keys})


def quantize_for_decode(params: Dict[str, Any], cfg, *,
                        quantize_lm_head: bool = True) -> Dict[str, Any]:
    """Llama or Qwen2-MoE params -> a new params dict whose projection
    weights are ``Int8Weight``s, on the params' device (the dense tensors
    it keeps are shared, not copied). The family comes from the config:
    ``num_experts`` present is MoE. Quantizing already-quantized params
    raises: re-quantizing int8 through f32 would silently add error."""
    if is_quantized_params(params):
        raise ValueError("params are already weight-only quantized")
    layers = params["layers"]
    if isinstance(layers, (list, tuple)):
        raise ValueError("quantize_for_decode takes layer-stacked params "
                         "(a dict of [L, ...] tensors)")
    if hasattr(cfg, "num_experts"):
        layers = _quantized(layers, _QWEN_ATTN_KEYS)
        layers["experts"] = _quantized(layers["experts"], _FFN_KEYS)
        layers["shared"] = _quantized(layers["shared"], _FFN_KEYS)
    else:
        layers = _quantized(layers, _LLAMA_LAYER_KEYS)
    out = dict(params, layers=layers)
    if quantize_lm_head:
        out["lm_head"] = Int8Weight.quantize(params["lm_head"])
    return out


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
