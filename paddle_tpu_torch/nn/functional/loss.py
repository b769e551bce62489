"""``cross_entropy`` over class logits: ``paddle_tpu/nn/functional/loss.py``
(:20-55) for hard integer labels; and ``mse_loss`` (:105).

It is the JAX package's fused path: the per-row NLL ``logsumexp(logits)
− logits[label]`` of ``ops.fused``'s ``fused_softmax_cross_entropy``
(f32 statistics, the closed-form backward), cast to the logits' dtype;
``reduction="mean"`` sums it in f32 over the rows whose label is not
``ignore_index`` and divides by their count (at least 1). Under
``auto_cast`` the op is on the black list: its input runs in f32.

Soft labels, class weights, label smoothing and ``use_softmax=False``
are not on the vision step's path and are not ported.
"""
from __future__ import annotations

import torch

from ...amp import amp_cast
from ...ops.fused import fused_softmax_cross_entropy

__all__ = ["cross_entropy", "mse_loss"]


def cross_entropy(input, label, weight=None, ignore_index: int = -100,
                  reduction: str = "mean", soft_label: bool = False,
                  axis: int = -1, use_softmax: bool = True,
                  label_smoothing: float = 0.0):
    """Paddle's ``cross_entropy`` (module docstring): ``input`` ``[...,
    C]`` logits (class axis ``axis``), ``label`` int ``[...]`` or
    ``[..., 1]``."""
    if soft_label or weight is not None or label_smoothing or \
            not use_softmax:
        raise NotImplementedError(
            "cross_entropy: soft labels, class weights, label smoothing "
            "and use_softmax=False are not ported")
    (logits,) = amp_cast("cross_entropy", input)
    if axis not in (-1, logits.dim() - 1):
        logits = logits.movedim(axis, -1)
    lbl = label
    if lbl.dim() == logits.dim():
        lbl = lbl.squeeze(-1)
    lbl = lbl.long()
    valid = lbl != ignore_index
    # the fused op masks the rows labelled -1 (its own ignore index), so
    # any ignore_index works, in the class range or not
    loss = fused_softmax_cross_entropy(
        logits, torch.where(valid, lbl, -1), ignore_index=-1).to(
        logits.dtype)
    if reduction == "mean":
        denom = valid.float().sum().clamp_min(1.0)
        return (loss.float().sum() / denom).to(logits.dtype)
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label, reduction: str = "mean"):
    """``(input − label)²``, its mean, sum or itself (``reduction``):
    ``paddle_tpu/nn/functional/loss.py`` ``mse_loss`` (:105)."""
    loss = torch.square(input - label)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss
