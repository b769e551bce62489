"""Fused softmax cross-entropy that saves no log-probabilities.

Port of ``paddle_tpu/ops/fused/cross_entropy.py``
``fused_softmax_cross_entropy`` (plain torch ops; the JAX op is no Pallas
kernel). The forward reduces the logits to f32 ``[...]`` statistics; the
only residuals are the logits in their own dtype and the f32 lse, and
the backward recomputes ``softmax(logits) - onehot(labels)`` from them.
"""
from __future__ import annotations

import torch

__all__ = ["fused_softmax_cross_entropy"]


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, ignore_index):
        safe = labels.clamp(min=0).long()
        lf = logits.float()
        m = lf.amax(-1, keepdim=True)
        lse = torch.log(torch.exp(lf - m).sum(-1)) + m[..., 0]
        label_logit = lf.gather(-1, safe[..., None])[..., 0]
        del lf
        nll = torch.where(labels == ignore_index, 0.0, lse - label_logit)
        ctx.save_for_backward(logits, labels, lse)
        ctx.ignore_index = ignore_index
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        g = torch.where(labels != ctx.ignore_index, g, 0.0).float()
        # p - onehot, scaled by the cotangent, built in place on one f32
        # [..., V] buffer
        grad = logits.float().sub_(lse[..., None]).exp_()
        grad.scatter_add_(-1, labels.clamp(min=0).long()[..., None],
                          torch.full(labels.shape + (1,), -1.0,
                                     device=grad.device))
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None, None


def fused_softmax_cross_entropy(logits, labels, ignore_index: int = -100):
    """Per-token NLL ``logsumexp(logits) - logits[labels]`` in f32.

    logits: ``[..., V]`` any float dtype; labels: int ``[...]``. Where
    ``labels == ignore_index`` the loss and the gradient are 0."""
    return _FusedCE.apply(logits, labels, ignore_index)
