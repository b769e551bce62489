"""Fused softmax cross-entropy that saves no log-probabilities.

Port of ``paddle_tpu/ops/fused/cross_entropy.py``
``fused_softmax_cross_entropy`` (plain torch ops; the JAX op is no Pallas
kernel). The forward reduces the logits to f32 ``[...]`` statistics; the
only residuals are the logits in their own dtype and the f32 lse, and
the backward recomputes ``softmax(logits) - onehot(labels)`` from them.

``vocab_parallel_cross_entropy`` is the same function over logits whose
classes are sharded over a tensor-parallel group (the reference's
``_c_softmax_with_cross_entropy``, mp_ops.py:414): three ``[...]``
all-reduces (max, sum-exp, label logit) and no gather of the logits;
its backward is the JAX closed form ``softmax_local - onehot_local``
from the saved global lse, local math with no collective.
"""
from __future__ import annotations

import torch

__all__ = ["fused_softmax_cross_entropy", "vocab_parallel_cross_entropy"]


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


class _VocabParallelCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, vocab_start, g):
        from ...distributed import communication as C

        def reduce_(t, op):
            if g is not None and g.nranks > 1:
                C.all_reduce(t, op, g)

        lf = logits.float()
        m = lf.amax(-1)
        reduce_(m, C.ReduceOp.MAX)
        s = torch.exp(lf - m[..., None]).sum(-1)
        reduce_(s, C.ReduceOp.SUM)
        lse = torch.log(s) + m
        local = labels.long() - vocab_start
        inside = (local >= 0) & (local < logits.shape[-1])
        label_logit = torch.where(
            inside, lf.gather(-1, local.clamp(0, logits.shape[-1] - 1)
                              [..., None])[..., 0], 0.0)
        del lf
        reduce_(label_logit, C.ReduceOp.SUM)
        ctx.save_for_backward(logits, local, inside, lse)
        return lse - label_logit

    @staticmethod
    def backward(ctx, g):
        logits, local, inside, lse = ctx.saved_tensors
        grad = logits.float().sub_(lse[..., None]).exp_()
        rows = torch.where(inside, -1.0, 0.0)[..., None]
        grad.scatter_add_(-1, local.clamp(0, logits.shape[-1] - 1)[..., None],
                          rows)
        grad.mul_(g.float()[..., None])
        return grad.to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, labels, group="tp",
                                 vocab_start=None):
    """Per-token NLL, f32 ``[...]``, of logits ``[..., V/tp]`` holding
    this rank's classes ``[vocab_start, vocab_start + V/tp)`` (default
    ``rank · V/tp``) against global label ids ``[...]``, the other
    classes on the other ranks of ``group`` (a ``Group`` or a mesh axis
    name; one rank: the plain fused cross entropy's value)."""
    from ...parallel.mp_ops import axis_group
    g = axis_group(group)
    if vocab_start is None:
        vocab_start = (0 if g is None else g.rank) * logits.shape[-1]
    return _VocabParallelCE.apply(logits, labels, int(vocab_start), g)
