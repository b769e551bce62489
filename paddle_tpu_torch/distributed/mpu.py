"""Tensor-parallel layers (Megatron's ``mpu``).

Port of ``paddle_tpu/distributed/mpu.py`` (reference:
``fleet/layers/mpu/mp_layers.py``). The JAX layers hold the whole weight
sharded over the mesh's tp axis and let GSPMD insert the collectives;
the port's ``nn.Module``s hold this rank's shard and call the f / g
pair of ``parallel.mp_ops`` themselves:

* ``VocabParallelEmbedding``: rows ``[r·V/tp, (r+1)·V/tp)`` of the
  table; ids outside the range look up zeros, and the partial rows are
  all-reduced ("g");
* ``ColumnParallelLinear``: columns of ``W [in, out]`` and the bias;
  the input passes "f"; ``gather_output`` all-gathers the output's last
  dim (its backward takes this rank's part);
* ``RowParallelLinear``: rows of ``W``; an input that is not already
  split (``input_is_parallel=False``) is split first; the partial
  products are all-reduced ("g"), then the whole bias is added;
* ``ParallelCrossEntropy``: per-token softmax cross entropy over logits
  whose classes are sharded over tp (``ops.fused.
  vocab_parallel_cross_entropy``: three ``[...]`` all-reduces, no
  gather of the logits);
* ``split``: this rank's part of ``x`` along ``axis`` (``c_split``).

The tp group is ``mp_group`` when given, else this rank's tp line of the
global hybrid mesh (one rank when there is none). Weights are made on
``device`` (the card unless given), in Paddle's ``[in, out]`` layout.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import resolve_device
from ..parallel.mp_ops import (axis_group, gather_fwd_split_bwd,
                               identity_fwd_psum_bwd, psum_fwd_identity_bwd,
                               split_fwd_gather_bwd)

__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "ParallelCrossEntropy", "split"]


def _tp(mp_group):
    g = axis_group("tp") if mp_group is None else mp_group
    if g is None:
        return None, 1, 0
    return g, g.nranks, g.rank


def _divides(n: int, tp: int, what: str) -> int:
    if n % tp:
        raise ValueError(f"{what} {n} not divisible by tp degree {tp}")
    return n // tp


def _xavier(shape, fan_in, fan_out, device, dtype, generator):
    std = math.sqrt(2.0 / (fan_in + fan_out))
    w = torch.empty(shape, device=device, dtype=torch.float32)
    w.normal_(0.0, std, generator=generator)
    return nn.Parameter(w.to(dtype))


class VocabParallelEmbedding(nn.Module):
    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, mp_group=None, name=None, *,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.group, tp, rank = _tp(mp_group)
        self.num_embeddings, self.embedding_dim = num_embeddings, \
            embedding_dim
        self.per_rank = _divides(num_embeddings, tp, "num_embeddings")
        self.vocab_start = rank * self.per_rank
        dev = resolve_device(device)
        w = torch.empty((self.per_rank, embedding_dim), device=dev,
                        dtype=torch.float32)
        self.weight = nn.Parameter(
            w.normal_(0.0, 1.0, generator=generator).to(dtype))

    def forward(self, x):
        ids = x.long() - self.vocab_start
        inside = (ids >= 0) & (ids < self.per_rank)
        out = F.embedding(ids.clamp(0, self.per_rank - 1), self.weight)
        out = out * inside[..., None].to(out.dtype)
        return psum_fwd_identity_bwd(out, self.group)


class ColumnParallelLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = True, fuse_matmul_bias: bool = False,
                 mp_group=None, name=None, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.group, tp, _ = _tp(mp_group)
        self.gather_output = gather_output
        per = _divides(out_features, tp, "out_features")
        dev = resolve_device(device)
        self.weight = _xavier((in_features, per), in_features,
                              out_features, dev, dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(per, device=dev, dtype=dtype))
                     if has_bias else None)

    def _local(self, x):
        y = x @ self.weight
        return y if self.bias is None else y + self.bias

    def forward(self, x):
        y = self._local(identity_fwd_psum_bwd(x, self.group))
        if self.gather_output:
            y = gather_fwd_split_bwd(y, y.dim() - 1, self.group)
        return y


class RowParallelLinear(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = False,
                 fuse_matmul_bias: bool = False, mp_group=None, name=None,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.group, tp, _ = _tp(mp_group)
        self.input_is_parallel = input_is_parallel
        per = _divides(in_features, tp, "in_features")
        dev = resolve_device(device)
        self.weight = _xavier((per, out_features), in_features,
                              out_features, dev, dtype, generator)
        self.bias = (nn.Parameter(torch.zeros(out_features, device=dev,
                                              dtype=dtype))
                     if has_bias else None)

    def forward(self, x):
        if not self.input_is_parallel:
            x = split_fwd_gather_bwd(x, x.dim() - 1, self.group)
        y = psum_fwd_identity_bwd(x @ self.weight, self.group)
        return y if self.bias is None else y + self.bias


class ParallelCrossEntropy(nn.Module):
    """Per-token NLL of logits ``[..., V/tp]`` (this rank's classes,
    from ``r·V/tp``) against global labels ``[...]``; 0 where
    ``label == ignore_index``."""

    def __init__(self, mp_group=None, name=None, ignore_index: int = -100):
        super().__init__()
        self.group = mp_group
        self.ignore_index = ignore_index

    def forward(self, input, label):
        from ..ops.fused.cross_entropy import vocab_parallel_cross_entropy
        g, _, rank = _tp(self.group)
        keep = label != self.ignore_index
        nll = vocab_parallel_cross_entropy(
            input, torch.where(keep, label, 0), g,
            vocab_start=rank * input.shape[-1])
        return torch.where(keep, nll, 0.0)


def split(x: torch.Tensor, axis: int = 0, group=None) -> torch.Tensor:
    """This rank's equal part of ``x`` along ``axis`` (``mp_ops.c_split``);
    the backward all-gathers."""
    return split_fwd_gather_bwd(x, axis, "tp" if group is None else group)
