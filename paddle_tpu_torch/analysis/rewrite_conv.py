"""The conv-bn fold as a load-time transform of an inference model.

Port of ``paddle_tpu/analysis/rewrite_conv.py`` ``ConvBnFoldPass``
(:118-181). The JAX pass matches ``conv → batch_norm(infer) → relu?`` in a
traced jaxpr and substitutes ``conv_bn_act_nchw`` at every call.
``fold_conv_bn`` matches the same pattern once, in the ``torch.fx`` graph
of an eval-mode model, and replaces each site with a ``ConvBnAct`` module
that holds the folded weight and bias, computed once in f32 exactly as
``conv_bn_act_nchw`` computes them per call (``s = γ·rsqrt(var + eps)``,
``w' = w·s``, ``bias = β − mean·s``; ``w'`` stored in the conv's dtype,
the bias in f32). Its forward is ``conv_bn_act_nchw``'s arithmetic:

* 1x1 / stride-1 / unpadded / ungrouped convs: the epilogue kernel
  (``ops/kernels/conv_epilogue.py`` ``matmul_bias_act``) on the
  activation's ``[B·H·W, C]`` rows, with ``w'`` stored ``[K, N]``;
* the 7x7 / stride-2 / pad-3 stem over 3 channels at an even image size:
  the dense 4x4 conv on the space-to-depth input, with the s2d kernel of
  ``w'`` stored;
* every other conv: ``F.conv2d`` with ``w'``, then the bias and the relu.

Matching rules, as the JAX pass's: the conv (2-D, no bias, zero padding)
feeds only the BN and the BN's channels are the conv's outputs; the relu
is folded when it is the BN's only consumer, else the site folds without
it. In a bottleneck, ``conv3 → bn3`` and each downsample fold with
``relu=False``; the residual add and its relu stay separate ops, as in
the JAX graph. A model in training mode is refused: BN then normalises
with the batch's statistics, which cannot fold into weights (the JAX
pass's structural no-fire on BN-train).

Layout: the folded weights are ``torch.channels_last``, so every conv
returns NHWC memory, pooling, add and relu keep it, and a row-wise
site's ``[B·H·W, C]`` operand is a view of its input. An input that is
not channels-last is converted once and counted in
``ConvBnAct.input_copies`` (zero on ResNet, which the smoke asserts).

``StemSpaceToDepthPass`` and ``ConvNhwcLayoutPass`` fire only on training
graphs in the JAX package and are not ported yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import torch
import torch.fx
import torch.nn.functional as F
from torch import nn

from ..models.resnet import BatchNorm2D
from ..ops.fused import conv_epilogue as _fused
from ..ops.kernels import conv_epilogue as _kernels

__all__ = ["ConvBnAct", "FoldResult", "fold_conv_bn"]

RULE = "conv-bn-fold"


def _padding(conv: nn.Conv2d):
    ph, pw = conv.padding
    return ((ph, ph), (pw, pw))


class ConvBnAct(nn.Module):
    """One folded ``conv → BN → relu?`` site (module docstring). Buffers:
    ``weight`` (``[K, N]`` for a row-wise site, else OIHW, channels-last),
    ``weight_s2d`` (the stem's s2d kernel, OIHW) and the f32 ``bias``."""

    #: row-wise inputs that were not channels-last and had to be copied
    input_copies = 0

    def __init__(self, conv: nn.Conv2d, bn: BatchNorm2D, relu: bool,
                 impl: str = "auto"):
        super().__init__()
        self.strides = tuple(conv.stride)
        self.padding = _padding(conv)
        self.dilation = tuple(conv.dilation)
        self.groups = conv.groups
        self.relu = bool(relu)
        self.impl = impl
        dtype = conv.weight.dtype
        with torch.no_grad():
            wf, bias = _fused.fold_bn(conv.weight, bn.weight, bn.bias,
                                      bn._mean, bn._variance, bn.epsilon)
            hwio = wf.permute(2, 3, 1, 0)
            self.rowwise = _fused._is_rowwise_matmul(
                hwio, self.strides, self.padding, self.dilation,
                self.groups)
            self.stem = _fused._is_stem_shape(
                conv.weight, self.strides, self.padding, self.dilation,
                self.groups, (0, 0))
            if self.rowwise:
                weight = hwio.reshape(hwio.shape[2], hwio.shape[3])
                weight = weight.to(dtype).contiguous()
            else:
                weight = wf.to(dtype).contiguous(
                    memory_format=torch.channels_last)
            self.register_buffer("weight", weight)
            self.register_buffer("bias", bias.contiguous())
            s2d = None
            if self.stem:
                s2d = _fused.space_to_depth_stem_kernel(hwio).permute(
                    3, 2, 0, 1).to(dtype).contiguous(
                    memory_format=torch.channels_last)
            self.register_buffer("weight_s2d", s2d)

    def forward(self, x):
        w = self.weight if self.weight.dtype == x.dtype else \
            self.weight.to(x.dtype)
        if self.rowwise:
            if not x.is_contiguous(memory_format=torch.channels_last):
                x = x.contiguous(memory_format=torch.channels_last)
                ConvBnAct.input_copies += 1
            b, c, h, wd = x.shape
            x2 = x.permute(0, 2, 3, 1).view(b * h * wd, c)
            out = _kernels.matmul_bias_act(x2, w, self.bias, relu=self.relu,
                                           impl=self.impl)
            return out.view(b, h, wd, -1).permute(0, 3, 1, 2)
        if self.stem and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            xt = _fused.space_to_depth_nhwc(x.permute(0, 2, 3, 1))
            out = _fused._conv_nchw(xt.permute(0, 3, 1, 2),
                                    self.weight_s2d.to(x.dtype), (1, 1),
                                    _fused.STEM_S2D_PADDING, (1, 1), 1)
        else:
            out = _fused._conv_nchw(x, w, self.strides, self.padding,
                                    self.dilation, self.groups)
        return _fused._bias_act(out, self.bias, self.relu)


class FoldResult(NamedTuple):
    module: torch.fx.GraphModule
    fired: Dict[str, int]


class _Tracer(torch.fx.Tracer):
    def is_leaf_module(self, m: nn.Module, qualname: str) -> bool:
        return isinstance(m, (BatchNorm2D, ConvBnAct)) or \
            super().is_leaf_module(m, qualname)


def _is_relu(node: torch.fx.Node, modules) -> bool:
    if node.op == "call_module":
        return isinstance(modules.get(node.target), nn.ReLU)
    return (node.op == "call_function"
            and node.target in (F.relu, torch.relu)
            and not node.kwargs.get("inplace", False))


def _foldable(conv, bn) -> bool:
    return (isinstance(conv, nn.Conv2d) and isinstance(bn, BatchNorm2D)
            and conv.bias is None and conv.padding_mode == "zeros"
            and not isinstance(conv.padding, str)
            and bn.num_features == conv.out_channels)


def fold_conv_bn(model: nn.Module, *, impl: str = "auto") -> FoldResult:
    """Fold every ``conv → BatchNorm2D → relu?`` of an eval-mode model
    (module docstring). Returns the folded ``GraphModule`` (it shares the
    unfolded modules it still calls with ``model``, which is left as it
    was) and ``{"conv-bn-fold": sites}``. ``impl`` goes to every row-wise
    site's ``matmul_bias_act``. Fold after any ``.to(dtype)``: the folded
    weights take the conv's dtype, the bias stays f32."""
    if model.training or any(m.training for m in model.modules()
                             if isinstance(m, BatchNorm2D)):
        raise ValueError(
            "fold_conv_bn takes an eval-mode model: in training BN "
            "normalises with the batch's statistics, which cannot be "
            "folded into the conv weights; call model.eval() first")
    graph = _Tracer().trace(model)
    gm = torch.fx.GraphModule(model, graph)
    modules = dict(gm.named_modules())
    calls: Dict[str, int] = {}
    for node in graph.nodes:
        if node.op == "call_module":
            calls[node.target] = calls.get(node.target, 0) + 1
    fired = 0
    for node in list(graph.nodes):
        if node.op != "call_module" or len(node.users) != 1:
            continue
        bn_node = next(iter(node.users))
        conv, bn = modules.get(node.target), modules.get(bn_node.target)
        if bn_node.op != "call_module" or bn_node.args[:1] != (node,) or \
                calls[node.target] != 1 or not _foldable(conv, bn):
            continue
        relu_node = None
        if len(bn_node.users) == 1:
            user = next(iter(bn_node.users))
            if _is_relu(user, modules) and user.args[:1] == (bn_node,):
                relu_node = user
        gm.add_submodule(node.target, ConvBnAct(conv, bn, relu_node
                                                is not None, impl))
        last = relu_node or bn_node
        last.replace_all_uses_with(node)
        if relu_node is not None:
            graph.erase_node(relu_node)
        graph.erase_node(bn_node)
        fired += 1
    graph.lint()
    gm.recompile()
    gm.delete_all_unused_submodules()
    gm.eval()
    return FoldResult(gm, {RULE: fired})
