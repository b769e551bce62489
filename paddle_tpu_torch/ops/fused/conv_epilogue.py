"""Conv + folded-BN + activation: the replacement surface of the conv-bn
fold (``analysis/rewrite_conv.py``).

Port of ``paddle_tpu/ops/fused/conv_epilogue.py``. The functions take the
JAX package's layouts and arguments, so the tests compare like with like:

* ``conv_bias_act`` — NHWC ``x``, HWIO ``w``, f32 ``bias``: a 1x1,
  stride-1, unpadded, undilated, ungrouped conv is a matmul over the
  ``B·H·W`` pixel rows and goes to the epilogue kernel
  (``ops/kernels/conv_epilogue.py`` ``matmul_bias_act``); every other conv
  is ``torch.nn.functional.conv2d`` (cuDNN on the card, as the JAX package
  leaves it to ``lax.conv_general_dilated``) plus the bias in the conv
  output's dtype and the relu, in that order;
* ``space_to_depth_nhwc``, ``space_to_depth_stem_kernel`` and
  ``stem_s2d_conv_nchw`` — the 7x7 / stride-2 stem as a dense 4x4 /
  stride-1 conv over the 2x2 phases stacked into channels;
* ``conv_bn_act_nchw`` — inference ``relu?(batch_norm(conv(x, w)))`` with
  the BN folded into the conv in f32 (``s = γ·rsqrt(var + eps)``,
  ``w' = w·s``, ``bias = β − mean·s``), NCHW in and out.

The JAX package's ``PADDLE_TPU_CONV_EPILOGUE_IMPL`` / ``fused_impl()``
switch is the ``impl`` argument here, with the port's meaning: ``"auto"``
— the kernel for CUDA tensors, its plain version for CPU tensors;
``"kernel"`` — the kernel or an error; ``"reference"`` — the plain
version. It applies to the row-wise convs only. ``decode_precision`` has
no counterpart: PyTorch has no per-conv precision request (f32 convs on
the card are exact only with ``torch.backends.cudnn.allow_tf32 = False``).

NCHW tensors that are ``torch.channels_last`` in memory are NHWC tensors
without a copy: ``conv_bn_act_nchw``'s transposes are then views, and a
row-wise conv's ``[B·H·W, C]`` operand is the activation itself.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import conv_epilogue as _kernels

__all__ = ["conv_bias_act", "conv_bn_act_nchw", "space_to_depth_nhwc",
           "space_to_depth_stem_kernel", "stem_s2d_conv_nchw",
           "fold_bn"]


def _is_rowwise_matmul(w_hwio, strides, padding, dilation, groups) -> bool:
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    return (kh == 1 and kw == 1 and tuple(strides) == (1, 1)
            and all(tuple(p) == (0, 0) for p in padding)
            and tuple(dilation) == (1, 1) and groups == 1)


def _conv_nchw(x, w_oihw, strides, padding, dilation, groups):
    """``F.conv2d`` with the JAX package's ``((lo, hi), (lo, hi))``
    padding: symmetric padding goes to the conv, asymmetric padding is
    applied first with zeros."""
    (ht, hb), (wl, wr) = padding
    if ht == hb and wl == wr:
        pad = (ht, wl)
    else:
        x = F.pad(x, (wl, wr, ht, hb))
        pad = (0, 0)
    return F.conv2d(x, w_oihw, stride=tuple(strides), padding=pad,
                    dilation=tuple(dilation), groups=groups)


def _bias_act(out, bias, relu: bool):
    out = out.add_(bias.to(out.dtype).view(1, -1, 1, 1))
    return out.relu_() if relu else out


def conv_bias_act(x, w, bias, *, strides=(1, 1),
                  padding=((0, 0), (0, 0)), dilation=(1, 1), groups=1,
                  relu=True, impl="auto"):
    """NHWC conv + bias + optional relu. ``x`` [B, H, W, Cin], ``w``
    [kh, kw, Cin / groups, Cout] (HWIO), ``bias`` [Cout]; returns NHWC in
    x's dtype. Row-wise convs go through ``matmul_bias_act`` (module
    docstring), the rest through ``F.conv2d`` + bias + relu."""
    if _is_rowwise_matmul(w, strides, padding, dilation, groups):
        b, h, wd, cin = x.shape
        cout = w.shape[-1]
        out = _kernels.matmul_bias_act(
            x.reshape(b * h * wd, cin),
            w.reshape(cin, cout).to(x.dtype), bias.to(torch.float32),
            relu=relu, impl=impl)
        return out.view(b, h, wd, cout)
    out = _conv_nchw(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(x.dtype),
                     strides, padding, dilation, groups)
    return _bias_act(out, bias, relu).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# space-to-depth stem (7x7/stride-2 -> dense 4x4/stride-1 at 4x channels)
# ---------------------------------------------------------------------------

#: the s2d stem conv's padding ((top, bottom), (left, right))
STEM_S2D_PADDING = ((2, 1), (2, 1))


def space_to_depth_nhwc(x):
    """[B, H, W, C] -> [B, H/2, W/2, 4C]: each output pixel stacks its
    2x2 input phase block into channels (channel order (h2, w2, c))."""
    b, h, w, c = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, c)
    return xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)


def space_to_depth_stem_kernel(w_hwio):
    """[7, 7, Cin, Cout] HWIO -> the [4, 4, 4Cin, Cout] kernel that,
    applied stride-1 with padding ((2, 1), (2, 1)) to the space-to-depth
    input, computes the 7x7 / stride-2 / pad-3 conv: the taps padded to
    8x8 with one leading zero row and column, each spatial axis split
    into (block, phase), the phases folded into the input channels in the
    data's (h2, w2, c) order."""
    kh, kw, cin, cout = w_hwio.shape
    if (kh, kw) != (7, 7):
        raise ValueError(f"the s2d stem kernel takes 7x7 taps, got "
                         f"{(kh, kw)}")
    wp = F.pad(w_hwio, (0, 0, 0, 0, 1, 0, 1, 0))
    wp = wp.reshape(4, 2, 4, 2, cin, cout)
    return wp.permute(0, 2, 1, 3, 4, 5).reshape(4, 4, 4 * cin, cout)


def stem_s2d_conv_nchw(x, w_oihw):
    """The stem substitution on NCHW tensors: space-to-depth both
    operands, run the dense 4x4 / stride-1 conv, back to NCHW (a view
    of NHWC memory). The same taps in another association."""
    xt = space_to_depth_nhwc(x.permute(0, 2, 3, 1))
    ws = space_to_depth_stem_kernel(w_oihw.permute(2, 3, 1, 0))
    return _conv_nchw(xt.permute(0, 3, 1, 2),
                      ws.permute(3, 2, 0, 1).to(xt.dtype), (1, 1),
                      STEM_S2D_PADDING, (1, 1), 1)


def _is_stem_shape(w_oihw, strides, padding, dilation, groups,
                   hw) -> bool:
    return (w_oihw.shape[1] == 3 and tuple(w_oihw.shape[2:]) == (7, 7)
            and tuple(strides) == (2, 2)
            and tuple(map(tuple, padding)) == ((3, 3), (3, 3))
            and tuple(dilation) == (1, 1) and groups == 1
            and hw[0] % 2 == 0 and hw[1] % 2 == 0)


def fold_bn(w, gamma, beta, mean, var, eps: float):
    """The BN fold in f32: ``s = γ·rsqrt(var + eps)``; returns
    (``w·s`` f32 OIHW, ``β − mean·s`` f32 [C])."""
    s = gamma.float() * torch.rsqrt(var.float() + eps)
    bias = beta.float() - mean.float() * s
    return w.float() * s[:, None, None, None], bias


def conv_bn_act_nchw(x, w, gamma, beta, mean, var, *, eps,
                     strides=(1, 1), padding=((0, 0), (0, 0)),
                     dilation=(1, 1), groups=1, relu=True, impl="auto"):
    """Inference ``relu?(batch_norm(conv(x, w)))`` with the BN folded into
    the conv, NCHW in and out (NHWC inside: views when x is channels-last
    in memory). ``w`` is OIHW; the BN statistics and affine are [C].
    Stem-shaped convs take the space-to-depth form."""
    wf, bias = fold_bn(w, gamma, beta, mean, var, eps)
    xt = x.permute(0, 2, 3, 1)
    if _is_stem_shape(w, strides, padding, dilation, groups, x.shape[2:]):
        out = conv_bias_act(space_to_depth_nhwc(xt),
                            space_to_depth_stem_kernel(wf.permute(2, 3, 1, 0)),
                            bias, padding=STEM_S2D_PADDING, relu=relu,
                            impl=impl)
    else:
        out = conv_bias_act(xt, wf.permute(2, 3, 1, 0), bias,
                            strides=strides, padding=padding,
                            dilation=dilation, groups=groups, relu=relu,
                            impl=impl)
    return out.permute(0, 3, 1, 2).to(x.dtype)
