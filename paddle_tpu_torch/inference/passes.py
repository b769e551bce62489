"""Inference-time parameter folds on a module, in place.

Port of ``paddle_tpu/inference/passes.py``: ``fold_batch_norms`` (:108),
``remove_dropouts`` (:154) and ``fuse_linear_chains`` (:172), the
counterparts of the reference's ``conv_bn_fuse_pass``,
``delete_dropout_op_pass`` and ``fc_fuse_pass``.

``fold_batch_norms(model, input_spec)`` folds an eval-mode BatchNorm
into the Conv or Linear that feeds it:

    w' = w * gamma / sqrt(var + eps)        (per out-channel)
    b' = (b - mean) * gamma / sqrt(var + eps) + beta

computed in f64 and rounded once to the layer's dtype, as the JAX pass
does. The pairing is checked on the dataflow, not guessed from
attribute order: a trace of one forward (``core.graph_trace``) records
which module produced each tensor and how many times it is consumed; a
BatchNorm folds only when its input is a Conv or Linear output consumed
by nothing else (the model's outputs count), and both modules run once.
The folded BatchNorm becomes an ``nn.Identity``, so container indices
keep working.

The passes take the port's layers (``models/_layers.py``: ``Conv2D``,
``Linear`` with its weight ``[in, out]``, ``BatchNorm2D`` with
``_mean`` / ``_variance`` / ``epsilon``, ``Dropout``) and torch's own
``nn.Conv{1,2,3}d``, ``nn.Linear`` (weight ``[out, in]``),
``nn.BatchNorm{1,2,3}d`` (with running statistics) and dropouts.

When to use which fold: ``analysis.fold_conv_bn`` is the load-time
rewrite for serving a vision model on the card. It matches ``conv → BN
→ relu?`` in the ``torch.fx`` graph and replaces each site with a
``ConvBnAct`` that sends 1x1 convs to the conv-epilogue kernel and the
stem to its space-to-depth route. ``fold_batch_norms`` is the
parameter-level fold of the deployment passes: any Conv or Linear
followed by a BN, convs with a bias too, the modules kept as they are
(a conv stays ``F.conv2d`` with a bias), so it never routes a site to a
kernel. Use it on models the rewrite does not match, or to strip BNs
from a model before ``jit.save`` when no kernel route is wanted.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from ..models import _layers

__all__ = ["fold_batch_norms", "remove_dropouts", "fuse_linear_chains"]

_LINEARS = (_layers.Linear, nn.Linear)
_CONVS = (nn.Conv1d, nn.Conv2d, nn.Conv3d)
_BNS = (_layers.BatchNorm2D, nn.BatchNorm1d, nn.BatchNorm2d,
        nn.BatchNorm3d)
_DROPOUTS = (_layers.Dropout, nn.Dropout, nn.Dropout1d, nn.Dropout2d,
             nn.Dropout3d, nn.AlphaDropout, nn.FeatureAlphaDropout)


def _f64(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float64).numpy()


def _bn_stats(bn):
    """(mean, var, eps) of a BatchNorm, or None when it keeps no running
    statistics (it then normalises with the batch's, even in eval)."""
    if isinstance(bn, _layers.BatchNorm2D):
        return bn._mean, bn._variance, bn.epsilon
    if bn.running_mean is None:
        return None
    return bn.running_mean, bn.running_var, bn.eps


def _bn_affine(bn) -> Tuple[np.ndarray, np.ndarray]:
    """Per-channel (scale, shift): y = x*scale + shift in eval mode."""
    mean, var, eps = _bn_stats(bn)
    mean, var = _f64(mean), _f64(var)
    gamma = _f64(bn.weight) if bn.weight is not None else np.ones_like(mean)
    beta = _f64(bn.bias) if bn.bias is not None else np.zeros_like(mean)
    inv = gamma / np.sqrt(var + eps)
    return inv, beta - mean * inv


def _io_weight(lin) -> np.ndarray:
    """A Linear's weight as ``[in, out]`` in f64."""
    w = _f64(lin.weight)
    return w if isinstance(lin, _layers.Linear) else w.T


@torch.no_grad()
def _set(param_owner, name: str, value: np.ndarray, like) -> None:
    """Set ``param_owner.<name>`` to ``value``, rounded once to ``like``'s
    dtype on its device: in place when the shape is kept, else as a new
    parameter."""
    t = torch.from_numpy(np.array(value)).to(
        device=like.device, dtype=like.dtype)
    old = getattr(param_owner, name)
    if old is not None and old.shape == t.shape:
        old.copy_(t)
    else:
        setattr(param_owner, name, nn.Parameter(
            t, requires_grad=old is None or old.requires_grad))


def _fold_into(prev, bn) -> bool:
    """Fold ``bn`` into ``prev`` (Conv / Linear); True on success."""
    if _bn_stats(bn) is None:
        return False
    scale, shift = _bn_affine(bn)
    if isinstance(prev, _LINEARS):
        w = _io_weight(prev)                 # [in, out] x per-out scale
        if w.shape[1] != scale.shape[0]:
            return False
        w_new = w * scale[None, :]
        if not isinstance(prev, _layers.Linear):
            w_new = w_new.T
    elif isinstance(prev, _CONVS):
        w = _f64(prev.weight)
        if w.shape[0] != scale.shape[0] or prev.transposed:
            return False
        w_new = w * scale.reshape((-1,) + (1,) * (w.ndim - 1))
    else:
        return False
    b_old = _f64(prev.bias) if prev.bias is not None else 0.0
    b_new = np.broadcast_to(b_old * scale + shift, scale.shape)
    _set(prev, "weight", w_new, prev.weight)
    _set(prev, "bias", b_new, prev.weight)
    return True


def _trace_and_maps(model, input_spec):
    """Shared pass plumbing: normalise the input spec, run the tracing
    forward, and build the dataflow maps every rewrite pass needs.
    Returns (trace, layer_events, produced_by, parent_of)."""
    from ..core.graph_trace import trace_layer_graph
    spec = input_spec
    if isinstance(spec, (list, tuple)) and len(spec) and (
            hasattr(spec[0], "shape") or isinstance(spec[0], (list, tuple))):
        spec = spec[0]  # [InputSpec(...)] or [(1, 3, H, W)] wrapper
    shape = [1 if (d is None or (isinstance(d, int) and d < 0)) else int(d)
             for d in (spec.shape if hasattr(spec, "shape") else spec)]
    like = next((p for p in model.parameters() if p.is_floating_point()),
                None)
    x = torch.zeros(shape, dtype=like.dtype if like is not None
                    else torch.float32,
                    device=like.device if like is not None else "cpu")
    tr = trace_layer_graph(model, x)
    layer_events = []
    for ev in tr.events:
        if ev[0] != "layer":
            continue
        _, mod, inputs, output = ev
        src = inputs[0] if isinstance(inputs, tuple) and inputs else inputs
        layer_events.append((mod, id(src), id(output)))
    produced_by = {out_id: mod for mod, _, out_id in layer_events}
    # parent map so a rewritten module can be replaced in its container
    parent_of = {}
    for container in model.modules():
        for name, sub in container._modules.items():
            if sub is not None:
                parent_of[id(sub)] = (container, name)
    return tr, layer_events, produced_by, parent_of


def fold_batch_norms(model: nn.Module, input_spec) -> int:
    """Fold eval-mode BatchNorms into their dataflow-preceding Conv /
    Linear modules (module docstring); returns the number folded.

    input_spec: one ``jit.InputSpec`` (or plain shape list) for the
    tracing forward; dims that are None/-1 trace as 1."""
    if model.training:
        raise ValueError(
            "fold_batch_norms needs eval mode (model.eval()): folding "
            "bakes the running statistics into the weights")
    tr, layer_events, produced_by, parent_of = _trace_and_maps(
        model, input_spec)
    folded = 0
    done = set()
    for mod, in_id, _ in layer_events:
        if not isinstance(mod, _BNS) or id(mod) in done:
            continue
        prev = produced_by.get(in_id)
        if prev is None or not isinstance(prev, _LINEARS + _CONVS):
            continue
        # each module must run exactly once in the trace: a reused conv
        # feeds other call sites (folding would corrupt them), a reused
        # bn would be folded into the conv twice (scale squared)
        if tr.layer_calls.get(id(prev)) != 1 or \
                tr.layer_calls.get(id(mod)) != 1:
            continue
        if tr.consumers.get(in_id, 0) != 1:
            continue  # the conv output feeds something else too
        if id(mod) not in parent_of:
            continue
        if _fold_into(prev, mod):
            container, name = parent_of[id(mod)]
            container._modules[name] = nn.Identity()
            done.add(id(mod))
            folded += 1
    return folded


def remove_dropouts(model: nn.Module) -> int:
    """Replace every dropout module with ``nn.Identity`` for deployment;
    eval-mode dropout is already the identity, this takes it out of the
    saved program. Returns the count."""
    removed = 0
    for container in list(model.modules()):
        for name, sub in list(container._modules.items()):
            if isinstance(sub, _DROPOUTS):
                container._modules[name] = nn.Identity()
                removed += 1
    return removed


@torch.no_grad()
def _fuse_pair(prev, lin) -> None:
    """``lin`` becomes ``prev`` then ``lin``: ``W = W1 @ W2``, ``b = b1 @
    W2 + b2`` in ``[in, out]`` f64, rounded once to ``lin``'s dtype."""
    w1, w2 = _io_weight(prev), _io_weight(lin)
    w = w1 @ w2
    b = _f64(prev.bias) @ w2 if prev.bias is not None else 0.0
    if lin.bias is not None:
        b = b + _f64(lin.bias)
    like = lin.weight
    _set(lin, "weight", w if isinstance(lin, _layers.Linear) else w.T, like)
    lin.in_features = w.shape[0]
    if prev.bias is not None or lin.bias is not None:
        _set(lin, "bias", np.broadcast_to(b, (w.shape[1],)), like)


def fuse_linear_chains(model: nn.Module, input_spec) -> int:
    """Fuse dataflow-adjacent Linear → Linear pairs into one Linear
    (``_fuse_pair``), with ``fold_batch_norms``' dataflow checks: the
    first Linear's output feeds only the second, and both run once.
    Chains of 3+ fuse pairwise until none is left. Returns the number of
    pairs fused."""
    fused = 0
    while True:
        tr, layer_events, produced_by, parent_of = _trace_and_maps(
            model, input_spec)
        did = False
        for mod, in_id, _ in layer_events:
            if not isinstance(mod, _LINEARS):
                continue
            prev = produced_by.get(in_id)
            if (not isinstance(prev, _LINEARS) or prev is mod
                    or tr.layer_calls.get(id(prev)) != 1
                    or tr.layer_calls.get(id(mod)) != 1
                    or tr.consumers.get(in_id, 0) != 1
                    or id(prev) not in parent_of):
                continue
            _fuse_pair(prev, mod)
            container, name = parent_of[id(prev)]
            container._modules[name] = nn.Identity()
            fused += 1
            did = True
            break  # re-trace: ids and consumers are stale after a rewrite
        if not did:
            return fused
