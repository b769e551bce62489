"""The dataflow trace of a module's forward, for the inference passes.

Port of ``paddle_tpu/core/graph_trace.py``'s ``TraceResult`` (:175) and
``trace_layer_graph`` (:203); the jaxpr walk of that file belongs to the
JAX package's ``analysis`` and has no counterpart here.

``trace_layer_graph(model, x)`` runs ``model(x)`` once in eval mode
without gradients and records, at the top level (outside any leaf
module): each leaf module's call with its inputs and output (a
``"layer"`` event), each torch function applied between them (an
``"op"`` event: ``torch.overrides.TorchFunctionMode`` sees every torch
function and method and its tensor arguments; calls that return no
tensor, such as ``x.shape`` or ``x.dim()``, read metadata and are not
ops), how many times each tensor is consumed, and how many times each
module is called. Consumers are the tensors passed to a leaf module,
positionally or by keyword, the tensor arguments of a top-level op, and
the model's outputs, walked through tuples, lists and dicts: a tensor
that is returned never counts as feeding only its one layer consumer.
Tensors are keyed by ``id``; the result keeps every tensor it saw alive,
so an id is not reused during the trace.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Set, Tuple

import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree

__all__ = ["TraceResult", "trace_layer_graph"]


def _tensors(tree):
    return [t for t in pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


@dataclass
class TraceResult:
    #: ordered top-level events:
    #:   ("layer", module, inputs, output) | ("op", name, args, kwargs, out)
    events: List[Tuple] = field(default_factory=list)
    #: id(tensor) -> number of top-level consumptions (leaf-module inputs
    #: + top-level op args + model outputs)
    consumers: Dict[int, int] = field(default_factory=dict)
    #: ids of every tensor produced during the trace
    traced_ids: Set[int] = field(default_factory=set)
    #: per-module top-level call counts (object identity)
    layer_calls: Dict[int, int] = field(default_factory=dict)
    #: the model's return value
    y: Any = None
    #: strong refs: a freed tensor's id could be reused mid-trace
    keep: List[Any] = field(default_factory=list)

    def consumed(self, tree):
        for t in _tensors(tree):
            self.keep.append(t)
            self.consumers[id(t)] = self.consumers.get(id(t), 0) + 1

    def produced(self, tree):
        for t in _tensors(tree):
            self.keep.append(t)
            self.traced_ids.add(id(t))


class _OpRecorder(TorchFunctionMode):
    def __init__(self, res: TraceResult, depth: list):
        super().__init__()
        self._res = res
        self._depth = depth

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _tensors(out):
            return out      # metadata (shape, dim, dtype): not an op
        self._res.produced(out)
        if self._depth[0] == 0:
            self._res.consumed((args, kwargs))
            name = getattr(func, "__name__", str(func))
            self._res.events.append(("op", name, args, kwargs, out))
        return out


def trace_layer_graph(model: torch.nn.Module, x) -> TraceResult:
    """Run ``model(x)`` in eval mode without gradients with recording
    hooks installed (module docstring) on the modules without children,
    one ``"layer"`` event each; restores the training mode and removes
    the hooks afterwards."""
    res = TraceResult()
    depth = [0]

    def pre(mod, args, kwargs):
        if depth[0] == 0:
            res.consumed((args, kwargs))
        depth[0] += 1

    def post(mod, args, kwargs, output):
        depth[0] -= 1
        res.produced(output)
        if depth[0] == 0:
            res.events.append(("layer", mod, args, output))
            res.layer_calls[id(mod)] = res.layer_calls.get(id(mod), 0) + 1
            res.keep.append(args)

    hooks = []
    for m in model.modules():
        if list(m.children()):
            continue
        hooks.append(m.register_forward_pre_hook(pre, with_kwargs=True))
        hooks.append(m.register_forward_hook(post, with_kwargs=True))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad(), _OpRecorder(res, depth):
            res.y = model(x)
    finally:
        model.train(was_training)
        for h in hooks:
            h.remove()
    res.consumed(res.y)
    return res
