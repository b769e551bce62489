"""static: the legacy static-graph namespace.

Port of ``paddle_tpu/static/__init__.py``. Program capture here is the
port's ``jit.to_static`` (``torch.compile``, one graph a signature), and
deployment its ``jit.save`` / ``inference.create_predictor``; there is no
separate static graph. Kept, with the JAX package's semantics:
``InputSpec`` (the port's ``jit``'s) and ``data``; ``nn``, the control
flow that stays inside a captured program (``cond``, ``while_loop``,
``case``, ``switch_case``); places as ``torch.device``\\ s; the guards
and the global scope; the helpers ``create_global_var``,
``create_parameter``, ``accuracy``, ``auc``, ``Print``, ``py_func``,
``append_backward``, ``gradients``, ``WeightNormParamAttr`` and
``ExponentialMovingAverage``. ``Program``, ``Executor``, the default
programs, ``save`` / ``load`` and ``save_inference_model`` /
``load_inference_model`` raise with guidance, as the JAX package's do.
"""
from __future__ import annotations

import contextlib
import math

import torch

from ..device import resolve_device
from ..jit import InputSpec, torch_dtype
from . import nn

__all__ = ["InputSpec", "nn", "data", "Program", "Executor",
           "default_main_program", "default_startup_program", "name_scope",
           "cpu_places", "cuda_places", "xpu_places", "device_guard",
           "program_guard", "scope_guard", "global_scope", "Variable",
           "create_global_var", "create_parameter", "accuracy", "auc",
           "Print", "py_func", "append_backward", "gradients",
           "WeightNormParamAttr", "ExponentialMovingAverage", "save", "load",
           "save_inference_model", "load_inference_model"]

Variable = torch.Tensor


def data(name, shape, dtype="float32", lod_level=0):
    return InputSpec(shape, dtype, name)


class Program:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "no legacy static graphs in paddle_tpu_torch; use jit.to_static "
            "(whole-function capture) or the functional models")


class Executor:
    def __init__(self, *a, **kw):
        raise NotImplementedError(
            "no executor of static programs; a captured function runs as "
            "one compiled program — see paddle_tpu_torch.jit")


def default_main_program():
    raise NotImplementedError(
        "no legacy static graphs; see paddle_tpu_torch.jit")


def default_startup_program():
    raise NotImplementedError(
        "no legacy static graphs; see paddle_tpu_torch.jit")


def name_scope(prefix=None):
    return contextlib.nullcontext()


# -- places and guards ------------------------------------------------------

def cpu_places(device_count=None):
    """``device_count`` CPU places (one when None)."""
    return [torch.device("cpu")] * (device_count or 1)


def cuda_places(device_ids=None):
    """The CUDA cards (all of them, or those of ``device_ids``); the CPU
    places when there is none."""
    devs = ([torch.device("cuda", i)
             for i in range(torch.cuda.device_count())] or cpu_places())
    if device_ids is not None:
        devs = [devs[i] for i in device_ids]
    return devs


xpu_places = cuda_places


_GUARDED = []     # the devices of the open device_guards, innermost last


@contextlib.contextmanager
def device_guard(device=None):
    """Scoped default device (reference static/device_guard):
    ``"cpu"``, ``"gpu"``/``"gpu:N"`` or a torch device name. Tensors
    made inside land there, ``create_global_var`` and
    ``create_parameter`` among them."""
    if not device:
        yield
        return
    name = str(device)
    if name.startswith("gpu"):
        name = "cuda" + name[3:]
    dev = torch.device(name)
    _GUARDED.append(dev)
    try:
        with dev:
            yield
    finally:
        _GUARDED.pop()


def _place(device, force_cpu=False):
    """Where a static helper makes its tensor: the CPU when forced, else
    the named device, else the innermost ``device_guard``'s, else the
    card (``device.resolve_device``)."""
    if force_cpu:
        return torch.device("cpu")
    if device is None and _GUARDED:
        device = _GUARDED[-1]
    return resolve_device(device)


def program_guard(main_program=None, startup_program=None):
    return contextlib.nullcontext()


def scope_guard(scope):
    return contextlib.nullcontext()


class _Scope(dict):
    def var(self, name):
        return self.setdefault(name, None)

    def find_var(self, name):
        return self.get(name)


_GLOBAL_SCOPE = _Scope()


def global_scope():
    """Variable scope (reference global_scope): a dict-like singleton
    that ``create_global_var`` records into."""
    return _GLOBAL_SCOPE


# -- helpers ---------------------------------------------------------------

def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None, device=None):
    """A tensor of ``shape`` filled with ``value``, recorded in the
    global scope; on the card unless ``force_cpu``, ``device`` or a
    ``device_guard`` says otherwise."""
    t = torch.full(tuple(shape), value, dtype=torch_dtype(dtype),
                   device=_place(device, force_cpu))
    _GLOBAL_SCOPE[name or f"gvar_{len(_GLOBAL_SCOPE)}"] = t
    return t


def _xavier_normal(shape, dtype, device):
    """The reference's default weight initializer: normal with std
    sqrt(2 / (fan_in + fan_out)), fans from the ``[in, out, *k]``
    layout."""
    shape = tuple(shape)
    if len(shape) < 2:
        fan_in = fan_out = shape[0] if shape else 1
    elif len(shape) == 2:
        fan_in, fan_out = shape
    else:
        r = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * r, shape[0] * r
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, dtype=torch.float32,
                       device=device).mul_(std).to(dtype)


def create_parameter(shape, dtype, name=None, attr=None, is_bias=False,
                     default_initializer=None, device=None):
    """A ``torch.nn.Parameter`` of ``shape``: ``attr.initializer`` or
    ``default_initializer`` (a callable ``(shape, dtype) -> tensor``)
    when given, else zeros for a bias and Xavier-normal for a weight;
    ``attr.trainable=False`` makes it need no gradient. On the card
    unless ``device`` or a ``device_guard`` says otherwise."""
    dt = torch_dtype(dtype)
    dev = _place(device)
    init = default_initializer
    if attr is not None and getattr(attr, "initializer", None) is not None:
        init = attr.initializer
    if init is not None:
        value = torch.as_tensor(init(tuple(shape), dt), device=dev)
    elif is_bias:
        value = torch.zeros(tuple(shape), dtype=dt, device=dev)
    else:
        value = _xavier_normal(shape, dt, dev)
    trainable = attr is None or getattr(attr, "trainable", True) is not False
    return torch.nn.Parameter(value, requires_grad=trainable)


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy (reference static/nn/metric.py accuracy): the share
    of rows whose label is among the k largest logits (ties to the
    lower index), f32."""
    logits = torch.as_tensor(input)
    lbl = torch.as_tensor(label)
    lbl = lbl.reshape(lbl.shape[0], -1)[:, 0]
    topk = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
    hit = (topk == lbl[:, None]).any(dim=-1)
    return hit.float().mean()


def auc(input, label, curve="ROC", num_thresholds=200, topk=1,
        slide_steps=1, name=None):
    """Area under the ROC curve (reference static/nn/metric.py auc),
    computed exactly from the ranks of the scores (the last column of a
    2-D input), f32."""
    logits = torch.as_tensor(input)
    score = logits[:, -1] if logits.dim() == 2 else logits
    lbl = torch.as_tensor(label).reshape(-1)
    order = torch.argsort(score, stable=True)
    ranks = torch.argsort(order, stable=True) + 1
    pos = lbl == 1
    n_pos = pos.sum()
    n_neg = lbl.shape[0] - n_pos
    value = (ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / torch.clamp(
        n_pos * n_neg, min=1)
    return value.float()


def Print(input, first_n=-1, message=None, summarize=20,
          print_tensor_name=True, print_tensor_type=True,
          print_tensor_shape=True, print_tensor_layout=True,
          print_tensor_lod=True, print_phase="both"):
    """Debug print (reference static/nn/control_flow.py Print): the
    message, the shape and the first ``summarize`` values; returns the
    input."""
    if isinstance(input, torch.Tensor):
        flat = input.detach().reshape(-1)[:summarize].tolist()
        print(f"{message or ''} shape={tuple(input.shape)} {flat}")
    return input


def py_func(func, x, out, backward_func=None,
            skip_vars_in_backward_input=None):
    """Run a Python function as an op (reference static/nn/common.py
    py_func): called directly on the inputs."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    return func(*xs)


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None, checkpoints=None):
    """Reference static append_backward: runs the backward of ``loss``
    and returns ``[(param, param.grad)]`` for ``parameter_list``."""
    loss.backward()
    return [(p, p.grad) for p in (parameter_list or [])]


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Reference static gradients(ys, xs): dys/dxs, None for an input
    the targets do not depend on."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    return list(torch.autograd.grad(targets, inputs,
                                    grad_outputs=target_gradients,
                                    allow_unused=True))


class WeightNormParamAttr:
    """Reference static/nn/common.py WeightNormParamAttr: the attributes
    of a parameter reparameterized as w = g · v / ||v||, carried as
    metadata."""

    def __init__(self, dim=None, name=None, initializer=None,
                 learning_rate=1.0, regularizer=None, trainable=True,
                 do_model_average=False, need_clip=True):
        self.dim = dim
        self.name = name
        self.initializer = initializer
        self.trainable = trainable


class ExponentialMovingAverage:
    """EMA of parameters (reference static/nn/common.py
    ExponentialMovingAverage): ``update()`` after each step, with decay
    ``min(decay, (1 + step) / (10 + step))``; ``apply()`` swaps the
    averages into the parameters for evaluation and ``restore()`` swaps
    them back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._ema = {}
        self._backup = {}
        self._params = []
        self._step = 0

    def _track(self, params):
        if not self._params:
            self._params = list(params)
            for p in self._params:
                self._ema[id(p)] = p.detach().clone()

    @torch.no_grad()
    def update(self, parameters=None):
        if parameters is not None or not self._params:
            self._track(parameters or [])
        self._step += 1
        d = min(self._decay, (1 + self._step) / (10 + self._step))
        for p in self._params:
            self._ema[id(p)] = d * self._ema[id(p)] + (1 - d) * p.detach()

    @contextlib.contextmanager
    def apply(self, executor=None, need_restore=True):
        with torch.no_grad():
            self._backup = {id(p): p.detach().clone() for p in self._params}
            for p in self._params:
                p.copy_(self._ema[id(p)].to(p.dtype))
        try:
            yield
        finally:
            if need_restore:
                self.restore()

    @torch.no_grad()
    def restore(self, executor=None):
        for p in self._params:
            if id(p) in self._backup:
                p.copy_(self._backup[id(p)])
        self._backup = {}


# -- programs on disk: the JAX package's raises -----------------------------

def save(program, model_path, protocol=4, **configs):
    raise NotImplementedError(
        "static Program save is a non-goal; use torch.save (state dicts) "
        "or paddle_tpu_torch.jit.save (exported programs)")


def load(program, model_path, executor=None, var_list=None):
    raise NotImplementedError(
        "static Program load is a non-goal; use torch.load or "
        "paddle_tpu_torch.jit.load")


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor=None,
                         **kwargs):
    """Not built: the deployment path is ``jit.save`` of a module (a
    ``torch.export`` program) read by ``inference.create_predictor``."""
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.save(layer, path, input_spec) — "
        "inference deployment here is torch.export + inference.Config")


def load_inference_model(path_prefix, executor=None, **kwargs):
    raise NotImplementedError(
        "use paddle_tpu_torch.jit.load(path) / inference.create_predictor")
