"""jit: whole-function capture and saved inference programs.

Port of ``paddle_tpu/jit/__init__.py``: ``InputSpec`` (:37),
``StaticFunction`` (:62), ``to_static`` (:215), ``save`` (:252),
``TranslatedLayer`` (:313), ``load`` (:334) and the switches
``not_to_static``, ``enable_to_static``, ``ignore_module``,
``set_code_level`` and ``set_verbosity``; ``bucketing`` is
``paddle_tpu/jit/bucketing.py``'s.

Capture. The JAX package traces a function with ``jax.jit`` into one
XLA program per input signature, the owning layer's parameters as
inputs, so gradients reach them. The PyTorch counterpart of that capture
is dynamo: ``to_static`` wraps ``torch.compile`` (``dynamic=False``: one
program per input signature, and one per AMP state, since an O1 cast is
decided at trace time; ``backend=None`` is inductor). Gradients
flow to the live parameters through the compiled graph's backward.
``full_graph=True`` (the default) is ``fullgraph=True``: a function
dynamo cannot capture whole raises, as the JAX trace does.
``full_graph=False`` lets dynamo break the function into captured graphs
around the Python it cannot trace (a data-dependent ``if`` on a value),
which then runs eagerly: the counterpart of the JAX package's segment
mode (``paddle_tpu/jit/segments.py``) and of the reference's SOT graph
breaks. ``graph_break_stats`` counts the graphs captured
(``segments``), the ops in them (``ops_recorded``), dynamo's graph
breaks (``graph_breaks``) and the calls that captured nothing new
(``cache_hits``). ``lower(*args)`` returns the text of the function's
``torch.export`` graph, where the JAX package returns StableHLO text.
Every hand-written kernel entry is a PyTorch operator
(``torch.ops.paddle_tpu.*``, ``ops/kernels/_op.py``): the conv
epilogue's ``matmul_bias_act``, ``rms_norm_fwd`` / ``rms_norm_bwd``,
``rope``, ``flash_attention_fwd`` / ``_bwd_dq`` / ``_bwd_dkv``,
``ragged_paged_attention_packed``, ``paged_attention`` /
``paged_attention_stats``, ``int8_matmul``, ``gmm`` and ``tgmm``. A
captured or exported graph keeps each call one node, the differentiable
ones with their backward operators in the captured backward, so a
compiled Llama or Qwen2-MoE loss, serving tick or decode step still
launches the kernels; ``static.nn``'s control flow stays one
higher-order node of the graph.

Saved programs. ``save(module, path, input_spec)`` exports the module
with ``torch.export.export`` and writes one ``<path>.pdmodel`` file: the
exported program (``torch.export.save``) and, beside it in the same
archive, the number of inputs, the spec and the device the program was
saved on. Symbolic dims follow the JAX rules: a string dim is a shared
named dim; ``None`` or ``-1`` at axis 0 is the shared ``"batch"``
(inputs that combine along the batch must share it); ``None`` or ``-1``
elsewhere gets a dim of its own. Each dynamic dim may be 1 or more. The
program is traced on zeros of the spec's dtype on the module's device,
with every dynamic dim at ``EXAMPLE_DIM``. ``load(path, device=None)``
returns a ``TranslatedLayer``: calling it runs the program without
gradients; ``eval()`` returns it and ``train()`` raises. Given a device
other than the one the program was saved on, ``load`` moves the program
(``torch.export.passes.move_to_device_pass``) and raises, saying so,
where it cannot. The artifact is the port's own: the JAX package's
StableHLO blob is not read here, nor this one there.
"""
from __future__ import annotations

import functools
import json
import os
import types
from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from ..amp.auto_cast import amp_state
from . import bucketing
from .bucketing import BucketedFunction, bucket_size, bucketed

__all__ = ["InputSpec", "StaticFunction", "to_static", "not_to_static",
           "enable_to_static", "save", "load", "TranslatedLayer",
           "ignore_module", "set_code_level", "set_verbosity", "bucketing",
           "bucket_size", "bucketed", "BucketedFunction"]

#: the size a dynamic dim has in the example that ``save`` traces
EXAMPLE_DIM = 2
_META = "paddle_tpu_torch.json"
_FORMAT = "paddle_tpu_torch.jit/1"


class InputSpec:
    """Symbolic input signature (reference ``paddle.static.InputSpec``)."""

    def __init__(self, shape, dtype="float32", name=None,
                 stop_gradient=True):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient

    def to_json(self) -> dict:
        return {"shape": list(self.shape), "dtype": str(torch_dtype(
            self.dtype)).replace("torch.", ""), "name": self.name}


def torch_dtype(dtype) -> torch.dtype:
    """A dtype given as a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = getattr(dtype, "name", None) or str(dtype)
    name = name.replace("torch.", "")
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


# ---------------------------------------------------------------------------
# to_static: dynamo capture
# ---------------------------------------------------------------------------

_IGNORED_MODULES: set = set()
_CODE_LEVEL = 0
_VERBOSITY = 0


def _graph_breaks() -> int:
    from torch._dynamo.utils import counters
    return sum(counters["graph_break"].values())


class StaticFunction:
    """The captured callable ``to_static`` returns (module docstring):
    one compiled program per input signature and AMP state, the owning
    module's parameters read live."""

    def __init__(self, function: Callable, layer: Optional[nn.Module] = None,
                 full_graph: bool = True, backend=None):
        self._fn = function
        self._layer = layer
        self._backend = "inductor" if backend is None else backend
        self._full_graph = full_graph
        self._stats = {"segments": 0, "ops_recorded": 0, "graph_breaks": 0,
                       "cache_hits": 0}
        functools.update_wrapper(self, function)
        # the user's own frame is the one dynamo captures (a wrapper frame
        # around it would count each break twice)
        self._target = (function if layer is None
                        else types.MethodType(function, layer))
        self._compiled: dict = {}

    def _program(self):
        """The compiled callable for the AMP state in force. An O1 cast is
        decided while the program is traced (``amp_transform_args``), and
        dynamo does not guard on it, so each state gets a
        ``torch.compile`` of its own; each has its own backend object,
        which keeps dynamo's cache entries for the one code object apart."""
        state = amp_state()
        fn = self._compiled.get(state)
        if fn is None:
            fn = self._compiled[state] = torch.compile(
                self._target, backend=functools.partial(self._count),
                fullgraph=self._full_graph, dynamic=False)
        return fn

    def _count(self, gm: torch.fx.GraphModule, example_inputs):
        """The compile backend: counts the graph and its ops, then hands
        it to the real backend."""
        self._stats["segments"] += 1
        self._stats["ops_recorded"] += sum(
            n.op in ("call_function", "call_method", "call_module")
            for n in gm.graph.nodes)
        backend = self._backend
        if isinstance(backend, str):
            backend = torch._dynamo.lookup_backend(backend)
        return backend(gm, example_inputs)

    def __call__(self, *args, **kwargs):
        graphs, breaks = self._stats["segments"], _graph_breaks()
        out = self._program()(*args, **kwargs)
        if self._stats["segments"] == graphs:
            self._stats["cache_hits"] += 1
        self._stats["graph_breaks"] += _graph_breaks() - breaks
        return out

    @property
    def graph_break_stats(self) -> dict:
        """Capture counters (module docstring)."""
        return dict(self._stats)

    @property
    def dygraph_function(self):
        return self._fn

    def concrete_program(self, *args, **kwargs):
        raise NotImplementedError("inspect the program via .lower(...)")

    def lower(self, *args) -> str:
        """The text of the ``torch.export`` graph for these example
        inputs (the JAX package returns StableHLO text here)."""
        with torch.no_grad():
            ep = torch.export.export(_Bound(self._fn, self._layer),
                                     tuple(args))
        return str(ep)


class _Bound(nn.Module):
    """A function, or a module's unbound forward, as a module to export."""

    def __init__(self, fn, layer):
        super().__init__()
        self.fn = fn
        self.layer = layer

    def forward(self, *args):
        if self.layer is not None:
            return self.fn(self.layer, *args)
        return self.fn(*args)


def to_static(function=None, input_spec=None, build_strategy=None,
              backend=None, full_graph: bool = True, **kwargs):
    """Decorator / wrapper (module docstring). A module gets a
    ``StaticFunction`` as its ``forward`` and is returned; a function is
    returned wrapped. ``backend``: a ``torch.compile`` backend (None:
    inductor). ``input_spec`` and ``build_strategy`` are the reference's
    arguments and go unused: a program is made for each signature met."""
    def wrap(f):
        if isinstance(f, nn.Module):
            f.forward = StaticFunction(type(f).forward, layer=f,
                                       full_graph=full_graph,
                                       backend=backend)
            return f
        return StaticFunction(f, full_graph=full_graph, backend=backend)

    if function is not None:
        return wrap(function)
    return wrap


def not_to_static(function=None):
    if function is None:
        return lambda f: f
    return function


def enable_to_static(flag: bool = True):
    pass


def ignore_module(modules):
    """Record modules exempt from capture (reference
    ``jit.ignore_module``); returns the recorded set as a list."""
    _IGNORED_MODULES.update(modules)
    return list(_IGNORED_MODULES)


def set_code_level(level=100, also_to_stdout=False):
    global _CODE_LEVEL
    _CODE_LEVEL = level


def set_verbosity(level=0, also_to_stdout=False):
    global _VERBOSITY
    _VERBOSITY = level


# ---------------------------------------------------------------------------
# save / load: torch.export programs
# ---------------------------------------------------------------------------

def _dims(input_spec: Sequence[InputSpec]):
    """``(example sizes, dynamic_shapes)`` by the module docstring's
    naming rules, one scope for all inputs."""
    from torch.export import Dim
    scope = {}

    def dim(name):
        if name not in scope:
            scope[name] = Dim(name, min=1)
        return scope[name]

    sizes, dynamic = [], []
    for i, spec in enumerate(input_spec):
        shape, dyn = [], {}
        for j, d in enumerate(spec.shape):
            if isinstance(d, str):
                dyn[j] = dim(d)
            elif d is None or d < 0:
                dyn[j] = dim("batch" if j == 0 else f"b{i}_{j}")
            else:
                shape.append(int(d))
                continue
            shape.append(EXAMPLE_DIM)
        sizes.append(shape)
        dynamic.append(dyn or None)
    return sizes, tuple(dynamic)


def _module_device(module: nn.Module) -> torch.device:
    for t in list(module.parameters()) + list(module.buffers()):
        return t.device
    return torch.device("cpu")


def save(layer, path: str, input_spec: Optional[Sequence] = None,
         **configs) -> None:
    """Export ``layer`` and write ``<path>.pdmodel`` (module
    docstring)."""
    if not isinstance(layer, nn.Module):
        raise TypeError("jit.save expects an nn.Module (functions: wrap "
                        "them in a module)")
    if input_spec is None:
        raise ValueError("jit.save(layer, ...) needs input_spec")
    specs = [s if isinstance(s, InputSpec) else InputSpec(s)
             for s in input_spec]
    dev = _module_device(layer)
    sizes, dynamic = _dims(specs)
    args = tuple(torch.zeros(shape, dtype=torch_dtype(s.dtype), device=dev)
                 for shape, s in zip(sizes, specs))
    with torch.no_grad():
        program = torch.export.export(layer, args, dynamic_shapes=dynamic)
    meta = {"format": _FORMAT, "num_inputs": len(specs),
            "input_spec": [s.to_json() for s in specs],
            "device": str(dev)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path + ".pdmodel", "wb") as f:
        torch.export.save(program, f, extra_files={_META: json.dumps(meta)})


class TranslatedLayer:
    """A loaded inference program (reference ``translated_layer.py``):
    ``program`` is the ``torch.export.ExportedProgram``, ``input_spec``
    the specs it was saved with, ``device`` where it runs."""

    def __init__(self, program, meta: dict, device: torch.device):
        self.program = program
        self.num_inputs = meta["num_inputs"]
        self.input_spec: List[InputSpec] = [
            InputSpec(s["shape"], s["dtype"], s.get("name"))
            for s in meta["input_spec"]]
        self.device = device
        self._module = program.module()

    def __call__(self, *args):
        with torch.no_grad():
            return self._module(*args)

    def eval(self):
        return self

    def train(self, mode: bool = True):
        raise RuntimeError("loaded programs are inference-only")


def load(path: str, device=None, **configs) -> TranslatedLayer:
    """Read ``<path>.pdmodel`` (module docstring); ``device``: where the
    program runs (None: where it was saved)."""
    # the kernels' operators must be registered before a program that
    # calls one of them is read
    from ..ops.kernels._op import register_all
    register_all()
    extra = {_META: ""}
    with open(path + ".pdmodel", "rb") as f:
        program = torch.export.load(f, extra_files=extra)
    meta = json.loads(extra[_META]) if extra[_META] else {}
    if meta.get("format") != _FORMAT:
        raise ValueError(f"{path}.pdmodel was not written by this "
                         f"package's jit.save")
    saved = torch.device(meta["device"])
    dev = saved if device is None else torch.device(device)
    if dev != saved:
        from torch.export.passes import move_to_device_pass
        try:
            program = move_to_device_pass(program, dev)
        except Exception as e:
            raise RuntimeError(
                f"{path}.pdmodel was saved on {saved} and cannot be moved "
                f"to {dev}: {e}") from e
    return TranslatedLayer(program, meta, dev)
