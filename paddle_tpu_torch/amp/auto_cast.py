"""``auto_cast`` (O1) and ``decorate`` (O2), as
``paddle_tpu/amp/auto_cast.py``.

Paddle's O1 decides per op by name: an op on ``white_list`` runs its
floating inputs in the low-precision dtype (bf16 by default), an op on
``black_list`` runs them in f32, any other op keeps the dtypes it is
given. The lists and the decision (``amp_transform_args``) are the JAX
package's, verbatim. The port applies the decision where the op is
called (``amp_cast`` at the conv and ``Linear`` layers and in
``cross_entropy``: the ops on the vision step's path), so the dtype each layer
leaves is Paddle's: under O1 a conv returns bf16, BN (``batch_norm_train``,
on neither list) rounds its normalised output to that bf16 and the f32
affine promotes it to f32, relu, pooling and the residual add keep f32.

``torch.autocast`` is not used: its op lists are not Paddle's, and they
differ between CUDA and the CPU.

The state is a context variable (per thread and per asyncio task), set
by ``auto_cast`` for the ``with`` block.

``decorate(models, optimizers, level="O2", dtype)`` casts every floating
parameter to the AMP dtype except those of the norm layers (the port's
``BatchNorm2D``, torch's BatchNorm and LayerNorm) and of
``excluded_layers`` (types or instances), and sets each optimizer's
``_multi_precision`` (True unless ``master_weight`` says otherwise), so
it keeps f32 master weights. Buffers keep their dtype. What a decorated
layer then computes in follows the JAX package's dtype rules, which are
not the O1/O2 lists (its dispatch never applies them): ``Linear``
promotes an f32 input against bf16 parameters to f32, and a conv given
an input of another dtype than its weight raises, as ``lax.conv``
does. Under ``auto_cast(level="O2")`` the port's call sites cast, so a
decorated conv-BN network trains there (the JAX package's would raise at
the conv after the first BN).
"""
from __future__ import annotations

import contextvars
from typing import NamedTuple, Optional, Set

import torch
from torch import nn

__all__ = ["white_list", "black_list", "auto_cast", "amp_transform_args",
           "amp_cast", "decorate", "is_bfloat16_supported",
           "is_float16_supported"]

# ops that benefit from low precision (MXU-bound)
white_list: Set[str] = {
    "matmul", "mm", "bmm", "mv", "linear", "einsum", "conv1d", "conv2d",
    "conv3d", "conv1d_transpose", "conv2d_transpose", "conv3d_transpose",
    "addmm", "scaled_dot_product_attention_ref", "lstm", "gru", "simple_rnn",
}

# ops that must stay float32 for numeric health
black_list: Set[str] = {
    "exp", "log", "log2", "log10", "log1p", "expm1", "pow", "square",
    "cross_entropy", "nll_loss", "binary_cross_entropy", "softmax_with_cross_entropy",
    "binary_cross_entropy_with_logits", "kl_div", "mse_loss", "l1_loss",
    "smooth_l1_loss", "cosine_similarity", "norm", "vector_norm", "dist",
    "logsumexp", "erfinv", "cumprod", "prod", "softplus", "log_softmax",
    "log_sigmoid", "logit", "rsqrt", "sum", "mean", "std", "var",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class AMPState(NamedTuple):
    enabled: bool = False
    dtype: torch.dtype = torch.bfloat16
    level: str = "O1"
    custom_white: frozenset = frozenset()
    custom_black: frozenset = frozenset()


_state: contextvars.ContextVar = contextvars.ContextVar(
    "paddle_tpu_torch_amp", default=AMPState())


def _to_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return _DTYPES[str(dtype)]


def amp_state() -> AMPState:
    """The AMP state in force in this context."""
    return _state.get()


class auto_cast:
    """``with auto_cast(enable=True, custom_white_list=None,
    custom_black_list=None, level="O1", dtype="bfloat16"):`` — mixed
    precision for the ops called inside (O1 and O2 decide alike per op;
    O0 and OD leave every dtype alone)."""

    def __init__(self, enable: bool = True, custom_white_list=None,
                 custom_black_list=None, level: str = "O1",
                 dtype="bfloat16"):
        if level not in ("O0", "OD", "O1", "O2"):
            raise ValueError(f"level must be O0, OD, O1 or O2, got {level!r}")
        self._new = AMPState(enable and level in ("O1", "O2"),
                             _to_dtype(dtype), level,
                             frozenset(custom_white_list or ()),
                             frozenset(custom_black_list or ()))
        self._token = None

    def __enter__(self):
        self._token = _state.set(self._new)
        return self

    def __exit__(self, *exc):
        _state.reset(self._token)
        return False


@torch.compiler.assume_constant_result
def amp_transform_args(op_name: str) -> Optional[torch.dtype]:
    """The dtype this op's floating inputs are cast to, or None to leave
    them alone (the JAX package's decision, op by name). A captured
    program takes the decision made while it is traced; ``jit.to_static``
    keeps one program per AMP state."""
    st = _state.get()
    if not st.enabled:
        return None
    in_white = (op_name in white_list or op_name in st.custom_white) and \
        op_name not in st.custom_black
    in_black = op_name in black_list or op_name in st.custom_black
    if in_white:
        return st.dtype
    if in_black:
        return torch.float32
    return None


def amp_cast(op_name: str, *tensors):
    """``tensors`` with every floating one cast to
    ``amp_transform_args(op_name)`` (None and integer tensors pass
    through); a tuple in the order given."""
    dt = amp_transform_args(op_name)
    if dt is None:
        return tensors
    return tuple(t.to(dt) if t is not None and t.is_floating_point()
                 else t for t in tensors)


def _norm_layer(m: nn.Module) -> bool:
    from ..models._layers import BatchNorm2D
    return isinstance(m, (BatchNorm2D, nn.modules.batchnorm._BatchNorm,
                          nn.LayerNorm))


@torch.no_grad()
def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None, master_grad=False,
             excluded_layers=None):
    """O2 decoration (module docstring). Returns what the JAX package
    returns: the model or the list, and the optimizers when given."""
    single_model = isinstance(models, nn.Module)
    model_list = [models] if single_model else list(models)
    if level == "O2":
        dt = _to_dtype(dtype)
        excluded = set()
        if excluded_layers:
            ex = (excluded_layers
                  if isinstance(excluded_layers, (list, tuple))
                  else [excluded_layers])
            types = tuple(e for e in ex if isinstance(e, type))
            insts = [e for e in ex if isinstance(e, nn.Module)]
            for m in model_list:
                for layer in m.modules():
                    if isinstance(layer, types) or any(layer is e
                                                       for e in insts):
                        excluded.update(id(p) for p in layer.parameters())
        for m in model_list:
            for layer in m.modules():
                if _norm_layer(layer):
                    excluded.update(id(p) for p in
                                    layer.parameters(recurse=False))
            for p in m.parameters():
                if id(p) not in excluded and p.is_floating_point():
                    p.data = p.data.to(dt)
        for opt in ([optimizers] if optimizers is not None
                    and not isinstance(optimizers, (list, tuple))
                    else (optimizers or [])):
            opt._multi_precision = (True if master_weight is None
                                    else master_weight)
    if optimizers is None:
        return models if single_model else model_list
    return (models if single_model else model_list), optimizers


def is_bfloat16_supported(device=None) -> bool:
    """bf16 on ``device`` (the card unless the CPU is asked for): the
    CPU, or a card of compute capability 8.0 and up."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return dev.type == "cpu" or torch.cuda.get_device_capability(dev) >= (8, 0)


def is_float16_supported(device=None) -> bool:
    """f16 on ``device`` (the card unless the CPU is asked for)."""
    from ..device import resolve_device
    dev = resolve_device(device)
    return dev.type == "cpu" or torch.cuda.get_device_capability(dev) >= (5, 3)
