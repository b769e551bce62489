"""``auto_cast``: O1 mixed precision, as ``paddle_tpu/amp/auto_cast.py``.

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
by ``auto_cast`` for the ``with`` block. ``decorate`` (O2) is not ported.
"""
from __future__ import annotations

import contextvars
from typing import NamedTuple, Optional, Set

import torch

__all__ = ["white_list", "black_list", "auto_cast", "amp_transform_args",
           "amp_cast"]

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
