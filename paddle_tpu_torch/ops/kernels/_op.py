"""The kernel entries as PyTorch operators.

Every entry of ``ops/kernels`` is a ``torch.library.custom_op`` in the
``paddle_tpu`` namespace (``torch.ops.paddle_tpu.<entry>``), registered
when its module is imported. The operator's body is the entry's run
function: the kernel for CUDA tensors and the plain version for CPU
tensors under ``impl="auto"``, the kernel under ``"kernel"`` (strict),
the plain version under ``"reference"``; a launch counts in the entry's
``.launches`` inside the body. Its fake gives the real output's shape,
dtype and strides (contiguous), so ``torch.compile`` and
``torch.export`` keep each call one node of their graph, where a
``ctypes`` launch cannot be traced at all.

An entry's wrapper calls the operator only while a graph is traced
(``traced()``) and the run function directly otherwise: through the
dispatcher a call at one ResNet-50 shape took 72–123 µs of an H100
host's time against 40–69 direct (``tools/torch_dispatch_cost.py``).

A differentiable entry registers its formula on the operator
(``register_autograd``: a ``setup_context`` and a backward that calls the
backward operators). ``direct_function`` makes an autograd Function of
the same formula for the eager call: its backward is handed the backward
entries' run functions where the operator's is handed their operators,
so one formula serves both.
"""
from __future__ import annotations

import torch

__all__ = ["IMPLS", "traced", "check_impl", "use_kernel", "acc_dtype",
           "direct_function", "register_all"]

IMPLS = ("auto", "kernel", "reference")


def traced() -> bool:
    """Whether ``torch.compile`` or ``torch.export`` is tracing."""
    return torch.compiler.is_compiling()


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be auto|kernel|reference, got {impl!r}")


def use_kernel(impl: str, t: torch.Tensor) -> bool:
    """``impl``'s choice for a tensor: the kernel, or the plain version."""
    check_impl(impl)
    return impl == "kernel" or (impl == "auto" and t.is_cuda)


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The plain versions' accumulation type: f32, or f64 for f64."""
    return torch.promote_types(dtype, torch.float32)


def direct_function(name: str, run, setup_context, backward):
    """An autograd Function whose forward is ``run(*inputs)`` and whose
    formula is ``setup_context(ctx, inputs, output)`` and
    ``backward(ctx, *grads)`` — what ``register_autograd`` takes. The
    gradients of outputs that feed nothing arrive as None, as they do to
    the operator's backward."""
    def forward(ctx, *inputs):
        ctx.set_materialize_grads(False)
        out = run(*inputs)
        setup_context(ctx, inputs, out)
        return out

    def bwd(ctx, *grads):
        return backward(ctx, *grads)

    return type(name, (torch.autograd.Function,),
                {"forward": staticmethod(forward),
                 "backward": staticmethod(bwd)})


def register_all() -> None:
    """Import every kernel module, registering all operators (a saved
    program that calls one of them needs it before it is read)."""
    from . import (conv_epilogue, flash_attention,  # noqa: F401
                   fused_norm_rope, grouped_matmul, int8_matmul,
                   paged_attention, ragged_paged_attention)
