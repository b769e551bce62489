"""AMP debugging: ``paddle_tpu/amp/debugging.py`` with the nan/inf hook
of ``paddle_tpu/ops/registry.py`` (``_check_nan_inf``, :292).

``check_numerics`` counts a tensor's NaN, Inf and zero elements and
raises in the aborting mode. The tensor checker turns
``FLAGS_check_nan_inf`` on (``enable_tensor_checker``, ``debug_guard``,
or ``core.flags.set_flags`` directly): while it is on, every eager op
whose floating output holds a NaN or an Inf raises ``FloatingPointError``
naming the op (its aten name, such as ``div.Tensor``).

The hook is a ``TorchDispatchMode``, so it sees every aten op, those
inside modules and autograd's too; outputs of the allocation ops
(``empty*``, whose memory is not yet written) are not checked. A check
reads one flag back from the device an op, which is the feature. The
flag is process-wide, as in the JAX package, but torch keeps dispatch
modes per thread: ``sync_thread()`` installs or removes the calling
thread's checker to match the flag. ``set_flags`` runs it on the thread
that sets the flag, and the serving engine's loop once a turn, so its
tick thread follows the flag from its next tick on. A thread that runs
eager ops of its own while the flag is on calls ``sync_thread()`` once.
With the flag off no mode is installed and an op runs as it would
without this module.
"""
from __future__ import annotations

import contextlib
import enum
import threading
from typing import Optional

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode)

from ..core.flags import get_flag, get_flags, set_flags

__all__ = ["DebugMode", "TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "debug_guard", "check_numerics",
           "compare_accuracy", "sync_thread"]


class DebugMode(enum.Enum):
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


class TensorCheckerConfig:
    def __init__(self, enable: bool,
                 debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT,
                 output_dir: Optional[str] = None, checked_op_list=None,
                 skipped_op_list=None, debug_step=None, stack_height_limit=1):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir


def enable_tensor_checker(checker_config: TensorCheckerConfig):
    if checker_config.enable:
        set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    set_flags({"FLAGS_check_nan_inf": False})


@contextlib.contextmanager
def debug_guard(config: TensorCheckerConfig):
    prev = get_flags(["FLAGS_check_nan_inf"])["FLAGS_check_nan_inf"]
    enable_tensor_checker(config)
    try:
        yield
    finally:
        set_flags({"FLAGS_check_nan_inf": prev})


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=DebugMode.CHECK_NAN_INF_AND_ABORT):
    """Count (num_nan, num_inf, num_zero), as 0-d int64 tensors on the
    tensor's device, and abort on a non-finite element when the mode
    says so (reference check_numerics semantics)."""
    data = torch.as_tensor(tensor)
    counts = torch.stack([torch.isnan(data).sum(), torch.isinf(data).sum(),
                          (data == 0).sum()])
    num_nan, num_inf, num_zero = counts.tolist()   # one read-back
    if (debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT
            and (num_nan or num_inf)):
        raise FloatingPointError(
            f"[check_numerics] op={op_type or '?'} var={var_name or '?'}: "
            f"{num_nan} NaN, {num_inf} Inf")
    return tuple(counts.unbind())


def compare_accuracy(dump_path, another_dump_path, output_filename,
                     loss_scale=1, dump_all_tensors=False):
    raise NotImplementedError(
        "fp16 vs fp32 dump comparison: dump tensors with paddle_tpu_torch."
        "save and diff with numpy; the reference's workflow file format "
        "is not replicated")


def _unchecked(func) -> bool:
    name = func.overloadpacket.__name__
    return "empty" in name or name in ("resize_", "set_")


class _NanInfChecker(TorchDispatchMode):
    """Raises on a non-finite floating output of any aten op."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if _unchecked(func):
            return out
        for t in pytree.tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and t.numel() and t.device.type != "meta"
                    and not bool(torch.isfinite(t).all())):
                raise FloatingPointError(
                    f"NaN/Inf detected in output of op "
                    f"'{func.overloadpacket.__name__}.{func._overloadname}' "
                    f"(FLAGS_check_nan_inf is on)")
        return out


_tls = threading.local()


def sync_thread() -> None:
    """Install (flag on) or remove (flag off) the calling thread's
    checker (module docstring)."""
    on = get_flag("check_nan_inf")
    mode = getattr(_tls, "mode", None)
    if on and mode is None:
        mode = _NanInfChecker()
        mode.__enter__()
        _tls.mode = mode
    elif not on and mode is not None:
        if _get_current_dispatch_mode() is not mode:
            raise RuntimeError(
                "FLAGS_check_nan_inf turned off inside another dispatch "
                "mode entered after it was turned on")
        _tls.mode = None
        mode.__exit__(None, None, None)


def _on_flag(value) -> None:
    sync_thread()


sync_thread()   # FLAGS_check_nan_inf from the environment
