"""Global runtime flag registry: ``paddle_tpu/core/flags.py``.

A process-wide registry of typed flags (the reference's exported-flag
machinery, ``paddle/common/flags.h``), overridable from the environment
as ``FLAGS_<name>`` when the flag is defined and from Python through
``get_flags`` / ``set_flags``; an unknown name raises ``ValueError``.
The parsing and typing rules are the JAX package's.

The port defines the flags it reads: ``check_nan_inf`` (``amp.debugging``:
every eager op's floating output checked for NaN / Inf). The JAX
package's TPU and XLA flags (``allocator_strategy``, ``use_pallas_kernels``,
``jit_static_shapes``, ``eager_vjp_cache``, ``amp_dtype``,
``default_device``, ``eager_log_ops``) name nothing the port has and are
not defined.

A flag's value is process-wide. Where setting a flag must act on
per-thread state (the nan/inf checker is a dispatch mode, which torch
keeps per thread), the module that owns that state is named in
``_WATCHERS`` and told of each ``set_flags``: it updates the calling
thread, and other threads pick the value up themselves (the serving
engine once per loop turn).
"""
from __future__ import annotations

import importlib
import os
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional

__all__ = ["FlagInfo", "define_flag", "get_flags", "set_flags", "get_flag",
           "all_flags"]


@dataclass
class FlagInfo:
    name: str
    default: Any
    type: type
    help: str
    value: Any


_FLAGS: Dict[str, FlagInfo] = {}
_LOCK = threading.Lock()

# flag -> module (relative to this package) whose ``_on_flag(value)`` runs
# after each ``set_flags`` of it, on the calling thread
_WATCHERS = {"check_nan_inf": "..amp.debugging"}


def _parse(tp: type, raw: str):
    if tp is bool:
        return raw.lower() in ("1", "true", "yes", "on")
    return tp(raw)


def define_flag(name: str, default, help: str = "",
                type: Optional[type] = None):
    """Register a flag. Environment variable FLAGS_<name> overrides default."""
    tp = type or (bool if isinstance(default, bool) else default.__class__)
    value = default
    env = os.environ.get("FLAGS_" + name)
    if env is not None:
        value = _parse(tp, env)
    with _LOCK:
        _FLAGS[name] = FlagInfo(name, default, tp, help, value)
    return value


def _key(name: str) -> str:
    key = name[6:] if name.startswith("FLAGS_") else name
    if key not in _FLAGS:
        raise ValueError(f"unknown flag: {name}")
    return key


def get_flags(flags) -> Dict[str, Any]:
    """Return {name: value} for a flag name or list of names."""
    if isinstance(flags, str):
        flags = [flags]
    return {f: _FLAGS[_key(f)].value for f in flags}


def set_flags(flags: Dict[str, Any]):
    """Set flag values from a {name: value} dict."""
    for name, v in flags.items():
        key = _key(name)
        info = _FLAGS[key]
        info.value = (_parse(info.type, v) if isinstance(v, str)
                      and info.type is not str else info.type(v))
        if key in _WATCHERS:
            importlib.import_module(_WATCHERS[key], __package__)._on_flag(
                info.value)


def get_flag(name: str):
    return _FLAGS[name].value


def all_flags() -> Iterable[FlagInfo]:
    return list(_FLAGS.values())


define_flag("check_nan_inf", False,
            "check op outputs for NaN/Inf after each eager op")
