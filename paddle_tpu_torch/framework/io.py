"""``save`` / ``load``: ``paddle_tpu/framework/io.py`` on torch tensors.

The JAX package's file format, kept, so a ``.pdparams`` or ``.pdopt``
written by either package reads in the other: a pickle of the nested
object with every tensor replaced by ``{"_paddle_tpu_tensor_": True,
"data": <numpy array>, "stop_gradient": bool, "is_param": bool}``.
``stop_gradient`` is ``not requires_grad``; ``is_param`` marks an
``nn.Parameter``.

``load`` restores the tensors on ``device`` (the card unless the caller
names another, ``device.resolve_device``) as ``nn.Parameter`` where
``is_param``, or returns the numpy arrays with ``return_numpy=True``.

bf16: numpy has no bfloat16 (the JAX package writes ``ml_dtypes``
arrays, a package the port does not need). The port stores a bf16
tensor's uint16 bits with the tag ``"dtype": "bfloat16"``, which its own
``load`` reads back bit for bit (``return_numpy`` widens them to f32,
exactly). bf16 files are not promised to read across the packages.
"""
from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch
from torch import nn

from ..device import resolve_device

__all__ = ["save", "load"]

_SENTINEL = "_paddle_tpu_tensor_"


def _pack(obj: Any):
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        rec = {_SENTINEL: True, "stop_gradient": not obj.requires_grad,
               "is_param": isinstance(obj, nn.Parameter)}
        if t.dtype == torch.bfloat16:
            rec.update(data=t.contiguous().view(torch.int16).numpy().view(
                np.uint16).copy(), dtype="bfloat16")
        else:
            rec["data"] = t.numpy().copy()
        return rec
    if isinstance(obj, dict):
        return {k: _pack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_pack(v) for v in obj)
    return obj


def _to_tensor(rec: dict, device: torch.device) -> torch.Tensor:
    data = rec["data"]
    if rec.get("dtype") == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(data).view(
            np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(data))
    t = t.to(device)
    grad = not rec.get("stop_gradient", True) and t.is_floating_point()
    if rec.get("is_param"):
        return nn.Parameter(t, requires_grad=grad)
    return t.requires_grad_(grad)


def _unpack(obj: Any, return_numpy: bool, device):
    if isinstance(obj, dict):
        if obj.get(_SENTINEL):
            if return_numpy:
                if obj.get("dtype") == "bfloat16":
                    return (obj["data"].astype(np.uint32) << 16).view(
                        np.float32)
                return obj["data"]
            return _to_tensor(obj, device)
        return {k: _unpack(v, return_numpy, device) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_unpack(v, return_numpy, device) for v in obj)
    return obj


def save(obj, path, protocol: int = 4, **configs):
    if hasattr(path, "write"):  # file-like
        pickle.dump(_pack(obj), path, protocol=protocol)
        return
    d = os.path.dirname(str(path))
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(_pack(obj), f, protocol=protocol)


def load(path, device=None, **configs):
    """The object ``save`` wrote, its tensors on ``device`` (module
    docstring); ``return_numpy=True`` returns numpy arrays instead."""
    return_numpy = bool(configs.get("return_numpy", False))
    dev = None if return_numpy else resolve_device(device)
    if hasattr(path, "read"):
        return _unpack(pickle.load(path), return_numpy, dev)
    with open(path, "rb") as f:
        return _unpack(pickle.load(f), return_numpy, dev)
