"""paddle.distributed.io — save/load for distributed training.

Port of ``paddle_tpu/distributed/io.py``: the framework's ``save`` /
``load`` and the sharded checkpoint's ``save_state_dict`` /
``load_state_dict``. Static-program persistables are not ported, as in
the JAX package.
"""
from __future__ import annotations

from ..framework.io import load, save  # noqa: F401
from .checkpoint import load_state_dict, save_state_dict  # noqa: F401

__all__ = ["save", "load", "save_state_dict", "load_state_dict",
           "save_persistables", "load_persistables"]


def save_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    raise NotImplementedError(
        "static Program persistables are a non-goal; use "
        "paddle_tpu_torch.save / distributed.save_state_dict")


def load_persistables(executor=None, dirname=None, main_program=None,
                      filename=None):
    raise NotImplementedError(
        "static Program persistables are a non-goal; use "
        "paddle_tpu_torch.load / distributed.load_state_dict")
