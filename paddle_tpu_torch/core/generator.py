"""A seeded key stream: the port's ``paddle_tpu/core/generator.py``.

The JAX package's ``Generator`` holds one threefry key and answers every
``next_key()`` by splitting it, keeping the first half and returning the
second. This one does the same on ``prng``'s int64 key tensors, so with
the same seed it returns ``jax.random``'s keys bit for bit. It lives on
one device (the keys are split there, so drawing one launches device
work and never waits for it) and is passed explicitly to what draws
from it, such as ``vision.train.make_train_step``: the port keeps no
default generator.
"""
from __future__ import annotations

import threading

import torch

from .. import prng

__all__ = ["Generator"]


class Generator:
    """``Generator(seed, device="cpu")``: ``next_key()`` returns a key
    ``[2]`` (int64 holding two uint32 words) on ``device``."""

    def __init__(self, seed: int = 0, device="cpu"):
        self._lock = threading.Lock()
        self.device = torch.device(device)
        self.manual_seed(seed)

    def manual_seed(self, seed: int) -> "Generator":
        with self._lock:
            self._key = prng.key(seed, device=self.device)
        return self

    def next_key(self) -> torch.Tensor:
        with self._lock:
            keys = prng.split(self._key)
            self._key, sub = keys[0], keys[1]
            return sub
