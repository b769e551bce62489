"""Dynamic-shape bucketing: a bounded set of shapes for varying batch/seq.

Port of ``paddle_tpu/jit/bucketing.py``: ``bucket_size`` (:27),
``BucketedFunction`` (:36) and ``bucketed`` (:92), copied, not imported.
The dynamic dim is padded up to a bucket from a fixed ladder (powers of
two by default), the function runs on the padded inputs, outputs that
kept the padded dim are sliced back, and with ``with_length=True`` the
function gets the true length (a 0-d int32 tensor) so it can mask. The
JAX package jits one executable per bucket; here the function runs as
it is, so wrap it in ``to_static`` to capture one program per bucket:
the padding bounds the shapes it sees to the ladder.

    step = bucketed(fn, axis=0)                    # pad + slice
    step = bucketed(fn, axis=0, with_length=True)  # fn gets valid_len
"""
from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

__all__ = ["DEFAULT_BUCKETS", "bucket_size", "BucketedFunction", "bucketed"]

DEFAULT_BUCKETS = tuple(2 ** i for i in range(16))  # 1..32768


def bucket_size(n: int, buckets: Optional[Sequence[int]] = None) -> int:
    """Smallest bucket >= n (power-of-two ladder by default)."""
    for b in sorted(buckets or DEFAULT_BUCKETS):
        if b >= n:
            return b
    raise ValueError(f"{n} exceeds the largest bucket "
                     f"{max(buckets or DEFAULT_BUCKETS)}")


class BucketedFunction:
    """Wraps a function so calls with any size of the dynamic ``axis``
    see only the bucket sizes."""

    def __init__(self, fn: Callable, axis: int = 0,
                 buckets: Optional[Sequence[int]] = None,
                 with_length: bool = False,
                 pad_value: float = 0):
        self._fn = fn
        self.axis = axis
        self.buckets = tuple(sorted(buckets or DEFAULT_BUCKETS))
        self.with_length = with_length
        self.pad_value = pad_value
        functools.update_wrapper(self, fn)

    def _has_dim(self, a) -> bool:
        """Whether the bucketed axis exists on ``a`` (correct for a
        negative axis too)."""
        if not isinstance(a, torch.Tensor):
            return False
        ax = self.axis
        return a.dim() >= (-ax if ax < 0 else ax + 1)

    def __call__(self, *args):
        ax = self.axis
        arrays = [torch.as_tensor(a) for a in args]
        sizes = {a.shape[ax] for a in arrays if self._has_dim(a)}
        if len(sizes) != 1:
            raise ValueError(
                f"all inputs must agree on dim {ax}; got {sizes}")
        n = sizes.pop()
        b = bucket_size(n, self.buckets)
        padded = []
        for a in arrays:
            if self._has_dim(a) and a.shape[ax] != b:
                shape = list(a.shape)
                shape[ax] = b - n
                a = torch.cat([a, a.new_full(shape, self.pad_value)], dim=ax)
            padded.append(a)
        if self.with_length:
            dev = padded[0].device if padded else None
            out = self._fn(*padded, valid_len=torch.tensor(
                n, dtype=torch.int32, device=dev))
        else:
            out = self._fn(*padded)

        # slice outputs that kept the bucketed dim back to the true size
        def unpad(o):
            if self._has_dim(o) and o.shape[ax] == b and b != n:
                return o.narrow(ax, 0, n)
            return o
        return pytree.tree_map(unpad, out)


def bucketed(fn: Optional[Callable] = None, *, axis: int = 0,
             buckets: Optional[Sequence[int]] = None,
             with_length: bool = False, pad_value: float = 0):
    """Decorator form of :class:`BucketedFunction`."""
    def wrap(f):
        return BucketedFunction(f, axis=axis, buckets=buckets,
                                with_length=with_length,
                                pad_value=pad_value)
    return wrap(fn) if fn is not None else wrap
