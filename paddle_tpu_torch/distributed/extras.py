"""``paddle.distributed``'s top-level ``save_state_dict`` /
``load_state_dict``.

Port of the two functions of ``paddle_tpu/distributed/extras.py``
(:161-174); the rest of that module (the auto-parallel names) is not
ported yet.
"""
from __future__ import annotations

__all__ = ["save_state_dict", "load_state_dict"]


def save_state_dict(state_dict, path, **kwargs):
    """Sharded checkpoint save (reference distributed/checkpoint/
    save_state_dict.py): ``checkpoint.save_state_dict``."""
    from . import checkpoint
    return checkpoint.save_state_dict(state_dict, path, **kwargs)


def load_state_dict(state_dict, path=None, **kwargs):
    """reference load_state_dict(state_dict, path): fills the given
    structure in place from a sharded checkpoint."""
    from . import checkpoint
    if path is None:
        raise ValueError("path required")
    return checkpoint.load_state_dict(state_dict, path, **kwargs)
