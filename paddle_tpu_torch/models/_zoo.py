"""Shared helpers for the vision model-zoo factories.

Port of ``paddle_tpu/models/_zoo.py``: the no-download policy and the
factory maker, with the JAX package's messages."""
from __future__ import annotations

__all__ = ["check_no_pretrained", "zoo_factory"]


def check_no_pretrained(pretrained: bool):
    """Raise for ``pretrained=True``: no weights are downloaded; load a
    local state dict with ``load_state_dict`` instead."""
    if pretrained:
        raise NotImplementedError(
            "pretrained weights need a download hub (zero-egress build); "
            "load converted weights with model.load_state_dict instead")


def zoo_factory(cls, name: str, **fixed):
    """Factory with a real ``__name__``: ``name(pretrained=False,
    **kwargs)`` builds ``cls(**fixed, **kwargs)``."""
    def make(pretrained: bool = False, **kwargs):
        check_no_pretrained(pretrained)
        return cls(**{**fixed, **kwargs})
    make.__name__ = make.__qualname__ = name
    make.__doc__ = f"Build {cls.__name__} ({fixed or 'defaults'})."
    return make
