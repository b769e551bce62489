"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` when the caller
    names none, the named one otherwise. Raises when CUDA is absent and
    nothing was asked, so a run meant for the card never carries on on
    the CPU; the CPU is used only when asked for (``device="cpu"``)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on "
                "the CPU")
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {str(dev)!r} requested but CUDA "
                               f"is not available")
        if dev.index is None:   # name the card, so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
