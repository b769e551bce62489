"""PyTorch/CUDA port of ``paddle_tpu`` for one NVIDIA Hopper card.

The port mirrors ``paddle_tpu``'s module layout and public names, so a
reader finds each counterpart at the same path. It is PyTorch only: it
imports neither JAX nor anything of ``paddle_tpu``. Every TPU kernel on
a ported path is a hand-written CUDA kernel under ``csrc/``, built with
``nvcc`` at first use (``ops/kernels/_build.py``); beside each kernel
sits its plain PyTorch version, which runs only for CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see ``device.resolve_device``).

Ported so far: serving — ``serving.ServingEngine`` over
``models.llama.serving_tick`` / ``serving_tick_block`` and the ragged
paged-attention kernel (``ops/kernels/ragged_paged_attention.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
