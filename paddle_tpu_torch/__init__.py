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
paged-attention kernel (``ops/kernels/ragged_paged_attention.py``), with
sampling on ``prng`` (threefry, bitwise ``jax.random``'s), speculative
decoding (``serving.speculative``), ``defragment()`` and the Prometheus
exposition (``serving.metrics``); the
one-device train step (``models.llama.make_train_step``); paged and
weight-only int8 decode (``models.llama.generate_paged``, the serving
steps, ``inference.GenerationPredictor``,
``quantization.quantize_for_decode``) on the paged-attention and int8
matmul kernels; Qwen2-MoE training with dropless experts
(``models.qwen2_moe.make_train_step``, ``incubate.moe``) on the
grouped-matmul kernels (``ops/kernels/grouped_matmul.py``); ResNet
inference (``models.resnet``, ``vision.models``) folded by
``analysis.fold_conv_bn``, its 1x1 convs on the conv-epilogue kernel
(``ops/kernels/conv_epilogue.py``).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
