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
grouped-matmul kernels (``ops/kernels/grouped_matmul.py``); vision
inference, ResNet and the rest of the zoo (``vision.models``: LeNet,
AlexNet, VGG, SqueezeNet, MobileNet V1-V3, ShuffleNetV2, DenseNet,
GoogLeNet, Inception v3), folded by ``analysis.fold_conv_bn``, its 1x1
convs on the conv-epilogue kernel (``ops/kernels/conv_epilogue.py``);
the vision train step (``vision.train.make_train_step``: BN and dropout
in training, O1 ``amp.auto_cast``, ``nn.functional.cross_entropy``,
``optimizer.Momentum``, the key stream ``core.Generator``) for ResNet
and the zoo, with the train-time transforms
``analysis.prepare_training``; the deployment front end: ``jit``
(``InputSpec``, ``save`` / ``load`` of ``torch.export`` programs,
``TranslatedLayer``, ``to_static`` over ``torch.compile``,
``bucketing``), ``inference`` (``Config``, ``Predictor``,
``create_predictor``, ``DynamicBatcher`` in ``inference.serving``, the
passes ``fold_batch_norms`` / ``remove_dropouts`` /
``fuse_linear_chains`` in ``inference.passes``) and the dataflow trace
``core.graph_trace``; the conv epilogue is the PyTorch operator
``paddle_tpu::matmul_bias_act``, so a saved or compiled folded model
still launches its kernel; the high-level trainer ``hapi.Model``
(``fit`` / ``evaluate`` / ``predict`` / ``save`` / ``load``, also
``paddle_tpu_torch.Model``) with its data pipeline ``io`` (``DataLoader``
onto the card), ``vision.transforms`` / ``vision.datasets``, ``metric``,
the Paddle optimizers and LR schedulers (``optimizer``,
``optimizer.lr``), the clips and loss layers (``nn``) and ``save`` /
``load`` (``framework.io``); ONNX export (``onnx``), the rest of ``amp``
(``GradScaler``, O2 ``decorate``, ``debugging``) over ``core.flags``,
and ``profiler`` (``RecordEvent`` at the engine's ticks, bridged into
the span tracer by ``observability.bridge_record_events``); data- and
tensor-parallel training over ``torch.distributed``, one process a rank
(``parallel`` — the hybrid mesh, Megatron's autograd pairs;
``distributed`` — the Paddle collective API, ``spawn``, ZeRO,
``mpu``, ``DataParallel``, ``fleet``; ``models.llama.make_train_step(
cfg, mesh=..., zero_stage=...)``).
"""
from .device import resolve_device
from .framework.io import load, save

# the JAX package's version, copied
__version__ = "0.3.0"

__all__ = ["Model", "load", "resolve_device", "save", "__version__"]


def __getattr__(name):
    # the JAX package's top level resolves Model lazily, as here
    if name == "Model":
        from .hapi import Model
        return Model
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
