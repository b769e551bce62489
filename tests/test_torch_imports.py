"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads
neither JAX nor the JAX package, and its entry points refuse to fall
back to the CPU when no device was asked for and CUDA is absent."""
import subprocess
import sys

import pytest
import torch

_PROBE = """
import sys
import chip_smoke
import paddle_tpu_torch
from paddle_tpu_torch.models import llama, qwen2_moe, resnet
from paddle_tpu_torch.ops.kernels import (
    _build, conv_epilogue, flash_attention, fused_norm_rope, grouped_matmul,
    int8_matmul, paged_attention, ragged_paged_attention)
from paddle_tpu_torch.ops.fused import conv_epilogue
from paddle_tpu_torch.analysis import fold_conv_bn, kv_invariants
from paddle_tpu_torch.vision.models import resnet50
from paddle_tpu_torch.incubate.moe import functional
from paddle_tpu_torch.ops.fused import fused_softmax_cross_entropy
from paddle_tpu_torch.ops.fused import int8_matmul
from paddle_tpu_torch.quantization import decode
from paddle_tpu_torch.inference import GenerationPredictor, paged_kv
from paddle_tpu_torch.serving import (ColdTier, ServingEngine, metrics,
                                      prefix_cache, prefix_fingerprints,
                                      scheduler, speculative)
from paddle_tpu_torch import prng
from paddle_tpu_torch.observability import (FlightRecorder,
                                            RecompileSentinel, SpanTracer,
                                            flight, sentinel, tracer)
from paddle_tpu_torch.serving import locktrace
from paddle_tpu_torch.serving.fleet import (FleetRouter, Replica,
                                            ServingFleet, fleet, replica,
                                            router)
from paddle_tpu_torch.serving.fleet.proc import (
    ProcReplica, ProcServingFleet, WorkerSpec, WorkerTransport)
from paddle_tpu_torch.serving.fleet.proc import (
    fleet, replica, transport, wire, worker)
from paddle_tpu_torch.analysis import concurrency
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
print(','.join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def test_entry_points_raise_without_cuda_or_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import GenerationPredictor
    from paddle_tpu_torch.models import llama, qwen2_moe, resnet
    from paddle_tpu_torch.serving import ServingEngine, ServingFleet
    from paddle_tpu_torch.vision.models import resnet50
    cfg = llama.LlamaConfig.tiny()
    qcfg = qwen2_moe.Qwen2MoeConfig.tiny(moe_impl="dropless")
    prompt = [[1, 2, 3]]
    calls = [
        lambda: resolve_device(),
        lambda: resolve_device("cuda"),
        lambda: llama.init_params(cfg, torch.Generator()),
        lambda: llama.params_from_jax({}),
        lambda: llama.init_serving_pages(cfg, 4, 4),
        lambda: llama.init_kv_cache(cfg, 1, 8),
        lambda: llama.make_train_step(cfg),
        lambda: llama.make_batch(cfg, 1, 8),
        lambda: ServingEngine({"embed": torch.zeros(1)}, cfg),
        lambda: llama.generate_paged(
            llama.init_params(cfg, torch.Generator()), prompt, [3], cfg, 2),
        lambda: GenerationPredictor({"embed": torch.zeros(1)}, cfg),
        lambda: ServingEngine({"embed": torch.zeros(1)}, cfg,
                              quantization="int8"),
        lambda: ServingFleet(
            lambda: ServingEngine({"embed": torch.zeros(1)}, cfg),
            replicas=1),
        lambda: qwen2_moe.make_train_step(qcfg),
        lambda: qwen2_moe.init_params(qcfg, torch.Generator()),
        lambda: qwen2_moe.make_batch(qcfg, 1, 8),
        lambda: resnet50(),
        lambda: resnet.resnext50_32x4d(num_classes=10),
        lambda: resnet.ResNet(depth=18, dtype=torch.bfloat16),
        lambda: resnet.params_from_jax({}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
