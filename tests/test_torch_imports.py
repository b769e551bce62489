"""The PyTorch port stands alone: importing it (and chip_smoke.py) loads
neither JAX nor the JAX package, and its entry points refuse to fall
back to the CPU when no device was asked for and CUDA is absent."""
import os
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
from paddle_tpu_torch.models import (
    _layers, _zoo, alexnet, densenet, googlenet, inceptionv3, lenet,
    mobilenet, shufflenetv2, squeezenet, vgg)
from paddle_tpu_torch.vision import models
from paddle_tpu_torch.analysis import site_routes
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
from paddle_tpu_torch import amp, core, nn, optimizer
from paddle_tpu_torch.amp import auto_cast
from paddle_tpu_torch.core import generator
from paddle_tpu_torch.nn.functional import common, loss
from paddle_tpu_torch.optimizer import lr, optimizer as _optimizer
from paddle_tpu_torch import framework, hapi, io, metric
from paddle_tpu_torch import Model, load, save
from paddle_tpu_torch.framework import io as _framework_io
from paddle_tpu_torch.hapi import (Callback, CallbackList, EarlyStopping,
                                   LRScheduler, ModelCheckpoint,
                                   ProgBarLogger, callbacks, model, summary)
from paddle_tpu_torch.io import (DataLoader, DistributedBatchSampler,
                                 TensorDataset, dataloader, dataset, sampler)
from paddle_tpu_torch.metric import Accuracy, Auc, Precision, Recall
from paddle_tpu_torch.nn import (ClipGradByGlobalNorm, CrossEntropyLoss,
                                 MSELoss, clip, modules_loss)
from paddle_tpu_torch.optimizer import (
    ASGD, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb, Momentum, NAdam,
    RAdam, RMSProp, Rprop)
from paddle_tpu_torch.vision import datasets, transforms
from paddle_tpu_torch.vision import train
from paddle_tpu_torch.analysis import prepare_training
from paddle_tpu_torch import jit
from paddle_tpu_torch.jit import (BucketedFunction, InputSpec, StaticFunction,
                                  TranslatedLayer, bucket_size, bucketed,
                                  bucketing, load, save, to_static)
from paddle_tpu_torch.inference import (
    Config, DynamicBatcher, IOHandle, PlaceType, Predictor, create_predictor,
    fold_batch_norms, fuse_linear_chains, get_version, passes,
    remove_dropouts, serving)
from paddle_tpu_torch.core import graph_trace
from paddle_tpu_torch import static
from paddle_tpu_torch.static import nn as static_nn
from paddle_tpu_torch import onnx, profiler
from paddle_tpu_torch.onnx import _proto, export
from paddle_tpu_torch.amp import (GradScaler, debugging, decorate,
                                  grad_scaler)
from paddle_tpu_torch.core import flags
from paddle_tpu_torch.observability import bridge_record_events
from paddle_tpu_torch.ops.kernels import _op
from paddle_tpu_torch import distributed, parallel
from paddle_tpu_torch.distributed import (
    DataParallel, communication, env, fleet, functional, group_sharded_parallel,
    mpu, sequence_parallel, sharding, spawn)
from paddle_tpu_torch.distributed import parallel as _dist_parallel
from paddle_tpu_torch.distributed import (
    TCPStore, Watchdog, auto_tuner, checkpoint, extras, io as _dist_io,
    launch, load_state_dict, save_state_dict, store, watchdog)
from paddle_tpu_torch.distributed.launch import build_parser
from paddle_tpu_torch.models.llama import checkpoint_layout
from paddle_tpu_torch.models.qwen2_moe import checkpoint_layout
from paddle_tpu_torch.parallel import mesh, mp_ops
from paddle_tpu_torch.parallel import (Schedule, build_schedule,
                                       pipeline_spmd, pipeline_train_1f1b,
                                       pipeline_train_async)
import paddle_tpu_torch.parallel.pipeline_1f1b
import paddle_tpu_torch.parallel.pipeline_async
import paddle_tpu_torch.parallel.pipeline_spmd
from paddle_tpu_torch.models.llama import forward_pipelined, grads_1f1b
from paddle_tpu_torch.ops.fused import vocab_parallel_cross_entropy
from paddle_tpu_torch.ops.kernels.fused_norm_rope import (
    fused_rms_norm_sharded, fused_rope_sharded)
_op.register_all()
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'paddle_tpu'))
print(','.join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", _PROBE],
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "", out.stdout


def _one_rank_mesh(pp: int = 1):
    from paddle_tpu_torch.parallel import HybridMesh
    return HybridMesh({"dp": 1, "pp": pp, "tp": 1}, list(range(pp)), {}, 0)


def test_entry_points_raise_without_cuda_or_device():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.inference import (Config, GenerationPredictor,
                                            create_predictor)
    from paddle_tpu_torch.models import llama, qwen2_moe, resnet
    from paddle_tpu_torch.serving import ServingEngine, ServingFleet
    from paddle_tpu_torch.vision import models as zoo
    from paddle_tpu_torch.vision.models import resnet50
    from paddle_tpu_torch.vision.train import make_train_step
    from paddle_tpu_torch import Model, amp, distributed, load
    from paddle_tpu_torch.io import DataLoader, TensorDataset
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
        lambda: zoo.LeNet(),
        lambda: zoo.alexnet(num_classes=10),
        lambda: zoo.vgg11(batch_norm=True),
        lambda: zoo.squeezenet1_1(),
        lambda: zoo.mobilenet_v1(scale=0.25),
        lambda: zoo.mobilenet_v2(),
        lambda: zoo.mobilenet_v3_small(),
        lambda: zoo.mobilenet_v3_large(dtype=torch.bfloat16),
        lambda: zoo.shufflenet_v2_x1_0(),
        lambda: zoo.shufflenet_v2_swish(),
        lambda: zoo.densenet121(),
        lambda: zoo.googlenet(),
        lambda: zoo.inception_v3(),
        lambda: zoo.params_from_jax({}),
        lambda: make_train_step(
            zoo.resnet18(num_classes=10, device="cpu")),
        lambda: create_predictor(Config("model")),
        lambda: DataLoader(TensorDataset([torch.zeros(4)])),
        lambda: load(os.devnull),
        lambda: Model(torch.nn.ReLU()).predict([torch.zeros(2)]),
        lambda: amp.is_bfloat16_supported(),
        lambda: amp.is_float16_supported(),
        lambda: distributed.init_parallel_env(),
        lambda: distributed.fleet.init(),
        lambda: distributed.mpu.ColumnParallelLinear(4, 4),
        lambda: distributed.mpu.RowParallelLinear(4, 4),
        lambda: distributed.mpu.VocabParallelEmbedding(8, 4),
        lambda: llama.make_train_step(cfg, mesh=_one_rank_mesh()),
        lambda: llama.make_train_step(
            llama.LlamaConfig.tiny(pp_stages=2, pp_schedule="zb",
                                   num_microbatches=2),
            mesh=_one_rank_mesh(pp=2)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
