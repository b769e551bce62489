#!/usr/bin/env python3
"""Where an inference forward of the PyTorch port's vision models spends
its time on the card.

Runs ``resnet50(num_classes=1000)`` (``chip_smoke.make_resnet50``) and,
with ``--models``, the vision zoo's models of ``chip_smoke.ZOO_MODELS``
(``chip_smoke.make_zoo_model``; ``zoo`` names them all) on one NVIDIA GPU,
bf16, at their published widths and image sizes, seeded random weights
and BN statistics, eval, channels-last, folded by
``analysis.fold_conv_bn`` (the 1x1 sites on the conv-epilogue kernel)
and unfolded (conv -> BN -> act, cuDNN), at B 8 and B 128 (``--batches``).
Prints one JSON line per (model, fold, batch): host ms
per forward (``--reps`` forwards ending in a synchronize), the device span
per forward (CUDA events around the same forwards), the summed device time
of its kernels from ``torch.profiler`` (and so the device's idle share of
the span), that time by kernel family (the conv-epilogue kernel, cuDNN
convs, BN, the fc GEMM, everything else: pooling, residual adds, relu,
layout), the top kernels, and the card's name and power limit as
``nvidia-smi`` reports them.

    python3 tools/torch_resnet_profile.py [--models resnet50 zoo ...]
        [--batches 8 128] [--reps 20]

``--train`` times the train step of ``chip_smoke.py`` phase 19 (a)
instead: ``resnet50(num_classes=1000)`` at B 128 (``--batches`` takes
the first batch given when set), 224², AMP O1 bf16, SGD lr 0.1 with
momentum 0.9, ``prepare_training``, channels-last (``chip_smoke.
resnet50_train_run``), and prints one JSON line: ms a step chained as
``tools/resnet_bench.py`` times it, images/s, MFU against 989 TFLOP/s,
peak memory, busy ms and idle share over three chained steps, and busy
ms by family (conv forward, conv backward, batch norm, elementwise,
optimizer; ``chip_smoke.train_family``) with the top kernels.

    python3 tools/torch_resnet_profile.py --train [--batches 128]
"""
from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from chip_smoke import (ZOO_MODELS, make_resnet50,  # noqa: E402
                        make_zoo_model, nvidia_smi_line)
from paddle_tpu_torch.analysis import fold_conv_bn  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402
from torch_train_profile import _kernel_times  # noqa: E402

FAMILIES = (
    ("conv_epilogue", ("mba_wgmma_kernel", "mba_f32_kernel")),
    ("batch_norm", ("batch_norm", "bn_fw", "batchnorm")),
    ("cudnn_conv", ("fprop", "conv", "cudnn", "xmma", "implicit",
                    "winograd", "cutlass")),
    ("gemm", ("gemm", "nvjet", "cublas")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile(model, x, reps: int) -> dict:
    with torch.no_grad():
        for _ in range(3):                            # warm-up
            model(x)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        for _ in range(reps):
            model(x)
        b.record()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        span_ms = a.elapsed_time(b) / reps
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                model(x)
            torch.cuda.synchronize()
    kern = _kernel_times(prof)
    busy_ms = sum(t for t, _ in kern.values()) / 1e3 / reps
    fams = {}
    for k, (t, _) in kern.items():
        f = family(k)
        fams[f] = fams.get(f, 0.0) + t / 1e3 / reps
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    return {"host_ms_per_forward": host_ms,
            "device_span_ms_per_forward": span_ms,
            "kernel_busy_ms_per_forward": busy_ms,
            "idle_share": max(0.0, 1.0 - busy_ms / span_ms),
            "images_per_s": x.shape[0] / host_ms * 1e3,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "busy_ms_by_family": {k: round(v, 4) for k, v in
                                  sorted(fams.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_forward": [
                [k[:90], round(t / 1e3 / reps, 4), c // reps]
                for k, (t, c) in top]}


def build(name: str):
    """(the bf16 model, its input channels, its image size)."""
    if name == "resnet50":
        return make_resnet50(torch.bfloat16), 3, 224
    _, factory, kwargs, size, chans = next(
        m for m in ZOO_MODELS if m[0] == name)
    return make_zoo_model(factory, kwargs, seed=0).bfloat16(), chans, size


def train(args) -> int:
    """``--train``: phase 19 (a)'s step, profiled (module docstring)."""
    if "--batches" in sys.argv:
        chip_smoke.TRAIN_B = args.batches[0]
    rec = chip_smoke.resnet50_train_run()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
        "model": "resnet50 train step, AMP O1 bf16, prepare_training",
        "batch": chip_smoke.TRAIN_B, "image": chip_smoke.TRAIN_IMAGE,
        **{k: v for k, v in rec.items() if k != "top"},
        "top_kernels_ms_per_step": [[k[:90], round(v, 4)]
                                    for k, v in rec["top"]]}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--models", nargs="+", default=["resnet50"],
                    choices=["resnet50", "zoo"] + [m[0] for m in ZOO_MODELS])
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 128])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--train", action="store_true",
                    help="time phase 19 (a)'s ResNet-50 train step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_resnet_profile: no CUDA device", file=sys.stderr)
        return 2
    if args.train:
        return train(args)
    _build.build(["conv_epilogue"])
    smi = nvidia_smi_line()
    names = [n for m in args.models for n in
             ([z[0] for z in ZOO_MODELS] if m == "zoo" else [m])]
    for mname in names:
        unfolded, chans, size = build(mname)
        folded, fired = fold_conv_bn(copy.deepcopy(unfolded))
        for B in args.batches:
            gen = torch.Generator(device="cuda").manual_seed(5)
            x = torch.randn((B, chans, size, size), generator=gen,
                            device="cuda").to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            for name, model in (("folded", folded), ("unfolded", unfolded)):
                print(json.dumps({
                    "device": torch.cuda.get_device_name(0),
                    "nvidia_smi": smi, "model": f"{mname} bf16 {name}",
                    "batch": B, "image": size,
                    "fold_sites": fired["conv-bn-fold"],
                    **profile(model, x, args.reps)}), flush=True)
        del folded, unfolded
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
