#!/usr/bin/env python3
"""Where a ResNet-50 inference forward of the PyTorch port spends its time
on the card.

Runs ``resnet50(num_classes=1000)`` on one NVIDIA GPU, bf16, 224 x 224,
seeded random weights and BN statistics, eval, channels-last
(``chip_smoke.make_resnet50``), folded by ``analysis.fold_conv_bn`` (the
1x1 sites on the conv-epilogue kernel) and unfolded (conv -> BN -> relu,
cuDNN), at B 8 and B 128. Prints one JSON line per (model, batch): host ms
per forward (``--reps`` forwards ending in a synchronize), the device span
per forward (CUDA events around the same forwards), the summed device time
of its kernels from ``torch.profiler`` (and so the device's idle share of
the span), that time by kernel family (the conv-epilogue kernel, cuDNN
convs, BN, the fc GEMM, everything else: pooling, residual adds, relu,
layout), the top kernels, and the card's name and power limit as
``nvidia-smi`` reports them.

    python3 tools/torch_resnet_profile.py [--batches 8 128] [--reps 20]
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

from chip_smoke import (make_resnet50, nvidia_smi_line,  # noqa: E402
                        resnet_input)
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
            "busy_ms_by_family": {k: round(v, 4) for k, v in
                                  sorted(fams.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms_per_forward": [
                [k[:90], round(t / 1e3 / reps, 4), c // reps]
                for k, (t, c) in top]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 128])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_resnet_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build(["conv_epilogue"])
    unfolded = make_resnet50(torch.bfloat16)
    folded, fired = fold_conv_bn(copy.deepcopy(unfolded))
    smi = nvidia_smi_line()
    for B in args.batches:
        x = resnet_input(B, torch.bfloat16)
        for name, model in (("folded", folded), ("unfolded", unfolded)):
            print(json.dumps({
                "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                "model": f"resnet50 bf16 {name}", "batch": B,
                "image": x.shape[-1], "fold_sites": fired["conv-bn-fold"],
                **profile(model, x, args.reps)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
