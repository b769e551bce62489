#!/usr/bin/env python3
"""What calling the conv epilogue through PyTorch's dispatcher costs the
host, on one NVIDIA GPU.

``ops.kernels.conv_epilogue.matmul_bias_act`` is also the PyTorch
operator ``paddle_tpu::matmul_bias_act``, which traced programs call; an
eager call runs the same function without the dispatcher. This script
times both ways after a dropped first round of each, alternating
A B B A A B B A:

- one call at ResNet-50's first bottleneck shape (B 8: M 25088, K 64,
  N 256, bf16): host µs to queue it, each call queued behind a device
  sleep so the host time is the call's own (median of ``--calls``);
- the eager forward of ``resnet50(num_classes=1000)`` at published
  widths, 224², bf16, channels-last, folded by ``analysis.fold_conv_bn``
  (33 sites on the kernel), at B 1 and 8: host ms to queue a forward
  (queued behind a device sleep, median of ``--reps``) and host ms per
  forward over ``--reps`` forwards ending in a synchronize.

Prints one JSON line with both ways' numbers (one a round, in the order
run) and the card's name and power limit as ``nvidia-smi`` reports
them.

    python3 tools/torch_dispatch_cost.py [--reps 30] [--calls 300]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import (make_resnet50, nvidia_smi_line,  # noqa: E402
                        resnet_input)
from paddle_tpu_torch.analysis import fold_conv_bn  # noqa: E402
from paddle_tpu_torch.analysis import rewrite_conv  # noqa: E402
from paddle_tpu_torch.ops.kernels import conv_epilogue as ce  # noqa: E402

WAYS = ("direct", "operator")
# a first round of each way is run and dropped (lazy set-up on first use)
ORDER = ("direct", "operator", "operator", "direct") * 2


def _operator(x2, w, bias, relu=True, impl="auto"):
    return ce._op(x2, w, bias, bool(relu), impl)


class _Way:
    """Within the block, the folded model's sites call the kernel through
    the dispatcher (``operator``) or directly (``direct``)."""

    def __init__(self, way: str):
        self.way = way

    def __enter__(self):
        if self.way == "operator":
            rewrite_conv._kernels = types.SimpleNamespace(
                matmul_bias_act=_operator)

    def __exit__(self, *exc):
        rewrite_conv._kernels = ce


def _queued_host_ms(fn, reps: int, cycles: int = 50_000_000) -> float:
    """Median host ms to queue ``fn()``, each queued behind a device
    sleep of ``cycles`` clocks so the host never waits on the card."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(out))


def _synced_ms(fn, reps: int) -> float:
    """Host ms per call over ``reps`` calls ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def one_call(calls: int) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((25088, 64), generator=gen, device="cuda").bfloat16()
    w = torch.randn((64, 256), generator=gen, device="cuda").bfloat16()
    b = torch.randn((256,), generator=gen, device="cuda")
    fns = {"direct": lambda: ce.matmul_bias_act(x, w, b),
           "operator": lambda: _operator(x, w, b)}
    assert torch.equal(fns["direct"](), fns["operator"]())
    got = {k: [] for k in WAYS}
    for way in WAYS:
        _queued_host_ms(fns[way], calls, 2_000_000)
    for way in ORDER:
        got[way].append(_queued_host_ms(fns[way], calls, 2_000_000) * 1e3)
    return {f"{k}_us": got[k] for k in WAYS}


def forwards(B: int, reps: int) -> dict:
    folded, _ = fold_conv_bn(make_resnet50(torch.bfloat16, seed=200))
    x = resnet_input(B, torch.bfloat16, seed=210)
    with torch.no_grad():
        want = folded(x)
        with _Way("operator"):
            assert torch.equal(folded(x), want)
        got = {f"{k}_{m}": [] for k in WAYS for m in ("queue_ms",
                                                         "synced_ms")}
        for way in WAYS:
            with _Way(way):
                _queued_host_ms(lambda: folded(x), reps)
        for way in ORDER:
            with _Way(way):
                got[f"{way}_queue_ms"].append(
                    _queued_host_ms(lambda: folded(x), reps))
                got[f"{way}_synced_ms"].append(
                    _synced_ms(lambda: folded(x), reps))
    del folded
    torch.cuda.empty_cache()
    return got


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--calls", type=int, default=300)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_dispatch_cost: no CUDA device", file=sys.stderr)
        return 2
    rec = {"gpu": nvidia_smi_line(), "torch": torch.__version__,
           "order": list(ORDER), "one_call": one_call(args.calls)}
    for B in (1, 8):
        rec[f"resnet50_b{B}"] = forwards(B, args.reps)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
