#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time on the card.

Runs ``paddle_tpu_torch.models.llama`` serving ticks at the full
Llama-3-8B width and depth (bf16, seeded random weights) on one NVIDIA
GPU and prints one JSON line per scenario:

* ``decode_block``: ``serving_tick_block`` with 8 live slots over ~300
  cached tokens each, 4 fused steps (the engine's pure-decode tick);
* ``mixed_tick``: ``serving_tick`` with 8 decode rows plus a 256-token
  prefill span behind a 128-token cached prefix (an admission tick).

For each: host wall time per model step (ends in a synchronize), the
device span of the step measured with CUDA events, the summed device
time of its kernels from ``torch.profiler`` (and so the device's idle
share of the span), the ragged paged-attention kernel's share, and the
top kernels by device time.

    python3 tools/torch_serving_profile.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.models import llama  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402

S, PS, PPS = 8, 16, 34


def _tables():
    return torch.arange(1, 1 + S * PPS, dtype=torch.int32,
                        device="cuda").reshape(S, PPS)


def _decode_block(params, cfg, pools):
    tok = torch.randint(0, cfg.vocab_size, (S,), dtype=torch.int32,
                        device="cuda")
    lengths = torch.full((S,), 300, dtype=torch.int32, device="cuda")
    tables = _tables()

    def step():
        llama.serving_tick_block(params, tok, lengths, tables,
                                 pools["k_pages"], pools["v_pages"], cfg,
                                 num_steps=4)
    return step, 4


def _mixed_tick(params, cfg, pools):
    rng = np.random.RandomState(0)
    # 7 decode rows at position 300, then the last slot's prefill span:
    # 256 tokens behind a 128-token cached prefix
    tok, meta = llama.pack_tick(
        [(s, rng.randint(cfg.vocab_size), 300) for s in range(S - 1)],
        [(S - 1, rng.randint(0, cfg.vocab_size, 256), 128)],
        _tables().cpu().numpy(), PS, "cuda")

    def step():
        llama.serving_tick(params, tok, meta, pools["k_pages"],
                           pools["v_pages"], cfg)
    return step, 1


def _kernel_times(prof):
    """{kernel name: (device µs, count)} from the profiler's averages."""
    from torch.autograd import DeviceType
    out = {}
    for it in prof.key_averages():
        if it.device_type != DeviceType.CUDA:
            continue
        t = getattr(it, "self_device_time_total", None)
        if t is None:
            t = it.self_cuda_time_total
        out[it.key] = (float(t), int(it.count))
    return out


def profile(name, step, n_steps, reps=3):
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    walls, spans = [], []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        step()
        b.record()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        spans.append(a.elapsed_time(b))
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    kern = _kernel_times(prof)
    busy_ms = sum(t for t, _ in kern.values()) / 1e3
    attn_ms = sum(t for k, (t, _) in kern.items()
                  if "rpa_packed_kernel" in k) / 1e3
    span = float(np.median(spans))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "scenario": name, "model_steps": n_steps,
        "host_ms_per_step": float(np.median(walls)) / n_steps,
        "device_span_ms_per_step": span / n_steps,
        "kernel_busy_ms_per_step": busy_ms / n_steps,
        "idle_share": (max(0.0, 1.0 - busy_ms / span) if busy_ms
                       else None),
        "attention_ms_per_step": attn_ms / n_steps,
        "top_kernels_ms": [[k[:90], round(t / 1e3, 4), c]
                           for k, (t, c) in top],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
    pools = llama.init_serving_pages(cfg, 1 + S * PPS, PS)
    g = torch.Generator(device="cuda").manual_seed(1)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    for name, make in (("decode_block", _decode_block),
                       ("mixed_tick", _mixed_tick)):
        step, n = make(params, cfg, pools)
        print(json.dumps(profile(name, step, n)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
