#!/usr/bin/env python3
"""Where a serving tick of the PyTorch port spends its time on the card.

Runs ``paddle_tpu_torch.models.llama`` serving ticks at the full
Llama-3-8B width and depth (bf16, seeded random weights) on one NVIDIA
GPU and prints one JSON line per scenario:

* ``decode_block``: ``serving_tick_block`` with 8 live slots over ~300
  cached tokens each, 4 fused steps (the engine's pure-decode tick);
* ``mixed_tick``: ``serving_tick`` with 8 decode rows plus a 256-token
  prefill span behind a 128-token cached prefix (an admission tick);
* ``paged_decode_bf16`` / ``paged_decode_int8``: one ``generate_paged``
  decode step (``_decode_paged_step``) at ``bench.py``'s mix (32 streams
  of 64-2016 prompt tokens, page 32, the first tail slot), with bf16
  weights and with ``quantize_for_decode`` weights.

For each: host wall time per model step (ends in a synchronize), the
device span of the step measured with CUDA events, the summed device
time of its kernels from ``torch.profiler`` (and so the device's idle
share of the span), the attention kernels' share (ragged or paged), the
int8 matmul kernel's share, and the top kernels by device time.

``--model qwen2_moe`` runs the default ``Qwen2MoeConfig()`` (the widths
of Qwen1.5-MoE-A2.7B, 24 layers, bf16) instead: ``decode_block`` and
``mixed_tick`` as above with bf16 weights, then ``decode_block_int8``
and ``mixed_tick_int8`` with ``quantize_for_decode`` weights. Each line
adds the device time of the routed MoE FFN (``moe_ffn``), of its
einsums (the dispatch, the three expert products and the combine) and of
the int8 experts' dequantization (``_dense_w``), and their shares of the
busy time; the two model functions are wrapped in profiler ranges by
this script only.

    python3 tools/torch_serving_profile.py [--model llama|qwen2_moe]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from paddle_tpu_torch.models import llama, qwen2_moe  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402

S, PS, PPS = 8, 16, 34


def _tables():
    return torch.arange(1, 1 + S * PPS, dtype=torch.int32,
                        device="cuda").reshape(S, PPS)


def _module(cfg):
    return qwen2_moe if hasattr(cfg, "num_experts") else llama


def _decode_block(params, cfg, pools):
    tok = torch.randint(0, cfg.vocab_size, (S,), dtype=torch.int32,
                        device="cuda")
    lengths = torch.full((S,), 300, dtype=torch.int32, device="cuda")
    tables = _tables()

    def step():
        _module(cfg).serving_tick_block(params, tok, lengths, tables,
                                        pools["k_pages"], pools["v_pages"],
                                        cfg, num_steps=4)
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
        _module(cfg).serving_tick(params, tok, meta, pools["k_pages"],
                                  pools["v_pages"], cfg)
    return step, 1


def _paged_decode(params, cfg):
    """A decode step of generate_paged from one prefill of the bench mix;
    every call attends the prompt pages plus the first tail slot."""
    import chip_smoke
    prompt, lens = chip_smoke.bench_mix(cfg.vocab_size)
    logits, cache = llama.prefill_paged(params, prompt, lens, cfg,
                                        chip_smoke.BENCH_NEW,
                                        chip_smoke.PAGED_BENCH["ps"])
    tok = logits.argmax(-1)

    def step():
        cache["n_tail"] = 0
        llama._decode_paged_step(params, tok, cache, cfg)
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


# host ranges whose device time is reported (Qwen2-MoE): their key in the
# profiler's averages
MOE_RANGES = {"moe_ffn": "qwen2_moe.moe_ffn", "einsum": "aten::einsum",
              "dequant": "qwen2_moe.dequant_experts"}


def _ranged(fn, label):
    def wrapped(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return wrapped


def _range_ms(prof, key):
    """Device ms of the kernels launched under the host range ``key``
    (its children included), or None when the profiler shows none."""
    from torch.autograd import DeviceType
    total = 0.0
    for it in prof.key_averages():
        if it.key != key or it.device_type != DeviceType.CPU:
            continue
        t = getattr(it, "device_time_total", None)
        total += float(it.cuda_time_total if t is None else t)
    return total / 1e3 if total else None


def profile(name, step, n_steps, reps=3, ranges=None):
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
    # the ranges' GPU-side annotations span their kernels and the gaps
    # between them: not kernels
    kern = {k: v for k, v in _kernel_times(prof).items()
            if k not in (ranges or {}).values()}
    busy_ms = sum(t for t, _ in kern.values()) / 1e3
    attn_ms = sum(t for k, (t, _) in kern.items()
                  if "decode_attention_kernel" in k) / 1e3
    int8_ms = sum(t for k, (t, _) in kern.items()
                  if "int8_mm_" in k) / 1e3
    span = float(np.median(spans))
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    extra = {}
    for label, key in (ranges or {}).items():
        ms = _range_ms(prof, key)
        extra[f"{label}_ms_per_step"] = (None if ms is None
                                         else ms / n_steps)
        extra[f"{label}_share_of_busy"] = (None if ms is None or not busy_ms
                                           else ms / busy_ms)
    return {
        "scenario": name, "model_steps": n_steps,
        "host_ms_per_step": float(np.median(walls)) / n_steps,
        "device_span_ms_per_step": span / n_steps,
        "kernel_busy_ms_per_step": busy_ms / n_steps,
        "idle_share": (max(0.0, 1.0 - busy_ms / span) if busy_ms
                       else None),
        "attention_ms_per_step": attn_ms / n_steps,
        "int8_matmul_ms_per_step": int8_ms / n_steps,
        "top_kernels_ms": [[k[:90], round(t / 1e3, 4), c]
                           for k, (t, c) in top],
        **extra,
    }


def qwen_main() -> int:
    """bf16 then int8 ticks of the default Qwen2MoeConfig()."""
    from paddle_tpu_torch.quantization import quantize_for_decode
    cfg = qwen2_moe.Qwen2MoeConfig()
    params = qwen2_moe.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0))
    pools = qwen2_moe.init_serving_pages(cfg, 1 + S * PPS, PS)
    g = torch.Generator(device="cuda").manual_seed(1)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    qwen2_moe.moe_ffn = _ranged(qwen2_moe.moe_ffn, MOE_RANGES["moe_ffn"])
    qwen2_moe._dense_w = _ranged(qwen2_moe._dense_w, MOE_RANGES["dequant"])
    for tag, p in (("", params), ("_int8", quantize_for_decode(params,
                                                                cfg))):
        for name, make in (("decode_block", _decode_block),
                           ("mixed_tick", _mixed_tick)):
            step, n = make(p, cfg, pools)
            print(json.dumps(dict(profile(name + tag, step, n,
                                          ranges=MOE_RANGES),
                                  model="qwen2_moe")), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=("llama", "qwen2_moe"),
                    default="llama")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_serving_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    if args.model == "qwen2_moe":
        return qwen_main()
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
    del pools, step
    torch.cuda.empty_cache()
    from paddle_tpu_torch.quantization import quantize_for_decode
    for name, p in (("paged_decode_bf16", params),
                    ("paged_decode_int8", quantize_for_decode(params, cfg))):
        step, n = _paged_decode(p, cfg)
        print(json.dumps(profile(name, step, n)), flush=True)
        del step, p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
