#!/usr/bin/env python3
"""Where a train step of the PyTorch port spends its time on the card.

Runs a train step of the port (forward with per-layer remat, backward,
AdamW) on one NVIDIA GPU, bf16, seeded random weights, B 1, T 2048:
``--model llama3_8b`` (default) is ``models.llama`` at the full
Llama-3-8B width and depth; ``--model qwen2_moe`` is ``models.qwen2_moe``
with ``moe_impl="dropless"`` at Qwen1.5-MoE-A2.7B's width and
``chip_smoke.QWEN_LAYERS`` layers. Prints one JSON line: the host time
of the step and of its three parts (forward, backward, optimizer; each
ends in a synchronize), the device span of the step (CUDA events), the
summed device time of its kernels from ``torch.profiler`` (and so the
device's idle share of the span), that time by kernel family (the
port's grouped-matmul, flash-attention, RMSNorm and RoPE kernels, GEMMs,
everything else), the top kernels, and the card's name and power limit
as ``nvidia-smi`` reports them.

    python3 tools/torch_train_profile.py [--model qwen2_moe] [--layers N]
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from chip_smoke import QWEN_LAYERS, nvidia_smi_line  # noqa: E402
from chip_smoke import kernel_times as _kernel_times  # noqa: E402
from paddle_tpu_torch.models import llama, qwen2_moe  # noqa: E402
from paddle_tpu_torch.ops.kernels import _build  # noqa: E402

B, T = 1, 2048
FAMILIES = (
    # gmm_wgmma_kernel and gmm_f32_kernel name tgmm's kernels too
    ("grouped_matmul", ("gmm_wgmma_kernel", "gmm_f32_kernel")),
    ("flash_attention", ("fa_fwd_kernel", "fa_bwd_dq_kernel",
                         "fa_bwd_dkv_kernel")),
    ("rms_norm", ("rms_fwd_kernel", "rms_bwd_kernel", "rms_dw_sum_kernel")),
    ("rope", ("rope_kernel",)),
    ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("llama3_8b", "qwen2_moe"),
                    default="llama3_8b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut depth (default: llama3_8b's 32 layers, "
                         f"qwen2_moe's {QWEN_LAYERS})")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build()
    if args.model == "qwen2_moe":
        model = qwen2_moe
        cfg = qwen2_moe.Qwen2MoeConfig(moe_impl="dropless",
                                       num_hidden_layers=QWEN_LAYERS)
    else:
        model = llama
        cfg = llama.LlamaConfig.llama3_8b()
    if args.layers:
        cfg.num_hidden_layers = args.layers
    opt = llama.default_train_optimizer()
    step, init = model.make_train_step(cfg, optimizer=opt)
    state = init(torch.Generator(device="cuda").manual_seed(0))
    batch = model.make_batch(cfg, B, T)
    for _ in range(2):                                 # warm-up
        state, _ = step(state, batch)
    torch.cuda.synchronize()

    parts = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        parts[name] = (time.perf_counter() - t0) * 1e3
        return out

    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    loss = timed("forward_ms", lambda: model.loss_fn(state["params"], batch,
                                                     cfg))
    timed("backward_ms", loss.backward)
    timed("optimizer_ms", lambda: opt.update_(state["params"], state["opt"]))
    b.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    span_ms = a.elapsed_time(b)

    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kern = _kernel_times(prof)
    busy_ms = sum(t for t, _ in kern.values()) / 1e3
    fams = {}
    for k, (t, _) in kern.items():
        f = family(k)
        fams[f] = fams.get(f, 0.0) + t / 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
        "model": args.model, "layers": cfg.num_hidden_layers, "batch": B,
        "seq_len": T, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "host_ms_per_step": host_ms, **parts,
        "device_span_ms_per_step": span_ms,
        "kernel_busy_ms_per_step": busy_ms,
        "idle_share": max(0.0, 1.0 - busy_ms / span_ms),
        "busy_ms_by_family": {k: round(v, 3) for k, v in
                              sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms": [[k[:90], round(t / 1e3, 3), c]
                           for k, (t, c) in top],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
