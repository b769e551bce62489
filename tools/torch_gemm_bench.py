#!/usr/bin/env python3
"""Time the port's grouped-matmul and int8 kernels (bf16) at the main
path's shapes on one NVIDIA GPU, with ``chip_smoke.time_ms`` (median of
20 launches, each after a 256 MiB L2 flush):

* ``gmm``: ``chip_smoke.gmm_times`` — gmm forward and dlhs and tgmm at
  the Qwen1.5-MoE-A2.7B dropless layer (uniform routing), gate/up and
  down shapes: kernel, plain and library (``torch._grouped_mm``) ms and
  the bound;
* ``int8``: the int8 kernel and cuBLAS bf16 on the dequantized weight at
  llama3_8b's five weight shapes for M = 1, 8, 32, 256 and 4096, and the
  sums over a layer's seven projections plus lm_head at M = 32 (a decode
  step), 256 and 4096 (prefill's shapes), with their bounds.

Prints one JSON line per case and per sum, then one with the card's name
and power limit. ``--root DIR`` imports ``paddle_tpu_torch`` from another
checkout (an older commit unpacked with ``git archive``), so two versions
are compared on one card in one run; its kernels build into that
checkout's own ``build/kernels``. The timing code is always this
checkout's.

    python3 tools/torch_gemm_bench.py [--root DIR] [--only gmm|int8]
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
# a layer's seven projections and lm_head, by weight shape
STEP_COUNT = {"wq_wo": 2, "wk_wv": 2, "gate_up": 2, "down": 1, "lm_head": 1}


def int8_times(smoke) -> list:
    import torch
    from paddle_tpu_torch.ops.fused.int8_matmul import (
        quantize_weight_per_channel)
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    rows, times = [], {}
    for i, (name, (K, N)) in enumerate(smoke.INT8_SHAPES.items()):
        gen = torch.Generator(device="cuda").manual_seed(40 + i)
        w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
        q, s = quantize_weight_per_channel(w.to(torch.bfloat16))
        wb = (q.float() * s).to(torch.bfloat16)
        del w
        x = torch.randn((max(smoke.INT8_MS), K), generator=gen,
                        device="cuda").to(torch.bfloat16)
        for m in smoke.INT8_MS:
            xm = x[:m].contiguous()
            bound, by = smoke.int8_bound_ms(m, K, N)
            t = dict(ms=smoke.time_ms(lambda: int8_matmul(xm, q, s,
                                                          "kernel")),
                     library_ms=smoke.time_ms(lambda: xm @ wb),
                     bound_ms=bound, bound_by=by)
            times[(name, m)] = t
            rows.append({"int8": name, "K": K, "N": N, "M": m, **t})
        del q, s, wb, x
        torch.cuda.empty_cache()
    for m in (32, 256, 4096):
        rows.append({"int8_step_sum": m, **{
            key: sum(n * times[(s, m)][key] for s, n in STEP_COUNT.items())
            for key in ("ms", "library_ms", "bound_ms")}})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--only", choices=("gmm", "int8"), default=None)
    args = ap.parse_args()
    # the package under test from --root; chip_smoke from this checkout,
    # by path (--root has one of its own)
    sys.path.insert(0, str(args.root.resolve()))
    import importlib.util
    import torch
    if not torch.cuda.is_available():
        print("torch_gemm_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gm
    assert Path(gm.__file__).resolve().is_relative_to(args.root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.only in (None, "gmm"):
        times = smoke.gmm_times()
        for name, t in times.items():
            if name != "library":
                print(json.dumps({"gmm": name, "library": times["library"],
                                  **t}), flush=True)
    if args.only in (None, "int8"):
        for row in int8_times(smoke):
            print(json.dumps(row), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.nvidia_smi_line(),
                      "root": str(args.root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
