#!/usr/bin/env python3
"""Read the port's flash kernels' non-causal errors on one NVIDIA GPU at
the context-parallel ring's three hop shapes (``chip_smoke.CP_HOPS``:
(2048, 2048), (1024, 1024), (1024, 2048), llama3_8b's 32 / 8 heads of
128) over several seeds, with ``chip_smoke.check_flash(causal=False)``:
the f32 kernel against the f64 evaluation (``o/f32`` ...), the plain
version's own f32 evaluation against f64 (``o/f32_plain_f32`` ...), and
the bf16 kernel against the plain version and f64. The readings set the
per-shape bounds of ``chip_smoke.CP_NONCAUSAL_BOUNDS``.

Prints one JSON line per (shape, seed), then one per shape with the
largest reading of each metric over the seeds, then one with the card's
name and power limit.

    python3 tools/torch_flash_noncausal_ulps.py [--seeds 260 261 ...]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=list(range(260, 268)))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import torch
    if not torch.cuda.is_available():
        print("torch_flash_noncausal_ulps: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as smoke
    from paddle_tpu_torch.ops.kernels import _build
    _build.build(["flash_attention"])
    for name, (T, S) in smoke.CP_HOPS.items():
        worst = {}
        for seed in args.seeds:
            errs = {f"{a}/{b}": v for (a, b), v in smoke.check_flash(
                T, S, seed=seed, causal=False).items()}
            print(json.dumps({"shape": name, "T": T, "S": S, "seed": seed,
                              **errs}), flush=True)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
        print(json.dumps({"shape": name, "T": T, "S": S,
                          "seeds": len(args.seeds), "max": worst}),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.nvidia_smi_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
