#!/usr/bin/env python3
"""Time the port's conv-epilogue kernel (``matmul_bias_act``, bf16) at
ResNet-50's twelve 1x1 shapes on one NVIDIA GPU: ``chip_smoke.
conv_epilogue_times`` (kernel, plain and library ms cold-L2, bound, host
µs a call) at B 8 or, with ``--batch 128``, sixteen times the rows. Prints
one JSON line per shape, then one with the sums over a forward's 33 sites
and the card's name and power limit.

``--root DIR`` imports ``paddle_tpu_torch`` from another checkout (an
older commit unpacked with ``git archive``), so two versions are compared
on one card in one run; its kernels build into that checkout's own
``build/kernels``. The timing code is always this checkout's.

    python3 tools/torch_conv_epilogue_bench.py [--root DIR] [--batch 8]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--batch", type=int, default=8, choices=(8, 128))
    args = ap.parse_args()
    # the package under test from --root; chip_smoke from this checkout,
    # by path (--root has one of its own)
    sys.path.insert(0, str(args.root.resolve()))
    import importlib.util
    import torch
    if not torch.cuda.is_available():
        print("torch_conv_epilogue_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    assert Path(ce.__file__).resolve().is_relative_to(args.root.resolve())
    torch.backends.cuda.matmul.allow_tf32 = False
    times = smoke.conv_epilogue_times(batch=args.batch)
    for name, t in times["shapes"].items():
        print(json.dumps({"shape": name, **t}), flush=True)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "nvidia_smi": smoke.nvidia_smi_line(), "root": str(args.root),
        "batch": args.batch, "library": times["library"],
        "sites": sum(smoke.RESNET_B8_SITES.values()),
        **{f"sum_{k}": v for k, v in times["per_forward"].items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
