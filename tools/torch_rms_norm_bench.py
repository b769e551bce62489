#!/usr/bin/env python3
"""Time the port's RMSNorm backward kernel (bf16) on one NVIDIA GPU with
``chip_smoke.time_ms`` (median of 20 launches, each after a 256 MiB L2
flush), at N 2048 and D 2560 (``bench.py``'s deep model), 4096
(llama3_8b) and 8192 (the widest it takes), and at the deep model's
N 16384 (B 8 x T 2048), D 2560: the kernel's, the plain version's and
``F.rms_norm``'s backward's ms, and the bytes bound. Beside them, as a
yardstick of what the card's memory path gives for the same traffic (two
reads and one write of N x D bf16), ``torch.add(x, g, out=dx)``.

Prints one JSON line per shape, then one with the card's name and power
limit. ``--root DIR`` imports ``paddle_tpu_torch`` from another checkout
(an older commit unpacked with ``git archive``), so two versions are
compared on one card in one run; its kernels build into that checkout's
own ``build/kernels``. The timing code is always this checkout's.
``--variants`` then also builds and times copies of this checkout's
``csrc/fused_rms_norm.cu`` with one design constant changed (``VARIANTS``:
a 3-stage ring; 8-warp blocks, two resident an SM), one JSON line per
variant and shape (bf16 only: an 8-warp block cannot hold an f32 row of
8192).

    python3 tools/torch_rms_norm_bench.py [--root DIR] [--variants]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SHAPES = ((2048, 2560), (2048, 4096), (2048, 8192), (16384, 2560))
# name: the source's text -> the variant's, each found exactly once
VARIANTS = {
    "stages3": (("constexpr int kStages = 2;",
                 "constexpr int kStages = 3;"),),
    "warps8": (("constexpr int kBwdWarps = 16;",
                "constexpr int kBwdWarps = 8;"),
               ("__launch_bounds__(kBwdWarps * 32, 1)",
                "__launch_bounds__(kBwdWarps * 32, 2)")),
}


def variant_times(smoke, gen) -> None:
    """Build each of ``VARIANTS`` beside the kernels and time its bf16
    backward at ``SHAPES`` in place of the package's library."""
    import ctypes
    import subprocess
    from paddle_tpu_torch.ops.kernels import _build
    src = (_build.CSRC / "fused_rms_norm.cu").read_text()
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        cu = _build.BUILD_DIR / f"fused_rms_norm_{name}.cu"
        cu.write_text(text)
        lib = cu.with_suffix(".so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                        str(_build.CSRC), "-o", str(lib), str(cu)],
                       check=True, capture_output=True)
        _build._loaded["fused_rms_norm"] = ctypes.CDLL(str(lib))
        for N, D in SHAPES:
            ms, _, _ = smoke.rms_bwd_times(N, D, gen)
            print(json.dumps({"variant": name, "N": N, "D": D, "ms": ms}),
                  flush=True)
    del _build._loaded["fused_rms_norm"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    # the package under test from --root; chip_smoke from this checkout,
    # by path (--root has one of its own)
    sys.path.insert(0, str(args.root.resolve()))
    import importlib.util
    import torch
    if not torch.cuda.is_available():
        print("torch_rms_norm_bench: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    assert Path(nr.__file__).resolve().is_relative_to(args.root.resolve())
    gen = torch.Generator(device="cuda").manual_seed(30)
    for N, D in SHAPES:
        ms, plain, lib = smoke.rms_bwd_times(N, D, gen)
        nbytes = 3 * N * D * 2 + D * 2 + N * 4 + D * 4
        a = smoke._randn((N, D), gen).bfloat16()
        b = smoke._randn((N, D), gen).bfloat16()
        o = torch.empty_like(a)
        add_ms = smoke.time_ms(lambda: torch.add(a, b, out=o))
        del a, b, o
        print(json.dumps({"N": N, "D": D, "ms": ms, "plain_ms": plain,
                          "library_ms": lib, "add_ms": add_ms,
                          "bound_ms": nbytes / smoke.H100_BYTES_PER_S * 1e3,
                          "bound_by": "bytes"}), flush=True)
    if args.variants:
        variant_times(smoke, gen)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smoke.nvidia_smi_line(),
                      "root": str(args.root)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
