"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, under
``build/kernels/`` at the repository root (listed in ``.gitignore``),
and loaded with ``ctypes``. The library's file name carries a digest of
the source, of every shared header ``csrc/*.cuh`` and of the flags, so
an edited source or header builds anew and an unchanged one is reused.
``build`` starts one ``nvcc`` per source, all at once, and waits for
them together. ``tile_counters`` holds the zeroed int32 counters with
which the int8 and decode-attention kernels find the last block of a
tile.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "BUILD_DIR", "build", "load", "tile_counters"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
KERNELS = ("ragged_paged_attention", "flash_attention", "fused_rms_norm",
           "fused_rope", "paged_attention", "int8_matmul", "grouped_matmul",
           "conv_epilogue")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}
# Per (device, stream): counters that start at zero and that every launch
# using them leaves zero. Launches on one stream run in order, so one
# buffer serves all of them; two streams would mix their counts (a tile's
# combine could be skipped), so each stream has its own buffer.
_counters: Dict[tuple, "torch.Tensor"] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = KERNELS) -> Dict[str, Path]:
    """Compile every named kernel not built yet, one ``nvcc`` process
    per source, all started together. Returns ``{name: library}``;
    raises with the compiler's output when a build fails. Each build's
    compiler output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        Path(str(target) + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _loaded[name] = lib
    return lib


def tile_counters(dev, stream: int, n: int):
    """At least ``n`` zeroed int32 counters on ``dev`` for launches on
    ``stream`` (``torch.cuda.current_stream().cuda_stream``)."""
    import torch
    buf = _counters.get((dev, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=dev)
        _counters[(dev, stream)] = buf
    return buf
