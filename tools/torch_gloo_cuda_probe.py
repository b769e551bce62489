#!/usr/bin/env python3
"""Which ``torch.distributed`` ops gloo runs on CUDA tensors, and whether
NCCL takes two ranks on one card.

The port's collective API (``paddle_tpu_torch/distributed/
communication.py``) calls each backend's own op, but sends gloo's
point-to-point messages of CUDA tensors through host copies and builds
``alltoall`` from ``all_to_all_single``. This probe tries each
native op on CUDA tensors of two ranks sharing ``cuda:0`` over gloo
(f32, and bf16 for ``all_reduce``), and then an NCCL world of two ranks
on the same card, and prints one JSON line an op::

    python3 tools/torch_gloo_cuda_probe.py

Each op runs in a world of its own (gloo aborts the process on some
ops it cannot run on device memory); a rank catches an op's Python
error to report it, and a world whose ranks die reports their exit
codes. The process groups time out after 60 s.
"""
from __future__ import annotations

import datetime
import json
import os
import shutil
import sys

import torch
import torch.distributed as dist


def _try(name, fn, out):
    try:
        fn()
        torch.cuda.synchronize()
        out[name] = "ok"
    except Exception as e:      # the probe reports what each op does
        out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _ops(rank, dev):
    x = torch.ones(8, device=dev) * (rank + 1)

    def p2p():
        if rank == 0:
            dist.send(x, 1)
        else:
            dist.recv(torch.empty_like(x), 0)

    return {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "all_reduce_bf16": lambda: dist.all_reduce(x.to(torch.bfloat16)),
        "broadcast": lambda: dist.broadcast(x.clone(), 0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(2)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(4, device=dev), x),
        "reduce_scatter": lambda: dist.reduce_scatter(
            torch.empty(4, device=dev), list(x.chunk(2))),
        "reduce_scatter_bf16": lambda: dist.reduce_scatter(
            torch.empty(4, device=dev, dtype=torch.bfloat16),
            list(x.to(torch.bfloat16).chunk(2))),
        "all_gather_bf16": lambda: dist.all_gather(
            [torch.empty_like(x, dtype=torch.bfloat16) for _ in range(2)],
            x.to(torch.bfloat16)),
        "reduce": lambda: dist.reduce(x.clone(), 0),
        "gather": lambda: dist.gather(
            x, [torch.empty_like(x) for _ in range(2)] if rank == 0
            else None, 0),
        "scatter": lambda: dist.scatter(
            torch.empty_like(x), list(x.repeat(2).chunk(2)) if rank == 0
            else None, 0),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "all_to_all": lambda: dist.all_to_all(
            [torch.empty(4, device=dev) for _ in range(2)],
            list(x.chunk(2))),
        "send_recv": p2p,
        "barrier": dist.barrier,
    }


OPS = list(_ops(0, "cpu"))


def gloo_rank(path: str, op: str) -> dict:
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=60))
    out = {}
    _try(op, _ops(rank, torch.device("cuda", 0))[op], out)
    dist.destroy_process_group()
    return out


def nccl_rank(path: str, op: str) -> dict:
    rank = int(os.environ["RANK"])
    torch.cuda.set_device(0)
    out = {}

    def run():
        dist.init_process_group("nccl", init_method=f"file://{path}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        dist.all_reduce(torch.ones(8, device="cuda:0"))
    _try("nccl_two_ranks_one_card", run, out)
    return out


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from paddle_tpu_torch.distributed.spawn import spawn
    import tempfile
    if not torch.cuda.is_available():
        print("torch_gloo_cuda_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__,
                      "card": torch.cuda.get_device_name(0),
                      "cards": torch.cuda.device_count()}), flush=True)
    from paddle_tpu_torch.distributed.spawn import SpawnError
    for fn, op in [(gloo_rank, op) for op in OPS] + [
            (nccl_rank, "nccl_two_ranks_one_card")]:
        d = tempfile.mkdtemp()
        try:
            res = spawn(fn, (os.path.join(d, "store"), op), nprocs=2,
                        timeout_s=120)
            got = {f"rank{r}": res[r][op] for r in range(2)}
        except SpawnError as e:     # a rank died: report how
            got = {"died": " | ".join(
                ln for ln in str(e).splitlines()
                if "exit code" in ln or "Error" in ln)[:400]}
        shutil.rmtree(d, ignore_errors=True)
        print(json.dumps({"backend": fn.__name__[:-5], "op": op, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
