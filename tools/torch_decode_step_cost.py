#!/usr/bin/env python3
"""Host time of one eager paged decode step of ``llama3_8b`` on one
NVIDIA GPU, bf16 and int8 weights, for one or more checkouts of the repo.

``models.llama._decode_paged_step`` (``generate_paged``'s step) at
``bench.py``'s paged mix (32 prompts of 64-2016 tokens, page 32, 16 new
tokens, ``chip_smoke.bench_mix``) on random weights from seed 0 at
published widths (``--layers`` deep). From one prefill, ``--rounds``
rounds of the 15 decode steps (each step a greedy pick, as phase 8 of
``chip_smoke.py`` times them) after a dropped first round; the host ms of
a step ends in a synchronize. The decode step is host-bound, so this is
the time a user of the eager path waits.

Each checkout (``--trees``) runs in a process of its own, importing its
own package and building its own kernels on first use, in the order
``--order`` gives (default A B B A for two trees), so two versions are
compared within one call on one card. Host load on the card's machine
moves a run's median by up to ±25 %, so beside the whole step the
script times, in its own process and alternating, the two ways a step
can write its token into the dense tail: with a Python-int slot (a
slice write, ``kt[:, n] = k[:, 0]``) and with a 0-d int32 tensor slot
(``kt.index_copy_(1, n.reshape(1).long(), k)``), each with the tail's
live mask (``arange(Nt) < n``), 2 writes and one mask a layer for 32
layers at the bench mix's tail shape: host µs a step, median of
``--reps`` alternating pairs, each ending in a synchronize.

Prints one JSON line: each run's median and quartiles, whether every run
picked the same tokens, the tail writes' µs, and the card's name and
power limit as ``nvidia-smi`` reports them.

    python3 tools/torch_decode_step_cost.py [--trees . OTHER]
        [--order 0 1 1 0] [--rounds 3] [--layers 32] [--reps 200]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _worker(root: str, rounds: int, layers: int) -> dict:
    import torch
    sys.path.insert(0, str(Path(root).resolve()))
    import chip_smoke as cs
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.quantization import quantize_for_decode
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(),
                              num_hidden_layers=layers)
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
    prompt, lens = cs.bench_mix(cfg.vocab_size)
    out = {"package": str(Path(llama.__file__).resolve().parents[1])}
    for tag, p in (("bf16", params),
                   ("int8", quantize_for_decode(params, cfg))):
        logits, cache = llama.prefill_paged(p, prompt, lens, cfg,
                                            cs.BENCH_NEW,
                                            cs.PAGED_BENCH["ps"])
        tok0, n0 = logits.argmax(-1), cache["n_tail"]
        times, toks = [], []
        for r in range(rounds + 1):
            cache["n_tail"], tok, toks = n0, tok0, []
            for _ in range(cs.BENCH_NEW - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tok = llama._decode_paged_step(p, tok, cache, cfg).argmax(-1)
                torch.cuda.synchronize()
                if r:
                    times.append((time.perf_counter() - t0) * 1e3)
                toks.append(tok)
        q1, med, q3 = np.percentile(times, (25, 50, 75))
        out[tag] = dict(median_ms=float(med), q1_ms=float(q1),
                        q3_ms=float(q3), steps=len(times),
                        tokens=torch.stack(toks, 1).cpu().tolist())
        del p, cache, logits
    return out


def _tail_writes(reps: int) -> dict:
    import torch
    L, B, Nt, Hkv, Dh = 32, 32, 16, 8, 128
    kt = torch.zeros((B, Nt, Hkv, Dh), dtype=torch.bfloat16, device="cuda")
    k = torch.randn((B, 1, Hkv, Dh), device="cuda").to(torch.bfloat16)
    slot = 3
    n_t = torch.full((), slot, dtype=torch.int32, device="cuda")

    def with_int():
        for _ in range(L):
            kt[:, slot] = k[:, 0]
            kt[:, slot] = k[:, 0]
            torch.arange(Nt, device="cuda") < slot + 1

    def with_tensor():
        at, n1 = n_t.reshape(1).long(), n_t + 1
        for _ in range(L):
            kt.index_copy_(1, at, k)
            kt.index_copy_(1, at, k)
            torch.arange(Nt, device="cuda") < n1

    out = {"int": [], "tensor": []}
    for i in range(reps + 1):
        for way, fn in ((("int", with_int), ("tensor", with_tensor))
                        if i % 2 else (("tensor", with_tensor),
                                       ("int", with_int))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                out[way].append((time.perf_counter() - t0) * 1e6)
    return {f"{w}_us": float(np.median(v)) for w, v in out.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[str(ROOT)])
    ap.add_argument("--order", nargs="+", type=int, default=None)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker is not None:
        print(json.dumps(_worker(args.worker, args.rounds, args.layers)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_decode_step_cost: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from chip_smoke import nvidia_smi_line
    tail = _tail_writes(args.reps)
    order = args.order or ([0, 1, 1, 0] if len(args.trees) == 2 else [0])
    runs = []
    for i in order:
        res = subprocess.run(
            [sys.executable, __file__, "--worker", args.trees[i],
             "--rounds", str(args.rounds), "--layers", str(args.layers)],
            capture_output=True, text=True, check=False)
        if res.returncode:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        rec = json.loads(res.stdout.strip().splitlines()[-1])
        rec["tree"] = args.trees[i]
        runs.append(rec)
    same = all(r[t]["tokens"] == runs[0][t]["tokens"]
               for r in runs for t in ("bf16", "int8"))
    for r in runs:
        for t in ("bf16", "int8"):
            del r[t]["tokens"]
    print(json.dumps(dict(card=nvidia_smi_line(), layers=args.layers,
                          rounds=args.rounds, tokens_equal=same,
                          tail_writes=tail, runs=runs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
