#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA H100
and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises; nothing is caught):

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: every CUDA kernel of the path from ``paddle_tpu_torch/csrc``;
3. the ragged paged-attention kernel against its plain PyTorch version
   on the card, at the Llama-3-8B attention geometry (H 32, Hkv 8,
   Dh 128, page 16): (a) a serving mix of prefill spans, decode rows and
   padding tokens, (b) long-context decode over 16,384-token tables,
   (c) empty slots, shuffled tables and NaN in the trash page and in
   stale page rows, (d) the serving phase's mixed tick at the engine's
   own geometry (8 slots, 34 pages a slot, 273 pages). The f32 kernel is held to TILED_ULP_BOUND ulps at
   row scale against the plain version evaluated in f64 on the same
   inputs; the bf16 kernel to ``BF16_PLAIN_ULPS`` against the bf16 plain
   version and to ``BF16_EXACT_ULPS`` against the f64 evaluation on the
   same bf16 values; row invariance is checked bitwise. Kernel, plain-version and
   ``scaled_dot_product_attention`` (yardstick only) times are printed;
4. serving: ``ServingEngine`` on ``llama3_8b`` at full width and depth,
   bf16, seeded random weights; 16 staggered requests (two pairs share
   a 256-token prefix); every request must complete with its token
   count, and the kernel's launch count must equal layers x model steps.
   One mixed tick runs with ``attn_impl="kernel"`` and ``"reference"``
   and their logits are compared; the engine's greedy tokens are
   compared with the port's ``generate()`` for three requests
   (reported, not required: cuBLAS does not promise row invariance
   across batch shapes);
5. the train-step kernels against their plain versions at the
   Llama-3-8B training geometry (B 1, T 2048, H 32, Hkv 8, Dh 128,
   D 4096): flash attention forward and dq/dk/dv (T = S = 2048, S > T,
   and T = S not a multiple of 64), RMSNorm forward, dx and dw, RoPE
   forward and backward at theta 500000. As in phase 3, f32 kernels are
   held to the plain version evaluated in f64 on the same (pre-scaled)
   inputs and bf16 kernels to the bf16 plain version and to the f64
   evaluation on the same bf16 values, each to the bound stated beside
   it; two backward launches must give bitwise equal dq, dk, dv and dw.
   Kernel, plain-version and library-call times are printed;
6. training: ``make_train_step`` on ``llama3_8b`` at full width and
   depth (32 layers, bf16, seeded random weights, AdamW state in bf16),
   B 1, T 2048, ``TRAIN_STEPS`` steps on one fixed batch. Every kernel's
   launch count must equal its per-step formula times the steps, the
   loss must be finite and fall, and the first step's loss must agree
   with the plain versions' loss on the same state within
   ``TRAIN_LOSS_REL``. Step ms, tokens/s, MFU (``bench.py``'s
   accounting) and peak memory are printed.

The last two lines of standard output are the card's name and power
limit, then ``{"ok": true, "device": {...}}``; the line before them is
the kernels' JSON record. Exits non-zero without those lines when CUDA
is not available.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# bf16 kernel vs the bf16 plain version, in bf16 ulps at each packed
# row's output scale: the plain version rounds the scores, the
# probabilities, the PV product and the denominator to bf16 (the JAX
# package's rounding points) where the kernel keeps f32; each rounding
# is half an ulp of its operand, and the score rounding is amplified by
# |score| inside exp, so a few ulps separate the two. 8 leaves room.
BF16_PLAIN_ULPS = 8
# bf16 kernel vs the plain version evaluated in f64 on the same bf16
# values (q pre-scaled and rounded as the kernel does): only the
# kernel's f32 arithmetic and its final rounding to bf16 (half an ulp of
# the element) separate them.
BF16_EXACT_ULPS = 1
# one serving tick through 32 bf16 layers with random weights, kernel
# vs plain attention: max |dlogit| relative to the largest logit of the
# live rows. The per-layer attention difference (a few bf16 ulps, see
# above) is amplified through the random residual stack: measured 0.060
# on an H100 80GB HBM3 (700 W) with this script; the bound leaves 1.7x.
# The kernel itself is held to the ulp bounds above on the same tick's
# geometry (case d); this check covers the tick around it.
LOGITS_REL_TOL = 0.1
TRAIN_STEPS = 4
# first train step's loss (kernels) vs the plain versions' loss on the
# same state, relative: the plain flash attention rounds scores,
# probabilities and PV to bf16 where the kernel keeps f32, and 32 random
# layers carry that difference to the logits; the loss averages 2048
# tokens' cross entropy. Measured 6.5e-6 on an H100 80GB HBM3 (700 W)
# with this script; the bound leaves two orders of magnitude.
TRAIN_LOSS_REL = 1e-3
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM, 700 W)
H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak (SXM)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# ragged paged-attention cases
# ---------------------------------------------------------------------------

def make_case(slots, *, H, Hkv, Dh, ps, pps, n_pad=0, shuffle=False,
              nan_garbage=False, seed=0, device="cuda"):
    """A packed ragged-attention batch: ``slots`` is ``[(q_len, kv_len)]``
    per slot (q_len 0 = empty slot, 1 = decode row, >1 = prefill span
    ending at kv_len). Decode rows sit at their slot index in the first
    S stream positions (padding where a slot has none), spans follow,
    then ``n_pad`` padding tokens. Returns f32 tensors on ``device``."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    S = len(slots)
    P = 1 + S * pps
    ids = rng.permutation(np.arange(1, P)) if shuffle else np.arange(1, P)
    tables = ids.reshape(S, pps).astype(np.int32)
    q_len = np.asarray([s[0] for s in slots], np.int32)
    kv_len = np.asarray([s[1] for s in slots], np.int32)
    kp = torch.randn((Hkv, P, ps, Dh), generator=g, device=device)
    vp = torch.randn((Hkv, P, ps, Dh), generator=g, device=device)
    for s in range(S):
        covered = -(-int(kv_len[s]) // ps)
        tables[s, covered:] = 0                     # trash past the span
        if nan_garbage and kv_len[s] % ps:
            page = tables[s, kv_len[s] // ps]       # stale rows of a page
            kp[:, page, kv_len[s] % ps:] = float("nan")
            vp[:, page, kv_len[s] % ps:] = float("nan")
    if nan_garbage:
        kp[:, 0] = float("nan")
        vp[:, 0] = float("nan")
    tok_slot = [s if q_len[s] == 1 else S for s in range(S)]
    tok_qoff = [0] * S
    for s in range(S):
        if q_len[s] > 1:
            tok_slot += [s] * int(q_len[s])
            tok_qoff += list(range(int(q_len[s])))
    tok_slot += [S] * n_pad
    tok_qoff += [0] * n_pad
    T = len(tok_slot)
    q = torch.randn((T, H, Dh), generator=g, device=device)

    def i32(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return dict(q=q, k_pages=kp, v_pages=vp, tok_slot=i32(tok_slot),
                tok_qoff=i32(tok_qoff), q_len=i32(q_len),
                kv_len=i32(kv_len), tables=i32(tables))


def cast(case, dtype):
    return {k: (v.to(dtype) if v.is_floating_point() else v)
            for k, v in case.items()}


def live_keys(case) -> np.ndarray:
    """Keys each packed row attends (0 for padding / empty rows)."""
    ts = case["tok_slot"].cpu().numpy()
    qo = case["tok_qoff"].cpu().numpy()
    ql = case["q_len"].cpu().numpy()
    kl = case["kv_len"].cpu().numpy()
    S = ql.size
    sl = np.minimum(ts, S - 1)
    n = kl[sl] - ql[sl] + qo + 1
    return np.where((ts < S) & (qo < ql[sl]), np.maximum(n, 0), 0)


def attention_bound_ms(case) -> tuple:
    """Least time the card could take for the packed attention of this
    case: each input read once (q, the live K/V keys of every slot, the
    metadata), the output written once; operations = 4·H·Dh per
    (row, live key) pair (QK and PV), at the bf16 tensor-core peak."""
    q, kp = case["q"], case["k_pages"]
    T, H, Dh = q.shape
    Hkv = kp.shape[0]
    es = q.element_size()
    keys = live_keys(case)
    slots = case["tok_slot"].cpu().numpy()
    kl = case["kv_len"].cpu().numpy()
    S = kl.size
    live_slots = {int(s) for s, k in zip(slots, keys) if s < S and k > 0}
    kv_bytes = sum(int(kl[s]) for s in live_slots) * Hkv * Dh * es * 2
    meta = 4 * (2 * T + 2 * S + case["tables"].numel())
    nbytes = 2 * T * H * Dh * es + kv_bytes + meta
    flops = 4.0 * float(keys.sum()) * H * Dh
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def run_rpa(case, impl, **kw):
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        ragged_paged_attention_packed)
    return ragged_paged_attention_packed(
        case["q"], case["k_pages"], case["v_pages"], case["tok_slot"],
        case["tok_qoff"], case["q_len"], case["kv_len"], case["tables"],
        impl=impl, **kw)


def check_case(name, case) -> dict:
    """Kernel vs plain version on the card, f32 and bf16; padding rows
    must be exact zeros, outputs finite. Returns the measured errors."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        TILED_ULP_BOUND, tiled_ulp_error)
    pad = torch.as_tensor(live_keys(case) == 0, device=case["q"].device)
    out = {}
    k32 = run_rpa(case, "kernel")
    p32 = run_rpa(case, "reference")
    p64 = run_rpa(cast(case, torch.float64), "reference")
    torch.cuda.synchronize()
    assert torch.isfinite(k32).all(), f"{name}: non-finite f32 output"
    assert not k32[pad].any(), f"{name}: padding rows not zero (f32)"
    f32_eps = torch.finfo(torch.float32).eps
    out["f32_ulps"] = tiled_ulp_error(k32, p64, eps=f32_eps)
    out["f32_plain_ulps"] = tiled_ulp_error(p32, p64, eps=f32_eps)
    out["f32_vs_plain_f32_ulps"] = tiled_ulp_error(k32, p32)
    assert out["f32_ulps"] <= TILED_ULP_BOUND, (name, out)

    c16 = cast(case, torch.bfloat16)
    k16 = run_rpa(c16, "kernel")
    p16 = run_rpa(c16, "reference")
    assert torch.isfinite(k16).all(), f"{name}: non-finite bf16 output"
    assert not k16[pad].any(), f"{name}: padding rows not zero (bf16)"
    out["bf16_vs_plain_ulps"] = tiled_ulp_error(k16, p16)
    out["bf16_max_abs_err"] = float((k16.float() - p16.float()).abs().max())
    scale = 1.0 / math.sqrt(case["q"].shape[-1])
    c64 = cast(c16, torch.float64)
    c64["q"] = (c16["q"] * scale).to(torch.bfloat16).double()
    exact = run_rpa(c64, "reference", sm_scale=1.0)
    out["bf16_vs_exact_ulps"] = tiled_ulp_error(
        k16, exact, eps=torch.finfo(torch.bfloat16).eps)
    assert out["bf16_vs_plain_ulps"] <= BF16_PLAIN_ULPS, (name, out)
    assert out["bf16_vs_exact_ulps"] <= BF16_EXACT_ULPS, (name, out)
    return out


def check_row_invariance(case, split_slot: int, split: int) -> None:
    """Bitwise: (1) every slot's rows computed with only that slot in
    the stream equal its rows in the mixed batch; (2) slot
    ``split_slot``'s span attended as two chunks (split after ``split``
    rows) equals the whole span."""
    c = cast(case, torch.bfloat16)
    mixed = run_rpa(c, "kernel")
    ts = c["tok_slot"]
    S = c["q_len"].numel()
    for s in range(S):
        rows = (ts == s).nonzero().flatten()
        if rows.numel() == 0:
            continue
        alone = run_rpa(dict(c, q=c["q"][rows].contiguous(),
                             tok_slot=ts[rows].contiguous(),
                             tok_qoff=c["tok_qoff"][rows].contiguous()),
                        "kernel")
        assert torch.equal(alone, mixed[rows]), f"slot {s} not invariant"
    rows = (ts == split_slot).nonzero().flatten()
    ql = int(c["q_len"][split_slot])
    kl = int(c["kv_len"][split_slot])
    for lo, hi in ((0, split), (split, ql)):
        q_len = c["q_len"].clone()
        kv_len = c["kv_len"].clone()
        q_len[split_slot] = hi - lo
        kv_len[split_slot] = kl - ql + hi
        part = run_rpa(dict(c, q=c["q"][rows[lo:hi]].contiguous(),
                            tok_slot=ts[rows[lo:hi]].contiguous(),
                            tok_qoff=c["tok_qoff"][rows[lo:hi]] - lo,
                            q_len=q_len, kv_len=kv_len), "kernel")
        assert torch.equal(part, mixed[rows[lo:hi]]), \
            f"chunk {lo}:{hi} of slot {split_slot} differs from the span"


def time_ms(fn, reps: int = 20) -> float:
    """Median device time of ``fn`` in ms: CUDA events around each call,
    with a 256 MiB write between calls so every call starts with a cold
    L2 (as each layer's pools do in the engine)."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def sdpa_yardstick(case):
    """A closure timing ``scaled_dot_product_attention`` on the same
    attention: q scattered slot-major, each slot's pages gathered dense
    and repeated to H heads, the bottom-right causal + kv_len mask as a
    boolean ``attn_mask`` (none when every key is visible). Setup is
    outside the closure; the port never calls SDPA."""
    import torch.nn.functional as F
    q, kp, vp = case["q"], case["k_pages"], case["v_pages"]
    T, H, Dh = q.shape
    Hkv, _, ps, _ = kp.shape
    S, pps = case["tables"].shape
    ql = case["q_len"].long()
    kl = case["kv_len"].long()
    ts = case["tok_slot"].long()
    qo = case["tok_qoff"].long()
    Tq = max(int(ql.max()), 1)
    real = ts < S
    qs = q.new_zeros((S, Tq, H, Dh))
    qs[ts[real], qo[real]] = q[real]
    qs = qs.transpose(1, 2).contiguous()                  # [S, H, Tq, Dh]
    tab = case["tables"].long()
    k = kp[:, tab].reshape(Hkv, S, pps * ps, Dh).transpose(0, 1)
    v = vp[:, tab].reshape(Hkv, S, pps * ps, Dh).transpose(0, 1)
    k = k.repeat_interleave(H // Hkv, dim=1).contiguous()
    v = v.repeat_interleave(H // Hkv, dim=1).contiguous()
    t = torch.arange(Tq, device=q.device)[None, :, None]
    kidx = torch.arange(pps * ps, device=q.device)[None, None, :]
    mask = ((t < ql[:, None, None])
            & (kidx <= (kl - ql)[:, None, None] + t)
            & (kidx < kl[:, None, None]))[:, None]
    if bool(mask.all()):
        mask = None
    return lambda: F.scaled_dot_product_attention(qs, k, v,
                                                  attn_mask=mask)


# 8B attention geometry
GEOM = dict(H=32, Hkv=8, Dh=128, ps=16)
CASE_A = dict(slots=[(64, 64), (173, 941), (300, 1021), (1, 1), (1, 77),
                     (1, 513), (1, 1000), (1, 1024)], pps=64, n_pad=3)
CASE_B = dict(slots=[(1, 16384)] * 4, pps=1024)
CASE_C = dict(slots=[(5, 5), (0, 0), (1, 17), (3, 40), (0, 0), (1, 16)],
              pps=4, n_pad=2, shuffle=True, nan_garbage=True)
# one engine tick at the serving phase's geometry (8 slots, 34 pages of
# 16 a slot): slots 0-2 decode over 300/77/500 cached tokens, slot 3
# prefills 200 tokens behind a 64-token cached prefix, slot 4 a whole
# 90-token prompt, slots 5-7 idle
TICK_S, TICK_PPS = 8, 34
TICK_DECODE = {0: 300, 1: 77, 2: 500}
TICK_SPANS = [(3, 64, 200), (4, 0, 90)]          # (slot, start, take)


def _tick_slots():
    slots = [(0, 0)] * TICK_S
    for s, n in TICK_DECODE.items():
        slots[s] = (1, n + 1)
    for s, start, take in TICK_SPANS:
        slots[s] = (take, start + take)
    return slots


CASE_D = dict(slots=_tick_slots(), pps=TICK_PPS)


def kernel_phase() -> dict:
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    rec = {}
    for name, spec in (("a_serving_mix", CASE_A), ("b_long_context", CASE_B),
                       ("c_degenerate", CASE_C), ("d_engine_tick", CASE_D)):
        case = make_case(**spec, **GEOM, seed=len(rec))
        errs = check_case(name, case)
        log(f"kernel case {name}: " + " ".join(
            f"{k}={v:.4g}" for k, v in errs.items()))
        rec[name] = dict(errs)
        if name in ("a_serving_mix", "b_long_context"):
            c16 = cast(case, torch.bfloat16)
            ms = time_ms(lambda: run_rpa(c16, "kernel"))
            plain_ms = time_ms(lambda: run_rpa(c16, "reference"), reps=5)
            lib_ms = time_ms(sdpa_yardstick(c16))
            bound, by = attention_bound_ms(c16)
            rec[name].update(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=bound, bound_by=by)
            log(f"kernel case {name} bf16: kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound "
                f"{bound:.4f} ms ({by})")
        if name == "a_serving_mix":
            check_row_invariance(case, split_slot=2, split=120)
            log("kernel row invariance: per-slot and chunked == whole, "
                "bitwise")
        del case
        torch.cuda.empty_cache()
    rpa.ragged_paged_attention_packed.launches = 0
    return rec


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(vocab: int, seed: int = 0):
    """16 requests with prompts of 32-512 tokens and 8-32 new tokens;
    requests 5 and 11 share a 256-token prefix with requests 4 and 10."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, vocab, size=int(n)).astype(np.int32)
               for n in rng.randint(32, 513, size=16)]
    for a, b in ((4, 5), (10, 11)):
        prefix = rng.randint(0, vocab, 256).astype(np.int32)
        prompts[a] = np.concatenate(
            [prefix, rng.randint(0, vocab, 64).astype(np.int32)])
        prompts[b] = np.concatenate(
            [prefix, rng.randint(0, vocab, 100).astype(np.int32)])
    return prompts, [int(n) for n in rng.randint(8, 33, size=16)]


def serving_phase() -> dict:
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ServingEngine

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = llama.init_params(cfg, gen)
    torch.cuda.synchronize()
    log(f"serving: llama3_8b params initialised in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    L = cfg.num_hidden_layers
    eng = ServingEngine(params, cfg, max_batch=8, page_size=16,
                        max_prompt_len=512, max_new_tokens_cap=32,
                        prefill_chunk=256, decode_block_size=4)
    prompts, new = _requests(cfg.vocab_size)
    # warm-up request (allocator, cuBLAS handles), outside the counts
    eng.generate(np.arange(1, 41, dtype=np.int32), 4)
    steps0 = eng.stats()["counters"]["model_steps"]
    ticks0 = eng.stats()["counters"]["ticks"]

    rpa.ragged_paged_attention_packed.launches = 0
    t0 = time.perf_counter()
    handles = {}
    for i, (p, n) in enumerate(zip(prompts, new)):
        if i in (5, 11):
            # the prefix's owner must have finished its prefill (pages
            # registered) before its sharer arrives
            first = handles[i - 1]
            while not first.tokens_so_far and first.status != "completed":
                time.sleep(0.002)
        handles[i] = eng.submit(p, n)
        time.sleep(0.02)
    outs = {i: h.result(timeout=600) for i, h in handles.items()}
    wall = time.perf_counter() - t0
    launches = rpa.ragged_paged_attention_packed.launches
    snap = eng.stats()
    eng.close()
    c = snap["counters"]
    steps = c["model_steps"] - steps0
    ticks = c["ticks"] - ticks0
    for i, n in enumerate(new):
        assert outs[i].shape == (n,), (i, outs[i].shape, n)
        assert ((outs[i] >= 0) & (outs[i] < cfg.vocab_size)).all()
    assert launches == L * steps, (launches, L, steps)
    assert c["prefix_hits"] >= 2, c
    ttft = [handles[i].ttft_s for i in handles]
    tokens = sum(new)
    log(f"serving on {torch.cuda.get_device_name(0)}: {len(outs)} "
        f"requests, {tokens} tokens in {wall:.3f} s "
        f"= {tokens / wall:.1f} tok/s; mean TTFT {np.mean(ttft):.4f} s; "
        f"{ticks} ticks, {steps} model steps, {launches} kernel launches "
        f"(= {L} layers x {steps}); prefix hits {c['prefix_hits']}")

    # one mixed tick, kernel vs plain attention, same weights and pools
    S, ps, pps = TICK_S, 16, TICK_PPS
    pools = llama.init_serving_pages(cfg, 1 + S * pps, ps)
    g = torch.Generator(device="cuda").manual_seed(1)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    rng = np.random.RandomState(0)
    tok, meta = llama.pack_tick(
        [(s, rng.randint(cfg.vocab_size), n)
         for s, n in TICK_DECODE.items()],
        [(s, rng.randint(0, cfg.vocab_size, take), start)
         for s, start, take in TICK_SPANS],
        np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps), ps,
        "cuda")
    res = {}
    for impl in ("kernel", "reference"):
        kp, vp = (t.clone() for t in pools.values())
        res[impl] = llama.serving_tick(params, tok, meta, kp, vp, cfg,
                                       attn_impl=impl)
    live = meta["q_len"] > 0
    n_live = len(TICK_DECODE) + len(TICK_SPANS)
    lk, lr = res["kernel"][1][live], res["reference"][1][live]
    assert torch.isfinite(lk).all() and lk.shape == (n_live, cfg.vocab_size)
    diff = float((lk - lr).abs().max())
    scale = float(lr.abs().max())
    same = int((res["kernel"][0] == res["reference"][0])[live].sum())
    assert diff <= LOGITS_REL_TOL * scale, (diff, scale)
    log(f"serving tick kernel vs reference: max |dlogit| {diff:.4g} "
        f"(logit scale {scale:.4g}, bound {LOGITS_REL_TOL} x scale), "
        f"greedy tokens equal on {same}/{n_live} live slots")

    agree = []
    for i in (0, 5, 9):
        ref = llama.generate(params, prompts[i][None], cfg, new[i])
        ref = ref[0, prompts[i].size:].cpu().numpy()
        agree.append((int((ref == outs[i]).sum()), new[i],
                      int(np.argmax(ref != outs[i])) if (ref != outs[i])
                      .any() else new[i]))
    log("serving vs port generate(): " + ", ".join(
        f"request {i}: {a}/{n} tokens equal, first difference at {d}"
        for i, (a, n, d) in zip((0, 5, 9), agree)))
    return dict(launches=launches, tok_s=tokens / wall,
                mean_ttft_s=float(np.mean(ttft)), ticks=ticks,
                model_steps=steps, logits_max_abs_diff=diff)


# ---------------------------------------------------------------------------
# train-step kernels: flash attention, RMSNorm, RoPE
# ---------------------------------------------------------------------------

# Bounds of the train-step kernels, in ulps of the dtype at each row's
# output scale (``tiled_ulp_error`` over rows of Dh for attention and
# RoPE, of D for RMSNorm; dw is one row; dq is measured per head, over
# all T rows: a causal row that sees few keys has a dq near 0 made of
# dS terms that cancel (row 0 at S = T sees one key and its exact dq is
# 0), so its error is no fraction of its own size: at their own rows'
# scale the first card runs read 6.8 and 53 bf16 ulps from f64 on such
# rows, for two seeds). Keys: (kernel output, check).
#   f32:   the f32 kernel vs the plain version evaluated in f64 on the same
#          (pre-scaled) inputs;
#   plain: the bf16 kernel vs the bf16 plain version;
#   exact: the bf16 kernel vs the f64 evaluation on the same bf16 values.
TRAIN_BOUNDS = {
    # forward: f32 online softmax and f32 sums over 64-key tiles, as the
    # ragged kernel (whose bound this is); bf16 as phase 3: the plain
    # version rounds scores, p and PV to bf16, the kernel only its output
    ("o", "f32"): 16, ("o", "plain"): 8, ("o", "exact"): 1,
    # backward: dS = p (dP - delta) cancels, and dq sums dS k over up to
    # 2048 keys, dk and dv sum over the G = 4 heads' 2048 rows each (the
    # plain version's own f32 evaluation reads 24-43 ulps from f64 here).
    # bf16: the plain backward rounds dP, dS and every product to bf16,
    # the kernel only its outputs, as in the forward
    ("dq", "f32"): 32, ("dq", "plain"): 8, ("dq", "exact"): 1,
    ("dk", "f32"): 64, ("dk", "plain"): 8, ("dk", "exact"): 1,
    ("dv", "f32"): 64, ("dv", "plain"): 8, ("dv", "exact"): 1,
    # RMSNorm: one f32 row reduction and an elementwise pass; the bf16
    # plain version computes in f32 and rounds once, as the kernel does
    ("y", "f32"): 4, ("y", "plain"): 1, ("y", "exact"): 1,
    ("dx", "f32"): 4, ("dx", "plain"): 1, ("dx", "exact"): 1,
    # dw sums 2048 rows in f32 (chunks of 16, then the chunks in order)
    ("dw", "f32"): 16, ("dw", "plain"): 16, ("dw", "exact"): 16,
    # RoPE: the same f32 angle on both sides (expf/logf of the same
    # inputs), cosf / sinf within 2 ulps, two products and a sum
    ("rope", "f32"): 4, ("rope", "plain"): 1, ("rope", "exact"): 1,
    # rotation by +p then -p: cos^2 + sin^2 = 1 to f32 rounding, plus one
    # rounding per rotation in bf16
    ("rope_inverse", "f32"): 4, ("rope_inverse", "bf16"): 2,
}
F32_EPS = torch.finfo(torch.float32).eps
BF16_EPS = torch.finfo(torch.bfloat16).eps
TRAIN_GEOM = dict(H=32, Hkv=8, Dh=128, D=4096, theta=500000.0)
# flash cases: (T, S); S > T has the bottom-right offset, 1000 is not a
# multiple of the 64-row tile
FLASH_CASES = {"t2048": (2048, 2048), "s_gt_t": (1500, 2048),
               "t1000": (1000, 1000)}


def row_ulps(got, ref, width: int, eps: float) -> float:
    """Max error in ``eps`` units at each row's scale, rows of ``width``."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        tiled_ulp_error)
    return tiled_ulp_error(got.reshape(-1, width), ref.reshape(-1, width),
                           eps=eps)


def check_bounds(name: str, errs: dict) -> None:
    bad = {k: v for k, v in errs.items()
           if k in TRAIN_BOUNDS and not v <= TRAIN_BOUNDS[k]}
    assert not bad, (name, {k: (v, TRAIN_BOUNDS[k]) for k, v in bad.items()})


def _randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _flash_run(q, k, v, do, impl, scale):
    """o and (dq, dk, dv) of flash attention on pre-scaled q (sm_scale
    1), the gradient reported for the unscaled q (x scale)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if impl == "kernel":
        o = flash_attention(*leaves, causal=True, sm_scale=scale,
                            impl="kernel")
        grads = torch.autograd.grad(o, leaves, do)
        return (o.detach(),) + tuple(grads)
    qs = (leaves[0] * scale).to(q.dtype)   # as the kernel pre-scales
    o = flash_attention(qs, leaves[1], leaves[2], causal=True, sm_scale=1.0,
                        impl="reference")
    dqs, dk, dv = torch.autograd.grad(o, (qs, leaves[1], leaves[2]), do)
    return o.detach(), dqs * scale, dk, dv


def _errs(names, got, f64, plain, widths):
    """f32 or bf16 error entries of one set of outputs; ``widths`` gives
    each output's row width."""
    out = {}
    bf16 = got[0].dtype == torch.bfloat16
    for n, a, e, p, width in zip(names, got, f64, plain, widths):
        assert torch.isfinite(a).all(), f"{n}: non-finite kernel output"
        if bf16:
            out[(n, "plain")] = row_ulps(a, p, width, BF16_EPS)
            out[(n, "exact")] = row_ulps(a, e, width, BF16_EPS)
            out[(n, "max_abs_err")] = float((a.float() - p.float()).abs()
                                            .max())
        else:
            out[(n, "f32")] = row_ulps(a, e, width, F32_EPS)
            out[(n, "f32_plain_f32")] = row_ulps(p, e, width, F32_EPS)
    return out


def check_flash(T: int, S: int, seed: int) -> dict:
    """Flash attention forward and backward, f32 and bf16, at the 8B
    attention geometry; determinism of the backward (bitwise)."""
    gm = TRAIN_GEOM
    H, Hkv, Dh = gm["H"], gm["Hkv"], gm["Dh"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((1, T, H, Dh), gen)
    k = _randn((1, S, Hkv, Dh), gen)
    v = _randn((1, S, Hkv, Dh), gen)
    do = _randn((1, T, H, Dh), gen)
    scale = 1.0 / math.sqrt(Dh)
    names = ("o", "dq", "dk", "dv")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v, do)]
        got = _flash_run(*ins, "kernel", scale)
        if dt == torch.bfloat16:
            again = _flash_run(*ins, "kernel", scale)
            for n, a, b in zip(names[1:], got[1:], again[1:]):
                assert torch.equal(a, b), f"flash {n} not deterministic"
            del again
        plain = _flash_run(*ins, "reference", scale)
        # the f64 evaluation on the same values, q pre-scaled as the
        # kernel rounds it
        qs = (ins[0].float() * scale).to(dt).double()
        f64 = _flash_run(qs, *(t.double() for t in ins[1:]), "reference",
                         1.0)
        f64 = (f64[0], f64[1] * scale) + f64[2:]
        # dq is measured per head (rows of T x Dh), see TRAIN_BOUNDS
        got, plain, f64 = ((x[0], x[1].transpose(1, 2).contiguous())
                           + tuple(x[2:]) for x in (got, plain, f64))
        errs.update(_errs(names, got, f64, plain, (Dh, T * Dh, Dh, Dh)))
        del got, plain, f64
    torch.cuda.empty_cache()
    return errs


def check_rms_norm(seed: int = 10) -> dict:
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    D = TRAIN_GEOM["D"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = _randn((2048, D), gen, 2.0)
    w = 1.0 + _randn((D,), gen, 0.1)
    g = _randn((2048, D), gen)
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
        y, r = nr.rms_norm_fwd(xd, wd, 1e-5, "kernel")
        dx, dw = nr.rms_norm_bwd(xd, wd, r, gd, "kernel")
        py, _ = nr.rms_norm_fwd(xd, wd, 1e-5, "reference")
        pdx, pdw = nr.rms_norm_bwd(xd, wd, r, gd, "reference")
        ey, er = nr.rms_norm_fwd(xd.double(), wd.double(), 1e-5,
                                 "reference")
        edx, edw = nr.rms_norm_bwd(xd.double(), wd.double(), er,
                                   gd.double(), "reference")
        errs.update(_errs(("y", "dx"), (y, dx), (ey, edx), (py, pdx),
                          (D, D)))
        # dw is f32 whatever the input type: counted in f32 ulps
        tag = "f32" if dt == torch.float32 else "plain"
        errs[("dw", tag)] = row_ulps(dw, pdw if tag == "plain" else edw, D,
                                     F32_EPS)
        if dt == torch.bfloat16:
            errs[("dw", "exact")] = row_ulps(dw, edw, D, F32_EPS)
            dx2, dw2 = nr.rms_norm_bwd(xd, wd, r, gd, "kernel")
            assert torch.equal(dx, dx2) and torch.equal(dw, dw2), \
                "rms_norm backward not deterministic"
    return errs


def check_rope(seed: int = 11) -> dict:
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    gm = TRAIN_GEOM
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((1, 2048, gm["H"], gm["Dh"]), gen)
    k = _randn((1, 2048, gm["Hkv"], gm["Dh"]), gen)
    pos = torch.arange(2048, dtype=torch.int32, device="cuda")[None]
    th = gm["theta"]
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        qd, kd = q.to(dt), k.to(dt)
        got = nr.rope_rotate(qd, kd, pos, th, "kernel")
        plain = nr.rope_rotate(qd, kd, pos, th, "reference")
        f64 = nr.rope_rotate(qd.double(), kd.double(), pos, th, "reference")
        e = _errs(("rope_q", "rope_k"), got, f64, plain,
                  (gm["Dh"], gm["Dh"]))
        for tag in ("f32", "plain", "exact", "max_abs_err"):
            if ("rope_q", tag) in e:
                errs[("rope", tag)] = max(e[("rope_q", tag)],
                                          e[("rope_k", tag)])
        back = nr.rope_rotate(*got, -pos, th, "kernel")
        eps = F32_EPS if dt == torch.float32 else BF16_EPS
        errs[("rope_inverse", "f32" if dt == torch.float32 else "bf16")] = \
            max(row_ulps(b, a, gm["Dh"], eps)
                for a, b in zip((qd, kd), back))
    return errs


def train_kernel_bounds() -> dict:
    """Least time of each train-step kernel at the smoke's bf16 shapes
    (T = S = 2048): bytes (each input read once, each output written once)
    over 3.35 TB/s against operations over the bf16 peak."""
    gm = TRAIN_GEOM
    T, H, Hkv, Dh, D = 2048, gm["H"], gm["Hkv"], gm["Dh"], gm["D"]
    pairs = H * T * (T + 1) / 2           # visible (query, key) pairs
    qb, kb, st = T * H * Dh * 2, T * Hkv * Dh * 2, H * T * 4

    def bound(nbytes, flops):
        tb = nbytes / H100_BYTES_PER_S * 1e3
        to = flops / H100_BF16_FLOPS * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations")

    return {
        # QK and PV: 2 flops per multiply-add, Dh of each per pair
        "flash_attention_fwd": bound(2 * qb + 2 * kb + st, 4 * Dh * pairs),
        # recomputed scores, dP and dq
        "flash_attention_bwd_dq": bound(3 * qb + 2 * kb + 2 * st,
                                        6 * Dh * pairs),
        # recomputed scores, dP, dV and dK
        "flash_attention_bwd_dkv": bound(2 * qb + 4 * kb + 2 * st,
                                         8 * Dh * pairs),
        "fused_rms_norm_fwd": bound(2 * T * D * 2 + D * 2 + T * 4,
                                    4 * T * D),
        "fused_rms_norm_bwd": bound(3 * T * D * 2 + D * 2 + T * 4 + D * 4,
                                    10 * T * D),
        "fused_rope": bound(2 * (qb + kb) + T * 4, 6 * T * (H + Hkv) * Dh),
    }


def train_kernel_times() -> dict:
    """bf16 kernel, plain-version and library times (ms) at T = S = 2048.
    Library calls (yardsticks only; the port calls none of them):
    ``scaled_dot_product_attention`` causal with GQA, forward and its
    backward; ``F.rms_norm``, forward and its backward; RoPE has none."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    gm = TRAIN_GEOM
    H, Hkv, Dh, D = gm["H"], gm["Hkv"], gm["Dh"], gm["D"]
    T = 2048
    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(20)
    q = _randn((1, T, H, Dh), gen).to(bf)
    k = _randn((1, T, Hkv, Dh), gen).to(bf)
    v = _randn((1, T, Hkv, Dh), gen).to(bf)
    do = _randn((1, T, H, Dh), gen).to(bf)
    scale = 1.0 / math.sqrt(Dh)
    out = {}
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True, scale)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    po = fa._dense_reference(*leaves, True, scale)
    pgrad = lambda: torch.autograd.grad(po, leaves, do, retain_graph=True)
    tq, tk, tv, tdo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sl = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    so = F.scaled_dot_product_attention(*sl, is_causal=True,
                                        enable_gqa=True)
    with torch.no_grad():
        out["flash_attention_fwd"] = (
            time_ms(lambda: fa.flash_attention_fwd(q, k, v, True, scale)),
            time_ms(lambda: fa._dense_reference(q, k, v, True, scale),
                    reps=5),
            time_ms(lambda: F.scaled_dot_product_attention(
                tq, tk, tv, is_causal=True, enable_gqa=True)))
    plain_bwd = time_ms(pgrad, reps=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(so, sl, tdo,
                                                  retain_graph=True))
    out["flash_attention_bwd_dq"] = (
        time_ms(lambda: fa.flash_attention_bwd_dq(q, k, v, o, do, lse, True,
                                                  scale)),
        plain_bwd, lib_bwd)
    out["flash_attention_bwd_dkv"] = (
        time_ms(lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta,
                                                   True, scale)),
        plain_bwd, lib_bwd)
    del po, so, leaves, sl
    x = _randn((T, D), gen, 2.0).to(bf)
    w = (1.0 + _randn((D,), gen, 0.1)).to(bf)
    g = _randn((T, D), gen).to(bf)
    _, r = nr.rms_norm_fwd(x, w, 1e-5, "kernel")
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    ly = F.rms_norm(xl, (D,), wl, 1e-5)
    with torch.no_grad():
        out["fused_rms_norm_fwd"] = (
            time_ms(lambda: nr.rms_norm_fwd(x, w, 1e-5, "kernel")),
            time_ms(lambda: nr.rms_norm_fwd(x, w, 1e-5, "reference")),
            time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)))
        out["fused_rms_norm_bwd"] = (
            time_ms(lambda: nr.rms_norm_bwd(x, w, r, g, "kernel")),
            time_ms(lambda: nr.rms_norm_bwd(x, w, r, g, "reference")),
            None)
    out["fused_rms_norm_bwd"] = out["fused_rms_norm_bwd"][:2] + (time_ms(
        lambda: torch.autograd.grad(ly, (xl, wl), g, retain_graph=True)),)
    pos = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    th = gm["theta"]
    out["fused_rope"] = (
        time_ms(lambda: nr.rope_rotate(q, k, pos, th, "kernel")),
        time_ms(lambda: nr.rope_rotate(q, k, pos, th, "reference")),
        None)
    torch.cuda.empty_cache()
    return out


TRAIN_KERNELS = (
    # name, source, the TPU kernel it replaces
    ("flash_attention_fwd", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:83"),
    ("flash_attention_bwd_dq", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:83"),
    ("flash_attention_bwd_dkv", "paddle_tpu_torch/csrc/flash_attention.cu",
     "paddle_tpu/ops/pallas/flash_attention.py:83"),
    ("fused_rms_norm_fwd", "paddle_tpu_torch/csrc/fused_rms_norm.cu",
     "paddle_tpu/ops/pallas/fused_norm_rope.py:127"),
    ("fused_rms_norm_bwd", "paddle_tpu_torch/csrc/fused_rms_norm.cu",
     "paddle_tpu/ops/pallas/fused_norm_rope.py:136"),
    ("fused_rope", "paddle_tpu_torch/csrc/fused_rope.cu",
     "paddle_tpu/ops/pallas/fused_norm_rope.py:45"),
)


def train_kernel_phase() -> dict:
    """All train-kernel comparisons and timings; every error must be
    within ``TRAIN_BOUNDS``. Returns per-kernel records."""
    errs = {}
    for name, (T, S) in FLASH_CASES.items():
        e = check_flash(T, S, seed=len(errs))
        log(f"flash case {name} (T={T}, S={S}): " + " ".join(
            f"{a}/{b}={v:.4g}" for (a, b), v in e.items()))
        check_bounds(f"flash {name}", e)
        errs[name] = e
    log("flash backward: two launches bitwise equal (dq, dk, dv)")
    for name, fn in (("rms_norm", check_rms_norm), ("rope", check_rope)):
        e = fn()
        log(f"{name}: " + " ".join(f"{a}/{b}={v:.4g}"
                                   for (a, b), v in e.items()))
        check_bounds(name, e)
        errs[name] = e
    log("rms_norm backward: two launches bitwise equal (dx, dw)")
    times = train_kernel_times()
    bounds = train_kernel_bounds()
    fe, re, pe = errs["t2048"], errs["rms_norm"], errs["rope"]
    max_err = {
        "flash_attention_fwd": fe[("o", "max_abs_err")],
        "flash_attention_bwd_dq": fe[("dq", "max_abs_err")],
        "flash_attention_bwd_dkv": max(fe[("dk", "max_abs_err")],
                                       fe[("dv", "max_abs_err")]),
        "fused_rms_norm_fwd": re[("y", "max_abs_err")],
        "fused_rms_norm_bwd": re[("dx", "max_abs_err")],
        "fused_rope": pe[("rope", "max_abs_err")],
    }
    rec = {}
    for name, _, _ in TRAIN_KERNELS:
        ms, plain_ms, lib_ms = times[name]
        b, by = bounds[name]
        rec[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b, bound_by=by, max_abs_err=max_err[name])
        log(f"kernel {name} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{b:.4f} ms ({by}), max |err| vs plain {max_err[name]:.4g}")
    return rec


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_launches() -> dict:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    return {"flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv,
            "fused_rms_norm_fwd": nr.rms_norm_fwd,
            "fused_rms_norm_bwd": nr.rms_norm_bwd,
            "fused_rope": nr.rope_rotate}


def per_step_launches(L: int) -> dict:
    """Launches of each kernel in one train step with per-layer remat:
    every layer's forward runs twice (forward, recompute), its backward
    once; the final norm is outside the remat."""
    return {"flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L, "fused_rms_norm_fwd": 4 * L + 1,
            "fused_rms_norm_bwd": 2 * L + 1, "fused_rope": 3 * L}


def count_params(cfg) -> int:
    """``bench.py``'s parameter count (embeddings, lm_head, projections;
    norms excluded)."""
    D, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    H, Hkv, Dh, Fi = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim, cfg.intermediate_size)
    return V * D * 2 + L * (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
                            + 3 * D * Fi)


def train_phase(num_layers=None) -> dict:
    import dataclasses
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_8b()
    if num_layers is not None:
        cfg.num_hidden_layers = num_layers
    L, B, T = cfg.num_hidden_layers, 1, 2048
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, init = llama.make_train_step(cfg)
    state = init(torch.Generator(device="cuda").manual_seed(0))
    batch = llama.make_batch(cfg, B, T)
    torch.cuda.synchronize()
    log(f"train: llama3_8b ({L} layers) state initialised in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    plain_cfg = dataclasses.replace(cfg, use_flash_attention="reference",
                                    use_fused_norm_rope="reference")
    with torch.no_grad():
        plain_loss = float(llama.loss_fn(state["params"], batch, plain_cfg))
    counters = train_launches()
    for fn in counters.values():
        fn.launches = 0
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, loss = step(state, batch)
        losses.append(float(loss))          # synchronises
        times.append(time.perf_counter() - t1)
    launches = {n: fn.launches for n, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {n: c * TRAIN_STEPS for n, c in per_step_launches(L).items()}
    assert launches == want, (launches, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    assert rel <= TRAIN_LOSS_REL, (losses[0], plain_loss, rel)
    dt = float(np.median(times[1:]))
    flops = (6 * count_params(cfg) + 6 * L * cfg.hidden_size * T) * B * T
    mfu = flops / dt / H100_BF16_FLOPS
    log(f"train on {torch.cuda.get_device_name(0)}: losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; plain versions' loss on the same state {plain_loss:.6f} "
        f"(relative difference {rel:.3g}, bound {TRAIN_LOSS_REL}); step "
        f"{dt * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0] * 1e3:.1f} ms), {B * T / dt:.1f} tokens/s, MFU "
        f"{mfu:.4f} of {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches per step "
        + ", ".join(f"{n}={c // TRAIN_STEPS}" for n, c in launches.items()))
    return dict(launches=launches, losses=losses, plain_loss=plain_loss,
                step_ms=dt * 1e3, tokens_per_s=B * T / dt, mfu=mfu,
                peak_gib=peak / 2 ** 30)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build

    smi = nvidia_smi_line()
    log(f"env: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}, "
        f"nvidia-smi: {smi}")
    # the references are exact f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    libs = _build.build()
    log(f"build: {len(libs)} kernel(s) in {time.perf_counter() - t0:.1f} s")
    for name, path in libs.items():
        for ln in Path(str(path) + ".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"ptxas {name}: {ln.strip()}")

    rec = kernel_phase()
    train_rec = train_kernel_phase()
    serving = serving_phase()
    torch.cuda.empty_cache()
    train = train_phase()

    a = rec["a_serving_mix"]
    kernels = [{
        "name": "ragged_paged_attention",
        "route": "cuda",
        "source": "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "paddle_tpu/ops/pallas/ragged_paged_attention.py:301",
        "launches": serving["launches"],
        "max_abs_err": a["bf16_max_abs_err"],
        "ms": a["ms"],
        "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"],
        "bound_by": a["bound_by"],
        "library_ms": a["library_ms"],
    }]
    for name, source, replaces in TRAIN_KERNELS:
        r = train_rec[name]
        kernels.append(dict(name=name, route="cuda", source=source,
                            replaces=replaces,
                            launches=train["launches"][name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
