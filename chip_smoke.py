#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths (Llama-3-8B with sampling and
speculative decoding, Qwen2-MoE), training paths (Llama-3-8B, Qwen2-MoE
dropless training) and ResNet-50 inference on one NVIDIA H100 and check
them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failed check raises; nothing is caught):

1. environment: Python, torch and CUDA versions, and the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build: every CUDA kernel of the path from ``paddle_tpu_torch/csrc``,
   with each kernel's registers and spills as ptxas reports them; the
   bf16 flash-attention kernels' SASS must hold HGMMA, the bf16 paged
   and ragged decode-attention kernels' HMMA (tensor cores), and every
   bf16 gmm, tgmm, int8 and conv-epilogue instantiation (the shared
   wgmma + TMA mainloop of ``csrc/gemm_sm90.cuh`` and its pieces) HGMMA
   and no HMMA;
3. the ragged paged-attention kernel against its plain PyTorch version
   on the card, at the Llama-3-8B attention geometry (H 32, Hkv 8,
   Dh 128, page 16): (a) a serving mix of prefill spans, decode rows and
   padding tokens, (b) long-context decode over 16,384-token tables,
   (c) empty slots, shuffled tables and NaN in the trash page and in
   stale page rows, (d) the serving phase's mixed tick at the engine's
   own geometry (8 slots, 34 pages a slot, 273 pages), (e) the edges of
   the kernels' fixed 512-key chunks (decode rows over 511, 512, 513,
   1024 and 1 keys, a span whose causal limits cross a chunk boundary
   inside one query tile, a span's end followed by decode rows in the
   stream). The f32 kernel is held to TILED_ULP_BOUND ulps at
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
   and T = S not a multiple of 64; and B 2 at Dh 64, H 8 / Hkv 2,
   T 700, S 1024), RMSNorm forward, dx and dw, RoPE
   forward and backward at theta 500000. As in phase 3, f32 kernels are
   held to the plain version evaluated in f64 on the same (pre-scaled)
   inputs and bf16 kernels to the bf16 plain version and to the f64
   evaluation on the same bf16 values, each to the bound stated beside
   it; two backward launches must give bitwise equal dq, dk, dv and dw.
   Kernel, plain-version and library-call times are printed, and the
   achieved TFLOP/s over the minimal work of the kernels that
   operations bound;
6. training: ``make_train_step`` on ``llama3_8b`` at full width and
   depth (32 layers, bf16, seeded random weights, AdamW state in bf16),
   B 1, T 2048, ``TRAIN_STEPS`` steps on one fixed batch. Every kernel's
   launch count must equal its per-step formula times the steps, the
   loss must be finite and fall, and the first step's loss must agree
   with the plain versions' loss on the same state within
   ``TRAIN_LOSS_REL``. Step ms, tokens/s, MFU (``bench.py``'s
   accounting) and peak memory are printed;
7. the decode kernels against their plain versions at the Llama-3-8B
   geometry. Paged attention (both modes, o, m and l) at ``bench.py``'s
   mix (32 streams of 64-2016 tokens, page 32) and at the engine's (8
   slots, page 16, one 16k sequence), over shuffled tables with NaN in
   the trash page and past every length, and at the chunk edges (511,
   512, 513, 1024 and 1 keys); a sequence alone and under another page
   placement must give the same bits. The int8 matmul at
   the five weight shapes for M = 1, 8, 32, 256 and 4096, with rows
   bitwise equal across M and order. Bounds as in phases 3 and 5 (f32
   vs f64, bf16 vs the bf16 plain version and f64), stated beside each;
   kernel, plain, bound and library (SDPA; cuBLAS bf16 on the
   dequantized weight) times;
8. the paged and int8 decode paths on ``llama3_8b`` (phase 4's params):
   ``generate_paged`` in bf16 and with ``quantize_for_decode`` weights
   at the bench mix (16 new tokens), ``serving_decode_block`` (8 slots,
   4 steps) and ``ServingEngine(quantization="int8")`` on phase 4's
   requests, each with its launch counts asserted; first decode step
   kernel vs plain (attention, then the int8 product) from one shared
   prefill; int8 vs bf16 logits within the JAX package's bound. Decode
   ms/step against the weight-stream bound, tok/s and TTFT are printed.

9. the grouped-matmul kernels against their plain versions at the
   dropless MoE layer of Qwen1.5-MoE-A2.7B (2048 tokens, top-4 of 60
   experts, D 2048, expert F 1408, tile_m 128) for a uniform and a
   skewed routing (5 experts empty) and the JAX package's tiny
   ``[0, 2, 2]`` case, and the skewed routing again at widths the tgmm
   tiles do not divide (``GMM_RAGGED``): gmm forward, dlhs (the weight
   read transposed) and tgmm, f32 vs f64 and bf16 vs the bf16 plain
   version and f64 (``GMM_BOUNDS``); padding rows and empty experts
   exactly 0; two launches and a shuffled tile order bitwise equal.
   ``moe_mlp_dropless`` forward and backward through the kernels vs the
   plain path (``MOE_BOUNDS``), dropless vs the einsum ``moe_ffn`` at a
   capacity that drops nothing (``MOE_EINSUM_ULPS``), and flash attention
   at G = 1 (H = Hkv = 16, T 2048). Kernel, plain, bound and library
   (``torch._grouped_mm``, or cuBLAS per expert) times;
10. training: ``qwen2_moe.make_train_step`` on
   ``Qwen2MoeConfig(moe_impl="dropless")`` at full width, ``QWEN_LAYERS``
   layers (the cut and its reason are stated there), bf16, seeded random
   weights, B 1, T 2048, ``TRAIN_STEPS`` steps on one fixed batch:
   launches per the per-step formula, the loss finite and falling, the
   first step's loss within ``QWEN_TRAIN_LOSS_REL`` of the plain
   versions'; step ms, tokens/s, MFU and peak memory.
11. the conv-epilogue kernel (the 1x1 conv after the conv-bn fold)
   against its plain version at ResNet-50's 12 shapes at B 8
   (``RESNET_B8_SITES``) and layer 4's two at B 1, relu on and off: f32
   vs f64 and bf16 vs the bf16 plain version and f64
   (``CONV_EPILOGUE_BOUNDS``); a second launch, B 1 against the same
   rows of B 8, and the same rows at M = 49, 392 and 6272
   (``CONV_ROWS_ACROSS_M``), bitwise; no write outside [M, N]
   (a NaN band around the output). Kernel, plain, bound and library
   (``torch._addmm_activation`` / ``torch.addmm``) times and the
   kernel's host µs per call, per shape and summed over one forward's 33
   sites;
12. ResNet-50 inference: ``resnet50(num_classes=1000)`` at 224 x 224,
   seeded random weights and BN statistics, eval, channels-last,
   ``fold_conv_bn`` (53 sites). f32 folded vs unfolded (TF32 off) within
   ``RESNET_F32_LOGITS_REL``; bf16 folded on the kernel vs on the plain
   versions within ``RESNET_BF16_LOGITS_REL``; the 33 row-wise sites at
   exactly ``RESNET_B8_SITES``, none copying its input; launches = 33 x
   forwards; ms per forward, images/s and peak memory at B 8 and B 128,
   folded and unfolded (conv -> BN -> relu on cuDNN).

13. sampling and speculation on ``llama3_8b`` (phase 4's params): (a)
   the serving tick's sampler on the card against the same function on
   the CPU, on ``[8, 128256]`` and ``[40, 128256]`` f32 logits whose
   rows are greedy, sampled (temperature 0.8, top-k 50, top-p 0.95),
   top-k 1 and top-p 0: threefry bits bitwise, the degenerate rows
   bitwise the argmax, sampled tokens equal on every row whose two
   largest perturbed logits differ by more than ``SAMPLE_MARGIN``; its
   host and device ms and kernels a call; (b) one speculative verify
   tick (``spec_k`` 4: 3 slots drafting 4, 2 drafting 2, 2 decode rows,
   a 256-token prefill span; three slots' drafts planted from the plain
   tick's own picks, so drafts are accepted), kernel vs plain attention:
   the logits at every verify position within ``LOGITS_REL_TOL``, the
   picks and ``accept`` equal wherever no token's logit difference
   between the two ticks can reorder the plain pick, L ragged launches;
   (c)
   ``ServingEngine(speculative="ngram", spec_k=4)`` on 16 requests (8
   sampled, 4 with periodic prompts) against a plain engine: every
   request's token count, ragged launches = L x model steps, verify ticks
   and accepted drafts > 0, a ``defragment()`` between two waves that
   moves pages, ``expose()`` parsed back, all-greedy waves launching no
   sampler; tok/s and tokens per model step on the mixed requests (one
   run) and, as median and range over ``SPEC_WAVE_REPS`` reps with the
   engines' order alternating, on 16 periodic and 16 random prompts; the
   streams' agreement between the engines (reported); (d) sampled ``generate_paged`` at the bench mix, its
   paged-kernel launches as in phase 8, the per-step sampler's host and
   device ms.

14. Qwen2-MoE serving on the default ``Qwen2MoeConfig()`` (the widths
   of Qwen1.5-MoE-A2.7B, 24 layers, bf16, seeded random weights): (a)
   the ragged kernel (phase 3's cases a, b, d and e) and the paged
   kernel (phase 7's engine and chunk-edge cases) at G = 1 (H = Hkv =
   16, Dh 128) against their plain versions to the same bounds, with row
   invariance, and the times and bounds of the engine tick, the ragged
   16k decode rows (case b) and the paged 16k decode; (b) the int8 matmul at Qwen's four weight shapes (K 2048 ->
   N 2048, 5632, 151936; K 5632 -> N 2048) at M 8 and 256, to phase 7's
   bounds; (c) phase 4's engine, wave and checks on Qwen2-MoE (ragged
   launches = 24 x model steps; the mixed tick kernel vs plain within
   ``LOGITS_REL_TOL`` with the MoE routing pinned to the plain tick's,
   the free tick's difference and routing flips reported
   (``compare_tick_logits``: an ulp can move a token to other experts);
   three requests' tokens against ``generate()``, whose prompt runs on
   the flash kernel, reported), ``serving_decode_block`` (paged launches
   = 24 x steps), and the same wave on a speculative engine
   (``"ngram"``, spec_k 4) and a plain one, request 0 sampled from a
   fixed seed on both; (d) ``quantize_for_decode`` on the card; on one
   32-row decode tick, routing pinned, int8 against bf16 (greedy tokens
   equal on ``QWEN_INT8_GREEDY_MIN`` of the rows, the JAX package's
   Qwen criterion; phase 8's logit bound reported) and the int8 kernel
   path against the plain int8 products (``DECODE_LOGITS_REL_TOL``); the
   int8 engine on the wave (int8 launches = (7 x 24 + 1) x model
   steps); tok/s, TTFT and the weight bytes a step.

15. KV-chain migration and the cold tier on ``llama3_8b`` (phase 4's
   params; engines of 4 slots, page 16, prompts up to 1088 tokens, 32
   new, the paged-KV audit after every tick): the ragged kernel at the
   adopting engine's shapes (a 16-token span behind 1040 keys and a
   decode row over 1087, shuffled pages) against its plain version to
   phase 3's bounds, and two page placements of the same bytes bitwise;
   (a) engine A serves four 1040-token chains (65 pages each), chain 0
   is exported whole, pickled and adopted by engine B, and its
   continuation (32 greedy tokens) alone on A and on B gives the same
   tokens, B attaching all 1040 adopted tokens, ragged launches = L x
   model steps; (b) chain 1 the same in chunks of 8 pages with a defrag
   of A moving the chain's pages mid-transfer, audits clean, and an
   adopt_chain_begin / _abort pair that returns B's free pages; (c) a
   1 GiB cold tier on an engine where each chain evicts the last: p1's
   rewarmed tokens equal its warm run's, cold_hits 1, cold_hit_pages 64;
   (d) export and adopt GB/s (whole and a chunk), ms a spilled page,
   cold_adopt_s, TTFT cold / warm / rewarmed, and the largest decode
   stall of a stream on A alone and during a whole-blob export.

Phases run in the order 1, 2, 3, 5, 7, 4, 8, 13, 15, 14, 6, 9, 10, 11,
12: phase 14 starts after the 8B serving state is freed, phase 6 after
phase 14's, phases 9 and 10 after phase 6's.

The last two lines of standard output are the card's name and power
limit, then ``{"ok": true, "device": {...}}``; the line before them is
the kernels' JSON record. Exits non-zero without those lines when CUDA
is not available.
"""
from __future__ import annotations

import gc
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
# the first decode step of generate_paged at the bench mix (32 rows,
# 32 bf16 layers, random weights) from one shared prefill, kernel vs
# plain (the paged kernel vs plain attention; the int8 kernel vs the
# plain int8 product): max |dlogit| relative to the largest logit.
# Measured 0.021 and 0.018 on an H100 80GB HBM3 (700 W) with this
# script; the bound leaves 2.4x. The kernels themselves are held to the
# ulp bounds of phase 7.
DECODE_LOGITS_REL_TOL = 0.05
TRAIN_STEPS = 4
# first train step's loss (kernels) vs the plain versions' loss on the
# same state, relative: the plain flash attention rounds scores,
# probabilities and PV to bf16, where the kernel keeps scores, softmax
# and sums in f32 and feeds p (and dS) to the tensor cores as bf16
# hi + lo pairs (~16 bits); 32 random layers carry that difference to
# the logits, and the loss averages 2048 tokens' cross entropy. Measured
# 6.5e-6 with the FMA kernels, 3.5e-5 with the tensor-core kernels,
# on an H100 80GB HBM3 (700 W) with this script; the bound leaves two
# orders of magnitude.
TRAIN_LOSS_REL = 1e-3
H100_BYTES_PER_S = 3.35e12       # HBM3, NVIDIA data sheet (SXM, 700 W)
H100_BF16_FLOPS = 989e12         # dense bf16 tensor-core peak (SXM)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_short_name(mangled: str) -> str:
    """``fa_fwd_kernel_wgmma<128>`` from a mangled ``ns::fn<...>`` name:
    the last name before the template arguments, then the operand type
    where the first argument is one (bf16 or f32), and the integer and
    bool arguments."""
    import re
    if not mangled.startswith("_ZN"):
        return mangled
    i, part = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        part = mangled[j:j + int(mangled[i:j])]
        i = j + int(mangled[i:j])
    args = mangled[i:mangled.find("EE", i) + 1]
    vals = [("bf16" if "__nv_bfloat16" in args else "f32")] \
        if args.startswith("I") and ("__nv_bfloat16" in args
                                     or args.startswith("If")) else []
    vals += re.findall(r"L[ib](\d+)E", args)
    return part + (f"<{','.join(vals)}>" if vals else "")


def sass_count(lib: Path, op: str = "HGMMA") -> dict:
    """``{kernel function: count of instruction op}`` in the SASS of a
    built library (``cuobjdump -sass``)."""
    import shutil
    from torch.utils.cpp_extension import CUDA_HOME
    tool = (str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME
            else shutil.which("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    out, fn = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            fn = ln.split("Function :")[1].strip()
            out[fn] = 0
        elif fn is not None:
            out[fn] += op in ln
    return out


def check_flash_sass(lib: Path) -> dict:
    """The bf16 flash kernels run on tensor cores: HGMMA in the forward
    and in dq and dkv, for each head dim; returns the counts."""
    ops = sass_count(lib)
    got = {}
    for kern in ("fa_fwd_kernel_wgmma", "fa_bwd_dq_kernel_wgmma",
                 "fa_bwd_dkv_kernel_wgmma"):
        fns = {k: v for k, v in ops.items() if kern in k}
        assert len(fns) == 2, (kern, sorted(ops))      # Dh 64 and 128
        for fn, hgmma in fns.items():
            assert hgmma > 0, f"{fn}: no HGMMA in its SASS"
        got[kern] = sorted(fns.values())
    return got


def check_decode_sass(libs: dict) -> dict:
    """The bf16 paged and ragged decode-attention kernels run their
    products on tensor cores: HMMA (mma.sync) in the SASS of every bf16
    instantiation (8 head-dim x group cases, both stats modes or both row
    groupings); the f32 ones stay on FMA units. Returns
    ``{library: (bf16 kernels, min HMMA, max HMMA, f32 kernels with
    HMMA)}``."""
    got = {}
    for name in ("paged_attention", "ragged_paged_attention"):
        ops = sass_count(libs[name], "HMMA")
        bf16 = {k: v for k, v in ops.items() if "__nv_bfloat16" in k}
        f32 = {k: v for k, v in ops.items()
               if "decode_attention_kernel" in k and k not in bf16}
        assert len(bf16) == 16 and len(f32) == 16, (name, sorted(ops))
        for fn, n in bf16.items():
            assert n > 0, f"{fn}: no HMMA in its SASS"
        got[name] = (len(bf16), min(bf16.values()), max(bf16.values()),
                     sum(v > 0 for v in f32.values()))
    return got


def check_gemm_sass(libs: dict) -> dict:
    """The bf16 gmm, tgmm, int8 and conv-epilogue kernels run on the
    shared wgmma mainloop's pieces: HGMMA and no HMMA (mma.sync) in the
    SASS of every bf16 instantiation (gmm's tile widths 64 and 128,
    forward and transposed; tgmm's 64, 128 and 256; the int8 kernel's 64
    and 128 rows; the conv epilogue's 64 and 128). Returns ``{kernel:
    sorted HGMMA counts}``."""
    got = {}
    for lib, kern, n in (("grouped_matmul", "gmm_wgmma_kernel", 4),
                         ("grouped_matmul", "tgmm_wgmma_kernel", 3),
                         ("int8_matmul", "int8_mm_wgmma_kernel", 2),
                         ("conv_epilogue", "mba_wgmma_kernel", 2)):
        hgmma = sass_count(libs[lib])
        hmma = sass_count(libs[lib], "HMMA")
        # mangled names carry each name's length: "16gmm_wgmma_kernel" is
        # not inside "17tgmm_wgmma_kernel"
        fns = [k for k in hgmma if f"{len(kern)}{kern}" in k]
        assert len(fns) == n, (kern, sorted(hgmma))
        for fn in fns:
            assert hgmma[fn] > 0, f"{fn}: no HGMMA in its SASS"
            assert hmma[fn] == 0, f"{fn}: mma.sync (HMMA) in its SASS"
        got[kern] = sorted(hgmma[fn] for fn in fns)
    return got


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
              nan_garbage=False, tail_decode=False, seed=0, device="cuda"):
    """A packed ragged-attention batch: ``slots`` is ``[(q_len, kv_len)]``
    per slot (q_len 0 = empty slot, 1 = decode row, >1 = prefill span
    ending at kv_len). Decode rows sit at their slot index in the first
    S stream positions (padding where a slot has none), spans follow,
    then ``n_pad`` padding tokens; with ``tail_decode`` the spans come
    first and the decode rows right after them, so a span's last tokens
    and decode rows share a 16-token window of the stream. Returns f32
    tensors on ``device``."""
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
    decode = [s if q_len[s] == 1 else S for s in range(S)]
    if tail_decode:
        decode = [s for s in decode if s < S]
    tok_slot, tok_qoff = ([], []) if tail_decode else (decode, [0] * S)
    for s in range(S):
        if q_len[s] > 1:
            tok_slot += [s] * int(q_len[s])
            tok_qoff += list(range(int(q_len[s])))
    if tail_decode:
        tok_slot += decode
        tok_qoff += [0] * len(decode)
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
    L2 (as each layer's pools do in the engine), then a ~0.5 ms device
    sleep, so the host has queued the call before the first event fires
    and its wrapper's host time never counts."""
    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(1_000_000)
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
# the edges of the kernels' fixed key chunks (KEY_CHUNK = 512): decode rows
# over C - 1, C, C + 1, 2C and 1 keys; a 40-token span whose causal limits
# (491 .. 530) cross a chunk boundary inside one query tile; an 18-token
# span whose last tokens share a 16-token window of the stream with the
# decode rows that follow it
CASE_E = dict(slots=[(1, 511), (1, 512), (1, 513), (1, 1024), (1, 1),
                     (40, 530), (18, 700)], pps=64, n_pad=1,
              tail_decode=True)


def kernel_phase() -> dict:
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    rec = {}
    for name, spec in (("a_serving_mix", CASE_A), ("b_long_context", CASE_B),
                       ("c_degenerate", CASE_C), ("d_engine_tick", CASE_D),
                       ("e_chunk_edges", CASE_E)):
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
        if name == "e_chunk_edges":
            check_row_invariance(case, split_slot=5, split=21)
            log("kernel row invariance across the key-chunk edges: "
                "per-slot and chunked == whole, bitwise")
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


def init_8b():
    """llama3_8b's params (bf16, 32 layers) from seed 0 on the card."""
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
    torch.cuda.synchronize()
    log(f"llama3_8b params initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    return params, cfg


def model_module(cfg):
    """The port's model module of ``cfg``: Qwen2-MoE when it has
    experts, else Llama."""
    from paddle_tpu_torch.models import llama, qwen2_moe
    return qwen2_moe if hasattr(cfg, "num_experts") else llama


def serving_phase(params, cfg) -> dict:
    """``ServingEngine`` on phase 4's 16 requests (the model from the
    config), one mixed tick kernel vs plain attention, and the engine's
    tokens against the model's ``generate()`` for three requests."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ServingEngine

    mod = model_module(cfg)
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
    log(f"serving {mod.__name__.rsplit('.', 1)[-1]} on "
        f"{torch.cuda.get_device_name(0)}: {len(outs)} "
        f"requests, {tokens} tokens in {wall:.3f} s "
        f"= {tokens / wall:.1f} tok/s; mean TTFT {np.mean(ttft):.4f} s; "
        f"{ticks} ticks, {steps} model steps, {launches} kernel launches "
        f"(= {L} layers x {steps}); prefix hits {c['prefix_hits']}")

    # one mixed tick, kernel vs plain attention, same weights and pools
    pools, tok, meta = tick_state(cfg, TICK_DECODE, TICK_SPANS)
    cmp = compare_tick_logits(
        "serving tick kernel vs reference",
        tick_runner(params, cfg, pools, tok, meta, "kernel"),
        tick_runner(params, cfg, pools, tok, meta, "reference"), meta,
        lambda d, scale, std, greedy: d <= LOGITS_REL_TOL * scale,
        f"{LOGITS_REL_TOL} x scale")
    del pools
    diff, scale = cmp["max_abs_diff"], cmp["scale"]

    agree = []
    fa.flash_attention_fwd.launches = 0
    for i in (0, 5, 9):
        ref = mod.generate(params, prompts[i][None], cfg, new[i])
        ref = ref[0, prompts[i].size:].cpu().numpy()
        agree.append((int((ref == outs[i]).sum()), new[i],
                      int(np.argmax(ref != outs[i])) if (ref != outs[i])
                      .any() else new[i]))
    gen_flash = fa.flash_attention_fwd.launches
    log("serving vs port generate(): " + ", ".join(
        f"request {i}: {a}/{n} tokens equal, first difference at {d}"
        for i, (a, n, d) in zip((0, 5, 9), agree))
        + f"; generate()'s flash-attention launches {gen_flash}")
    return dict(launches=launches, tok_s=tokens / wall,
                mean_ttft_s=float(np.mean(ttft)), ticks=ticks,
                model_steps=steps, logits_max_abs_diff=diff,
                logit_scale=scale, tick=cmp,
                generate_flash_launches=gen_flash, generate_agree=agree)


def routing_trace(fn, pin=None):
    """``(fn(), trace)``: ``fn`` run with the MoE gating
    (``incubate.moe.functional.top_k_gating``) wrapped to record, per
    call, the experts each token is routed to (``[S, k]``, in pick
    order): the discrete decisions a small difference upstream can flip.
    With ``pin`` (the trace of an earlier run on the same state) every
    call routes each token to the pinned experts instead, its gate
    values from its own router, its dispatch built as ``top_k_gating``
    builds it: a comparison of two runs then measures their numerics
    alone. A Llama ``fn`` leaves the trace empty."""
    import torch.nn.functional as F
    from paddle_tpu_torch.incubate.moe import functional as moe_f
    orig, trace = moe_f.top_k_gating, []
    pinned = iter(pin or ())

    def pinned_gating(logits, top_k, capacity):
        S, E = logits.shape
        idx = next(pinned)
        raw = torch.softmax(logits.float(), dim=-1)
        dispatch = logits.new_zeros((S, E, capacity), dtype=torch.float32)
        combine = torch.zeros_like(dispatch)
        running = logits.new_zeros((E,), dtype=torch.float32)
        for i in range(top_k):
            m = F.one_hot(idx[:, i], E).float()
            gv = (raw * m).sum(-1)
            pos = ((torch.cumsum(m, 0) - m + running) * m).sum(-1).long()
            running = running + m.sum(0)
            d = (m * (pos < capacity).float()[:, None])[:, :, None] \
                * F.one_hot(pos.clamp(max=capacity - 1), capacity)[:, None]
            dispatch = dispatch + d
            combine = combine + gv[:, None, None] * d
        return dispatch, combine, raw.new_zeros(())

    def traced(logits, top_k, capacity, **kw):
        trace.append(torch.softmax(logits.float(), dim=-1)
                     .topk(top_k, dim=-1).indices)
        if pin is not None:
            return pinned_gating(logits, top_k, capacity)
        return orig(logits, top_k, capacity, **kw)

    moe_f.top_k_gating = traced
    try:
        return fn(), trace
    finally:
        moe_f.top_k_gating = orig


def routing_flips(tr_a, tr_b) -> tuple:
    """Token-layer routing decisions (expert sets) that differ between
    two traces, and how many were made."""
    flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                for a, b in zip(tr_a, tr_b))
    return flips, sum(t.shape[0] for t in tr_b)


def compare_tick_logits(name, run, ref_run, meta, holds, bound: str) -> dict:
    """A tick's logits ``[S, V]`` against a reference tick's on the same
    state, on the live slots. ``run(pin)`` and ``ref_run(pin)`` return
    ``(logits, trace)`` (``routing_trace``). A bf16 MoE stack can route
    a token to other experts when its input moves by an ulp, a discrete
    step the bound does not describe, so for Qwen2-MoE the free run's
    difference and flips are reported and ``run`` is rerun with the
    reference's routing pinned; that run must satisfy ``holds(max
    |dlogit|, logit scale, logit std, the share of live rows whose
    greedy token is the reference's)``."""
    live = meta["q_len"] > 0
    ref, tr_ref = ref_run(None)
    got, tr = run(None)
    assert torch.isfinite(got[live]).all(), f"{name}: non-finite logits"
    scale = float(ref[live].abs().max())
    std = float(ref[live].std())
    rec = dict(scale=scale, std=std)
    if tr_ref:
        rec["free_max_abs_diff"] = float((got - ref)[live].abs().max())
        rec["routing_flips"], rec["routing_decisions"] = routing_flips(
            tr, tr_ref)
        log(f"{name}, routing free: max |dlogit| "
            f"{rec['free_max_abs_diff']:.4g} "
            f"({rec['free_max_abs_diff'] / scale:.4g} x scale); "
            f"{rec['routing_flips']} of {rec['routing_decisions']} "
            f"token-layer routing decisions differ (reported)")
        got, _ = run(tr_ref)
        assert torch.isfinite(got[live]).all(), f"{name}: non-finite"
    diff = float((got - ref)[live].abs().max())
    same = int((got.argmax(-1) == ref.argmax(-1))[live].sum())
    rec.update(max_abs_diff=diff, greedy_equal=same, live=int(live.sum()))
    log(f"{name}{', routing pinned to the reference' if tr_ref else ''}: "
        f"max |dlogit| {diff:.4g} (logit scale {scale:.4g}, std "
        f"{std:.4g}; {diff / scale:.4g} x scale, {diff / std:.4g} x std); "
        f"greedy equal on {same}/{rec['live']} live slots; bound {bound}")
    assert holds(diff, scale, std, same / rec["live"]), (name, rec)
    return rec


def tick_runner(params, cfg, pools, tok, meta, attn_impl: str):
    """``run(pin) -> (logits, routing trace)``: one ``serving_tick`` of
    the model on copies of ``pools`` (``routing_trace``'s ``pin``)."""
    mod = model_module(cfg)

    def run(pin):
        kp, vp = (t.clone() for t in pools.values())
        (_, logits, _, _), trace = routing_trace(
            lambda: mod.serving_tick(params, tok, meta, kp, vp, cfg,
                                     attn_impl=attn_impl), pin)
        return logits, trace
    return run


def tick_state(cfg, decode, spans=(), pps: int = TICK_PPS, seed: int = 1,
               tok_seed: int = 0):
    """One tick over pools of random KV (page 16, ``pps`` pages a slot;
    from ``seed``): ``decode`` ``{slot: cached tokens}`` rows, then
    ``spans`` ``[(slot, start, take)]`` of prompt tokens, the tokens
    random from ``tok_seed``; as many slots as the larger of ``TICK_S``
    and the slots named. Returns ``(pools, tokens, meta)`` on the
    card."""
    from paddle_tpu_torch.models import llama
    S, ps = max([TICK_S, *[s + 1 for s in decode],
                 *[s + 1 for s, _, _ in spans]]), 16
    pools = model_module(cfg).init_serving_pages(cfg, 1 + S * pps, ps)
    g = torch.Generator(device="cuda").manual_seed(seed)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    rng = np.random.RandomState(tok_seed)
    tok, meta = llama.pack_tick(
        [(s, rng.randint(cfg.vocab_size), n) for s, n in decode.items()],
        [(s, rng.randint(0, cfg.vocab_size, take), start)
         for s, start, take in spans],
        np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps), ps,
        "cuda")
    return pools, tok, meta


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
    # and p, as a bf16 hi + lo pair (~16 bits, far below an output ulp)
    ("o", "f32"): 16, ("o", "plain"): 8, ("o", "exact"): 1,
    # backward: dS = p (dP - delta) cancels, and dq sums dS k over up to
    # 2048 keys, dk and dv sum over the G = 4 heads' 2048 rows each (the
    # plain version's own f32 evaluation reads 24-43 ulps from f64 here).
    # bf16: the plain backward rounds dP, dS and every product to bf16,
    # the kernel its outputs and p and dS as hi + lo pairs (one bf16 each
    # would read ~1.04 ulps on dq, over the exact bound)
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
# the prefill paths' shape the cases above miss: B > 1, and the Dh 64
# instantiation, with S > T and neither a multiple of the tile
FLASH_BATCH_GEOM = dict(H=8, Hkv=2, Dh=64)
FLASH_BATCH_CASE = dict(T=700, S=1024, B=2)


def row_ulps(got, ref, width: int, eps: float) -> float:
    """Max error in ``eps`` units at each row's scale, rows of ``width``."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        tiled_ulp_error)
    return tiled_ulp_error(got.reshape(-1, width), ref.reshape(-1, width),
                           eps=eps)


def check_bounds(name: str, errs: dict, bounds=None) -> None:
    bounds = TRAIN_BOUNDS if bounds is None else bounds
    bad = {k: v for k, v in errs.items()
           if k in bounds and not v <= bounds[k]}
    assert not bad, (name, {k: (v, bounds[k]) for k, v in bad.items()})


def _randn(shape, gen, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _flash_run(q, k, v, do, impl, scale, causal=True):
    """o and (dq, dk, dv) of flash attention on pre-scaled q (sm_scale
    1), the gradient reported for the unscaled q (x scale)."""
    from paddle_tpu_torch.ops.kernels.flash_attention import flash_attention
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    if impl == "kernel":
        o = flash_attention(*leaves, causal=causal, sm_scale=scale,
                            impl="kernel")
        grads = torch.autograd.grad(o, leaves, do)
        return (o.detach(),) + tuple(grads)
    qs = (leaves[0] * scale).to(q.dtype)   # as the kernel pre-scales
    o = flash_attention(qs, leaves[1], leaves[2], causal=causal,
                        sm_scale=1.0, impl="reference")
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


def check_flash(T: int, S: int, seed: int, gm=TRAIN_GEOM, B: int = 1,
                causal: bool = True) -> dict:
    """Flash attention forward and backward, f32 and bf16, at the 8B
    attention geometry (or ``gm``'s heads), batch ``B``; determinism of
    the backward (bitwise)."""
    H, Hkv, Dh = gm["H"], gm["Hkv"], gm["Dh"]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn((B, T, H, Dh), gen)
    k = _randn((B, S, Hkv, Dh), gen)
    v = _randn((B, S, Hkv, Dh), gen)
    do = _randn((B, T, H, Dh), gen)
    scale = 1.0 / math.sqrt(Dh)
    names = ("o", "dq", "dk", "dv")
    errs = {}
    for dt in (torch.float32, torch.bfloat16):
        ins = [t.to(dt) for t in (q, k, v, do)]
        got = _flash_run(*ins, "kernel", scale, causal)
        if dt == torch.bfloat16:
            again = _flash_run(*ins, "kernel", scale, causal)
            for n, a, b in zip(names[1:], got[1:], again[1:]):
                assert torch.equal(a, b), f"flash {n} not deterministic"
            del again
        plain = _flash_run(*ins, "reference", scale, causal)
        # the f64 evaluation on the same values, q pre-scaled as the
        # kernel rounds it
        qs = (ins[0].float() * scale).to(dt).double()
        f64 = _flash_run(qs, *(t.double() for t in ins[1:]), "reference",
                         1.0, causal)
        f64 = (f64[0], f64[1] * scale) + f64[2:]
        # dq is measured per head (rows of T x Dh), see TRAIN_BOUNDS
        got, plain, f64 = ((x[0], x[1].transpose(1, 2).contiguous())
                           + tuple(x[2:]) for x in (got, plain, f64))
        errs.update(_errs(names, got, f64, plain, (Dh, T * Dh, Dh, Dh)))
        del got, plain, f64
    torch.cuda.empty_cache()
    return errs


# RMSNorm shapes (N, D): the 8B width at T 2048, a ragged N, one row, the
# rows either side of a 16-row dw chunk (RMS_DW_CHUNK), bench.py's deep
# width and the widest row the backward kernel takes
RMS_SHAPES = ((2048, 4096), (2047, 4096), (1, 4096), (15, 4096), (17, 4096),
              (2048, 2560), (512, 8192))
# the widths row 8 is timed at (N 2048) beside the 8B one; their launches
# are the 8B width's
RMS_BWD_WIDTHS = (2560, 8192)
RMS_COUNTED_AS = {f"fused_rms_norm_bwd_d{d}": "fused_rms_norm_bwd"
                  for d in RMS_BWD_WIDTHS}


def _rms_errs(x, w, g) -> dict:
    """The forward's y and the backward's dx and dw, f32 and bf16, against
    the plain versions and the f64 evaluation (see TRAIN_BOUNDS)."""
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    D = x.shape[1]
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
    return errs


def check_rms_bwd_bits(xd, wd, r, gd) -> None:
    """The backward's dx and dw bitwise: two launches in a row, two
    launches on each of two streams at once, and each row of dx alone
    (N 1) and inside 17-row slices (across the 16-row chunks)."""
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    dx, dw = nr.rms_norm_bwd(xd, wd, r, gd, "kernel")
    dx2, dw2 = nr.rms_norm_bwd(xd, wd, r, gd, "kernel")
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2), \
        "rms_norm backward not deterministic"
    cur = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    outs = []
    for st in streams:
        st.wait_stream(cur)
    for _ in range(2):
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(nr.rms_norm_bwd(xd, wd, r, gd, "kernel"))
    torch.cuda.synchronize()
    for a, b in outs:
        assert torch.equal(a, dx) and torch.equal(b, dw), \
            "rms_norm backward differs on two streams at once"
    N = xd.shape[0]
    for i in (0, 1, 15, 16, 17, 1000, N - 1):
        a, _ = nr.rms_norm_bwd(xd[i:i + 1], wd, r[i:i + 1], gd[i:i + 1],
                               "kernel")
        assert torch.equal(a, dx[i:i + 1]), f"dx row {i} alone differs"
    for lo in (0, 9, 1000, N - 17):
        hi = lo + 17
        a, _ = nr.rms_norm_bwd(xd[lo:hi], wd, r[lo:hi], gd[lo:hi], "kernel")
        assert torch.equal(a, dx[lo:hi]), f"dx rows {lo}:{hi} differ"


def check_rms_norm(seed: int = 10) -> dict:
    """RMSNorm forward and backward at every ``RMS_SHAPES`` shape, f32 and
    bf16: each entry the worst over the shapes, and ``("dx_d<D>",
    "max_abs_err")`` the bf16 dx against the plain version per width; the
    backward's bits (``check_rms_bwd_bits``) at N 2048, D 4096 in both
    dtypes."""
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}
    for N, D in RMS_SHAPES:
        x = _randn((N, D), gen, 2.0)
        w = 1.0 + _randn((D,), gen, 0.1)
        g = _randn((N, D), gen)
        e = _rms_errs(x, w, g)
        log(f"rms_norm N={N} D={D}: " + " ".join(
            f"{a}/{b}={v:.4g}" for (a, b), v in e.items()))
        for k, v in e.items():
            errs[k] = max(errs.get(k, 0.0), v)
        key = (f"dx_d{D}", "max_abs_err")
        errs[key] = max(errs.get(key, 0.0), e[("dx", "max_abs_err")])
        if (N, D) == RMS_SHAPES[0]:
            for dt in (torch.float32, torch.bfloat16):
                xd, wd, gd = x.to(dt), w.to(dt), g.to(dt)
                _, r = nr.rms_norm_fwd(xd, wd, 1e-5, "kernel")
                check_rms_bwd_bits(xd, wd, r, gd)
        del x, g
    torch.cuda.empty_cache()
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
    over 3.35 TB/s against operations over the bf16 peak. Each entry is
    ``(ms, "bytes" or "operations", minimal operations)``."""
    gm = TRAIN_GEOM
    T, H, Hkv, Dh, D = 2048, gm["H"], gm["Hkv"], gm["Dh"], gm["D"]
    pairs = H * T * (T + 1) / 2           # visible (query, key) pairs
    qb, kb, st = T * H * Dh * 2, T * Hkv * Dh * 2, H * T * 4

    def bound(nbytes, flops):
        tb = nbytes / H100_BYTES_PER_S * 1e3
        to = flops / H100_BF16_FLOPS * 1e3
        return (max(tb, to), "bytes" if tb >= to else "operations", flops)

    # RMSNorm backward at width d: x, g and dx, w, rstd and dw once
    def rms_bwd(d):
        return bound(3 * T * d * 2 + d * 2 + T * 4 + d * 4, 10 * T * d)

    return {
        **{f"fused_rms_norm_bwd_d{d}": rms_bwd(d) for d in RMS_BWD_WIDTHS},
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
        "fused_rms_norm_bwd": rms_bwd(D),
        "fused_rope": bound(2 * (qb + kb) + T * 4, 6 * T * (H + Hkv) * Dh),
    }


def rms_bwd_times(N: int, D: int, gen) -> tuple:
    """bf16 RMSNorm backward at [N, D]: the kernel's, the plain version's
    and ``F.rms_norm``'s backward's ms (the library call is a yardstick
    only)."""
    import torch.nn.functional as F
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as nr
    bf = torch.bfloat16
    x = _randn((N, D), gen, 2.0).to(bf)
    w = (1.0 + _randn((D,), gen, 0.1)).to(bf)
    g = _randn((N, D), gen).to(bf)
    _, r = nr.rms_norm_fwd(x, w, 1e-5, "kernel")
    xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
    ly = F.rms_norm(xl, (D,), wl, 1e-5)
    with torch.no_grad():
        ms = time_ms(lambda: nr.rms_norm_bwd(x, w, r, g, "kernel"))
        plain = time_ms(lambda: nr.rms_norm_bwd(x, w, r, g, "reference"))
    lib = time_ms(lambda: torch.autograd.grad(ly, (xl, wl), g,
                                              retain_graph=True))
    return ms, plain, lib


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
    qs = fa.prescale_q(q, scale)
    o, lse = fa.flash_attention_fwd(qs, k, v, True)
    _, delta = fa.flash_attention_bwd_dq(qs, k, v, o, do, lse, True, scale)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    po = fa._dense_reference(*leaves, True, scale)
    pgrad = lambda: torch.autograd.grad(po, leaves, do, retain_graph=True)
    tq, tk, tv, tdo = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    sl = [t.detach().requires_grad_() for t in (tq, tk, tv)]
    so = F.scaled_dot_product_attention(*sl, is_causal=True,
                                        enable_gqa=True)
    with torch.no_grad():
        out["flash_attention_fwd"] = (
            time_ms(lambda: fa.flash_attention_fwd(qs, k, v, True)),
            time_ms(lambda: fa._dense_reference(q, k, v, True, scale),
                    reps=5),
            time_ms(lambda: F.scaled_dot_product_attention(
                tq, tk, tv, is_causal=True, enable_gqa=True)))
    plain_bwd = time_ms(pgrad, reps=5)
    lib_bwd = time_ms(lambda: torch.autograd.grad(so, sl, tdo,
                                                  retain_graph=True))
    out["flash_attention_bwd_dq"] = (
        time_ms(lambda: fa.flash_attention_bwd_dq(qs, k, v, o, do, lse,
                                                  True, scale)),
        plain_bwd, lib_bwd)
    out["flash_attention_bwd_dkv"] = (
        time_ms(lambda: fa.flash_attention_bwd_dkv(qs, k, v, do, lse, delta,
                                                   True)),
        plain_bwd, lib_bwd)
    del po, so, leaves, sl
    x = _randn((T, D), gen, 2.0).to(bf)
    w = (1.0 + _randn((D,), gen, 0.1)).to(bf)
    with torch.no_grad():
        out["fused_rms_norm_fwd"] = (
            time_ms(lambda: nr.rms_norm_fwd(x, w, 1e-5, "kernel")),
            time_ms(lambda: nr.rms_norm_fwd(x, w, 1e-5, "reference")),
            time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)))
    out["fused_rms_norm_bwd"] = rms_bwd_times(T, D, gen)
    for d in RMS_BWD_WIDTHS:
        out[f"fused_rms_norm_bwd_d{d}"] = rms_bwd_times(T, d, gen)
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
    # row 8 again at bench.py's deep width and the widest it takes (N 2048)
    *((f"fused_rms_norm_bwd_d{d}", "paddle_tpu_torch/csrc/fused_rms_norm.cu",
       "paddle_tpu/ops/pallas/fused_norm_rope.py:136")
      for d in RMS_BWD_WIDTHS),
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
    e = check_flash(**FLASH_BATCH_CASE, seed=len(errs), gm=FLASH_BATCH_GEOM)
    log(f"flash case b2_dh64 ({FLASH_BATCH_CASE}, {FLASH_BATCH_GEOM}): "
        + " ".join(f"{a}/{b}={v:.4g}" for (a, b), v in e.items()))
    check_bounds("flash b2_dh64", e)
    log("flash backward: two launches bitwise equal (dq, dk, dv)")
    for name, fn in (("rms_norm", check_rms_norm), ("rope", check_rope)):
        e = fn()
        log(f"{name}: " + " ".join(f"{a}/{b}={v:.4g}"
                                   for (a, b), v in e.items()))
        check_bounds(name, e)
        errs[name] = e
    log("rms_norm backward: dx and dw bitwise over two launches and on "
        "two streams at once; dx rows alone and in 17-row slices bitwise")
    times = train_kernel_times()
    bounds = train_kernel_bounds()
    fe, re, pe = errs["t2048"], errs["rms_norm"], errs["rope"]
    max_err = {
        "flash_attention_fwd": fe[("o", "max_abs_err")],
        "flash_attention_bwd_dq": fe[("dq", "max_abs_err")],
        "flash_attention_bwd_dkv": max(fe[("dk", "max_abs_err")],
                                       fe[("dv", "max_abs_err")]),
        "fused_rms_norm_fwd": re[("y", "max_abs_err")],
        "fused_rms_norm_bwd": re[("dx_d4096", "max_abs_err")],
        **{f"fused_rms_norm_bwd_d{d}": re[(f"dx_d{d}", "max_abs_err")]
           for d in RMS_BWD_WIDTHS},
        "fused_rope": pe[("rope", "max_abs_err")],
    }
    rec = {}
    for name, _, _ in TRAIN_KERNELS:
        ms, plain_ms, lib_ms = times[name]
        b, by, flops = bounds[name]
        # achieved rate over the minimal operations (not the kernel's
        # own), for the kernels that operations bound
        tflops = flops / ms * 1e-9 if by == "operations" else None
        rec[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b, bound_by=by, max_abs_err=max_err[name],
                         tflops=tflops)
        log(f"kernel {name} bf16: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms, bound "
            f"{b:.4f} ms ({by}), "
            + (f"{tflops:.1f} TFLOP/s over the minimal work, "
               if tflops else "")
            + f"max |err| vs plain {max_err[name]:.4g}")
    return rec


# ---------------------------------------------------------------------------
# decode kernels: paged attention (with its softmax stats) and int8 matmul
# ---------------------------------------------------------------------------

PAGED_GEOM = dict(H=32, Hkv=8, Dh=128)
# bench.py's paged mix: 32 streams of 64 + 1952 i / 31 tokens, page 32
PAGED_BENCH = dict(lens=[64 + 1952 * i // 31 for i in range(32)], ps=32)
# the engine's geometry: 8 slots, page 16, one 16k sequence among short ones
PAGED_ENGINE = dict(lens=[16384, 300, 77, 5000, 1, 17, 1000, 8191], ps=16)
# the edges of the fixed key chunks: C - 1, C, C + 1, 2C and 1 keys
PAGED_EDGES = dict(lens=[511, 512, 513, 1024, 1], ps=16)
# m and l (f32 kernel, and bf16 kernel on the same bf16 values) vs the f64
# evaluation, in f32 ulps at each sequence's largest |m| or l: the scores
# are f32 sums of Dh = 128 products in 16-byte chunks (a few ulps of
# sum |q k|, which is ~2x |m| for these inputs), and l adds the online
# rescaling's exp and one multiply per 64-key tile
PAGED_STATS_ULPS = 16


def make_paged_case(lens, ps, *, H, Hkv, Dh, seed=0, device="cuda"):
    """Decode-attention inputs (f32): one query per sequence, its pages
    shuffled over the pool, one spare table entry past every length (the
    trash page 0), NaN in the trash page and in the slots past each
    length inside its last page."""
    rng = np.random.RandomState(seed)
    g = torch.Generator(device=device).manual_seed(seed)
    B = len(lens)
    pps = max(-(-n // ps) for n in lens) + 1
    P = 1 + B * pps
    tables = rng.permutation(np.arange(1, P)).reshape(B, pps).astype(np.int32)
    kp = torch.randn((Hkv, P, ps, Dh), generator=g, device=device)
    vp = torch.randn((Hkv, P, ps, Dh), generator=g, device=device)
    for b, n in enumerate(lens):
        tables[b, -(-n // ps):] = 0
        if n % ps:
            page = tables[b, n // ps]
            kp[:, page, n % ps:] = float("nan")
            vp[:, page, n % ps:] = float("nan")
    kp[:, 0] = float("nan")
    vp[:, 0] = float("nan")
    q = torch.randn((B, H, Dh), generator=g, device=device)
    i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)
    return dict(q=q, k_pages=kp, v_pages=vp, lengths=i32(lens),
                page_indices=i32(tables))


def run_paged(case, impl, stats=True, **kw):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    fn = pa.paged_attention_stats if stats else pa.paged_attention
    return fn(case["q"], case["k_pages"], case["v_pages"], case["lengths"],
              case["page_indices"], impl=impl, **kw)


def check_paged_case(name, case) -> dict:
    """Kernel vs plain version, f32 and bf16, o, m and l; the plain-mode
    kernel's o equals the stats mode's bitwise; outputs finite (NaN sits
    in every unread slot)."""
    from paddle_tpu_torch.ops.kernels.ragged_paged_attention import (
        TILED_ULP_BOUND, tiled_ulp_error)
    out = {}
    k32 = run_paged(case, "kernel")
    e64 = run_paged(cast(case, torch.float64), "reference")
    torch.cuda.synchronize()
    for t in k32:
        assert torch.isfinite(t).all(), f"{name}: non-finite f32 output"
    assert torch.equal(run_paged(case, "kernel", stats=False), k32[0])
    for key, a, b in zip("oml", k32, e64):
        out[f"f32_{key}_ulps"] = tiled_ulp_error(a, b, eps=F32_EPS)
    assert out["f32_o_ulps"] <= TILED_ULP_BOUND, (name, out)
    assert max(out["f32_m_ulps"], out["f32_l_ulps"]) <= PAGED_STATS_ULPS, \
        (name, out)

    c16 = cast(case, torch.bfloat16)
    k16 = run_paged(c16, "kernel")
    p16 = run_paged(c16, "reference")
    for t in k16:
        assert torch.isfinite(t).all(), f"{name}: non-finite bf16 output"
    assert torch.equal(run_paged(c16, "kernel", stats=False), k16[0])
    scale = 1.0 / math.sqrt(case["q"].shape[-1])
    c64 = cast(c16, torch.float64)
    c64["q"] = (c16["q"] * scale).to(torch.bfloat16).double()
    exact = run_paged(c64, "reference", sm_scale=1.0)
    out["bf16_vs_plain_ulps"] = tiled_ulp_error(k16[0], p16[0])
    out["bf16_vs_exact_ulps"] = tiled_ulp_error(k16[0], exact[0],
                                                eps=BF16_EPS)
    out["bf16_m_ulps"] = tiled_ulp_error(k16[1], exact[1], eps=F32_EPS)
    out["bf16_l_ulps"] = tiled_ulp_error(k16[2], exact[2], eps=F32_EPS)
    out["bf16_max_abs_err"] = float((k16[0].float() - p16[0].float()).abs()
                                    .max())
    assert out["bf16_vs_plain_ulps"] <= BF16_PLAIN_ULPS, (name, out)
    assert out["bf16_vs_exact_ulps"] <= BF16_EXACT_ULPS, (name, out)
    assert max(out["bf16_m_ulps"], out["bf16_l_ulps"]) <= PAGED_STATS_ULPS, \
        (name, out)
    return out


def check_paged_invariance(case) -> None:
    """Bitwise (bf16, o, m and l): a sequence alone equals its row in the
    batch, and moving every page to another id changes nothing."""
    c = cast(case, torch.bfloat16)
    full = run_paged(c, "kernel")
    B = c["q"].shape[0]
    for b in sorted({0, B // 2, B - 1}):
        alone = run_paged(dict(
            c, q=c["q"][b:b + 1].contiguous(),
            lengths=c["lengths"][b:b + 1].contiguous(),
            page_indices=c["page_indices"][b:b + 1].contiguous()), "kernel")
        for a, f in zip(alone, full):
            assert torch.equal(a, f[b:b + 1]), f"sequence {b} not invariant"
    P = c["k_pages"].shape[1]
    gen = torch.Generator(device="cuda").manual_seed(5)
    new_of_old = torch.cat([torch.zeros(1, dtype=torch.long, device="cuda"),
                            torch.randperm(P - 1, generator=gen,
                                           device="cuda") + 1])
    moved = dict(c, page_indices=new_of_old[c["page_indices"].long()].int())
    for key in ("k_pages", "v_pages"):
        moved[key] = torch.empty_like(c[key])
        moved[key][:, new_of_old] = c[key]
    for a, f in zip(run_paged(moved, "kernel"), full):
        assert torch.equal(a, f), "outputs depend on the page placement"


def paged_bound_ms(case, stats: bool) -> tuple:
    """Least time of one decode-attention call: q, the live K/V keys and
    the metadata read once, o (and m, l) written once; 4·H·Dh operations
    per live key, at the bf16 peak."""
    q = case["q"]
    B, H, Dh = q.shape
    Hkv = case["k_pages"].shape[0]
    es = q.element_size()
    n = int(case["lengths"].sum())
    nbytes = (2 * B * H * Dh * es + 2 * n * Hkv * Dh * es
              + 4 * (B + case["page_indices"].numel())
              + (8 * B * H if stats else 0))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = 4.0 * n * H * Dh / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def paged_sdpa_yardstick(case):
    """``scaled_dot_product_attention`` on the same decode attention: each
    sequence's pages gathered dense (NaN zeroed) and a length mask, GQA
    native. Setup outside the closure; the port never calls SDPA."""
    import torch.nn.functional as F
    q, kp, vp = case["q"], case["k_pages"], case["v_pages"]
    B, H, Dh = q.shape
    Hkv, _, ps, _ = kp.shape
    tab = case["page_indices"].long()
    S = tab.shape[1] * ps
    k = torch.nan_to_num(kp[:, tab].reshape(Hkv, B, S, Dh).transpose(0, 1))
    v = torch.nan_to_num(vp[:, tab].reshape(Hkv, B, S, Dh).transpose(0, 1))
    k, v = k.contiguous(), v.contiguous()
    mask = (torch.arange(S, device=q.device)[None, :]
            < case["lengths"].long()[:, None])[:, None, None, :]
    qs = q[:, :, None, :].contiguous()
    return lambda: F.scaled_dot_product_attention(qs, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def paged_kernel_phase() -> dict:
    """Both paged-attention modes against the plain version at the 8B
    geometry (bench mix, engine geometry), invariance, bf16 timings."""
    rec = {}
    for name, spec in (("bench_mix", PAGED_BENCH),
                       ("engine_16k", PAGED_ENGINE),
                       ("chunk_edges", PAGED_EDGES)):
        case = make_paged_case(**spec, **PAGED_GEOM, seed=30 + len(rec))
        errs = check_paged_case(name, case)
        log(f"paged case {name}: " + " ".join(
            f"{k}={v:.4g}" for k, v in errs.items()))
        check_paged_invariance(case)
        if name == "chunk_edges":
            rec[name] = errs
            continue
        c16 = cast(case, torch.bfloat16)
        lib_ms = time_ms(paged_sdpa_yardstick(c16))
        plain_ms = time_ms(lambda: run_paged(c16, "reference"), reps=5)
        rec[name] = dict(errs, library_ms=lib_ms, plain_ms=plain_ms)
        for stats in (False, True):
            ms = time_ms(lambda: run_paged(c16, "kernel", stats=stats))
            bound, by = paged_bound_ms(c16, stats)
            key = "stats" if stats else "plain_mode"
            rec[name][key] = dict(ms=ms, bound_ms=bound, bound_by=by)
            log(f"paged case {name} bf16 ({'with' if stats else 'without'} "
                f"stats): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, sdpa "
                f"{lib_ms:.4f} ms, bound {bound:.4f} ms ({by})")
        del case, c16
        torch.cuda.empty_cache()
    log("paged kernel: sequences alone == in the batch, and any page "
        "placement, bitwise (o, m, l); NaN in unread slots never reaches "
        "an output")
    return rec


# the five (K, N) weight shapes of llama3_8b and the decode / prefill M
INT8_SHAPES = {"wq_wo": (4096, 4096), "wk_wv": (4096, 1024),
               "gate_up": (4096, 14336), "down": (14336, 4096),
               "lm_head": (4096, 128256)}
INT8_MS = (1, 8, 32, 256, 4096)
INT8_F32_ROWS = 256
# bf16 kernel vs the bf16 plain version and vs f64, in bf16 ulps at each
# row's largest output: both sides are the exact sum rounded once to bf16
# (half an ulp of the element each), the f32 sums being ~2^-16 ulp apart
INT8_BF16_ULPS = 1
# f32 kernel vs f64 on the first INT8_F32_ROWS rows, in f32 ulps at each
# row's largest output: K / 16 chunk sums of 16 products, each chunk added
# to the running total; the running total's rounding grows like
# sqrt(K / 16) ulps of the partial sums (30 at K = 14336), and one row has
# up to 128256 outputs for the tail to reach
INT8_F32_ULPS = 128


def int8_bound_ms(M: int, K: int, N: int) -> tuple:
    """Least time of one int8 product: x, q and scale read once, out
    written once (bf16 x and out), 2·M·K·N operations at the bf16 peak."""
    t_bytes = (K * N + 2 * M * K + 2 * M * N + 4 * N) / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * K * N / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _row_ulps(got, ref, eps: float) -> float:
    """``tiled_ulp_error`` on the card, for outputs of 10^8 elements."""
    got, ref = got.double(), ref.double()
    linf = ref.abs().amax(-1, keepdim=True).clamp(min=1e-30)
    return float(((got - ref).abs() / (eps * linf)).max())


def _int8pack_available() -> bool:
    """Whether this torch has a CUDA kernel for
    ``torch._weight_int8pack_mm`` (a yardstick only)."""
    fn = getattr(torch, "_weight_int8pack_mm", None)
    if fn is None:
        return False
    try:
        fn(torch.zeros(1, 32, dtype=torch.bfloat16, device="cuda"),
           torch.zeros(16, 32, dtype=torch.int8, device="cuda"),
           torch.ones(16, dtype=torch.bfloat16, device="cuda"))
        torch.cuda.synchronize()
        return True
    except (RuntimeError, NotImplementedError):
        return False


def check_int8(name: str, K: int, N: int, seed: int, timing: bool = True,
               ms_list=INT8_MS) -> dict:
    """One weight shape: a seeded random weight quantized by the port;
    bf16 x of max(ms_list) rows. The bf16 kernel vs the bf16 plain
    version and f64, the f32 kernel vs f64; every smaller M's output and
    a reversed x give the same rows bitwise; kernel, plain, cuBLAS-bf16
    (and int8pack, when the build has it) times per M."""
    from paddle_tpu_torch.ops.fused.int8_matmul import (
        quantize_weight_per_channel)
    from paddle_tpu_torch.ops.kernels.int8_matmul import int8_matmul
    gen = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.randn((K, N), generator=gen, device="cuda") / math.sqrt(K)
    q, s = quantize_weight_per_channel(w.to(torch.bfloat16))
    del w
    M = max(ms_list)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    full = int8_matmul(x, q, s, "kernel")
    plain = int8_matmul(x, q, s, "reference")
    exact = int8_matmul(x.double(), q, s, "reference")
    torch.cuda.synchronize()
    assert torch.isfinite(full).all(), f"{name}: non-finite output"
    errs = {"bf16_vs_plain_ulps": _row_ulps(full, plain, BF16_EPS),
            "bf16_vs_exact_ulps": _row_ulps(full, exact, BF16_EPS),
            "bf16_max_abs_err": float((full.float() - plain.float()).abs()
                                      .max())}
    del plain
    for m in ms_list:
        assert torch.equal(int8_matmul(x[:m], q, s, "kernel"), full[:m]), \
            f"{name}: rows at M={m} differ from M={M}"
    assert torch.equal(int8_matmul(x.flip(0), q, s, "kernel"),
                       full.flip(0)), f"{name}: rows depend on their place"
    r = min(INT8_F32_ROWS, M)
    xf = x[:r].float()
    errs["f32_ulps"] = _row_ulps(int8_matmul(xf, q, s, "kernel"), exact[:r],
                                 F32_EPS)
    errs["f32_plain_ulps"] = _row_ulps(int8_matmul(xf, q, s, "reference"),
                                       exact[:r], F32_EPS)
    del exact, full
    assert errs["bf16_vs_plain_ulps"] <= INT8_BF16_ULPS, (name, errs)
    assert errs["bf16_vs_exact_ulps"] <= INT8_BF16_ULPS, (name, errs)
    assert errs["f32_ulps"] <= INT8_F32_ULPS, (name, errs)
    if not timing:
        return errs
    wb = (q.float() * s).to(torch.bfloat16)
    pack = _int8pack_available()
    qt = q.t().contiguous() if pack else None
    sb = s.to(torch.bfloat16)
    times = {}
    for m in ms_list:
        xm = x[:m].contiguous()
        t = dict(ms=time_ms(lambda: int8_matmul(xm, q, s, "kernel")),
                 plain_ms=time_ms(lambda: int8_matmul(xm, q, s, "reference")),
                 library_ms=time_ms(lambda: xm @ wb))
        if pack and m <= 32:        # seconds a call at prefill sizes
            t["int8pack_ms"] = time_ms(
                lambda: torch._weight_int8pack_mm(xm, qt, sb), reps=5)
        t["bound_ms"], t["bound_by"] = int8_bound_ms(m, K, N)
        times[m] = t
    errs["times"] = times
    torch.cuda.empty_cache()
    return errs


def int8_kernel_phase() -> dict:
    rec = {}
    for name, (K, N) in INT8_SHAPES.items():
        e = check_int8(name, K, N, seed=40 + len(rec))
        log(f"int8 {name} (K={K}, N={N}): " + " ".join(
            f"{k}={v:.4g}" for k, v in e.items() if k != "times"))
        for m, t in e["times"].items():
            log(f"int8 {name} M={m}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, cuBLAS bf16 {t['library_ms']:.4f} "
                f"ms" + (f", int8pack {t['int8pack_ms']:.4f} ms"
                         if "int8pack_ms" in t else "")
                + f", bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        rec[name] = e
    for M in (32, 256, 4096):
        st = int8_step_record(rec, M)
        log(f"int8 step sum at M={M} (7 projections + lm_head): kernel "
            f"{st['ms']:.4f} ms, cuBLAS bf16 {st['library_ms']:.4f} ms, "
            f"bound {st['bound_ms']:.4f} ms ({st['bound_by']})")
    log("int8 kernel: rows bitwise equal at M = " + ", ".join(
        map(str, INT8_MS)) + " and in reversed order; torch int8pack CUDA "
        f"kernel {'present' if _int8pack_available() else 'absent'}")
    return rec


LLAMA_INT8_COUNT = {"wq_wo": 2, "wk_wv": 2, "gate_up": 2, "down": 1,
                    "lm_head": 1}


def int8_step_record(rec: dict, M: int = 32,
                     count=LLAMA_INT8_COUNT) -> dict:
    """The int8 products of one step at M rows: the seven projections of
    a layer plus lm_head (times, bounds summed; ``count`` is each
    shape's number). M = 32 is a decode step at the bench mix; M = 256
    and 4096 weigh prefill's shapes alike."""
    out = {}
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out[key] = sum(n * rec[s]["times"][M][key] for s, n in count.items())
    out["bound_by"] = "bytes" if all(
        rec[s]["times"][M]["bound_by"] == "bytes" for s in count) \
        else "operations"
    out["max_abs_err"] = max(rec[s]["bf16_max_abs_err"] for s in count)
    return out


# ---------------------------------------------------------------------------
# paged and int8 decode paths on llama3_8b
# ---------------------------------------------------------------------------

BENCH_NEW = 16          # new tokens per stream in the bench mix
# int8 vs bf16 prefill logits: the JAX package's form (tests/
# test_int8_decode.py), max |dlogit| < c x max(std, 1). Its c = 0.2 is set
# for a 4-layer, 64-wide model and 512 logits; here the quantization noise
# of 32 random 4096-wide layers reaches 4.1 M logits. The bf16 logit std
# measured 1.0002, so the std (not the floor of 1) sets the bound, and
# the max of the 4.1 M differences measured 0.31 x std on an H100 80GB
# HBM3 (700 W) with this script, above 0.2. 0.5 leaves 1.6x; unrelated
# logits (a broken quantizer) differ by the logit scale, about 5 std.
INT8_LOGIT_SPREAD = 0.5


def bench_mix(vocab: int, seed: int = 7):
    """bench.py's paged mix: 32 prompts of 64 + 1952 i / 31 tokens,
    right-padded to 2048, page size 32."""
    lens = np.asarray(PAGED_BENCH["lens"], np.int32)
    rng = np.random.RandomState(seed)
    prompt = np.zeros((lens.size, 2048), np.int32)
    for i, n in enumerate(lens):
        prompt[i, :n] = rng.randint(0, vocab, n)
    return (torch.as_tensor(prompt, device="cuda"),
            torch.as_tensor(lens, device="cuda"))


def decode_counters() -> dict:
    from paddle_tpu_torch.ops.kernels import int8_matmul as im
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    return {"paged_attention": pa.paged_attention,
            "paged_attention_stats": pa.paged_attention_stats,
            "int8_matmul": im.int8_matmul,
            "ragged_paged_attention": rpa.ragged_paged_attention_packed}


def _zero_counts() -> None:
    for fn in decode_counters().values():
        fn.launches = 0


def _counts() -> dict:
    return {n: fn.launches for n, fn in decode_counters().items()}


def compare_logits(name, got, ref, tol: float = DECODE_LOGITS_REL_TOL) -> dict:
    """max |dlogit| within ``tol`` x the logit scale; greedy tokens equal
    on every row whose top-2 gap in ``ref`` exceeds that bound."""
    assert torch.isfinite(got).all(), f"{name}: non-finite logits"
    diff = float((got - ref).abs().max())
    scale = float(ref.abs().max())
    bound = tol * scale
    top = ref.topk(2, dim=-1).values
    sure = (top[:, 0] - top[:, 1]) > bound
    same = got.argmax(-1) == ref.argmax(-1)
    assert diff <= bound, (name, diff, scale)
    assert bool(same[sure].all()), (name, "greedy token differs on a row "
                                    "whose top-2 gap exceeds the bound")
    log(f"{name}: max |dlogit| {diff:.4g} (logit scale {scale:.4g}, bound "
        f"{tol} x scale); greedy equal on {int(same.sum())}/{same.numel()} "
        f"rows ({int(sure.sum())} with top-2 gap above the bound, all equal)")
    return dict(max_abs_diff=diff, scale=scale,
                greedy_equal=int(same.sum()), rows=same.numel())


def step_bytes(params, prompt_lens, new: int, cfg) -> tuple:
    """Bytes one decode step of generate_paged reads: the weight stream
    (``decode_weight_bytes``) and the live K/V (prompt plus half the
    tail on average), bf16."""
    from paddle_tpu_torch.quantization import decode_weight_bytes
    kv_tok = (cfg.num_hidden_layers * cfg.num_key_value_heads
              * cfg.head_dim * 2 * 2)
    keys = int(prompt_lens.sum()) + prompt_lens.numel() * (new - 1) / 2
    return decode_weight_bytes(params), keys * kv_tok


def paged_decode_run(name, params, cfg, prompt, lens, ref_params=None,
                     ref_attn="kernel") -> dict:
    """From one shared prefill: the first decode step with the kernels vs
    ``ref_params`` / ``ref_attn`` (the plain version under test), then
    BENCH_NEW - 1 timed decode steps. Returns the prefill logits, the
    comparison and ms per step."""
    from paddle_tpu_torch.models import llama
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits0, cache = llama.prefill_paged(params, prompt, lens, cfg,
                                         BENCH_NEW, PAGED_BENCH["ps"])
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    tok = logits0.argmax(-1)
    lk = llama._decode_paged_step(params, tok, cache, cfg, "kernel")
    cache["n_tail"] = 0
    lr = llama._decode_paged_step(ref_params or params, tok, cache, cfg,
                                  ref_attn)
    cache["n_tail"] = 0
    cmp = compare_logits(name, lk, lr)
    times = []
    for _ in range(BENCH_NEW - 1):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        tok = llama._decode_paged_step(params, tok, cache, cfg).argmax(-1)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    del cache
    torch.cuda.empty_cache()
    return dict(cmp, logits0=logits0, prefill_s=prefill_s,
                step_ms=float(np.median(times)) * 1e3)


def paged_paths_phase(params, cfg) -> dict:
    """generate_paged in bf16 and int8 at the bench mix,
    serving_decode_block, and ServingEngine(quantization="int8"), each
    with its launch counts asserted."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.quantization import quantize_for_decode

    L, new, ps = cfg.num_hidden_layers, BENCH_NEW, PAGED_BENCH["ps"]
    prompt, lens = bench_mix(cfg.vocab_size)
    B = lens.numel()
    rec = {}

    def drive(p, tag):
        _zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = llama.generate_paged(p, prompt, lens, cfg, new, page_size=ps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = _counts()
        assert out.shape == (B, new) and out.dtype == torch.int32, out.shape
        assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
        log(f"generate_paged {tag}: {B} streams x {new} tokens in "
            f"{wall:.3f} s; launches {counts}")
        return out, counts, wall

    out16, c16, wall16 = drive(params, "bf16")
    assert c16 == dict(paged_attention=0, paged_attention_stats=L * (new - 1),
                       int8_matmul=0, ragged_paged_attention=0), c16
    r16 = paged_decode_run("generate_paged bf16 first decode step, paged "
                           "kernel vs plain attention", params, cfg, prompt,
                           lens, ref_attn="reference")
    w16, kv16 = step_bytes(params, lens, new, cfg)

    t0 = time.perf_counter()
    qparams = quantize_for_decode(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    out8, c8, wall8 = drive(qparams, "int8")
    assert c8 == dict(paged_attention=0, paged_attention_stats=L * (new - 1),
                      int8_matmul=(7 * L + 1) * new,
                      ragged_paged_attention=0), c8
    plain8 = plain_int8(qparams)
    r8 = paged_decode_run("generate_paged int8 first decode step, int8 "
                          "kernel vs plain int8 product", qparams, cfg,
                          prompt, lens, ref_params=plain8)
    w8, kv8 = step_bytes(qparams, lens, new, cfg)
    lg16, lg8 = r16.pop("logits0"), r8.pop("logits0")
    err = float((lg16 - lg8).abs().max())
    std = float(lg16.std())
    spread = max(std, 1.0)
    match = float((out16 == out8).float().mean())
    log(f"int8 vs bf16 prefill logits: max |dlogit| {err:.4g}, mean "
        f"{float((lg16 - lg8).abs().mean()):.4g}; logit std {std:.6g}, "
        f"bound {INT8_LOGIT_SPREAD} x max(std, 1) = "
        f"{INT8_LOGIT_SPREAD * spread:.4g}; greedy tokens equal on "
        f"{match:.3f} of {B} x {new}")
    assert err < INT8_LOGIT_SPREAD * spread, (err, spread)
    for tag, r, w, kv in (("bf16", r16, w16, kv16), ("int8", r8, w8, kv8)):
        r.update(weight_bytes=w, kv_bytes=kv,
                 weight_bound_ms=w / H100_BYTES_PER_S * 1e3,
                 bound_ms=(w + kv) / H100_BYTES_PER_S * 1e3,
                 tokens_per_s=B / r["step_ms"] * 1e3)
        log(f"paged decode {tag}: prefill {r['prefill_s']:.3f} s; decode "
            f"{r['step_ms']:.3f} ms/step (median of {new - 1}), "
            f"{r['tokens_per_s']:.1f} tokens/s; step reads "
            f"{w / 1e9:.3f} GB of weights + {kv / 1e9:.3f} GB of KV: bound "
            f"{r['weight_bound_ms']:.3f} ms (weights) / {r['bound_ms']:.3f} "
            f"ms (weights + KV)")
    rec["generate_paged"] = dict(bf16=dict(r16, launches=c16, wall_s=wall16),
                                 int8=dict(r8, launches=c8, wall_s=wall8,
                                           quantize_s=quant_s,
                                           logit_err_vs_bf16=err,
                                           logit_std_bf16=std,
                                           token_match_vs_bf16=match))
    del plain8, qparams, prompt, lens, out16, out8
    torch.cuda.empty_cache()

    rec["decode_block"] = decode_block_run(params, cfg)
    rec["engine_int8"] = engine_int8_run(params, cfg)
    torch.cuda.empty_cache()
    return rec


def plain_int8(params):
    """The params with every ``Int8Weight`` (nested dicts too) as a
    ``PlainInt8Weight`` sharing its leaves: the plain int8 product, the
    comparison's side."""
    from paddle_tpu_torch.ops.fused.int8_matmul import Int8Weight

    class PlainInt8Weight(Int8Weight):
        """An int8 weight whose product is the plain version; ``w[i]``
        keeps the class."""
        __slots__ = ()

        def dequant_matmul(self, x, impl: str = "reference"):
            return super().dequant_matmul(x, impl="reference")

    def walk(node):
        if isinstance(node, Int8Weight):
            return PlainInt8Weight(node.q, node.scale)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node
    return walk(params)


def decode_block_run(params, cfg, steps: int = 4) -> dict:
    """serving_decode_block over shared pools: 8 slots (one dead, all
    trash) with 1-2000 cached tokens of random KV, ``steps`` steps."""
    mod = model_module(cfg)
    L, ps = cfg.num_hidden_layers, 16
    lengths = [300, 77, 500, 1000, 0, 16, 2000, 64]
    pps = -(-(max(lengths) + steps) // ps)
    S = len(lengths)
    pools = mod.init_serving_pages(cfg, 1 + S * pps, ps)
    gen = torch.Generator(device="cuda").manual_seed(3)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=gen, device="cuda"))
    tables = np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps)
    tables[4] = 0
    tok = torch.as_tensor(np.random.RandomState(2).randint(
        cfg.vocab_size, size=S).astype(np.int32), device="cuda")
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, _, _ = mod.serving_decode_block(
        params, tok, torch.as_tensor(np.asarray(lengths, np.int32),
                                     device="cuda"),
        torch.as_tensor(tables, device="cuda"), pools["k_pages"],
        pools["v_pages"], cfg, num_steps=steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    assert counts["paged_attention"] == L * steps, counts
    assert counts["paged_attention_stats"] == 0, counts
    assert toks.shape == (S, steps) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all())
    log(f"serving_decode_block ({mod.__name__.rsplit('.', 1)[-1]}): {S} "
        f"slots x {steps} steps in {wall:.3f} s "
        f"({wall / steps * 1e3:.2f} ms/step); paged-attention launches "
        f"{counts['paged_attention']} (= {L} layers x {steps})")
    del pools
    torch.cuda.empty_cache()
    return dict(launches=counts, wall_s=wall, step_ms=wall / steps * 1e3)


def engine_int8_run(params, cfg) -> dict:
    """ServingEngine(quantization="int8") on phase 4's 16 requests, from
    phase 4's bf16 params: the engine quantizes them at construction."""
    from paddle_tpu_torch.quantization import is_quantized_params
    from paddle_tpu_torch.serving import ServingEngine
    L = cfg.num_hidden_layers
    assert not is_quantized_params(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = ServingEngine(params, cfg, quantization="int8", max_batch=8,
                        page_size=16, max_prompt_len=512,
                        max_new_tokens_cap=32, prefill_chunk=256,
                        decode_block_size=4)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assert is_quantized_params(eng._params), "the engine did not quantize"
    prompts, new = _requests(cfg.vocab_size)
    eng.generate(np.arange(1, 41, dtype=np.int32), 4)      # warm-up
    steps0 = eng.stats()["counters"]["model_steps"]
    _zero_counts()
    t0 = time.perf_counter()
    handles = [eng.submit(p, n) for p, n in zip(prompts, new)]
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    counts = _counts()
    snap = eng.stats()
    eng.close()
    steps = snap["counters"]["model_steps"] - steps0
    for o, n in zip(outs, new):
        assert o.shape == (n,) and ((o >= 0) & (o < cfg.vocab_size)).all()
    assert counts["int8_matmul"] == (7 * L + 1) * steps, (counts, steps)
    assert counts["ragged_paged_attention"] == L * steps, (counts, steps)
    ttft = float(np.mean([h.ttft_s for h in handles]))
    tokens = sum(new)
    log(f"ServingEngine(quantization='int8'): {len(outs)} requests, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s; "
        f"mean TTFT {ttft:.4f} s; {steps} model steps; int8 launches "
        f"{counts['int8_matmul']} (= (7 x {L} + 1) x {steps}); built "
        f"(bf16 params quantized) in {build_s:.3f} s")
    return dict(launches=counts, tok_s=tokens / wall, mean_ttft_s=ttft,
                model_steps=steps, build_s=build_s)


# ---------------------------------------------------------------------------
# sampling and speculation on llama3_8b (phase 13)
# ---------------------------------------------------------------------------

# sampled tokens on the card must equal the CPU's on every row whose two
# largest perturbed logits (masked logits + Gumbel noise, on the CPU)
# differ by more than this: the threefry bits are equal bitwise, the
# Gumbel noise (an f32 log of a log) and the masks' softmax / cumsum may
# round differently on the two devices, by well under this margin
SAMPLE_MARGIN = 1e-4
# the rows of phase 13's sampler checks, repeated: (temperature, top_p,
# top_k) — greedy; the engine's sampled requests; and the two filters
# that leave only the argmax
SAMPLER_ROWS = ((0.0, 1.0, 0), (0.8, 0.95, 50), (0.8, 1.0, 1),
                (0.8, 0.0, 0))
SPEC_K = 4
# the verify tick at the serving phase's geometry (8 slots, 34 pages of
# 16): slots 0-2 draft 4 tokens behind 300 / 77 / 500 cached, slots 3-4
# draft 2 behind 120 / 530, slots 5-6 decode plainly over 200 / 16,
# slot 7 prefills 256 tokens behind a 64-token cached prefix
VERIFY_DRAFTS = {0: (300, 4), 1: (77, 4), 2: (500, 4), 3: (120, 2),
                 4: (530, 2)}
VERIFY_DECODE = {5: 200, 6: 16}
VERIFY_SPAN = (7, 64, 256)
# slots whose first n drafts are the plain tick's own picks: slot 0 all 4
# (full acceptance, greedy), slot 1 the first 2 (accepts 2, sampled),
# slot 3 both (full acceptance, sampled); slots 2 and 4 keep random drafts
VERIFY_PLANT = {0: 4, 1: 2, 3: 2}
# reps of phase 13 c's repetitive and random greedy waves on each engine
SPEC_WAVE_REPS = 5
# the sampled requests' parameters (phase 13 c and d)
SAMPLED = dict(temperature=0.8, top_p=0.95, top_k=50)


def sampler_arrays(n: int, device, seed: int = 0) -> dict:
    """``_fused_sample``'s per-row arrays for ``n`` rows cycling through
    ``SAMPLER_ROWS``, with each row's key and continuation index."""
    from paddle_tpu_torch import prng
    rows = [SAMPLER_ROWS[i % len(SAMPLER_ROWS)] for i in range(n)]
    rng = np.random.RandomState(seed)
    keys = torch.stack([prng.key(int(s)) for s in
                        rng.randint(-1 << 31, 1 << 31, n)])
    out = dict(temp=torch.tensor([r[0] for r in rows]),
               top_p=torch.tensor([r[1] for r in rows]),
               top_k=torch.tensor([r[2] for r in rows], dtype=torch.int32),
               keys=keys, idx=torch.as_tensor(rng.randint(0, 64, n),
                                              dtype=torch.int32))
    return {k: v.to(device) for k, v in out.items()}


def sampler_cost(fn, reps: int = 10) -> dict:
    """One sampler call: host ms (the Python call while a device sleep
    keeps the card busy, so the host never waits), device ms (CUDA
    events around the call, queued behind the sleep, so the kernels run
    back to back), and the kernels it launches and their summed device
    time (``torch.profiler``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    for _ in range(3):
        fn()
    host, dev = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        fn()
        host.append((time.perf_counter() - t0) * 1e3)
        b.record()
        b.synchronize()
        dev.append(a.elapsed_time(b))
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels, busy = 0, 0.0
    for it in prof.key_averages():
        if it.device_type == DeviceType.CUDA:
            kernels += int(it.count)
            t = getattr(it, "self_device_time_total", None)
            busy += float(it.self_cuda_time_total if t is None else t)
    return dict(host_ms=float(np.median(host)),
                device_ms=float(np.median(dev)), kernels=kernels,
                busy_ms=busy / 1e3)


def check_sampler(rows: int, vocab: int, seed: int) -> dict:
    """The tick's sampler on the card against the same function on the
    CPU, on ``[rows, vocab]`` f32 logits: threefry bits bitwise,
    degenerate rows bitwise the argmax, sampled tokens equal above
    ``SAMPLE_MARGIN``; its cost per call."""
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models import llama
    gen = torch.Generator().manual_seed(seed)
    logits = torch.randn((rows, vocab), generator=gen) * 4.0
    cpu = sampler_arrays(rows, "cpu", seed)
    gpu = {k: v.to("cuda") for k, v in cpu.items()}
    lg = logits.to("cuda")
    kb_cpu = prng.fold_in(cpu["keys"], cpu["idx"])
    kb_gpu = prng.fold_in(gpu["keys"], gpu["idx"])
    assert torch.equal(kb_gpu.cpu(), kb_cpu), "fold_in differs"
    bits_cpu = prng.bits(kb_cpu, (vocab,))
    assert torch.equal(prng.bits(kb_gpu, (vocab,)).cpu(), bits_cpu), \
        "threefry bits differ between the card and the CPU"

    def run(lgt, a):
        return llama._fused_sample(lgt, a["temp"], a["top_p"], a["top_k"],
                                   a["keys"], a["idx"])

    got, want = run(lg, gpu).cpu(), run(logits, cpu)
    top = logits.argmax(-1).int()
    degen = torch.tensor([i % len(SAMPLER_ROWS) != 1 for i in range(rows)])
    assert torch.equal(got[degen], top[degen]), \
        "a greedy / top_k 1 / top_p 0 row is not the argmax"
    assert torch.equal(want[degen], top[degen])
    pert = (llama._draw_mask(logits, cpu["temp"], cpu["top_p"],
                             cpu["top_k"]) + prng.gumbel(kb_cpu, (vocab,)))
    two = pert.topk(2, dim=-1).values
    sure = (two[:, 0] - two[:, 1]) > SAMPLE_MARGIN
    close = int((~sure & ~degen).sum())
    assert torch.equal(got[sure], want[sure]), \
        "a sampled token differs from the CPU's above the margin"
    same = int((got == want).sum())
    cost = sampler_cost(lambda: run(lg, gpu))
    greedy = sampler_cost(lambda: lg.argmax(-1).int())
    log(f"sampler [{rows}, {vocab}] card vs CPU: fold_in and threefry bits "
        f"bitwise equal; degenerate rows bitwise the argmax; tokens equal "
        f"on {same}/{rows} rows ({close} sampled rows under the "
        f"{SAMPLE_MARGIN} margin); a sampled tick's sampler: host "
        f"{cost['host_ms']:.3f} ms, device {cost['device_ms']:.3f} ms "
        f"({cost['kernels']} kernels, busy {cost['busy_ms']:.3f} ms); the "
        f"greedy argmax: host {greedy['host_ms']:.3f} ms, device "
        f"{greedy['device_ms']:.3f} ms ({greedy['kernels']} kernels)")
    return dict(rows=rows, tokens_equal=same, under_margin=close,
                sampled=cost, greedy=greedy)


def verify_tick_run(params, cfg) -> dict:
    """One speculative verify tick (spec_k 4) at the serving geometry,
    with the ragged kernel and with the plain attention, the same
    weights and pools, half the slots sampling. Some slots' drafts are
    the plain tick's own picks (``VERIFY_PLANT``), so acceptance runs.
    The logits at every verify position within ``LOGITS_REL_TOL``; the
    picks and ``accept`` equal wherever no token's logit difference
    between the two ticks can reorder the plain pick; L ragged
    launches."""
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    L, S, ps, pps = cfg.num_hidden_layers, TICK_S, 16, TICK_PPS
    kk, V = 1 + SPEC_K, cfg.vocab_size
    pools = llama.init_serving_pages(cfg, 1 + S * pps, ps)
    g = torch.Generator(device="cuda").manual_seed(5)
    for t in pools.values():
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    rng = np.random.RandomState(13)
    slot, start, take = VERIFY_SPAN
    decode = [(s, rng.randint(V), n) for s, n in VERIFY_DECODE.items()]
    spans = [(slot, rng.randint(0, V, take), start)]
    cur = {s: rng.randint(V) for s in VERIFY_DRAFTS}
    drafts = {s: rng.randint(0, V, k) for s, (_, k) in VERIFY_DRAFTS.items()}
    tables = np.arange(1, 1 + S * pps, dtype=np.int32).reshape(S, pps)
    samp = dict(temp=torch.tensor([0.0, 0.8] * (S // 2)),
                top_p=torch.tensor([1.0, 0.95] * (S // 2)),
                top_k=torch.tensor([0, 50] * (S // 2), dtype=torch.int32),
                key=torch.stack([prng.key(s) for s in range(S)]),
                produced=torch.arange(S, dtype=torch.int32))

    def tick(impl):
        tok, meta = llama.pack_tick(
            decode, spans, tables, ps, "cuda", spec_k=SPEC_K,
            drafts=[(s, cur[s], n, drafts[s])
                    for s, (n, _) in VERIFY_DRAFTS.items()])
        meta.update({k: v.to("cuda") for k, v in samp.items()})
        kp, vp = (t.clone() for t in pools.values())
        rpa.ragged_paged_attention_packed.launches = 0
        out = llama.serving_tick(params, tok, meta, kp, vp, cfg,
                                 spec_k=SPEC_K, attn_impl=impl)
        return out[:3], rpa.ragged_paged_attention_packed.launches, meta

    # pass j sets draft j of each planted slot to the plain tick's pick
    # after span tokens 0..j, which the drafts planted before it decide
    for j in range(max(VERIFY_PLANT.values())):
        (picks, _, _), _, _ = tick("reference")
        for s, n in VERIFY_PLANT.items():
            if j < n:
                drafts[s][j] = int(picks[s, j])
    (rt, ra, rl), r_launches, meta = tick("reference")
    (kt, ka, kl), k_launches, _ = tick("kernel")
    assert k_launches == L, k_launches
    assert r_launches == 0
    for s, n in VERIFY_PLANT.items():
        assert int(ra[s]) >= n, (s, ra.tolist())
    assert kt.shape == (S, kk) and ka.shape == (S,)
    assert kl.shape == (S, kk, V) and torch.isfinite(kl).all()
    assert bool(((kt >= 0) & (kt < V)).all())
    assert int(ka.max()) <= SPEC_K and int(ka.min()) >= 0
    diff = float((kl - rl).abs().max())
    diff0 = float((kl[:, 0] - rl[:, 0]).abs().max())
    scale = float(rl.abs().max())
    assert diff <= LOGITS_REL_TOL * scale, (diff, scale)
    # the perturbed rows the picks maximise: the logits for a greedy row;
    # masked logits over temperature plus the draw's Gumbel noise for a
    # sampled one. A pick is clear when no token's difference between the
    # two ticks' rows can reorder it against the plain pick w: for every
    # token j, pr[w] - pr[j] > |dp[j]| + |dp[w]| (a token that one mask
    # keeps and the other drops differs by ~1e30). There the kernel
    # tick's pick must be w; elsewhere the two picks may differ by the
    # logits' rounding alone
    rows = {n: meta[n].repeat_interleave(kk, dim=0)
            for n in ("temp", "top_p", "top_k", "key")}
    idx = (meta["produced"][:, None]
           + torch.arange(kk, device="cuda")).reshape(-1)
    noise = prng.gumbel(prng.fold_in(rows["key"], idx), (V,))
    sampled = rows["temp"] > 0

    def perturbed(lg):
        m = llama._draw_mask(lg.reshape(S * kk, V), rows["temp"],
                             rows["top_p"], rows["top_k"])
        return torch.where(sampled[:, None], m + noise, lg.reshape(-1, V))

    pr, pk = perturbed(rl), perturbed(kl)
    dp = (pk - pr).abs()
    w = pr.argmax(-1, keepdim=True)
    lead = pr.gather(-1, w) - pr
    own = torch.arange(V, device="cuda")[None, :] == w
    clear = ((lead > dp + dp.gather(-1, w)) | own).all(-1).reshape(S, kk)
    del pr, pk, dp, lead, own
    assert torch.equal(kt[clear], rt[clear]), \
        "a verify pick differs from the plain tick's at a clear margin"
    # accept recounted on the host from the kernel tick's own picks: the
    # leading drafts equal to the picks at their span positions
    k_s, a_ref = meta["draft_len"].tolist(), ra.tolist()
    picks, dt = kt.cpu().numpy(), meta["draft_tok"].cpu().numpy()
    recount = [int(np.cumprod(picks[s, :k_s[s]] == dt[s, :k_s[s]]).sum())
               for s in range(S)]
    assert ka.tolist() == recount, (ka.tolist(), recount)
    assert sum(recount) > 0, "the kernel tick accepted no draft"
    # accept[s] is decided by the picks at positions 0..min(accept, k_s - 1)
    checked = [s for s in range(S)
               if bool(clear[s, :min(a_ref[s], k_s[s] - 1) + 1].all())]
    for s in checked:
        assert int(ka[s]) == a_ref[s], (s, ka.tolist(), a_ref)
    same = int((kt == rt).sum())
    log(f"verify tick (spec_k {SPEC_K}; 3 x 4 drafts, 2 x 2, 2 decode "
        f"rows, a 256-token span; half the slots sampling; drafts planted "
        f"from the plain tick's picks in slots {sorted(VERIFY_PLANT)}) "
        f"kernel vs reference: max |dlogit| {diff:.4g} over every verify "
        f"position, {diff0:.4g} at row 0 (logit scale {scale:.4g}, bound "
        f"{LOGITS_REL_TOL} x scale); picks equal on {same}/{kt.numel()}, "
        f"asserted on the {int(clear.sum())} that no logit difference can "
        f"reorder; accept kernel {ka.tolist()} (= the host's recount), "
        f"reference {a_ref}, asserted equal on slots {checked}; ragged "
        f"launches {k_launches} (= {L} layers)")
    del pools
    torch.cuda.empty_cache()
    return dict(logits_max_abs_diff=diff, row0_max_abs_diff=diff0,
                scale=scale, picks_equal=same, picks_clear=int(clear.sum()),
                accept_kernel=ka.tolist(), accept_reference=a_ref,
                accept_checked=checked)


def _spec_requests(vocab: int):
    """Phase 4's 16 requests with prompts 0, 4, 8 and 12 replaced by a
    period of 16 random tokens repeated to 128-320 tokens (the drafter
    predicts those), odd requests sampled with fixed seeds."""
    prompts, new = _requests(vocab)
    rng = np.random.RandomState(21)
    for i in (0, 4, 8, 12):
        pat = rng.randint(0, vocab, 16).astype(np.int32)
        prompts[i] = np.tile(pat, 20)[:int(rng.randint(128, 321))]
    samp = [dict(SAMPLED, seed=100 + i) if i % 2 else {}
            for i in range(16)]
    return prompts, new, samp


def _engine_wave(eng, prompts, new, samp):
    t0 = time.perf_counter()
    handles = [eng.submit(p, n, **s) for p, n, s in zip(prompts, new, samp)]
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    for o, n in zip(outs, new):
        assert o.shape == (n,), (o.shape, n)
    return outs, wall


def _greedy_waves(vocab: int, rep: int):
    """Rep ``rep``'s two greedy waves at phase 4's count (16 requests of
    192 prompt and 32 new tokens): a period of 16 random tokens repeated
    12 times, and random prompts; new prompts in every rep, so no rep
    meets the prefix cache of another."""
    rng = np.random.RandomState(22 + rep)
    return dict(repetitive=[np.tile(rng.randint(0, vocab, 16)
                                    .astype(np.int32), 12)
                            for _ in range(16)],
                random=[rng.randint(0, vocab, 192).astype(np.int32)
                        for _ in range(16)])


def spec_engine_run(params, cfg) -> dict:
    """ServingEngine(speculative="ngram", spec_k=4) against a plain
    engine on the same 16 requests; a defrag between two waves; the
    exposition; then ``SPEC_WAVE_REPS`` reps of a repetitive and a random
    greedy wave of 16 requests on both engines, the engines' order
    alternating from rep to rep: the median and range of each engine's
    tok/s and tokens per model step."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    from paddle_tpu_torch.serving import ServingEngine
    from paddle_tpu_torch.serving.metrics import _parse_exposition
    L, V = cfg.num_hidden_layers, cfg.vocab_size
    prompts, new, samp = _spec_requests(V)
    geom = dict(max_batch=8, page_size=16, max_prompt_len=512,
                max_new_tokens_cap=32, prefill_chunk=256,
                decode_block_size=4)
    engines = {"spec": ServingEngine(params, cfg, **geom,
                                     speculative="ngram", spec_k=SPEC_K),
               "plain": ServingEngine(params, cfg, **geom)}
    rec = {}
    for name, eng in engines.items():
        eng.generate(np.arange(1, 41, dtype=np.int32), 4)   # warm-up
        c0 = eng.stats()["counters"]
        rpa.ragged_paged_attention_packed.launches = 0
        outs, wall = _engine_wave(eng, prompts, new, samp)
        launches = rpa.ragged_paged_attention_packed.launches
        c = eng.stats()["counters"]
        d = {k: c[k] - c0[k] for k in c}
        assert launches == L * d["model_steps"], (launches, d)
        r = dict(outs=outs, wall_s=wall, tok_s=sum(new) / wall,
                 model_steps=d["model_steps"], spec_ticks=d["spec_ticks"],
                 draft_tokens=d["draft_tokens"],
                 draft_accepted=d["draft_accepted"],
                 tokens_per_launch=d["tokens_out"] / d["model_steps"])
        log(f"engine {name}: 16 requests (8 sampled, 4 periodic prompts), "
            f"{sum(new)} tokens in {wall:.3f} s = {r['tok_s']:.1f} tok/s "
            f"(one run); {d['model_steps']} model steps, {launches} ragged "
            f"launches (= {L} x model steps); {r['tokens_per_launch']:.3f} "
            f"tokens a model launch; verify ticks {d['spec_ticks']}, "
            f"drafts {d['draft_tokens']}, accepted {d['draft_accepted']}")
        rec[name] = r
    eng = engines["spec"]
    d = rec["spec"]
    assert d["spec_ticks"] > 0 and d["draft_accepted"] > 0, d
    moved = eng.defragment()
    assert moved > 0, "defragment() moved no page"
    rng = np.random.RandomState(23)
    wave2 = [prompts[i] for i in (1, 4, 10)] + \
        [rng.randint(0, V, n).astype(np.int32) for n in (50, 300, 17)]
    _engine_wave(eng, wave2, [12, 20, 8, 16, 9, 24],
                 [{}, dict(SAMPLED, seed=7)] * 3)
    text = eng.expose(labels={"engine": "spec"})
    fam = _parse_exposition(text, "paddle_serving")
    done = fam["counters"]["completed"][0][1]
    assert done == 1 + 16 + 6, done
    log(f"engine spec: defragment() moved {moved} pages between the waves; "
        f"the second wave (3 prompts of the first, whose prefix pages "
        f"moved, and 3 new) completed; expose() "
        f"({len(text.splitlines())} lines) parses back, {done} requests "
        f"completed")
    rec["spec"].update(defrag_moved=moved)
    runs = {(n, w): [] for n in engines for w in ("repetitive", "random")}
    for rep in range(SPEC_WAVE_REPS):
        order = list(engines) if rep % 2 == 0 else list(engines)[::-1]
        for wave, ps_ in _greedy_waves(V, rep).items():
            for name in order:
                eng = engines[name]
                n0 = llama.sample_draw.launches
                s0 = eng.stats()["counters"]
                _, w = _engine_wave(eng, ps_, [32] * 16, [{}] * 16)
                s1 = eng.stats()["counters"]
                assert llama.sample_draw.launches == n0, \
                    "an all-greedy wave launched the sampler"
                steps = s1["model_steps"] - s0["model_steps"]
                runs[name, wave].append(dict(
                    tok_s=512 / w, tokens_per_launch=512 / steps,
                    drafted=s1["draft_tokens"] - s0["draft_tokens"],
                    accepted=s1["draft_accepted"] - s0["draft_accepted"]))
    for (name, wave), rs in runs.items():
        tok_s = [x["tok_s"] for x in rs]
        tpl = [x["tokens_per_launch"] for x in rs]
        rec[name][wave] = dict(
            tok_s_median=float(np.median(tok_s)), tok_s_min=min(tok_s),
            tok_s_max=max(tok_s), tpl_median=float(np.median(tpl)),
            tpl_min=min(tpl), tpl_max=max(tpl),
            drafted=sum(x["drafted"] for x in rs),
            accepted=sum(x["accepted"] for x in rs))
        log(f"engine {name}, {wave} prompts ({SPEC_WAVE_REPS} reps of 16 x "
            f"192 tokens, 32 new, greedy; no sampler launch): tok/s median "
            f"{np.median(tok_s):.1f} (range {min(tok_s):.1f}-"
            f"{max(tok_s):.1f}; runs {', '.join(f'{x:.1f}' for x in tok_s)}"
            f"); tokens a model launch median {np.median(tpl):.3f} (range "
            f"{min(tpl):.3f}-{max(tpl):.3f}); drafts "
            f"{rec[name][wave]['drafted']}, accepted "
            f"{rec[name][wave]['accepted']}")
    for wave in ("repetitive", "random"):
        a, b = rec["spec"][wave], rec["plain"][wave]
        log(f"spec / plain, {wave} prompts: tok/s median "
            f"{a['tok_s_median'] / b['tok_s_median']:.3f}x (worst spec run "
            f"/ best plain run {a['tok_s_min'] / b['tok_s_max']:.3f}x, best "
            f"/ worst {a['tok_s_max'] / b['tok_s_min']:.3f}x); tokens a "
            f"model launch {a['tpl_median'] / b['tpl_median']:.3f}x")
    for eng in engines.values():
        eng.close()
    torch.cuda.empty_cache()
    agree = [bool(np.array_equal(a, b)) for a, b in
             zip(rec["spec"].pop("outs"), rec["plain"].pop("outs"))]
    greedy = sum(agree[0::2])
    sampled = sum(agree[1::2])
    log(f"spec vs plain engine, the 16 mixed requests: streams equal on "
        f"{greedy}/8 greedy and {sampled}/8 sampled requests (reported, "
        f"not required: cuBLAS does not promise row invariance across "
        f"batch shapes)")
    rec.update(greedy_equal=greedy, sampled_equal=sampled)
    return rec


def sampled_paged_run(params, cfg) -> dict:
    """Sampled generate_paged at the bench mix (bf16, 16 new tokens):
    the paged kernel's launches as in phase 8; the per-step sampler's
    host and device ms."""
    from paddle_tpu_torch import prng
    from paddle_tpu_torch.models import llama
    L, new, ps = cfg.num_hidden_layers, BENCH_NEW, PAGED_BENCH["ps"]
    prompt, lens = bench_mix(cfg.vocab_size)
    B = lens.numel()
    _zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = llama.generate_paged(params, prompt, lens, cfg, new,
                               page_size=ps, key=prng.key(7), **SAMPLED)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _counts()
    assert counts == dict(paged_attention=0,
                          paged_attention_stats=L * (new - 1),
                          int8_matmul=0, ragged_paged_attention=0), counts
    assert out.shape == (B, new) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())
    logits = torch.randn((B, cfg.vocab_size), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(8)) * 4.0
    key = prng.key(7, "cuda")
    cost = sampler_cost(lambda: llama.sample_logits(logits, key, **SAMPLED))
    log(f"sampled generate_paged bf16: {B} streams x {new} tokens in "
        f"{wall:.3f} s; launches {counts}; its sampler a step "
        f"(sample_logits, [{B}, {cfg.vocab_size}]): host "
        f"{cost['host_ms']:.3f} ms, device {cost['device_ms']:.3f} ms "
        f"({cost['kernels']} kernels, busy {cost['busy_ms']:.3f} ms)")
    del prompt, lens, logits
    torch.cuda.empty_cache()
    return dict(launches=counts, wall_s=wall, sampler=cost)


def sampling_phase(params, cfg) -> dict:
    """Phase 13: the sampler on the card against the CPU at S 8 and
    S 8 x (1 + 4) rows, one verify tick, the speculative engine against
    a plain one, and sampled generate_paged."""
    rec = {f"sampler_{n}": check_sampler(n, cfg.vocab_size, seed=30 + n)
           for n in (TICK_S, TICK_S * (1 + SPEC_K))}
    rec["verify_tick"] = verify_tick_run(params, cfg)
    rec["engine"] = spec_engine_run(params, cfg)
    rec["generate_paged"] = sampled_paged_run(params, cfg)
    return rec


# ---------------------------------------------------------------------------
# KV-chain migration and the cold tier on llama3_8b (phase 15)
# ---------------------------------------------------------------------------

# every engine of phase 15: 4 slots, page 16, prompts up to 1088 tokens, 32
# new, the paged-KV audit after every tick and around every defrag
# (562 MiB of pool an engine at the default 281 pages)
MIG_GEOM = dict(max_batch=4, page_size=16, max_prompt_len=1088,
                max_new_tokens_cap=32, check_invariants=True)
MIG_PROMPT = 1040        # 65 full pages a chain
MIG_NEW = 32             # greedy tokens of each continuation
MIG_CHUNK = 8            # pages a chunk of (b)'s transfer
# the ragged kernel at engine B's shapes over pages at arbitrary ids (as
# adopted ones are): a continuation's 16-token span behind 1040 cached
# tokens and a decode row at the continuation's last position
CASE_ADOPTED = dict(slots=[(16, 1056), (1, 1087), (0, 0), (0, 0)], pps=70,
                    shuffle=True)


def check_placement_invariance(case, seed: int = 7) -> None:
    """Bitwise: the same KV bytes with every page moved to another id
    (tables rewritten to match) give the same bf16 output."""
    c = cast(case, torch.bfloat16)
    P = c["k_pages"].shape[1]
    dev = c["q"].device
    new_id = torch.as_tensor(np.concatenate(
        [[0], np.random.RandomState(seed).permutation(np.arange(1, P))]),
        device=dev)
    moved = dict(c, k_pages=torch.empty_like(c["k_pages"]),
                 v_pages=torch.empty_like(c["v_pages"]),
                 tables=new_id[c["tables"].long()].to(torch.int32))
    moved["k_pages"][:, new_id] = c["k_pages"]
    moved["v_pages"][:, new_id] = c["v_pages"]
    assert torch.equal(run_rpa(c, "kernel"), run_rpa(moved, "kernel")), \
        "ragged kernel output depends on the page placement"


def adopted_kernel_case() -> dict:
    """The ragged kernel at engine B's shapes against its plain version
    (phase 3's bounds), under two page placements bitwise, and its
    kernel, plain, SDPA and bound times."""
    case = make_case(**CASE_ADOPTED, **GEOM, seed=15)
    rec = check_case("adopted", case)
    check_placement_invariance(case)
    c16 = cast(case, torch.bfloat16)
    rec.update(ms=time_ms(lambda: run_rpa(c16, "kernel")),
               plain_ms=time_ms(lambda: run_rpa(c16, "reference"), reps=5),
               library_ms=time_ms(sdpa_yardstick(c16)))
    rec["bound_ms"], rec["bound_by"] = attention_bound_ms(c16)
    log("ragged case adopted (16-token span behind 1040 keys and a decode "
        "row over 1087, shuffled pages): " + " ".join(
            f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items())
        + "; two page placements of the same bytes bitwise equal")
    del case, c16
    torch.cuda.empty_cache()
    return rec


def continue_chain(eng, prompt, new: int = MIG_NEW) -> dict:
    """``prompt`` alone on ``eng``, the ragged kernel's count zeroed just
    before and read just after: tokens, prefix tokens attached, model
    steps, ragged launches, TTFT."""
    from paddle_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    c0 = eng.snapshot()["counters"]
    rpa.ragged_paged_attention_packed.launches = 0
    h = eng.submit(prompt, new)
    out = h.result(timeout=600)
    launches = rpa.ragged_paged_attention_packed.launches
    c1 = eng.snapshot()["counters"]
    return dict(tokens=out, launches=launches,
                cached=c1["prefix_hit_tokens"] - c0["prefix_hit_tokens"],
                steps=c1["model_steps"] - c0["model_steps"],
                ttft_s=h.ttft_s)


def _chain_pages(eng, fp: int) -> list:
    with eng._tick_lock:
        return [nd.page for nd in
                eng.prefix_cache.chain_by_fingerprint(fp, max_depth=65)]


def _stall_max(eng, fn) -> float:
    """Largest ``decode_stall_s`` of one 32-token decode stream alone on
    ``eng`` while ``fn()`` runs (``fn`` starts once the stream's first
    token is out)."""
    hist = eng.metrics.histograms["decode_stall_s"]
    n0 = hist.summary()["count"]
    h = eng.submit(np.arange(1, 65, dtype=np.int32), MIG_NEW)
    next(iter(h))
    fn()
    h.result(timeout=600)
    with eng.metrics._lock:
        new = list(hist._vals)[-(hist.summary()["count"] - n0):]
    return float(max(new))


def migration_phase(params, cfg) -> dict:
    """Phase 15: migration and the cold tier at llama3_8b's full width
    and depth. (a) engine A serves four 1040-token chains; chain 0 is
    exported whole, pickled and adopted by engine B; its continuation
    (the chain + 16 new tokens, 32 greedy tokens) alone on A and on B
    gives the same tokens, B attaching all 1040 adopted tokens with
    ragged launches = L x model steps; (b) chain 1 the same way in
    chunks of 8 pages, with ``A.defragment()`` before each chunk moving
    the chain's pages mid-transfer, both engines' audits clean, then an
    adopt_chain_begin / _abort pair on chain 3 that leaves B's free pages
    as they were; (c) engine C, sized so each chain evicts the last,
    with a 1 GiB cold tier: p1 cold, p1 warm, p2, p3, then p1 rewarmed
    from host RAM (cold_hits 1, cold_hit_pages 64, its tokens the warm
    run's); (d) transfer rates, ms a spilled page, cold_adopt_s and the
    largest decode stall of a stream on A while a whole blob is
    exported."""
    import pickle

    from paddle_tpu_torch.serving import ServingEngine, prefix_fingerprints

    L = cfg.num_hidden_layers
    ps = MIG_GEOM["page_size"]
    dev = params["embed"].device
    smi = nvidia_smi_line()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(150)
    chains = [rng.randint(0, cfg.vocab_size, MIG_PROMPT).astype(np.int32)
              for _ in range(4)]
    suffix = [rng.randint(0, cfg.vocab_size, 16).astype(np.int32)
              for _ in range(4)]
    events = {}
    A = ServingEngine(params, cfg, device=dev, **MIG_GEOM,
                      on_chain_complete=lambda req, info:
                      events.setdefault(req.id, info))
    B = ServingEngine(params, cfg, device=dev, **MIG_GEOM)
    rec = {}
    try:
        hs = [A.submit(c, 16) for c in chains]
        for h in hs:
            assert h.result(timeout=600).shape == (16,)
        fps = [events[h.id]["fp"] for h in hs]
        for c, h, fp in zip(chains, hs, fps):
            assert events[h.id]["pages"] == MIG_PROMPT // ps
            # the hook's fingerprint is the router's hash of the chain
            assert fp == prefix_fingerprints(np.append(c, 0), ps, 65)[-1]
        assert A.gauges()["prefix_cache_cached_pages"] == 4 * 65
        page_bytes = 2 * L * cfg.num_key_value_heads * ps * cfg.head_dim \
            * torch.empty((), dtype=cfg.dtype).element_size()

        # (a) whole blob
        t0 = time.perf_counter()
        blob = A.export_chain(fps[0], max_depth=65)
        t_export = time.perf_counter() - t0
        # the same export again: host memory the first one touched is
        # reused, so the difference is the first touch of fresh pages
        t0 = time.perf_counter()
        A.export_chain(fps[0], max_depth=65)
        t_again = time.perf_counter() - t0
        blob = pickle.loads(pickle.dumps(blob))
        nbytes = blob["k"].nbytes + blob["v"].nbytes
        assert nbytes == 65 * page_bytes
        assert blob["k"].shape == (L, cfg.num_key_value_heads, 65, ps,
                                   cfg.head_dim), blob["k"].shape
        assert blob["k"].dtype == (np.uint16 if cfg.dtype == torch.bfloat16
                                   else np.float32)
        t0 = time.perf_counter()
        got = B.adopt_chain(blob)
        sync()
        t_adopt = time.perf_counter() - t0
        assert got == {"matched_pages": 0, "adopted_pages": 65}, got
        assert B.audit() == []
        back = B.export_chain(fps[0], max_depth=65)     # bytes, in order
        assert np.array_equal(back["k"], blob["k"])
        assert np.array_equal(back["v"], blob["v"])
        del back
        cont = np.concatenate([chains[0], suffix[0]])
        on_a = continue_chain(A, cont)
        on_b = continue_chain(B, cont)
        for r in (on_a, on_b):
            assert r["cached"] == MIG_PROMPT, r["cached"]
        assert np.array_equal(on_a["tokens"], on_b["tokens"]), \
            (on_a["tokens"], on_b["tokens"])
        assert on_b["launches"] == L * on_b["steps"], on_b
        launches = on_b["launches"]
        rec["whole"] = dict(export_gb_s=nbytes / t_export / 1e9,
                            export_again_gb_s=nbytes / t_again / 1e9,
                            adopt_gb_s=nbytes / t_adopt / 1e9,
                            export_s=t_export, adopt_s=t_adopt,
                            bytes=nbytes)
        log(f"migration (a) whole blob of 65 pages ({nbytes / 2**20:.0f} "
            f"MiB): export {t_export * 1e3:.2f} ms = "
            f"{rec['whole']['export_gb_s']:.2f} GB/s (again "
            f"{t_again * 1e3:.2f} ms = "
            f"{rec['whole']['export_again_gb_s']:.2f} GB/s), adopt "
            f"{t_adopt * 1e3:.2f} ms = {rec['whole']['adopt_gb_s']:.2f} "
            f"GB/s; {MIG_NEW} tokens on A (warm) == on B (adopted), B "
            f"attached {on_b['cached']} tokens, {on_b['launches']} ragged "
            f"launches = {L} x {on_b['steps']} model steps [{smi}]")

        # (b) chunked, with a defrag moving the chain mid-transfer
        hdr = A.export_chain_begin(fps[1], max_depth=65)
        st = B.adopt_chain_begin({"page_size": hdr["page_size"],
                                  "tokens": hdr["tokens"]})
        assert st["need"] == 65, st
        before = _chain_pages(A, fps[1])
        moved, t_exp, t_adp, chunk_bytes = [], [], [], []
        for start in range(0, 65, MIG_CHUNK):
            moved.append(A.defragment())
            t0 = time.perf_counter()
            ch = A.export_chain_chunk(hdr["xid"], start, MIG_CHUNK)
            t_exp.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            B.adopt_chain_chunk(st["aid"], ch["start"], ch["k"], ch["v"])
            sync()
            t_adp.append(time.perf_counter() - t0)
            chunk_bytes.append(ch["k"].nbytes + ch["v"].nbytes)
            assert A.audit() == [] and B.audit() == []
        after = _chain_pages(A, fps[1])
        assert moved[0] > 0 and before != after, \
            "the defrag did not move the chain being exported"
        got = B.adopt_chain_commit(st["aid"])
        A.export_chain_end(hdr["xid"])
        assert got == {"matched_pages": 0, "adopted_pages": 65}, got
        assert A.audit() == [] and B.audit() == []
        cont = np.concatenate([chains[1], suffix[1]])
        on_a = continue_chain(A, cont)
        on_b = continue_chain(B, cont)
        for r in (on_a, on_b):
            assert r["cached"] == MIG_PROMPT, r["cached"]
        assert np.array_equal(on_a["tokens"], on_b["tokens"]), \
            (on_a["tokens"], on_b["tokens"])
        assert on_b["launches"] == L * on_b["steps"], on_b
        launches += on_b["launches"]
        full = [i for i, n in enumerate(chunk_bytes)
                if n == MIG_CHUNK * page_bytes]
        rec["chunk"] = dict(
            export_gb_s=float(np.median([chunk_bytes[i] / t_exp[i]
                                         for i in full])) / 1e9,
            adopt_gb_s=float(np.median([chunk_bytes[i] / t_adp[i]
                                        for i in full])) / 1e9,
            pages_moved=moved[0],
            moved_chain_pages=sum(a != b for a, b in zip(before, after)))
        log(f"migration (b) {len(t_exp)} chunks of {MIG_CHUNK} pages "
            f"({MIG_CHUNK * page_bytes / 2**20:.0f} MiB): export "
            f"{rec['chunk']['export_gb_s']:.2f} GB/s, adopt "
            f"{rec['chunk']['adopt_gb_s']:.2f} GB/s (medians); the defrag "
            f"before the first chunk moved {moved[0]} pages, "
            f"{rec['chunk']['moved_chain_pages']} of the chain's; tokens "
            f"on A == on B; audits clean [{smi}]")
        free = B.pool.free_pages
        hdr = A.export_chain_begin(fps[3], max_depth=65)
        st = B.adopt_chain_begin(hdr)
        assert B.pool.free_pages == free - 65 and B.audit() == []
        B.adopt_chain_abort(st["aid"])
        A.export_chain_end(hdr["xid"])
        assert B.pool.free_pages == free, (B.pool.free_pages, free)
        assert A.audit() == [] and B.audit() == []

        # (d) the stall a decode stream on A sees
        base = _stall_max(A, lambda: None)
        during = _stall_max(A, lambda: A.export_chain(fps[2],
                                                      max_depth=65))
        rec["decode_stall_s"] = dict(alone=base, export=during)
        log(f"migration (d) largest decode_stall_s of a 32-token stream "
            f"on A: {base * 1e3:.2f} ms alone, {during * 1e3:.2f} ms with "
            f"a whole-blob export of 65 pages [{smi}]")
        assert A.audit() == [] and B.audit() == []
    finally:
        A.close()
        B.close()
    rec["launches"] = launches

    # (c) the cold tier: each chain must evict the last
    need = -(-(MIG_PROMPT + 16 - 1) // ps)
    C = ServingEngine(params, cfg, device=dev, **MIG_GEOM,
                      total_pages=1 + need, cold_tier_bytes=1 << 30)
    try:
        p1, p2, p3 = (rng.randint(0, cfg.vocab_size, MIG_PROMPT)
                      .astype(np.int32) for _ in range(3))
        runs = {}
        for name, p in (("cold", p1), ("warm", p1), ("p2", p2),
                        ("p3", p3), ("rewarmed", p1)):
            h = C.submit(p, 16)
            runs[name] = (h.result(timeout=600), h.ttft_s)
            if name == "p2":
                c = C.snapshot()["counters"]
                assert c["cold_spills"] >= 65, c["cold_spills"]
                assert prefix_fingerprints(p1, ps, 1)[0] not in \
                    C.affinity_summary(1), "p1 still cached after p2"
        snap = C.snapshot()
        c = snap["counters"]
        assert c["cold_hits"] == 1 and c["cold_hit_pages"] == 64, c
        assert np.array_equal(runs["rewarmed"][0], runs["warm"][0]), runs
        agree = int((runs["rewarmed"][0] == runs["cold"][0]).sum())
        adopt_s = snap["histograms"]["cold_adopt_s"]["max"]
        assert C.audit() == []
        # ms a spilled page: the cached chain evicted through the spill
        # hook (one synchronizing copy a page); beside it, its parts
        # alone on the same pages: the chain fingerprints, the copies
        with C._tick_lock:
            nodes = C.prefix_cache.nodes()
            t0 = time.perf_counter()
            for nd in nodes:
                C.prefix_cache.node_fingerprint(nd)
            t_fp = time.perf_counter() - t0
            t0 = time.perf_counter()
            for nd in nodes:
                idx = torch.tensor([nd.page], device=dev)
                torch.index_select(C._kp, 2, idx).cpu()
                torch.index_select(C._vp, 2, idx).cpu()
            t_copy = time.perf_counter() - t0
            s0 = C.metrics.counters["cold_spills"]
            n = C.prefix_cache.cached_pages
            t0 = time.perf_counter()
            C.prefix_cache.evict(n)
            t_spill = time.perf_counter() - t0
            spilled = C.metrics.counters["cold_spills"] - s0
        assert spilled == n, (spilled, n)
        assert C.audit() == []
        rec["cold"] = dict(
            spills=c["cold_spills"], hits=c["cold_hits"],
            hit_pages=c["cold_hit_pages"], cold_adopt_s=adopt_s,
            spill_ms_a_page=t_spill / n * 1e3,
            fingerprint_ms_a_page=t_fp / n * 1e3,
            copy_ms_a_page=t_copy / n * 1e3,
            ttft_s={k: runs[k][1] for k in ("cold", "warm", "rewarmed")},
            rewarmed_equal_cold=agree)
        log(f"migration (c) cold tier: {c['cold_spills']} spills, "
            f"{c['cold_hits']} hit of {c['cold_hit_pages']} pages; p1 "
            f"rewarmed == p1 warm (16 tokens), {agree}/16 equal to p1 cold "
            f"(a 1040-token prefill, other GEMM shapes); TTFT cold "
            f"{runs['cold'][1] * 1e3:.2f} ms, warm "
            f"{runs['warm'][1] * 1e3:.2f} ms, rewarmed "
            f"{runs['rewarmed'][1] * 1e3:.2f} ms; cold_adopt_s "
            f"{adopt_s * 1e3:.2f} ms (64 pages); "
            f"{rec['cold']['spill_ms_a_page']:.3f} ms a spilled page "
            f"({n} pages; alone on them: its fingerprint "
            f"{rec['cold']['fingerprint_ms_a_page']:.3f} ms, its two "
            f"copies {rec['cold']['copy_ms_a_page']:.3f} ms) [{smi}]")
    finally:
        C.close()
    return rec


# ---------------------------------------------------------------------------
# Qwen2-MoE serving (phase 14)
# ---------------------------------------------------------------------------

# Qwen1.5-MoE-A2.7B's attention: H = Hkv = 16, so G = 1 (one query row per
# kv head: a decode row fills 1 of the 16 rows of the kernels' MMA tile)
QWEN_GEOM = dict(H=16, Hkv=16, Dh=128)
# the ragged cases of phase 3 at G = 1: a serving mix (rows within one
# 512-key chunk and over two), long-context decode over 32 chunks, the
# engine's tick, the chunk edges
QWEN_RAGGED_CASES = (("a_serving_mix", CASE_A), ("b_long_context", CASE_B),
                     ("d_engine_tick", CASE_D), ("e_chunk_edges", CASE_E))
QWEN_PAGED_CASES = (("engine_16k", PAGED_ENGINE),
                    ("chunk_edges", PAGED_EDGES))
# the int8 products of a Qwen2-MoE step, (K, N), and their count a layer
# (lm_head once a step): q, k, v, o; the shared expert's gate and up,
# then its down. The routed experts are dequantized for the einsum.
QWEN_INT8_SHAPES = {"wq_wk_wv_wo": (2048, 2048),
                    "shared_gate_up": (2048, 5632),
                    "shared_down": (5632, 2048),
                    "lm_head": (2048, 151936)}
QWEN_INT8_COUNT = {"wq_wk_wv_wo": 4, "shared_gate_up": 2, "shared_down": 1,
                   "lm_head": 1}
QWEN_INT8_MS = (8, 256)
# phase 4's engine geometry
ENGINE_GEOM = dict(max_batch=8, page_size=16, max_prompt_len=512,
                   max_new_tokens_cap=32, prefill_chunk=256,
                   decode_block_size=4)


def qwen_attention_phase() -> dict:
    """(a) The ragged kernel (rows within one key chunk and rows walked
    over many) and the paged kernel at G = 1 against their plain
    versions, f32 and bf16, to phases 3 and 7's bounds; row invariance;
    kernel, plain, SDPA and bound times of the engine-like cases."""
    rec = {}
    for name, spec in QWEN_RAGGED_CASES:
        case = make_case(**spec, **QWEN_GEOM, ps=16, seed=50 + len(rec))
        errs = check_case(f"qwen {name}", case)
        log(f"qwen ragged case {name} (G = 1): " + " ".join(
            f"{k}={v:.4g}" for k, v in errs.items()))
        if name == "a_serving_mix":
            check_row_invariance(case, split_slot=2, split=120)
        if name == "e_chunk_edges":
            check_row_invariance(case, split_slot=5, split=21)
        if name in ("b_long_context", "d_engine_tick"):
            c16 = cast(case, torch.bfloat16)
            errs.update(ms=time_ms(lambda: run_rpa(c16, "kernel")),
                        plain_ms=time_ms(lambda: run_rpa(c16, "reference"),
                                         reps=5),
                        library_ms=time_ms(sdpa_yardstick(c16)))
            errs["bound_ms"], errs["bound_by"] = attention_bound_ms(c16)
            log(f"qwen ragged case {name} bf16: kernel {errs['ms']:.4f} ms, "
                f"plain {errs['plain_ms']:.4f} ms, sdpa "
                f"{errs['library_ms']:.4f} ms, bound {errs['bound_ms']:.4f} "
                f"ms ({errs['bound_by']})")
            del c16
        rec[f"ragged_{name}"] = errs
        del case
        torch.cuda.empty_cache()
    log("qwen ragged kernel at G = 1: per-slot and chunked == whole, "
        "bitwise (serving mix and chunk edges)")
    for name, spec in QWEN_PAGED_CASES:
        case = make_paged_case(**spec, **QWEN_GEOM, seed=60 + len(rec))
        errs = check_paged_case(f"qwen {name}", case)
        log(f"qwen paged case {name} (G = 1): " + " ".join(
            f"{k}={v:.4g}" for k, v in errs.items()))
        check_paged_invariance(case)
        if name == "engine_16k":
            c16 = cast(case, torch.bfloat16)
            errs.update(
                ms=time_ms(lambda: run_paged(c16, "kernel", stats=False)),
                plain_ms=time_ms(lambda: run_paged(c16, "reference",
                                                   stats=False), reps=5),
                library_ms=time_ms(paged_sdpa_yardstick(c16)))
            errs["bound_ms"], errs["bound_by"] = paged_bound_ms(c16, False)
            log(f"qwen paged case {name} bf16 (without stats): kernel "
                f"{errs['ms']:.4f} ms, plain {errs['plain_ms']:.4f} ms, sdpa "
                f"{errs['library_ms']:.4f} ms, bound {errs['bound_ms']:.4f} "
                f"ms ({errs['bound_by']})")
            del c16
        rec[f"paged_{name}"] = errs
        del case
        torch.cuda.empty_cache()
    log("qwen paged kernel at G = 1: sequences alone == in the batch, and "
        "any page placement, bitwise (o, m, l)")
    return rec


def qwen_int8_phase() -> dict:
    """(b) The int8 kernel at Qwen2-MoE's four weight shapes, M 8 and
    256, to phase 7's bounds; the step sums at M 8 and 256."""
    rec = {}
    for name, (K, N) in QWEN_INT8_SHAPES.items():
        e = check_int8(f"qwen {name}", K, N, seed=70 + len(rec),
                       ms_list=QWEN_INT8_MS)
        log(f"qwen int8 {name} (K={K}, N={N}): " + " ".join(
            f"{k}={v:.4g}" for k, v in e.items() if k != "times"))
        for m, t in e["times"].items():
            log(f"qwen int8 {name} M={m}: kernel {t['ms']:.4f} ms, plain "
                f"{t['plain_ms']:.4f} ms, cuBLAS bf16 {t['library_ms']:.4f} "
                f"ms" + (f", int8pack {t['int8pack_ms']:.4f} ms"
                         if "int8pack_ms" in t else "")
                + f", bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
        rec[name] = e
    for M in QWEN_INT8_MS:
        st = int8_step_record(rec, M, QWEN_INT8_COUNT)
        rec[f"step_{M}"] = st
        log(f"qwen int8 step sum at M={M} (7 products of a layer + "
            f"lm_head): kernel {st['ms']:.4f} ms, plain {st['plain_ms']:.4f}"
            f" ms, cuBLAS bf16 {st['library_ms']:.4f} ms, bound "
            f"{st['bound_ms']:.4f} ms ({st['bound_by']})")
    return rec


def _tensors(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    return [tree]


def init_qwen():
    """The default ``Qwen2MoeConfig()`` (Qwen1.5-MoE-A2.7B's widths, 24
    layers, bf16) from seed 0 on the card."""
    from paddle_tpu_torch.models import qwen2_moe
    cfg = qwen2_moe.Qwen2MoeConfig()
    t0 = time.perf_counter()
    params = qwen2_moe.init_params(cfg, torch.Generator(device="cuda")
                                   .manual_seed(0))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _tensors(params))
    log(f"qwen2_moe params ({n / 1e9:.2f} B) initialised "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    return params, cfg


def qwen_engine_run(params, cfg, name: str, samp=None, **kw) -> dict:
    """One engine of ``ENGINE_GEOM`` (plus ``kw``) over phase 4's 16
    requests submitted at once (``samp``: per-request sampling), after a
    warm-up request: every request's count, ragged launches = L x model
    steps; the decode counters, tok/s, mean TTFT, ticks."""
    from paddle_tpu_torch.models import llama
    from paddle_tpu_torch.serving import ServingEngine
    L = cfg.num_hidden_layers
    prompts, new = _requests(cfg.vocab_size)
    eng = ServingEngine(params, cfg, **ENGINE_GEOM, **kw)
    eng.generate(np.arange(1, 41, dtype=np.int32), 4)      # warm-up
    c0 = eng.stats()["counters"]
    _zero_counts()
    draws0 = llama.sample_draw.launches
    t0 = time.perf_counter()
    handles = [eng.submit(p, n, **s) for p, n, s in
               zip(prompts, new, samp or [{}] * len(new))]
    outs = [h.result(timeout=600) for h in handles]
    wall = time.perf_counter() - t0
    counts = _counts()
    draws = llama.sample_draw.launches - draws0
    c1 = eng.stats()["counters"]
    eng.close()
    steps = c1["model_steps"] - c0["model_steps"]
    for o, n in zip(outs, new):
        assert o.shape == (n,) and ((o >= 0) & (o < cfg.vocab_size)).all()
    assert counts["ragged_paged_attention"] == L * steps, (counts, steps)
    rec = dict(launches=counts, model_steps=steps,
               ticks=c1["ticks"] - c0["ticks"], tok_s=sum(new) / wall,
               wall_s=wall, sampler_draws=draws, outs=outs,
               spec_ticks=c1["spec_ticks"] - c0["spec_ticks"],
               draft_accepted=c1["draft_accepted"] - c0["draft_accepted"],
               ttft_mean_s=float(np.mean([h.ttft_s for h in handles])))
    log(f"qwen engine {name}: {len(outs)} requests, {sum(new)} tokens in "
        f"{wall:.3f} s = {rec['tok_s']:.1f} tok/s; mean TTFT "
        f"{rec['ttft_mean_s']:.4f} s; {rec['ticks']} ticks, "
        f"{steps} model steps; launches {counts}; sampler draws {draws}; "
        f"verify ticks {rec['spec_ticks']}, drafts accepted "
        f"{rec['draft_accepted']}")
    return rec


# the int8 comparisons' state: 32 decode rows (phase 8 compares the first
# decode step of 32 streams) over 32-512 cached tokens
QWEN_INT8_LENS = [32 + 480 * i // 31 for i in range(32)]


# int8 vs bf16 Qwen2-MoE, the JAX package's own criterion
# (tests/test_int8_decode.py::test_qwen_int8_greedy_token_match: greedy
# tokens equal on >= 0.6 of them). Phase 8's logit bound (max |dlogit| <
# INT8_LOGIT_SPREAD x max(std, 1)) does not hold here: with the routing
# pinned, 24 random 2048-wide layers whose ~19 products a token are each
# quantized read 1.18 x std (and 0.79 x the logit scale with the routing
# free: 37% of the routing decisions flip) on an H100 80GB HBM3 (700 W)
# with this script; its reading is reported beside this check.
QWEN_INT8_GREEDY_MIN = 0.6


def qwen_int8_tick_run(params, qparams, cfg) -> dict:
    """(d) On one shared decode tick (32 rows, kernel attention), routing
    pinned to the reference's (``compare_tick_logits``): int8 against
    bf16, greedy tokens equal on ``QWEN_INT8_GREEDY_MIN`` of the rows
    and max |dlogit| reported against phase 8's bound; the int8 kernel
    path against the plain int8 products within
    ``DECODE_LOGITS_REL_TOL``."""
    pools, tok, meta = tick_state(cfg, dict(enumerate(QWEN_INT8_LENS)),
                                  pps=33, seed=2, tok_seed=2)

    def runner(p):
        return tick_runner(p, cfg, pools, tok, meta, "kernel")

    rec = dict(vs_bf16=compare_tick_logits(
        "qwen int8 vs bf16 decode tick", runner(qparams), runner(params),
        meta, lambda d, scale, std, greedy: greedy >= QWEN_INT8_GREEDY_MIN,
        f"greedy equal on >= {QWEN_INT8_GREEDY_MIN} of the rows; phase "
        f"8's {INT8_LOGIT_SPREAD} x max(std, 1) reported"))
    rec["kernel_vs_plain"] = compare_tick_logits(
        "qwen int8 decode tick, int8 kernel vs plain int8 product",
        runner(qparams), runner(plain_int8(qparams)), meta,
        lambda d, scale, std, greedy: d <= DECODE_LOGITS_REL_TOL * scale,
        f"{DECODE_LOGITS_REL_TOL} x scale")
    del pools
    return rec


def qwen_serving_phase() -> dict:
    """Phase 14: Qwen2-MoE serving at full width and depth. (a) decode
    attention at G = 1, (b) int8 at Qwen's shapes, (c) the bf16 engine
    (phase 4's wave, the mixed tick kernel vs plain, ``generate()``'s
    tokens reported), ``serving_decode_block``, one seeded sampled
    request and a speculative engine over the same wave, (d)
    ``quantize_for_decode`` on the card, int8 vs bf16 and kernel vs plain
    on one tick, the int8 engine on the same wave; weight bytes a step."""
    from paddle_tpu_torch.quantization import (decode_weight_bytes,
                                               quantize_for_decode)
    rec = dict(attention=qwen_attention_phase(), int8=qwen_int8_phase())
    params, cfg = init_qwen()
    L = cfg.num_hidden_layers
    new = _requests(cfg.vocab_size)[1]

    serving = serving_phase(params, cfg)
    assert serving["generate_flash_launches"] == 3 * L, serving
    rec["serving"] = serving
    rec["decode_block"] = decode_block_run(params, cfg)
    assert rec["decode_block"]["launches"]["int8_matmul"] == 0
    samp = [dict(SAMPLED, seed=7)] + [{}] * (len(new) - 1)
    spec = qwen_engine_run(params, cfg, "speculative (ngram, spec_k 4), "
                           "request 0 sampled", samp=samp,
                           speculative="ngram", spec_k=SPEC_K)
    assert spec["sampler_draws"] > 0 and spec["outs"][0].shape == (new[0],)
    sampled = qwen_engine_run(params, cfg, "plain, request 0 sampled",
                              samp=samp)
    agree = [bool(np.array_equal(a, b))
             for a, b in zip(spec.pop("outs"), sampled.pop("outs"))]
    log(f"qwen engines speculative vs plain: streams equal on "
        f"{sum(agree[1:])}/15 greedy requests, sampled request 0 "
        f"{'equal' if agree[0] else 'different'} (reported, not required)")
    rec.update(spec=spec, sampled=sampled, spec_agree=agree)

    t0 = time.perf_counter()
    qparams = quantize_for_decode(params, cfg)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    w16, w8 = decode_weight_bytes(params), decode_weight_bytes(qparams)
    rec["int8_tick"] = qwen_int8_tick_run(params, qparams, cfg)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    eng8 = qwen_engine_run(qparams, cfg, "int8", quantization="int8")
    eng8.pop("outs")
    assert eng8["launches"]["int8_matmul"] == \
        (7 * L + 1) * eng8["model_steps"], eng8
    rec.update(engine_int8=eng8, quantize_s=quant_s, weight_bytes_bf16=w16,
               weight_bytes_int8=w8)
    log(f"qwen weights a decode step: bf16 {w16 / 1e9:.3f} GB (bound "
        f"{w16 / H100_BYTES_PER_S * 1e3:.3f} ms), int8 {w8 / 1e9:.3f} GB "
        f"(bound {w8 / H100_BYTES_PER_S * 1e3:.3f} ms; the routed experts "
        f"are also written and read back as a bf16 copy each step); "
        f"quantized on the card in {quant_s:.2f} s; tok/s bf16 "
        f"{serving['tok_s']:.1f} (staggered), plain "
        f"{sampled['tok_s']:.1f}, speculative {spec['tok_s']:.1f}, int8 "
        f"{eng8['tok_s']:.1f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.1f} GiB")
    del qparams
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# grouped matmul: gmm (forward, dlhs) and tgmm at the dropless MoE layer of
# Qwen1.5-MoE-A2.7B
# ---------------------------------------------------------------------------

# one layer's routing: S tokens, top-k of E experts, D -> F -> D experts
GMM_GEOM = dict(S=2048, k=4, E=60, D=2048, F=1408, tile_m=128)
# routings of the kernel checks: (a) uniform over the experts; (b) skewed,
# half the assignments on experts 0 and 1 and the last 5 experts empty;
# (c) the JAX package's tiny case, E = 3, tile_expert [0, 2, 2] (expert 1
# owns no tile), K = N = 128
GMM_ROUTINGS = ("uniform", "skewed", "tiny")
# the skewed routing again at widths the kernels' tiles do not divide: tgmm
# writes [E, 584, 328] in 128 x 256 tiles (K = 4.56 tiles, N = 1.28; a
# last column panel 8 wide), gmm reads 584 and 328 wide
GMM_RAGGED = dict(GMM_GEOM, D=584, F=328)
# Bounds, in ulps of the dtype at each output row's largest reference
# value (rows of N; tgmm's rows are the [E, K, N] output's last axis).
#   f32: the f32 kernel vs the plain version evaluated in f64: each output
#        sums 16 products at a time and adds each chunk to the running
#        total; over up to 2048 reduction values that total's rounding
#        grows like sqrt(128) half-ulps of the partial sums, which stay
#        below the row's largest output;
#   plain / exact: the bf16 kernel vs the bf16 plain version (f32 sums,
#        one cast) and vs f64: both are an f32 sum rounded once to bf16,
#        half an ulp each, the f32 sums ~2^-16 ulp apart.
# Measured on an H100 80GB HBM3 (700 W) with this script: f32 <= 6.92,
# plain <= 0.98, exact <= 0.50.
GMM_BOUNDS = {"f32": 16, "plain": 1, "exact": 1}
# moe_mlp_dropless through the kernels vs the plain path, the output and
# every gradient, in ulps at each row's scale (rows of D for y and dx, of
# the weight's last axis for the weights, of E for the router): bf16 — the
# gmm outputs differ by at most an ulp, which the SwiGLU product, the down
# product and the combine carry to their own roundings; f32 vs f64 — the
# f32 sums of three chained products. Measured on an H100 80GB HBM3
# (700 W) with this script: bf16 <= 1.63, f32 <= 13.3.
MOE_BOUNDS = {"bf16": 4, "f32": 32}
# dropless (kernels) vs the einsum moe_ffn at a capacity that drops nothing
# (capacity_factor = E / top_k), bf16, one routed input: the same expert
# products, rounded in other places (the einsum path's combine sums the
# weighted expert outputs in f32 and rounds once; the dropless path rounds
# each weighted output first), in bf16 ulps at each token's output scale.
# Measured 0.99 on an H100 80GB HBM3 (700 W) with this script.
MOE_EINSUM_ULPS = 2
# flash attention at the Qwen geometry: G = 1 (H = Hkv = 16), T = 2048
QWEN_ATTN_GEOM = dict(H=16, Hkv=16, Dh=128)
# its bounds: TRAIN_BOUNDS, but the f32 forward against f64 at 32 ulps:
# the first card run read 16.36 here (the plain version's own f32
# evaluation 28.43), above TRAIN_BOUNDS' 16 for the 8B geometry, where the
# same kernel reads under 16. The metric counts each 128-wide output row
# in ulps of its own largest value, and a row that averages many values
# is small beside the f32 sums that made it.
QWEN_FLASH_BOUNDS = {**TRAIN_BOUNDS, ("o", "f32"): 32}


def gmm_layout(kind: str, seed: int, g=GMM_GEOM) -> dict:
    """Tile layout of one routing: tile_expert, the rows holding an
    assignment (the rest are padding, zero in every operand, as in
    ``moe_mlp_dropless``), the experts' assignment counts and the
    (K, N) shapes to check."""
    from paddle_tpu_torch.ops.kernels.grouped_matmul import (
        sort_and_pad_by_expert)
    if kind == "tiny":
        te = torch.tensor([0, 2, 2], dtype=torch.int32, device="cuda")
        return dict(te=te, live=torch.ones(384, dtype=torch.bool,
                                           device="cuda"),
                    E=3, counts=np.array([128, 0, 256]),
                    shapes={"tiny": (128, 128)})
    E, A = g["E"], g["S"] * g["k"]
    rs = np.random.RandomState(seed)
    if kind == "uniform":
        ids = rs.randint(0, E, A)
    else:
        ids = rs.randint(2, E - 5, A)
        hot = rs.rand(A) < 0.5
        ids[hot] = rs.randint(0, 2, int(hot.sum()))
    _, dest, te, m_pad = sort_and_pad_by_expert(
        torch.as_tensor(ids.astype(np.int32), device="cuda"), E,
        g["tile_m"])
    live = torch.zeros(m_pad, dtype=torch.bool, device="cuda")
    live[dest.long()] = True
    return dict(te=te, live=live, E=E, counts=np.bincount(ids, minlength=E),
                shapes={"gate": (g["D"], g["F"]), "down": (g["F"], g["D"])})


def tile_shuffle(te, seed: int):
    """A permutation of the row tiles that interleaves the experts at
    random and keeps each expert's own tiles in their order (so each
    expert's sum visits the same tiles in the same order)."""
    t = te.cpu().numpy()
    keys = np.random.RandomState(seed).rand(len(t))
    for e in np.unique(t):
        idx = np.nonzero(t == e)[0]
        keys[idx] = np.sort(keys[idx])
    return torch.as_tensor(np.argsort(keys, kind="stable"), device="cuda")


def _tiles(x, perm, tile_m: int):
    return x.reshape(-1, tile_m, x.shape[-1])[perm].reshape(x.shape)


def _gmm_operands(lay, K: int, N: int, gen):
    """lhs [M, K] and g [M, N] (zero on padding rows) and a weight
    [E, K, N] scaled by 1/sqrt(K), all f32."""
    live = lay["live"][:, None]
    M = live.shape[0]
    return (_randn((M, K), gen) * live, _randn((lay["E"], K, N), gen,
                                               1 / math.sqrt(K)),
            _randn((M, N), gen) * live)


def check_gmm(kind: str, seed: int, geom=GMM_GEOM) -> dict:
    """gmm forward, dlhs (the weight read transposed) and tgmm on one
    routing at ``geom``, f32 against the f64 evaluation and bf16 against
    the bf16 plain version and f64 (``GMM_BOUNDS``); padding rows of
    gmm's outputs and empty experts' tgmm slices exactly 0; two launches
    and a shuffled tile order (``tile_shuffle``) give the same bits."""
    from paddle_tpu_torch.ops.kernels.grouped_matmul import (
        gmm, gmm_reference, tgmm, tgmm_reference)
    lay = gmm_layout(kind, seed, geom)
    te, live, E = lay["te"], lay["live"], lay["E"]
    tm = geom["tile_m"]
    empty = sorted(set(range(E)) - set(te.cpu().tolist()))
    perm = tile_shuffle(te, seed)
    te_s = te[perm]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    errs = {}

    def put(key, v):
        errs[key] = max(errs.get(key, 0.0), v)

    for K, N in lay["shapes"].values():
        lhs, w, gout = _gmm_operands(lay, K, N, gen)
        for dt in (torch.float32, torch.bfloat16):
            a, b, g = lhs.to(dt), w.to(dt), gout.to(dt)
            got = {"fwd": gmm(a, b, te, tm, impl="kernel"),
                   "dlhs": gmm(g, b, te, tm, trans=True, impl="kernel"),
                   "tgmm": tgmm(a, g, te, E, tm, impl="kernel")}
            torch.cuda.synchronize()
            for n, x in got.items():
                assert torch.isfinite(x).all(), f"{kind} {n}: non-finite"
            assert not got["fwd"][~live].any() and \
                not got["dlhs"][~live].any(), \
                f"{kind}: padding rows of gmm not exactly zero"
            if empty:
                assert not got["tgmm"][empty].any(), \
                    f"{kind}: tgmm of empty experts {empty} not zero"
            f64 = {"fwd": gmm_reference(a.double(), b.double(), te, tm),
                   "dlhs": gmm_reference(g.double(), b.double(), te, tm,
                                         trans=True),
                   "tgmm": tgmm_reference(a.double(), g.double(), te, E,
                                          tm)}
            if dt == torch.float32:
                for n in got:
                    put((n, "f32"), _row_ulps(got[n], f64[n], F32_EPS))
                del f64
                continue
            plain = {"fwd": gmm_reference(a, b, te, tm),
                     "dlhs": gmm_reference(g, b, te, tm, trans=True),
                     "tgmm": tgmm_reference(a, g, te, E, tm).to(dt)}
            for n in got:
                put((n, "plain"), _row_ulps(got[n], plain[n], BF16_EPS))
                put((n, "exact"), _row_ulps(got[n], f64[n], BF16_EPS))
                put((n, "max_abs_err"), float(
                    (got[n].float() - plain[n].float()).abs().max()))
            del plain, f64
            assert torch.equal(tgmm(a, g, te, E, tm, impl="kernel"),
                               got["tgmm"]), f"{kind}: tgmm not reproducible"
            assert torch.equal(gmm(g, b, te, tm, trans=True, impl="kernel"),
                               got["dlhs"]), f"{kind}: gmm not reproducible"
            a_s, g_s = _tiles(a, perm, tm), _tiles(g, perm, tm)
            assert torch.equal(tgmm(a_s, g_s, te_s, E, tm, impl="kernel"),
                               got["tgmm"]), \
                f"{kind}: tgmm depends on the tile order"
            assert torch.equal(gmm(a_s, b, te_s, tm, impl="kernel"),
                               _tiles(got["fwd"], perm, tm)), \
                f"{kind}: gmm rows depend on their tile's place"
        del lhs, w, gout
    for key, bound in GMM_BOUNDS.items():
        for n in ("fwd", "dlhs", "tgmm"):
            v = errs[(n, key)]
            assert v <= bound, (kind, n, key, v, bound)
    torch.cuda.empty_cache()
    return errs


def _grouped_mm_works() -> bool:
    """Whether this torch's ``torch._grouped_mm`` (a yardstick only) runs
    bf16 on this card, with row offsets."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return False
    try:
        a = torch.zeros(32, 64, dtype=torch.bfloat16, device="cuda")
        b = torch.zeros(2, 64, 32, dtype=torch.bfloat16, device="cuda")
        fn(a, b, offs=torch.tensor([16, 32], dtype=torch.int32,
                                   device="cuda"))
        torch.cuda.synchronize()
        return True
    except (RuntimeError, NotImplementedError, TypeError):
        return False


def gmm_bound_ms(M: int, A: int, K: int, N: int, E_read: int) -> tuple:
    """Least time of one grouped product: a [M, K] bf16 operand and
    E_read [K, N] weight slices (or [M, N] cotangent) read once, the
    output written once; 2·A·K·N operations for the A assigned rows (the
    padding rows need none)."""
    t_bytes = 2.0 * (M * K + E_read * K * N + M * N) / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * A * K * N / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def gmm_times(seed: int = 60) -> dict:
    """bf16 kernel, plain-version and library times (ms) and bounds of the
    layer's grouped products at the uniform routing: forward, dlhs and
    tgmm at the gate/up shape (D 2048 -> F 1408) and the down shape. The
    library call is ``torch._grouped_mm`` with each expert's padded row
    offsets where this build runs it, else one cuBLAS matmul per expert
    (``library`` in the record says which); the port calls neither."""
    from paddle_tpu_torch.ops.kernels.grouped_matmul import (
        gmm, gmm_reference, tgmm, tgmm_reference)
    lay = gmm_layout("uniform", seed)
    te, E, tm = lay["te"], lay["E"], GMM_GEOM["tile_m"]
    M = lay["live"].shape[0]
    A = int(lay["counts"].sum())
    present = int((lay["counts"] > 0).sum())
    padded = -(-lay["counts"] // tm) * tm
    ends = np.cumsum(padded)
    offs = torch.as_tensor(ends.astype(np.int32), device="cuda")
    spans = [(int(e - p), int(e)) for e, p in zip(ends, padded)]
    lib = "torch._grouped_mm" if _grouped_mm_works() else \
        "cuBLAS matmul per expert"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {"library": lib}
    for sname, (K, N) in lay["shapes"].items():
        lhs, w, gout = _gmm_operands(lay, K, N, gen)
        a, b, g = (t.to(torch.bfloat16) for t in (lhs, w, gout))
        del lhs, w, gout
        if lib == "torch._grouped_mm":
            libs = (lambda: torch._grouped_mm(a, b, offs=offs),
                    lambda: torch._grouped_mm(g, b.transpose(1, 2),
                                              offs=offs),
                    lambda: torch._grouped_mm(a.t(), g, offs=offs))
        else:
            libs = (
                lambda: [a[s:e] @ b[x] for x, (s, e) in enumerate(spans)],
                lambda: [g[s:e] @ b[x].t() for x, (s, e) in
                         enumerate(spans)],
                lambda: [a[s:e].t() @ g[s:e] for s, e in spans])
        # (kernel, plain version, library call, bound); tgmm reads lhs and
        # g once and writes all E weight slices
        cases = {
            "gmm_fwd": (lambda: gmm(a, b, te, tm, impl="kernel"),
                        lambda: gmm_reference(a, b, te, tm), libs[0],
                        gmm_bound_ms(M, A, K, N, present)),
            "gmm_dlhs": (lambda: gmm(g, b, te, tm, trans=True,
                                     impl="kernel"),
                         lambda: gmm_reference(g, b, te, tm, trans=True),
                         libs[1], gmm_bound_ms(M, A, N, K, present)),
            "tgmm": (lambda: tgmm(a, g, te, E, tm, impl="kernel"),
                     lambda: tgmm_reference(a, g, te, E, tm)
                     .to(torch.bfloat16), libs[2],
                     gmm_bound_ms(M, A, K, N, E)),
        }
        with torch.no_grad():
            for key, (kern, plain, libf, (bound, by)) in cases.items():
                out[f"{key}_{sname}"] = dict(
                    ms=time_ms(kern), plain_ms=time_ms(plain, reps=5),
                    library_ms=time_ms(libf), bound_ms=bound, bound_by=by)
        del a, b, g
        torch.cuda.empty_cache()
    return out


def _moe_inputs(gen, dt):
    g = GMM_GEOM
    S, E, D, F = g["S"], g["E"], g["D"], g["F"]
    return dict(x=_randn((S, D), gen).to(dt),
                gate_w=_randn((D, E), gen, 0.02),
                w_gate=_randn((E, D, F), gen, 1 / math.sqrt(D)).to(dt),
                w_up=_randn((E, D, F), gen, 1 / math.sqrt(D)).to(dt),
                w_down=_randn((E, F, D), gen, 1 / math.sqrt(F)).to(dt))


def _moe_run(ins, impl, dy):
    """y, aux and the gradients of every input of moe_ffn_dropless."""
    from paddle_tpu_torch.incubate.moe.functional import moe_ffn_dropless
    leaves = {k: v.detach().requires_grad_() for k, v in ins.items()}
    y, aux = moe_ffn_dropless(leaves["x"], leaves["gate_w"],
                              leaves["w_gate"], leaves["w_up"],
                              leaves["w_down"], top_k=GMM_GEOM["k"],
                              impl=impl)
    grads = torch.autograd.grad((y * dy).sum() + aux, list(leaves.values()))
    return dict(y=y.detach(), aux=aux.detach(),
                **{"d" + k: gr for k, gr in zip(leaves, grads)})


def check_moe(seed: int = 70) -> dict:
    """moe_ffn_dropless forward and backward through the kernels vs the
    plain path (bf16 vs bf16 plain; f32 vs the f64 evaluation, whose
    router logits are the same f32 values, so the routing is the same),
    and the dropless path (kernels, bf16) vs the einsum ``moe_ffn`` at a
    capacity that drops nothing."""
    from paddle_tpu_torch.incubate.moe.functional import (
        moe_ffn, moe_ffn_dropless)
    from paddle_tpu_torch.ops.kernels.grouped_matmul import gmm, tgmm
    g = GMM_GEOM
    errs = {}
    for dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        ins = _moe_inputs(gen, dt)
        dy = _randn((g["S"], g["D"]), gen).to(dt)
        n0 = (gmm.launches, tgmm.launches)
        got = _moe_run(ins, "kernel", dy)
        assert (gmm.launches - n0[0], tgmm.launches - n0[1]) == (6, 3)
        if dt == torch.float32:
            ref = _moe_run({k: v.double() for k, v in ins.items()},
                           "reference", dy.double())
            eps = F32_EPS
        else:
            ref = _moe_run(ins, "reference", dy)
            eps = BF16_EPS
        for n in got:
            assert torch.isfinite(got[n]).all(), f"moe {n}: non-finite"
            if n == "aux":
                continue
            v = got[n].reshape(-1, got[n].shape[-1])
            r = ref[n].reshape(-1, ref[n].shape[-1])
            errs[(n, tag)] = _row_ulps(v, r, eps)
        errs[("aux", tag)] = float(abs(got["aux"].double() - ref["aux"])
                                   / ref["aux"].abs())
        if dt == torch.bfloat16:
            errs[("y", "max_abs_err")] = float(
                (got["y"].float() - ref["y"].float()).abs().max())
        del got, ref
        torch.cuda.empty_cache()
    bad = {k: v for k, v in errs.items() if k[1] in MOE_BOUNDS
           and k[0] != "aux" and not v <= MOE_BOUNDS[k[1]]}
    assert not bad, ("moe_mlp_dropless kernels vs plain", bad)
    assert errs[("aux", "bf16")] == 0 and errs[("aux", "f32")] < 1e-6, errs
    # dropless vs the no-drop einsum formulation, bf16, one routed input
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    ins = _moe_inputs(gen, torch.bfloat16)
    args = (ins["x"], ins["gate_w"], ins["w_gate"], ins["w_up"],
            ins["w_down"])
    with torch.no_grad():
        yd, auxd = moe_ffn_dropless(*args, top_k=g["k"], impl="kernel")
        ye, auxe = moe_ffn(*args, top_k=g["k"],
                           capacity_factor=g["E"] / g["k"])
    errs[("einsum", "ulps")] = _row_ulps(yd, ye, BF16_EPS)
    errs[("einsum", "aux")] = float(abs(auxd - auxe) / auxe)
    assert errs[("einsum", "ulps")] <= MOE_EINSUM_ULPS, errs
    assert errs[("einsum", "aux")] < 1e-6, errs
    torch.cuda.empty_cache()
    return errs


GMM_KERNELS = (
    # name, the TPU kernel it replaces, the time record, the error record,
    # the launch count (gmm's counts forward and dlhs launches alike)
    ("grouped_matmul", "paddle_tpu/ops/pallas/grouped_matmul.py:60",
     "gmm_fwd_gate", "fwd", "grouped_matmul"),
    ("grouped_matmul_dlhs_gate", "paddle_tpu/ops/pallas/grouped_matmul.py:60",
     "gmm_dlhs_gate", "dlhs", "grouped_matmul"),
    ("grouped_matmul_fwd_down", "paddle_tpu/ops/pallas/grouped_matmul.py:60",
     "gmm_fwd_down", "fwd", "grouped_matmul"),
    ("grouped_matmul_dlhs_down", "paddle_tpu/ops/pallas/grouped_matmul.py:60",
     "gmm_dlhs_down", "dlhs", "grouped_matmul"),
    ("grouped_matmul_tgmm", "paddle_tpu/ops/pallas/grouped_matmul.py:98",
     "tgmm_gate", "tgmm", "grouped_matmul_tgmm"),
)


def gmm_kernel_phase() -> dict:
    """Phase 9: the grouped-matmul kernels at the Qwen1.5-MoE-A2.7B
    layer, moe_mlp_dropless and the einsum yardstick, and flash attention
    at G = 1; every error within its bound."""
    errs = {}
    for i, kind in enumerate(GMM_ROUTINGS):
        e = check_gmm(kind, seed=50 + i)
        log(f"gmm routing {kind}: " + " ".join(
            f"{a}/{b}={v:.4g}" for (a, b), v in sorted(e.items())))
        errs[kind] = e
    e = check_gmm("skewed", seed=53, geom=GMM_RAGGED)
    log("gmm routing skewed at D 584, F 328: " + " ".join(
        f"{a}/{b}={v:.4g}" for (a, b), v in sorted(e.items())))
    errs["skewed_ragged"] = e
    log("gmm/tgmm: padding rows and empty experts exactly 0; two launches "
        "and a shuffled tile order give the same bits")
    e = check_moe()
    log("moe_mlp_dropless kernels vs plain, and vs the no-drop einsum "
        "moe_ffn: " + " ".join(f"{a}/{b}={v:.4g}"
                               for (a, b), v in sorted(e.items())))
    g = QWEN_ATTN_GEOM
    fe = check_flash(2048, 2048, seed=80, gm=g)
    log(f"flash G=1 (H={g['H']}, Hkv={g['Hkv']}, T=S=2048): " + " ".join(
        f"{a}/{b}={v:.4g}" for (a, b), v in fe.items()))
    check_bounds("flash G=1", fe, QWEN_FLASH_BOUNDS)
    times = gmm_times()
    log(f"gmm library yardstick: {times['library']}")
    for name, t in times.items():
        if name == "library":
            continue
        log(f"kernel {name} bf16: kernel {t['ms']:.4f} ms, plain "
            f"{t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    rec = {}
    for name, _, tkey, ekey, _ in GMM_KERNELS:
        rec[name] = dict(times[tkey], max_abs_err=errs["uniform"][
            (ekey, "max_abs_err")])
    rec["all"] = dict(errs=errs, moe=e, flash_g1=fe, times=times)
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
    """Phase 6: ``make_train_step`` on ``llama3_8b`` (or ``num_layers``
    of it)."""
    import dataclasses
    from paddle_tpu_torch.models import llama
    cfg = llama.LlamaConfig.llama3_8b()
    if num_layers is not None:
        cfg.num_hidden_layers = num_layers
    plain_cfg = dataclasses.replace(cfg, use_flash_attention="reference",
                                    use_fused_norm_rope="reference")
    return train_run("train: llama3_8b", llama, cfg, plain_cfg,
                     train_launches(),
                     per_step_launches(cfg.num_hidden_layers),
                     TRAIN_LOSS_REL, count_params(cfg))


def train_run(name: str, model, cfg, plain_cfg, counters: dict,
              per_step: dict, loss_rel: float, flop_params: int) -> dict:
    """``TRAIN_STEPS`` steps of ``model.make_train_step(cfg)`` on one
    fixed batch (B 1, T 2048) from seeded random weights: each counter's
    launches must equal ``per_step`` times the steps, the loss must be
    finite and fall, and the first loss must be within ``loss_rel`` of
    ``plain_cfg``'s (the kernels' plain versions) on the same state. MFU
    counts 6 flops per parameter of ``flop_params`` and token, plus the
    causal attention, against the bf16 peak."""
    from paddle_tpu_torch.models.llama import _tree_leaves
    L, B, T = cfg.num_hidden_layers, 1, 2048
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    step, init = model.make_train_step(cfg)
    state = init(torch.Generator(device="cuda").manual_seed(0))
    batch = model.make_batch(cfg, B, T)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _tree_leaves(state["params"]))
    log(f"{name} ({L} layers, {n_params / 1e9:.3f} B params) state "
        f"initialised in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB on the card")
    with torch.no_grad():
        plain_loss = float(model.loss_fn(state["params"], batch, plain_cfg))
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
    want = {n: c * TRAIN_STEPS for n, c in per_step.items()}
    assert launches == want, (launches, want)
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], losses
    rel = abs(losses[0] - plain_loss) / abs(plain_loss)
    assert rel <= loss_rel, (losses[0], plain_loss, rel)
    dt = float(np.median(times[1:]))
    flops = (6 * flop_params + 6 * L * cfg.hidden_size * T) * B * T
    mfu = flops / dt / H100_BF16_FLOPS
    log(f"{name} on {torch.cuda.get_device_name(0)}: losses "
        + ", ".join(f"{x:.6f}" for x in losses)
        + f"; plain versions' loss on the same state {plain_loss:.6f} "
        f"(relative difference {rel:.3g}, bound {loss_rel}); step "
        f"{dt * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{times[0] * 1e3:.1f} ms), {B * T / dt:.1f} tokens/s, MFU "
        f"{mfu:.4f} of {H100_BF16_FLOPS / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches per step "
        + ", ".join(f"{n}={c // TRAIN_STEPS}" for n, c in launches.items()))
    return dict(launches=launches, losses=losses, plain_loss=plain_loss,
                step_ms=dt * 1e3, tokens_per_s=B * T / dt, mfu=mfu,
                peak_gib=peak / 2 ** 30, layers=L, params=n_params)


# ---------------------------------------------------------------------------
# Qwen2-MoE training (dropless)
# ---------------------------------------------------------------------------

# 12 of Qwen1.5-MoE-A2.7B's 24 layers. bf16 params, grads and both AdamW
# moments take 8 bytes a parameter: 12 layers hold 7.47 B parameters
# (55.7 GiB; the step peaks at 56.3 GiB on an H100 80GB HBM3), all 24 need
# 114.5 GB and so expert parallelism over several cards. 16 layers (9.7 B
# parameters) were measured to fit at a 73.3 GiB peak by
# tools/torch_train_profile.py in a fresh process; phase 10 runs in a
# process that has run phases 1-9 and keeps 12 layers' headroom.
QWEN_LAYERS = 12
# first train step's loss (kernels) vs the plain versions' loss on the same
# state, relative: flash attention as in TRAIN_LOSS_REL, and the gmm
# outputs, an ulp apart at most, can flip a later layer's top-4 choice for
# a token whose 4th and 5th router probabilities are that close; the loss
# averages 2048 tokens. Measured 1.52e-5 on an H100 80GB HBM3 (700 W) with
# this script; the bound leaves a factor of 60.
QWEN_TRAIN_LOSS_REL = 1e-3


def qwen_launches() -> dict:
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import grouped_matmul as gm
    return {"grouped_matmul": gm.gmm, "grouped_matmul_tgmm": gm.tgmm,
            "flash_attention_fwd": fa.flash_attention_fwd,
            "flash_attention_bwd_dq": fa.flash_attention_bwd_dq,
            "flash_attention_bwd_dkv": fa.flash_attention_bwd_dkv}


def qwen_per_step_launches(L: int) -> dict:
    """Per train step with per-layer remat: each layer's three expert
    products run in the forward, again in the recompute, and once more as
    dlhs, and its three weight gradients once; flash attention as in
    ``per_step_launches``."""
    return {"grouped_matmul": 9 * L, "grouped_matmul_tgmm": 3 * L,
            "flash_attention_fwd": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkv": L}


def qwen_active_params(cfg) -> int:
    """Parameters a token meets: embeddings and lm_head (as ``bench.py``
    counts them), attention, the router, its top-k experts (padding rows
    not counted) and the shared expert with its gate; norms excluded."""
    D, L, V = cfg.hidden_size, cfg.num_hidden_layers, cfg.vocab_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    per_layer = (D * H * Dh + 2 * D * Hkv * Dh + H * Dh * D
                 + D * cfg.num_experts
                 + cfg.num_experts_per_tok * 3 * D * cfg.moe_intermediate_size
                 + 3 * D * cfg.shared_expert_intermediate_size + D)
    return V * D * 2 + L * per_layer


def qwen_train_phase(num_layers: int = QWEN_LAYERS) -> dict:
    """Phase 10: ``qwen2_moe.make_train_step`` on
    ``Qwen2MoeConfig(moe_impl="dropless")`` at full width."""
    import dataclasses
    from paddle_tpu_torch.models import qwen2_moe
    cfg = qwen2_moe.Qwen2MoeConfig(moe_impl="dropless",
                                   num_hidden_layers=num_layers)
    plain_cfg = dataclasses.replace(cfg, use_flash_attention="reference",
                                    use_grouped_matmul="reference")
    active = qwen_active_params(cfg)
    log(f"qwen2_moe MFU accounting: {active / 1e9:.3f} B active parameters "
        f"a token (embeddings and lm_head, attention, router, the top-"
        f"{cfg.num_experts_per_tok} experts, the shared expert; padding "
        f"rows not counted)")
    return train_run("train: qwen2_moe dropless", qwen2_moe, cfg, plain_cfg,
                     qwen_launches(), qwen_per_step_launches(num_layers),
                     QWEN_TRAIN_LOSS_REL, active)

# ---------------------------------------------------------------------------
# conv epilogue: the 1x1-conv kernel of the conv-bn fold (ResNet-50)
# ---------------------------------------------------------------------------

# ResNet-50's 1x1 / stride-1 sites at B 8, 224 x 224 (M = 8 x H x W):
# (M, K, N, relu) -> sites a forward. Every bottleneck's conv1 (relu) and
# conv3 (no relu), and layer 1's stride-1 downsample (no relu); phase 12
# asserts that the folded model calls exactly these.
RESNET_B8_SITES = {
    (25088, 64, 64, True): 1, (25088, 64, 256, False): 4,
    (25088, 256, 64, True): 2, (25088, 256, 128, True): 1,
    (6272, 128, 512, False): 4, (6272, 512, 128, True): 3,
    (6272, 512, 256, True): 1, (1568, 256, 1024, False): 6,
    (1568, 1024, 256, True): 5, (1568, 1024, 512, True): 1,
    (392, 512, 2048, False): 3, (392, 2048, 512, True): 2,
}
# layer 4's two shapes at B 1 (M = 49 = 7 x 7)
RESNET_B1_LAYER4 = ((49, 512, 2048), (49, 2048, 512))
# Bounds, in ulps of the dtype at each output row's largest reference value
# (``_row_ulps``, rows of N):
#   f32: the f32 kernel vs the plain version evaluated in f64: K / 16 chunk
#        sums of 16 products added to the running total in order, the bias
#        added to that f32 sum; K <= 2048, as the gmm f32 kernel's bound;
#   plain / exact: the bf16 kernel vs the bf16 plain version (f32 sum and
#        bias, one cast) and vs f64: both an f32 sum rounded once to bf16,
#        half an ulp of the element each, the f32 sums ~2^-16 ulp apart
#        (relu is 1-Lipschitz and adds nothing).
CONV_EPILOGUE_BOUNDS = {"f32": 16, "plain": 1, "exact": 1}


def conv_epilogue_bound_ms(M: int, K: int, N: int) -> tuple:
    """Least time of one call: x [M, K] and w [K, N] in bf16 and the f32
    bias read once, the [M, N] bf16 output written once; 2·M·K·N
    operations."""
    t_bytes = (2.0 * (M * K + K * N + M * N) + 4.0 * N) \
        / H100_BYTES_PER_S * 1e3
    t_ops = 2.0 * M * K * N / H100_BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _mba_operands(M: int, K: int, N: int, gen):
    return (_randn((M, K), gen), _randn((K, N), gen, 1 / math.sqrt(K)),
            _randn((N,), gen))


def check_conv_epilogue(M: int, K: int, N: int, seed: int,
                        relus=(True, False)) -> dict:
    """The kernel at one shape, relu on and off: f32 vs the f64
    evaluation, bf16 vs the bf16 plain version and vs f64
    (``CONV_EPILOGUE_BOUNDS``); a second launch gives the same bits."""
    from paddle_tpu_torch.ops.kernels.conv_epilogue import (
        matmul_bias_act, matmul_bias_act_reference)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x, w, b = _mba_operands(M, K, N, gen)
    errs = {}
    for relu in relus:
        for dt in (torch.float32, torch.bfloat16):
            a, ww = x.to(dt), w.to(dt)
            got = matmul_bias_act(a, ww, b, relu, impl="kernel")
            torch.cuda.synchronize()
            assert torch.isfinite(got).all(), (M, K, N, relu, dt)
            assert torch.equal(matmul_bias_act(a, ww, b, relu,
                                               impl="kernel"), got)
            f64 = matmul_bias_act_reference(a.double(), ww.double(),
                                            b.double(), relu)
            if dt == torch.float32:
                errs["f32"] = max(errs.get("f32", 0.0),
                                  _row_ulps(got, f64, F32_EPS))
                continue
            plain = matmul_bias_act_reference(a, ww, b, relu)
            errs["plain"] = max(errs.get("plain", 0.0),
                                _row_ulps(got, plain, BF16_EPS))
            errs["exact"] = max(errs.get("exact", 0.0),
                                _row_ulps(got, f64, BF16_EPS))
            errs["max_abs_err"] = max(errs.get("max_abs_err", 0.0), float(
                (got.float() - plain.float()).abs().max()))
    for key, bound in CONV_EPILOGUE_BOUNDS.items():
        assert errs[key] <= bound, ((M, K, N), key, errs[key], bound)
    return errs


def check_conv_epilogue_rows(seed: int = 112) -> None:
    """B 1 against B 8 at layer 4's shapes, bitwise, f32 and bf16: the
    first image's 49 rows alone and the fourth image's (rows 147-195,
    inside the second 128-row tile) equal the same rows of the M = 392
    call."""
    from paddle_tpu_torch.ops.kernels.conv_epilogue import matmul_bias_act
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for M1, K, N in RESNET_B1_LAYER4:
        x, w, b = _mba_operands(8 * M1, K, N, gen)
        for dt in (torch.float32, torch.bfloat16):
            a, ww = x.to(dt), w.to(dt)
            full = matmul_bias_act(a, ww, b, impl="kernel")
            for lo in (0, 3 * M1):
                part = matmul_bias_act(a[lo:lo + M1].contiguous(), ww, b,
                                       impl="kernel")
                assert torch.equal(part, full[lo:lo + M1]), \
                    (M1, K, N, dt, lo)


# (K, N, Ms): the same rows at each M must come out bitwise equal. The
# bf16 kernel's arithmetic is fixed by K (chunks of 512) and its tile width
# by N and K; M changes only how many tiles there are: from one row tile
# (M 49) through a few (392, B 8's layer 4) to 49 (6272, B 128's).
CONV_ROWS_ACROSS_M = ((2048, 512, (49, 392, 6272)),
                      (1024, 256, (49, 392, 6272)))


def check_conv_epilogue_rows_across_m(cases=CONV_ROWS_ACROSS_M,
                                      seed: int = 115) -> None:
    """bf16, relu on and off: the first M rows and the last M rows of the
    largest M's input, run alone at each smaller M, equal the same rows of
    the largest M's output bitwise."""
    from paddle_tpu_torch.ops.kernels.conv_epilogue import matmul_bias_act
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for K, N, Ms in cases:
        big = max(Ms)
        x, w, b = _mba_operands(big, K, N, gen)
        a, ww = x.bfloat16(), w.bfloat16()
        for relu in (True, False):
            full = matmul_bias_act(a, ww, b, relu, impl="kernel")
            for M in Ms:
                for lo in (0, big - M):
                    part = matmul_bias_act(a[lo:lo + M], ww, b, relu,
                                           impl="kernel")
                    assert torch.equal(part, full[lo:lo + M]), \
                        (K, N, M, lo, relu)


def check_conv_epilogue_edges(seed: int = 113) -> None:
    """No write outside [M, N]: the kernel's C entry writes into the middle
    of a NaN-filled buffer with a band of 128 rows before and after; the
    bands stay NaN (the bf16 kernel's TMA store clips at the output's
    edges) and the output matches the wrapper's. Ragged M (49, 392, 1568)
    and N = 64."""
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for M, K, N in ((49, 512, 2048), (392, 2048, 512), (1568, 1024, 256),
                    (392, 64, 64), (25088, 64, 64)):
        x, w, b = _mba_operands(M, K, N, gen)
        for dt, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            a, ww = x.to(dt), w.to(dt)
            band = 128 * N
            buf = torch.full((M * N + 2 * band,), float("nan"), dtype=dt,
                             device="cuda")
            out = buf[band:band + M * N]
            err = ce._lib().paddle_matmul_bias_act(
                a.data_ptr(), ww.data_ptr(), b.data_ptr(), out.data_ptr(),
                M, K, N, 1, code, torch.cuda.current_stream().cuda_stream)
            assert err == 0, err
            torch.cuda.synchronize()
            assert buf[:band].isnan().all() and buf[band + M * N:].isnan(
            ).all(), f"write outside [M, N] at {(M, K, N)} {dt}"
            assert torch.equal(out.view(M, N), ce.matmul_bias_act(
                a, ww, b, impl="kernel")), (M, K, N, dt)


def _addmm_activation_works() -> bool:
    """Whether this torch has ``torch._addmm_activation`` (cuBLASLt with a
    bias + relu epilogue; a yardstick only) and it runs bf16 here."""
    fn = getattr(torch, "_addmm_activation", None)
    if fn is None:
        return False
    try:
        a = torch.zeros(16, 16, dtype=torch.bfloat16, device="cuda")
        fn(a[0], a, a, use_gelu=False)
        torch.cuda.synchronize()
        return True
    except (RuntimeError, NotImplementedError, TypeError):
        return False


def host_us(fn, reps: int = 200) -> float:
    """Host µs per call of ``fn``: the wall time of ``reps`` calls that
    only enqueue work (no synchronize inside), after a warm-up call. The
    device runs behind them, so this is the host side of a call (the
    wrapper's checks, allocations, tensor maps and the launch)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def conv_epilogue_times(seed: int = 114, batch: int = 8) -> dict:
    """bf16 kernel, plain-version and library times (ms) and bounds at the
    12 1x1 shapes of a ResNet-50 forward at B ``batch`` (the B-8 shapes'
    rows times batch / 8), and their sums over the forward's 33 sites; the
    kernel's host µs per call (``host_us``). The library call (the port
    never calls it) adds the bias in bf16:
    ``torch._addmm_activation(bias, x, w, use_gelu=False)`` for the relu
    sites where this torch runs it, else ``torch.addmm`` then ``relu_``;
    ``torch.addmm`` for the others."""
    from paddle_tpu_torch.ops.kernels.conv_epilogue import (
        matmul_bias_act, matmul_bias_act_reference)
    fused = _addmm_activation_works()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "host_us")
    shapes, total = {}, dict.fromkeys(keys, 0.0)
    for (M8, K, N, relu), sites in RESNET_B8_SITES.items():
        M = M8 * batch // 8
        x, w, b = _mba_operands(M, K, N, gen)
        a, ww, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
        if not relu:
            lib = lambda: torch.addmm(bb, a, ww)          # noqa: E731
        elif fused:
            lib = lambda: torch._addmm_activation(     # noqa: E731
                bb, a, ww, use_gelu=False)
        else:
            lib = lambda: torch.addmm(bb, a, ww).relu_()  # noqa: E731
        bound, by = conv_epilogue_bound_ms(M, K, N)
        with torch.no_grad():
            kern = lambda: matmul_bias_act(a, ww, b, relu,   # noqa: E731
                                           impl="kernel")
            t = dict(
                ms=time_ms(kern), host_us=host_us(kern),
                plain_ms=time_ms(lambda: matmul_bias_act_reference(
                    a, ww, b, relu), reps=5),
                library_ms=time_ms(lib), bound_ms=bound, bound_by=by,
                sites=sites)
        shapes[f"{M}x{K}x{N}{'_relu' if relu else ''}"] = t
        for k in keys:
            total[k] += sites * t[k]
        del x, w, a, ww
    torch.cuda.empty_cache()
    # what bounds the forward's 33 launches: the side that bounds most of
    # their summed bound
    total["bound_by"] = max(("bytes", "operations"), key=lambda by: sum(
        t["sites"] * t["bound_ms"] for t in shapes.values()
        if t["bound_by"] == by))
    return dict(shapes=shapes, per_forward=total, library=(
        "torch._addmm_activation" if fused else "torch.addmm + relu_"))


def conv_epilogue_phase() -> dict:
    """Phase 11: the conv-epilogue kernel against its plain version at
    ResNet-50's 12 B-8 shapes and layer 4's at B 1, relu on and off;
    rows bitwise across M; no write outside the output; timings."""
    errs = {}
    shapes = [(M, K, N) for M, K, N, _ in RESNET_B8_SITES]
    for i, (M, K, N) in enumerate(shapes + list(RESNET_B1_LAYER4)):
        e = check_conv_epilogue(M, K, N, seed=100 + i)
        errs[f"{M}x{K}x{N}"] = e
        log(f"conv_epilogue {M}x{K}x{N}: " + " ".join(
            f"{k}={v:.4g}" for k, v in sorted(e.items())))
    check_conv_epilogue_rows()
    check_conv_epilogue_rows_across_m()
    check_conv_epilogue_edges()
    log("conv_epilogue: rows at M 49 equal rows of M 392 bitwise (f32, "
        "bf16); bf16 rows equal at M 49 / 392 / 6272 (K, N) = "
        f"{[(K, N) for K, N, _ in CONV_ROWS_ACROSS_M]}; no write outside "
        "[M, N] (ragged M, N = 64); two launches give the same bits")
    times = conv_epilogue_times()
    for name, t in times["shapes"].items():
        log(f"kernel conv_epilogue {name} bf16 (x{t['sites']} a forward): "
            f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, "
            f"library {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
            f"ms ({t['bound_by']}); host {t['host_us']:.1f} us a call")
    pf = times["per_forward"]
    log(f"conv_epilogue per B-8 forward (33 sites): kernel {pf['ms']:.4f} "
        f"ms, plain {pf['plain_ms']:.4f} ms, library ({times['library']}) "
        f"{pf['library_ms']:.4f} ms, bound {pf['bound_ms']:.4f} ms "
        f"({pf['bound_by']}); host {pf['host_us']:.1f} us")
    b8 = {k: v for k, v in errs.items() if not k.startswith("49x")}
    return dict(pf, max_abs_err=max(
        e["max_abs_err"] for e in b8.values()), errs=errs, times=times)


# ---------------------------------------------------------------------------
# ResNet-50 inference with the conv-bn fold
# ---------------------------------------------------------------------------

# folded bf16 (kernels) vs folded bf16 (plain versions) on one B-8 input:
# max |dlogit| over the largest |logit|. The 33 kernel sites differ from
# their plain versions by an ulp at most (phase 11), which 16 blocks of
# bf16 convs and residual adds carry to the logits.
RESNET_BF16_LOGITS_REL = 0.05
# folded f32 (the f32 kernel) vs the unfolded f32 model (conv -> BN -> relu),
# TF32 off: the fold's reassociation (w·s summed, not the sum scaled) and
# other f32 summation orders through 53 convs, as the CPU tests' bound
# against the JAX package.
RESNET_F32_LOGITS_REL = 1e-4
RESNET_IMAGE = 224
RESNET_BATCHES = (8, 128)


@torch.no_grad()
def seed_resnet_bn_stats(model, seed: int) -> None:
    """Means N(0, 0.1), variances U(0.5, 1.5), γ ≈ 1 and β ≈ 0 with noise
    on every BatchNorm2D (the init leaves the identity, which makes the
    fold trivial)."""
    from paddle_tpu_torch.models.resnet import BatchNorm2D
    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm2D):
            c = m.num_features
            for t, v in ((m._mean, 0.1 * torch.randn(c, generator=gen)),
                         (m._variance, torch.rand(c, generator=gen) + 0.5),
                         (m.weight, 1 + 0.1 * torch.randn(c, generator=gen)),
                         (m.bias, 0.1 * torch.randn(c, generator=gen))):
                t.copy_(v)


def make_resnet50(dtype=torch.bfloat16, seed: int = 0):
    """``resnet50(num_classes=1000)`` on the card with seeded random
    weights and BN statistics, eval, channels-last."""
    from paddle_tpu_torch.models.resnet import resnet50
    model = resnet50(num_classes=1000, dtype=torch.float32,
                     generator=torch.Generator().manual_seed(seed))
    seed_resnet_bn_stats(model, seed + 1)
    return model.to(dtype=dtype, memory_format=torch.channels_last).eval()


def resnet_input(B: int, dtype, seed: int = 5):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((B, 3, RESNET_IMAGE, RESNET_IMAGE), generator=gen,
                       device="cuda").to(dtype)


def time_forwards(model, x, reps: int) -> tuple:
    """Host ms per forward over ``reps`` forwards ending in a synchronize
    (after 3 warm-up forwards), and the peak memory of the run in GiB."""
    with torch.no_grad():
        for _ in range(3):
            model(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(reps):
            model(x)
        torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / reps
    return dt * 1e3, torch.cuda.max_memory_allocated() / 2 ** 30


def _rowwise_hooks(folded, seen: list):
    """Forward hooks on the row-wise sites: each records (M, K, N, relu)
    and checks that the [M, K] operand is a view of the activation."""
    from paddle_tpu_torch.analysis import ConvBnAct

    def hook(mod, args, out):
        x = args[0]
        b, c, h, w = x.shape
        assert x.permute(0, 2, 3, 1).reshape(-1, c).data_ptr() == \
            x.data_ptr() and x.is_contiguous(
                memory_format=torch.channels_last), "a kernel site copied"
        seen.append((b * h * w, c, mod.weight.shape[1], mod.relu))

    return [m.register_forward_hook(hook) for m in folded.modules()
            if isinstance(m, ConvBnAct) and m.rowwise]


def resnet_phase() -> dict:
    """Phase 12: ResNet-50 inference, folded, on the conv-epilogue kernel
    at full width and depth (224 x 224, 1000 classes), B 8 and B 128."""
    import collections
    import copy
    from paddle_tpu_torch.analysis import ConvBnAct, fold_conv_bn
    from paddle_tpu_torch.ops.kernels import conv_epilogue as ce
    # f32: folded (the f32 kernel) vs unfolded, TF32 off (set in main)
    m32 = make_resnet50(torch.float32)
    n_params = sum(p.numel() for p in m32.parameters())
    f32_folded, fired = fold_conv_bn(m32)
    assert fired == {"conv-bn-fold": 53}, fired
    x32 = resnet_input(8, torch.float32)
    with torch.no_grad():
        ref32 = m32(x32)
        got32 = f32_folded(x32)
    torch.cuda.synchronize()
    scale32 = float(ref32.abs().max())
    rel32 = float((got32 - ref32).abs().max()) / scale32
    assert torch.isfinite(got32).all() and rel32 <= RESNET_F32_LOGITS_REL, \
        (rel32, RESNET_F32_LOGITS_REL)
    top32 = ref32.argmax(-1)
    log(f"resnet50 ({n_params / 1e6:.2f} M params): fold fired {fired}; "
        f"f32 folded (kernel) vs unfolded logits max |d| {rel32:.3g} of "
        f"the logit scale {scale32:.4g} (bound {RESNET_F32_LOGITS_REL}), "
        f"top-1 equal on {int((got32.argmax(-1) == top32).sum())}/8")
    del f32_folded, got32

    model = copy.deepcopy(m32).to(torch.bfloat16)
    del m32
    folded, fired = fold_conv_bn(model)
    plain, _ = fold_conv_bn(model, impl="reference")
    assert fired == {"conv-bn-fold": 53}, fired
    x8 = x32.to(torch.bfloat16)
    rec = dict(fired=fired["conv-bn-fold"], params=n_params)

    # the main path: every forward of the folded bf16 model, counted
    ce.matmul_bias_act.launches = 0
    ConvBnAct.input_copies = 0
    seen: list = []
    hooks = _rowwise_hooks(folded, seen)
    with torch.no_grad():
        logits = folded(x8)
    for h in hooks:
        h.remove()
    forwards = 1
    assert collections.Counter(seen) == RESNET_B8_SITES, \
        collections.Counter(seen)
    for B in RESNET_BATCHES:
        x = resnet_input(B, torch.bfloat16)
        ms, peak = time_forwards(folded, x, reps=20 if B == 8 else 10)
        forwards += 3 + (20 if B == 8 else 10)
        rec[f"folded_b{B}"] = dict(ms=ms, images_per_s=B / ms * 1e3,
                                   peak_gib=peak)
    launches = ce.matmul_bias_act.launches
    assert launches == 33 * forwards, (launches, forwards)
    assert ConvBnAct.input_copies == 0, ConvBnAct.input_copies
    rec["launches"] = launches

    with torch.no_grad():
        ref = plain(x8)
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all() and logits.shape == (8, 1000)
    scale = float(ref.float().abs().max())
    std = float(ref.float().std())
    rel = float((logits.float() - ref.float()).abs().max()) / scale
    assert rel <= RESNET_BF16_LOGITS_REL, (rel, RESNET_BF16_LOGITS_REL)
    agree = int((logits.argmax(-1) == top32).sum())
    log(f"resnet50 bf16 folded: kernels vs plain versions max |dlogit| "
        f"{rel:.4g} of the logit scale {scale:.4g} (std {std:.4g}; bound "
        f"{RESNET_BF16_LOGITS_REL}); top-1 equal to the f32 unfolded "
        f"model's on {agree}/8; launches {launches} = 33 x {forwards} "
        f"forwards; no kernel site copied its input")
    rec.update(bf16_rel=rel, logit_scale=scale, logit_std=std,
               f32_rel=rel32, top1_agree=agree)
    del plain, folded
    for B in RESNET_BATCHES:
        x = resnet_input(B, torch.bfloat16)
        ms, peak = time_forwards(model, x, reps=20 if B == 8 else 10)
        rec[f"unfolded_b{B}"] = dict(ms=ms, images_per_s=B / ms * 1e3,
                                     peak_gib=peak)
    for B in RESNET_BATCHES:
        f, u = rec[f"folded_b{B}"], rec[f"unfolded_b{B}"]
        log(f"resnet50 bf16 B {B} at {RESNET_IMAGE}x{RESNET_IMAGE}: folded "
            f"{f['ms']:.3f} ms/forward ({f['images_per_s']:.1f} images/s, "
            f"peak {f['peak_gib']:.2f} GiB); unfolded (conv -> BN -> relu "
            f"on cuDNN) {u['ms']:.3f} ms ({u['images_per_s']:.1f} images/s, "
            f"peak {u['peak_gib']:.2f} GiB)")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from paddle_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
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
        fn = ""
        for ln in Path(str(path) + ".log").read_text().splitlines():
            if "Compiling entry function" in ln:
                fn = kernel_short_name(ln.split("'")[1])
            elif "Used" in ln or "spill" in ln:
                log(f"ptxas {name} {fn}: {ln.strip()}")
            elif "Performance Loss" in ln:   # names its function itself
                text, _, rest = ln.partition("'")
                log(f"ptxas {name} {kernel_short_name(rest.split(chr(39))[0])}"
                    f": {text.strip()}")
    log("flash attention bf16 SASS, HGMMA per kernel (Dh 64, 128): "
        + ", ".join(f"{k} {v}" for k, v in
                    check_flash_sass(libs["flash_attention"]).items()))
    log("decode attention SASS (bf16 kernels, min / max HMMA, f32 kernels "
        "with HMMA): " + ", ".join(f"{k} {v}" for k, v in
                                   check_decode_sass(libs).items()))
    log("gmm, tgmm, int8 and conv-epilogue bf16 SASS, HGMMA per "
        "instantiation (no HMMA): " + ", ".join(
            f"{k} {v}" for k, v in check_gemm_sass(libs).items()))

    rec = kernel_phase()
    train_rec = train_kernel_phase()
    paged_rec = paged_kernel_phase()
    int8_rec = int8_kernel_phase()
    params, cfg = init_8b()
    serving = serving_phase(params, cfg)
    paths = paged_paths_phase(params, cfg)
    sampling_phase(params, cfg)
    adopted_rec = adopted_kernel_case()
    migration = migration_phase(params, cfg)
    # free the 8B serving state before Qwen2-MoE's 43 GB of weights and
    # the train step's 61 GiB peak
    del params
    gc.collect()
    torch.cuda.empty_cache()
    qwen_serve = qwen_serving_phase()
    gc.collect()
    torch.cuda.empty_cache()
    train = train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    gmm_rec = gmm_kernel_phase()
    qwen = qwen_train_phase()
    gc.collect()
    torch.cuda.empty_cache()
    ce_rec = conv_epilogue_phase()
    resnet = resnet_phase()

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
                            launches=train["launches"][
                                RMS_COUNTED_AS.get(name, name)],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"]))
    gp = paths["generate_paged"]
    for name, replaces, launches, case, mode in (
            ("paged_attention", "paddle_tpu/inference/paged_kv.py:201",
             paths["decode_block"]["launches"]["paged_attention"],
             paged_rec["engine_16k"], "plain_mode"),
            ("paged_attention_stats", "paddle_tpu/inference/paged_kv.py:285",
             gp["bf16"]["launches"]["paged_attention_stats"],
             paged_rec["bench_mix"], "stats")):
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/paged_attention.cu",
            replaces=replaces, launches=launches,
            max_abs_err=case["bf16_max_abs_err"], ms=case[mode]["ms"],
            plain_ms=case["plain_ms"], bound_ms=case[mode]["bound_ms"],
            bound_by=case[mode]["bound_by"], library_ms=case["library_ms"]))
    # row 9 in both regimes: a decode step's products at M = 32, and the
    # same seven projections and lm_head at prefill's M = 256 and 4096
    for name, M in (("int8_matmul", 32), ("int8_matmul_prefill_256", 256),
                    ("int8_matmul_prefill_4096", 4096)):
        step = int8_step_record(int8_rec, M)
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/int8_matmul.cu",
            replaces="paddle_tpu/ops/pallas/int8_matmul.py:48",
            launches=gp["int8"]["launches"]["int8_matmul"],
            max_abs_err=step["max_abs_err"], ms=step["ms"],
            plain_ms=step["plain_ms"], bound_ms=step["bound_ms"],
            bound_by=step["bound_by"], library_ms=step["library_ms"]))
    for name, replaces, _, _, count in GMM_KERNELS:
        r = gmm_rec[name]
        kernels.append(dict(
            name=name, route="cuda",
            source="paddle_tpu_torch/csrc/grouped_matmul.cu",
            replaces=replaces, launches=qwen["launches"][count],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"]))
    # phase 14: the decode kernels at Qwen2-MoE's geometry (G = 1, its
    # int8 shapes), launched by its serving paths
    qa = qwen_serve["attention"]
    for name, source, replaces, launches, case in (
            ("ragged_paged_attention_qwen_g1",
             "paddle_tpu_torch/csrc/ragged_paged_attention.cu",
             "paddle_tpu/ops/pallas/ragged_paged_attention.py:301",
             qwen_serve["serving"]["launches"], qa["ragged_d_engine_tick"]),
            ("paged_attention_qwen_g1",
             "paddle_tpu_torch/csrc/paged_attention.cu",
             "paddle_tpu/inference/paged_kv.py:201",
             qwen_serve["decode_block"]["launches"]["paged_attention"],
             qa["paged_engine_16k"])):
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=case["bf16_max_abs_err"],
            ms=case["ms"], plain_ms=case["plain_ms"],
            bound_ms=case["bound_ms"], bound_by=case["bound_by"],
            library_ms=case["library_ms"]))
    # phase 15: the ragged kernel over adopted pages (engine B's decode)
    kernels.append(dict(
        name="ragged_paged_attention_adopted", route="cuda",
        source="paddle_tpu_torch/csrc/ragged_paged_attention.cu",
        replaces="paddle_tpu/ops/pallas/ragged_paged_attention.py:301",
        launches=migration["launches"],
        max_abs_err=adopted_rec["bf16_max_abs_err"], ms=adopted_rec["ms"],
        plain_ms=adopted_rec["plain_ms"], bound_ms=adopted_rec["bound_ms"],
        bound_by=adopted_rec["bound_by"],
        library_ms=adopted_rec["library_ms"]))
    qstep = qwen_serve["int8"]["step_8"]
    kernels.append(dict(
        name="int8_matmul_qwen", route="cuda",
        source="paddle_tpu_torch/csrc/int8_matmul.cu",
        replaces="paddle_tpu/ops/pallas/int8_matmul.py:48",
        launches=qwen_serve["engine_int8"]["launches"]["int8_matmul"],
        max_abs_err=qstep["max_abs_err"], ms=qstep["ms"],
        plain_ms=qstep["plain_ms"], bound_ms=qstep["bound_ms"],
        bound_by=qstep["bound_by"], library_ms=qstep["library_ms"]))
    kernels.append(dict(
        name="conv_epilogue", route="cuda",
        source="paddle_tpu_torch/csrc/conv_epilogue.cu",
        replaces="paddle_tpu/ops/pallas/conv_epilogue.py:46",
        launches=resnet["launches"], max_abs_err=ce_rec["max_abs_err"],
        ms=ce_rec["ms"], plain_ms=ce_rec["plain_ms"],
        bound_ms=ce_rec["bound_ms"], bound_by=ce_rec["bound_by"],
        library_ms=ce_rec["library_ms"]))
    for k in kernels:     # every kernel of the line ran on its path
        assert k["launches"] > 0, k
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
