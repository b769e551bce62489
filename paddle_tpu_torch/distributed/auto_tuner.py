"""Parallel-config auto-tuner: memory + cost-model search over
(dp, tp, pp, zero, microbatches).

Port of ``paddle_tpu/distributed/auto_tuner.py`` (reference:
python/paddle/distributed/auto_tuner/, the prune-then-measure loop and
its memory cost model). Candidate hybrid-parallel configs are pruned by
a memory model (params, grads and AdamW moments as ZeRO shards them,
remat activation residency, the logits) and ranked by an analytic cost:
the step's matmul time on the cards' tensor cores plus the tp and dp
collectives' volume over the links between cards; an optional
``measure`` callback times the survivors for real.

The JAX module's defaults are measured or rated TPU figures; the port
carries no rate: ``flops_per_sec`` and ``link_bytes_per_sec`` are
required, and ``search``'s ``hbm_bytes`` defaults to the card's memory
(``torch.cuda.get_device_properties(0).total_memory``) when a card is
present and is required otherwise. The arithmetic is the JAX module's.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, List, Optional, Sequence

__all__ = ["ModelDesc", "Candidate", "estimate_memory",
           "estimate_step_cost", "candidates", "search"]


@dataclasses.dataclass
class ModelDesc:
    """Transformer shape card (defaults match models/llama.py)."""
    hidden: int
    layers: int
    ffn: int
    vocab: int
    heads: int
    kv_heads: Optional[int] = None
    seq_len: int = 2048
    global_batch: int = 8
    dtype_bytes: int = 2          # bf16 params/grads/activations
    opt_bytes_per_param: int = 4  # adamw m+v in bf16

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    @property
    def n_params(self) -> int:
        kv = self.kv_heads or self.heads
        per_layer = (self.hidden * self.heads * self.head_dim
                     + 2 * self.hidden * kv * self.head_dim
                     + self.heads * self.head_dim * self.hidden
                     + 3 * self.hidden * self.ffn)
        return self.vocab * self.hidden * 2 + self.layers * per_layer


@dataclasses.dataclass
class Candidate:
    dp: int
    tp: int
    pp: int
    zero: int = 1
    microbatches: int = 1
    mem_bytes: float = 0.0
    step_cost: float = 0.0
    feasible: bool = True
    reason: str = ""

    @property
    def world(self) -> int:
        return self.dp * self.tp * self.pp


def estimate_memory(m: ModelDesc, c: Candidate) -> float:
    """Per-card bytes: params+grads+opt sharded by the config, plus remat
    activation residency for the local microbatch."""
    shard = c.tp * c.pp * (c.dp if c.zero >= 3 else 1)
    opt_shard = c.tp * c.pp * (c.dp if c.zero >= 1 else 1)
    p = m.n_params
    params = p * m.dtype_bytes / shard
    grads = p * m.dtype_bytes / (c.tp * c.pp * (c.dp if c.zero >= 2 else 1))
    opt = p * m.opt_bytes_per_param / opt_shard
    # remat residual stream: [B/dp/M, T, D] per local layer + one layer's
    # internals (attention + mlp intermediates, ~ (4D + 3F) wide)
    local_b = max(m.global_batch // c.dp, 1) / max(c.microbatches, 1)
    resid = (m.layers / c.pp) * local_b * m.seq_len * m.hidden \
        * m.dtype_bytes / c.tp
    layer_peak = local_b * m.seq_len * (4 * m.hidden + 3 * m.ffn) \
        * m.dtype_bytes / c.tp
    # lm-head logits (the fused-CE residual; vocab-sharded under tp)
    logits = local_b * m.seq_len * m.vocab * m.dtype_bytes / c.tp
    return params + grads + opt + resid + layer_peak + logits


def estimate_step_cost(m: ModelDesc, c: Candidate, flops_per_sec: float,
                       link_bytes_per_sec: float) -> float:
    """Relative step time: matmul time at ``flops_per_sec`` a card (an
    effective rate, not the tensor cores' peak), the pipeline bubble, and
    the tp and dp collectives at ``link_bytes_per_sec`` between cards."""
    tokens = m.global_batch * m.seq_len
    flops = 6 * m.n_params * tokens / c.world
    t_mm = flops / flops_per_sec
    # pipeline bubble (GPipe/1F1B fill): (S-1)/M extra
    bubble = (c.pp - 1) / max(c.microbatches, 1)
    t_mm *= 1.0 + bubble
    # tp: 2 allreduces of [b, T, D] per layer each way ~ 4 total
    local_tokens = tokens / c.dp / max(c.microbatches, 1)
    t_tp = 0.0
    if c.tp > 1:
        vol = 4 * m.layers * local_tokens * m.hidden * m.dtype_bytes \
            * 2 * (c.tp - 1) / c.tp
        t_tp = vol / link_bytes_per_sec
    # dp grad sync: reduce-scatter+all-gather of local params
    t_dp = 0.0
    if c.dp > 1:
        vol = 2 * m.n_params * m.dtype_bytes / (c.tp * c.pp)
        t_dp = vol / link_bytes_per_sec
    return t_mm + t_tp + t_dp


def candidates(n_devices: int, m: ModelDesc,
               microbatch_options: Sequence[int] = (1, 4, 8),
               zero_options: Sequence[int] = (1, 3)) -> List[Candidate]:
    out = []
    for tp, pp in itertools.product(range(1, n_devices + 1), repeat=2):
        if n_devices % (tp * pp):
            continue
        dp = n_devices // (tp * pp)
        if m.heads % tp or m.hidden % tp:
            continue
        if m.layers % pp:
            continue
        if m.global_batch % dp:
            continue
        for mb, z in itertools.product(microbatch_options, zero_options):
            if pp == 1 and mb != microbatch_options[0]:
                continue  # microbatching only matters with pp
            if pp > 1 and (m.global_batch // dp) % mb:
                continue
            out.append(Candidate(dp=dp, tp=tp, pp=pp, zero=z,
                                 microbatches=mb))
    return out


def _card_bytes() -> float:
    import torch
    if not torch.cuda.is_available():
        raise ValueError("hbm_bytes is required where no card is present")
    return float(torch.cuda.get_device_properties(0).total_memory)


def search(n_devices: int, m: ModelDesc, hbm_bytes: Optional[float] = None,
           measure: Optional[Callable[[Candidate], float]] = None,
           top_k: int = 5, headroom: float = 1.15, *,
           flops_per_sec: float, link_bytes_per_sec: float,
           **kw) -> List[Candidate]:
    """Prune by the memory model, rank by the cost model, optionally
    re-rank the top_k by measuring real steps (the reference tuner's
    prune-then-launch loop). ``headroom`` derates the card's memory for
    the model's bias and the allocator's slack: an under-estimating
    pruner admits configs that run out of memory, the costlier
    failure."""
    if hbm_bytes is None:
        hbm_bytes = _card_bytes()
    cands = candidates(n_devices, m, **kw)
    for c in cands:
        c.mem_bytes = estimate_memory(m, c)
        if c.mem_bytes * headroom > hbm_bytes:
            c.feasible = False
            c.reason = (f"est. {c.mem_bytes/2**30:.1f} GiB x "
                        f"{headroom} headroom > "
                        f"{hbm_bytes/2**30:.1f} GiB card memory")
            continue
        c.step_cost = estimate_step_cost(m, c, flops_per_sec,
                                         link_bytes_per_sec)
    ok = sorted([c for c in cands if c.feasible],
                key=lambda c: c.step_cost)
    if measure is not None:
        timed = ok[:top_k]
        for c in timed:
            c.step_cost = measure(c)
        ok = sorted(timed, key=lambda c: c.step_cost) + ok[top_k:]
    return ok
