"""Functional MoE: gating and expert dispatch, one device.

Port of ``paddle_tpu/incubate/moe/functional.py``:

* ``moe_ffn_dropless`` — f32 router logits, softmax, top-k, the
  switch-gate aux loss, and the dropless FFN on the grouped-matmul
  kernels (``ops/kernels/grouped_matmul.py``); nothing is dropped;
* ``moe_ffn`` — the GShard formulation: ``top_k_gating`` builds dense
  one-hot dispatch and combine tensors ``[S, E, C]`` for a capacity C
  (overflow tokens are dropped) and ``moe_expert_compute`` runs the
  experts as einsums. Plain PyTorch: it is ``Qwen2MoeConfig``'s default
  ``moe_impl`` and the independent yardstick of the dropless path (with
  a capacity that drops nothing, ``capacity_factor = E / top_k``, the two
  compute the same function).

One device: the JAX package's ``ep_axis`` (expert parallelism) raises
``NotImplementedError``. The random second-expert policy draws from a raw
key of ``prng`` (``prng.key(seed)``), which reproduces ``jax.random``'s
bits. ``torch.topk`` and ``torch.argmax`` break ties
toward the lower index, as ``lax.top_k`` and ``jnp.argmax`` do; with
continuous random router inputs ties do not occur in practice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ... import prng
from ...ops.kernels.grouped_matmul import moe_mlp_dropless

__all__ = ["default_capacity", "top_k_gating", "moe_ffn_dropless",
           "moe_expert_compute", "moe_ffn"]


def default_capacity(num_tokens: int, num_experts: int, top_k: int,
                     capacity_factor: float) -> int:
    """Per-expert token slots C (gshard_gate.py capacity computation)."""
    cap = int(capacity_factor * top_k * num_tokens / num_experts)
    return max(cap, top_k)


def _one_hot(idx, n: int):
    """f32 one-hot; an index outside [0, n) gives a zero row, as
    ``jax.nn.one_hot`` does."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def _switch_aux(raw_gates, top1, num_experts: int):
    """Load-balance aux loss: top-1 density x mean gate prob, times E^2
    (switch_gate.py), shared by both formulations."""
    density = _one_hot(top1, num_experts).mean(0)
    return (density * raw_gates.mean(0)).mean() * (num_experts
                                                   * num_experts)


def top_k_gating(logits, top_k: int, capacity: int, *, key=None,
                 second_policy: str = "all",
                 normalize_topk: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense top-k gating (GShard) of ``[S, E]`` router logits.

    Returns ``(dispatch, combine, aux_loss)``: dispatch ``[S, E, C]``
    one-hot, combine ``[S, E, C]`` weights, both f32, and the switch aux
    loss. Earlier k-slots and earlier tokens win capacity.

    ``second_policy="random"`` with a ``key`` (a raw ``prng`` key): the
    2nd and later experts are kept where a uniform draw is below twice
    their gate (GShard's random routing), one ``split`` of the key per
    slot, as the JAX package draws."""
    S, E = logits.shape
    random = key is not None and second_policy == "random"
    if random:
        key = key.to(logits.device)
    raw_gates = torch.softmax(logits.float(), dim=-1)
    masks, gate_vals, top1 = [], [], None
    g = raw_gates
    for i in range(top_k):
        idx = torch.argmax(g, dim=-1)
        top1 = idx if top1 is None else top1
        m = _one_hot(idx, E)                                    # [S, E]
        g = g * (1.0 - m)   # peeled before the draw: never re-picked
        gv = (raw_gates * m).sum(-1)
        if i > 0 and random:
            key, sub = prng.split(key)
            keep = (prng.uniform(sub, (S,)) < 2.0 * gv).float()
            m = m * keep[:, None]
            gv = gv * keep
        masks.append(m)
        gate_vals.append(gv)
    aux = _switch_aux(raw_gates, top1, E)
    if normalize_topk:  # mixtral-style renormalization over the chosen k
        denom = sum(gate_vals)
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        gate_vals = [gv / denom for gv in gate_vals]
    dispatch = torch.zeros((S, E, capacity), device=logits.device)
    combine = torch.zeros((S, E, capacity), device=logits.device)
    running = torch.zeros((E,), device=logits.device)
    for m, gv in zip(masks, gate_vals):
        pos_all = torch.cumsum(m, 0) - m + running             # [S, E]
        pos = (pos_all * m).sum(-1).to(torch.int32)            # [S]
        running = running + m.sum(0)
        within = (pos < capacity).float()
        d = ((m * within[:, None])[:, :, None]
             * _one_hot(pos, capacity)[:, None, :])            # [S, E, C]
        dispatch = dispatch + d
        combine = combine + gv[:, None, None] * d
    return dispatch, combine, aux


def moe_ffn_dropless(x, gate_w, w_gate, w_up, w_down, *, top_k: int = 2,
                     tile_m: int = 128, impl: str = "auto"):
    """Dropless token-choice MoE FFN over ``x [..., D]`` (the contract of
    ``moe_ffn``): returns ``(y, aux_loss)``. The combine weights are the
    top-k softmax probabilities cast to x's dtype; ``impl`` is the
    grouped-matmul kernels' switch."""
    orig_shape = x.shape
    D = orig_shape[-1]
    E = w_gate.shape[0]
    xs = x.reshape(-1, D)
    logits = xs.float() @ gate_w.float()
    raw_gates = torch.softmax(logits, dim=-1)
    cw, eids = torch.topk(raw_gates, top_k, dim=-1)
    aux = _switch_aux(raw_gates, eids[:, 0], E)
    y = moe_mlp_dropless(xs, eids, cw.to(x.dtype), w_gate, w_up, w_down,
                         tile_m=tile_m, impl=impl)
    return y.reshape(orig_shape), aux


def moe_expert_compute(xs, dispatch, combine, w_gate, w_up, w_down, *,
                       ep_axis: Optional[str] = None, activation=F.silu):
    """Dispatch -> SwiGLU experts -> combine on tokens ``[S, D]`` with
    gating tensors ``[S, E, C]``."""
    if ep_axis is not None:
        raise NotImplementedError("expert parallelism is not ported: the "
                                  "port's MoE runs on one device")
    dispatch = dispatch.to(xs.dtype)
    combine = combine.to(xs.dtype)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, xs)      # [E, C, D]
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, w_up)
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down)       # [E, C, D]
    return torch.einsum("sec,ecd->sd", combine, expert_out)    # [S, D]


def moe_ffn(x, gate_w, w_gate, w_up, w_down, *, top_k: int = 2,
            capacity_factor: float = 2.0, key=None,
            ep_axis: Optional[str] = None, activation=F.silu):
    """Mixture-of-experts SwiGLU FFN over ``x [..., D]`` with capacity
    dispatch; expert weights stacked on a leading E axis (``w_gate`` /
    ``w_up [E, D, F]``, ``w_down [E, F, D]``). Returns ``(y, aux)``.
    ``key`` goes to ``top_k_gating`` under its default policy, which
    draws nothing (the JAX signature)."""
    orig_shape = x.shape
    D = orig_shape[-1]
    E = w_gate.shape[0]
    xs = x.reshape(-1, D)
    capacity = default_capacity(xs.shape[0], E, top_k, capacity_factor)
    logits = xs.float() @ gate_w.float()
    dispatch, combine, aux = top_k_gating(logits, top_k, capacity, key=key)
    y = moe_expert_compute(xs, dispatch, combine, w_gate, w_up, w_down,
                           ep_axis=ep_axis, activation=activation)
    return y.reshape(orig_shape), aux.float()
