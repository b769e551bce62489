"""Functional MoE: gating and expert dispatch, on one device or over a
hybrid mesh.

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

Expert parallelism (``ep_axis``, an axis of the global ``HybridMesh``
with more than one rank). The JAX package computes one function of the
global batch, which GSPMD partitions; one process a rank, the port
computes the same function over ``torch.distributed``:

* the tokens a rank gives are its rows of the mesh's dp axis, replicated
  over ep (the JAX ``make_batch`` layout);
* the gating is global over dp: the capacity is ``default_capacity`` of
  the global token count, each token's queue position counts the tokens
  of the lower dp ranks ahead of it (one all-gather of the ``[k, E]``
  slot counts over dp), and the aux loss takes dp-summed statistics;
* each rank runs its own experts (the ``E / ep`` of its ep index) on its
  rows' slots and the partial combine is all-reduced over ep — the
  exchange GSPMD derives for tokens that ep replicates. The ep region is
  entered through the "f" operator (identity forward, all-reduce of the
  gradient) and left through "g" (all-reduce forward), so every ep rank
  holds the whole gradient of what ep replicates.

Gradients follow the mesh trainer's convention: each dp rank's loss is
the mean over its rows plus the global aux term, the trainer averages
the ranks' gradients. The aux statistics' dp all-reduce therefore
all-reduces its gradient too, so the average holds the aux gradient
once (an identity backward would leave it 1/dp too small).

The random second-expert policy draws from a raw key of ``prng``
(``prng.key(seed)``), which reproduces ``jax.random``'s bits; under dp
the draw is the global one and a rank takes its rows. ``torch.topk`` and
``torch.argmax`` break ties toward the lower index, as ``lax.top_k`` and
``jnp.argmax`` do; with continuous random router inputs ties do not
occur in practice.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ... import prng
from ...ops.kernels.grouped_matmul import moe_mlp_dropless

__all__ = ["default_capacity", "top_k_gating", "moe_ffn_dropless",
           "moe_expert_compute", "moe_ffn", "moe_ffn_sharded",
           "record_dropped"]


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


def _n(g) -> int:
    return 1 if g is None else g.nranks


def _live(g) -> bool:
    return _n(g) > 1


def _dp_rows(t, dp_g):
    """This dp rank's rows of a draw of the global batch (rows split over
    ``dp_g`` in rank order)."""
    if not _live(dp_g):
        return t
    n = t.shape[0] // dp_g.nranks
    return t[dp_g.rank * n:(dp_g.rank + 1) * n]


def _group(axis):
    """A mesh axis name (the global mesh's line through this rank) or a
    ``Group`` as a ``Group`` (None: one rank)."""
    from ...parallel.mp_ops import axis_group
    return axis_group(axis)


def _ep_mesh(ep_axis: str):
    """The global mesh and its ``ep_axis`` group; ``ValueError`` unless
    that axis has more than one rank."""
    from ...parallel.mesh import get_hybrid_mesh
    hm = get_hybrid_mesh()
    if hm is None or hm.degree(ep_axis) <= 1:
        raise ValueError(
            f"ep_axis={ep_axis!r} shards the experts over an axis of the "
            f"global hybrid mesh with more than one rank; the global mesh "
            f"is {hm!r}")
    return hm, hm.group(ep_axis)


_RECORD = [None]


@contextlib.contextmanager
def record_dropped():
    """Within it, every capacity gating appends to the yielded list the
    number of (token, slot) assignments it dropped over the global batch
    (a 0-d f32 tensor, read with ``float``): per expert, its queue's
    length beyond the capacity."""
    prev, out = _RECORD[0], []
    _RECORD[0] = out
    try:
        yield out
    finally:
        _RECORD[0] = prev


def _psum_both(x, g):
    """All-reduce over ``g`` in forward and of the gradient in backward
    (the transpose of a sum over dp ranks that each use the whole)."""
    from ...parallel.mp_ops import identity_fwd_psum_bwd, psum_fwd_identity_bwd
    return identity_fwd_psum_bwd(psum_fwd_identity_bwd(x, g), g)


def _slots(logits, top_k: int, key, second_policy: str, dp_g):
    """Softmax gates and, slot by slot, each token's expert (one-hot
    mask ``[S, E]``) and gate value ``[S]``: the top-k peeled off one at
    a time; under the random policy the 2nd and later slots keep their
    expert where a uniform draw of the global batch is below twice its
    gate. Returns ``(raw_gates, masks, gate_vals, top1)``."""
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
            u = _dp_rows(prng.uniform(sub, (S * _n(dp_g),)), dp_g)
            keep = (u < 2.0 * gv).float()
            m = m * keep[:, None]
            gv = gv * keep
        masks.append(m)
        gate_vals.append(gv)
    return raw_gates, masks, gate_vals, top1


def _aux(raw_gates, top1, dp_g):
    """The switch aux loss of the global batch: on one rank
    ``_switch_aux``; under dp the density and gate sums all-reduced (the
    gate sum's gradient too, see the module docstring)."""
    S, E = raw_gates.shape
    if not _live(dp_g):
        return _switch_aux(raw_gates, top1, E)
    from ...distributed import communication as C
    density = _one_hot(top1, E).sum(0)
    C.all_reduce(density, C.ReduceOp.SUM, dp_g)
    proxy = _psum_both(raw_gates.sum(0), dp_g)
    n = float(S * dp_g.nranks)
    return ((density / n) * (proxy / n)).mean() * (E * E)


def _queues(masks, capacity: int, dp_g):
    """Each slot's queue position ``[S]`` (int32) and whether it is
    within the capacity: earlier k-slots, then earlier tokens of the
    global batch win, the lower dp ranks' tokens ahead of this rank's."""
    counts = torch.stack([m.sum(0) for m in masks])            # [k, E]
    lower = None
    if _live(dp_g):
        from ...distributed import communication as C
        every = torch.stack(C.all_gather(None, counts, dp_g))  # [dp, k, E]
        lower, counts = every[:dp_g.rank].sum(0), every.sum(0)
    rec = _RECORD[0]
    if rec is not None:
        rec.append((counts.sum(0) - capacity).clamp(min=0).sum())
    running = torch.zeros_like(counts[0])
    out = []
    for i, m in enumerate(masks):
        pos_all = torch.cumsum(m, 0) - m + running             # [S, E]
        if lower is not None:
            pos_all = pos_all + lower[i]
        pos = (pos_all * m).sum(-1).to(torch.int32)            # [S]
        running = running + counts[i]
        out.append((pos, (pos < capacity).float()))
    return out


def _dispatch_combine(masks, gate_vals, queues, capacity: int, e0: int,
                      e1: int):
    """Dense dispatch and combine ``[S, e1 - e0, C]`` of experts
    ``e0 .. e1 - 1``."""
    S = masks[0].shape[0]
    dev = masks[0].device
    dispatch = torch.zeros((S, e1 - e0, capacity), device=dev)
    combine = torch.zeros((S, e1 - e0, capacity), device=dev)
    for m, gv, (pos, within) in zip(masks, gate_vals, queues):
        d = ((m[:, e0:e1] * within[:, None])[:, :, None]
             * _one_hot(pos, capacity)[:, None, :])            # [S, E, C]
        dispatch = dispatch + d
        combine = combine + gv[:, None, None] * d
    return dispatch, combine


def top_k_gating(logits, top_k: int, capacity: int, *, key=None,
                 second_policy: str = "all",
                 normalize_topk: bool = False, dp_axis=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dense top-k gating (GShard) of ``[S, E]`` router logits.

    Returns ``(dispatch, combine, aux_loss)``: dispatch ``[S, E, C]``
    one-hot, combine ``[S, E, C]`` weights, both f32, and the switch aux
    loss. Earlier k-slots and earlier tokens win capacity.

    ``second_policy="random"`` with a ``key`` (a raw ``prng`` key): the
    2nd and later experts are kept where a uniform draw is below twice
    their gate (GShard's random routing), one ``split`` of the key per
    slot, as the JAX package draws.

    ``dp_axis`` (a mesh axis name or a ``Group``): ``logits`` are this
    rank's rows of a batch split over it in rank order, and the result
    is those rows of the global batch's gating (``capacity`` is the
    global one)."""
    dp_g = _group(dp_axis)
    raw_gates, masks, gate_vals, top1 = _slots(logits, top_k, key,
                                               second_policy, dp_g)
    aux = _aux(raw_gates, top1, dp_g)
    if normalize_topk:  # mixtral-style renormalization over the chosen k
        denom = sum(gate_vals)
        denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        gate_vals = [gv / denom for gv in gate_vals]
    queues = _queues(masks, capacity, dp_g)
    E = logits.shape[1]
    dispatch, combine = _dispatch_combine(masks, gate_vals, queues,
                                          capacity, 0, E)
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


def _experts(xs, dispatch, combine, w_gate, w_up, w_down, activation):
    """Dispatch -> SwiGLU experts -> combine, the einsums of every
    layout; the gating tensors cast to the tokens' dtype."""
    dispatch = dispatch.to(xs.dtype)
    combine = combine.to(xs.dtype)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, xs)      # [E, C, D]
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, w_gate))
    h = h * torch.einsum("ecd,edf->ecf", expert_in, w_up)
    expert_out = torch.einsum("ecf,efd->ecd", h, w_down)       # [E, C, D]
    return torch.einsum("sec,ecd->sd", combine, expert_out)    # [S, D]


def moe_expert_compute(xs, dispatch, combine, w_gate, w_up, w_down, *,
                       ep_axis: Optional[str] = None, activation=F.silu):
    """Dispatch -> SwiGLU experts -> combine on tokens ``[S, D]`` with
    gating tensors ``[S, E, C]``.

    ``ep_axis``: the experts are sharded over that axis of the global
    mesh; ``xs``, ``dispatch`` and ``combine`` are replicated over it.
    The weights are either every expert (``[E, ...]``: this rank takes
    its ``E / ep``, and their gradient is all-gathered, so each rank
    holds every expert's) or this rank's shard (``[E / ep, ...]``). This
    rank's experts run on their slots and the partial combine is
    all-reduced over ep; ``combine``'s gradient is all-gathered and
    ``xs``'s all-reduced, so every ep rank holds the replicated
    gradients whole."""
    if ep_axis is None:
        return _experts(xs, dispatch, combine, w_gate, w_up, w_down,
                        activation)
    from ...parallel.mp_ops import (identity_fwd_psum_bwd,
                                    psum_fwd_identity_bwd,
                                    split_fwd_gather_bwd)
    _, g = _ep_mesh(ep_axis)
    E, n = dispatch.shape[1], g.nranks
    if E % n:
        raise ValueError(f"{E} experts do not split over ep={n}")
    El = E // n
    if w_gate.shape[0] == E:
        w_gate, w_up, w_down = (split_fwd_gather_bwd(w, 0, g)
                                for w in (w_gate, w_up, w_down))
    elif w_gate.shape[0] != El:
        raise ValueError(f"expert weights of {w_gate.shape[0]} experts: "
                         f"want all {E} or this rank's {El}")
    e0 = g.rank * El
    combine = split_fwd_gather_bwd(combine, 1, g)
    y = _experts(identity_fwd_psum_bwd(xs, g), dispatch[:, e0:e0 + El],
                 combine, w_gate, w_up, w_down, activation)
    return psum_fwd_identity_bwd(y, g)


def moe_ffn_sharded(x, gate_w, w_gate, w_up, w_down, *, top_k: int,
                    capacity_factor: float, key=None, dp_group=None,
                    ep_group=None, tp_group=None, x_router=None,
                    activation=F.silu):
    """``moe_ffn`` over explicit groups, the mesh model's MoE FFN.

    ``x [..., D]``: this rank's rows of a batch split over ``dp_group``,
    replicated over ``ep_group`` and ``tp_group``; ``x_router`` (default
    ``x``) the same values the router reads, for a caller whose
    replicated branches take another gradient path than the experts'.
    ``w_gate`` / ``w_up [El, D, Fl]``, ``w_down [El, Fl, D]``: this ep
    rank's ``El = E / ep`` experts, F split over ``tp_group`` (whole when
    it is None). Returns ``(y, aux)``: ``y`` summed over ep and PARTIAL
    over tp (the caller's reduce adds the tp shards' products), ``aux``
    the global batch's.

    Only the gate values' gradient ``[S, k]`` crosses ranks for the
    combine weights (all-reduced over tp and ep: each rank sees its
    experts' and its F shard's part), not a dense ``[S, E, C]``; the
    tokens' expert-path gradient is all-reduced over ep."""
    from ...parallel.mp_ops import identity_fwd_psum_bwd, psum_fwd_identity_bwd
    orig_shape = x.shape
    D = orig_shape[-1]
    E = gate_w.shape[-1]
    El, n_ep = w_gate.shape[0], _n(ep_group)
    if El * n_ep != E:
        raise ValueError(f"{w_gate.shape[0]} experts a rank over ep={n_ep} "
                         f"is not the router's {E}")
    xs = x.reshape(-1, D)
    xr = xs if x_router is None else x_router.reshape(-1, D)
    capacity = default_capacity(xs.shape[0] * _n(dp_group), E, top_k,
                                capacity_factor)
    logits = xr.float() @ gate_w.float()
    raw_gates, masks, gate_vals, top1 = _slots(logits, top_k, key, "all",
                                               dp_group)
    aux = _aux(raw_gates, top1, dp_group)
    queues = _queues(masks, capacity, dp_group)
    gv = torch.stack(gate_vals, -1)                            # [S, k]
    for g in (tp_group, ep_group):
        gv = identity_fwd_psum_bwd(gv, g)
    e0 = (ep_group.rank if _live(ep_group) else 0) * El
    dispatch, combine = _dispatch_combine(masks, gv.unbind(-1), queues,
                                          capacity, e0, e0 + El)
    y = _experts(identity_fwd_psum_bwd(xs, ep_group), dispatch, combine,
                 w_gate, w_up, w_down, activation)
    y = psum_fwd_identity_bwd(y, ep_group)
    return y.reshape(orig_shape), aux.float()


def moe_ffn(x, gate_w, w_gate, w_up, w_down, *, top_k: int = 2,
            capacity_factor: float = 2.0, key=None,
            ep_axis: Optional[str] = None, activation=F.silu):
    """Mixture-of-experts SwiGLU FFN over ``x [..., D]`` with capacity
    dispatch; expert weights stacked on a leading E axis (``w_gate`` /
    ``w_up [E, D, F]``, ``w_down [E, F, D]``). Returns ``(y, aux)``.
    ``key`` goes to ``top_k_gating`` under its default policy, which
    draws nothing (the JAX signature).

    ``ep_axis``: over the global mesh (``ValueError`` unless that axis
    has more than one rank), ``x`` is this rank's dp rows, the weights
    this rank's ep shard ``[E / ep, ...]`` (``param_specs``' layout), and
    the gating global over dp (``moe_ffn_sharded``)."""
    if ep_axis is not None:
        hm, g = _ep_mesh(ep_axis)
        return moe_ffn_sharded(x, gate_w, w_gate, w_up, w_down, top_k=top_k,
                               capacity_factor=capacity_factor, key=key,
                               dp_group=hm.group("dp"), ep_group=g,
                               activation=activation)
    orig_shape = x.shape
    D = orig_shape[-1]
    E = w_gate.shape[0]
    xs = x.reshape(-1, D)
    capacity = default_capacity(xs.shape[0], E, top_k, capacity_factor)
    logits = xs.float() @ gate_w.float()
    dispatch, combine, aux = top_k_gating(logits, top_k, capacity, key=key)
    y = moe_expert_compute(xs, dispatch, combine, w_gate, w_up, w_down,
                           activation=activation)
    return y.reshape(orig_shape), aux.float()
