"""Context parallelism: ring attention (contiguous and zigzag) and Ulysses
over the cp axis of the hybrid mesh.

Port of ``paddle_tpu/parallel/context_parallel.py``. The sequence is cut
over the cp ranks; each rank holds its part ``[B, T/cp, H, Dh]`` of q, k
and v (its dp rows and tp heads too under a hybrid mesh), so activation
memory per rank falls with cp:

* **ring attention**: the kv chunks (Hkv heads, unrepeated) rotate to
  the next rank of the cp line, ``distributed.communication.exchange``
  (host copies over gloo), while each hop's partial attention folds
  into this rank's queries. ``layout="zigzag"`` gives rank r cells r and
  2R-1-r of 2R, so every hop carries the same unmasked area;
* **Ulysses**: an all-to-all trades the sequence cut for a head cut,
  the flash kernel attends the whole sequence for H/cp heads, and the
  inverse all-to-all brings the output back.

The ring is one ``torch.autograd.Function`` over the hand-written flash
kernels (``csrc/flash_attention.cu``). Its forward runs each hop as the
kernel calls of ``hop_schedule`` (a hop whose pairs are all masked
launches nothing), merges the hops' (o, lse) in f32 and rounds once. Its
backward runs the dq and dkv kernels per hop with the merged lse and the
merged o (so delta is the global one); the f32 dk / dv accumulators
travel the ring with their chunk and arrive home after R hops, summed in
hop order: no atomics, the same bits from run to run. On CPU tensors
(``impl="auto"``) or under ``impl="reference"`` the hops run the
kernels' plain counterparts, so the CPU tests hold the card's ring
algebra to the JAX package.

``ring_loopback`` runs the same Function for R virtual ranks in one
process (the card checks hold it against one-device attention): only
the transport differs, so its bits are the distributed ring's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops.kernels.flash_attention import (_dkv_run, _dq_run, _fwd_run,
                                           flash_attention, prescale_q)
from ..ops.kernels._op import acc_dtype, check_impl
from .mp_ops import axis_group

__all__ = ["chunk_positions", "zigzag_global_perm", "HopCall",
           "hop_schedule", "hop_launches", "ring_attention",
           "ring_loopback", "ulysses_attention",
           "context_parallel_attention", "CP_KINDS"]

CP_KINDS = ("ring", "zigzag", "ulysses")
_LAYOUTS = ("contiguous", "zigzag")


def _check_zigzag(Tl: int) -> None:
    if Tl % 2:
        raise ValueError(
            f"zigzag needs an even per-rank chunk (got {Tl} slots): "
            "the global seq len must be divisible by 2*cp")


def chunk_positions(r: int, R: int, Tl: int,
                    layout: str = "contiguous") -> np.ndarray:
    """Global positions (int32) of rank ``r``'s ``Tl`` local slots.

    contiguous: rank r holds tokens ``[r·Tl, (r+1)·Tl)``. zigzag: the
    sequence is cut into 2R cells; rank r holds cell r and cell 2R-1-r
    (one early, one late)."""
    if layout == "zigzag":
        _check_zigzag(Tl)
        C = Tl // 2
        a = np.arange(C, dtype=np.int32)
        return np.concatenate([r * C + a, (2 * R - 1 - r) * C + a])
    return (r * Tl + np.arange(Tl)).astype(np.int32)


def zigzag_global_perm(T: int, R: int) -> np.ndarray:
    """Position j of the zigzag-laid-out sequence holds token
    ``perm[j]``: cutting the permuted sequence into R contiguous parts
    gives rank r cells r and 2R-1-r."""
    if T % (2 * R):
        raise ValueError(f"seq len {T} not divisible by 2*cp ({2 * R})")
    C = T // (2 * R)
    out = []
    for r in range(R):
        out.append(np.arange(r * C, (r + 1) * C))
        out.append(np.arange((2 * R - 1 - r) * C, (2 * R - r) * C))
    return np.concatenate(out)


# ---------------------------------------------------------------------------
# the hop schedule: one source for the ring, the tests and the loopback
# ---------------------------------------------------------------------------

class HopCall(NamedTuple):
    """One flash-kernel call of a hop: this rank's query slots ``q``
    against the visiting chunk's slots ``kv``, with the kernel's
    bottom-right causal mask or none."""
    q: slice
    kv: slice
    causal: bool


def hop_schedule(r: int, hop: int, R: int, Tl: int,
                 layout: str = "contiguous",
                 causal: bool = True) -> Tuple[HopCall, ...]:
    """The kernel calls rank ``r`` makes at ring hop ``hop``, when it
    holds the kv chunk of rank ``(r - hop) % R``.

    Non-causal: one full ``(Tl, Tl)`` call. Causal, the diagonal hop
    (src = r): one causal ``(Tl, Tl)`` call (zigzag's local order is
    monotone in global position, so the kernel's mask is exact).
    Contiguous: src < r is a full call, src > r is all masked and makes
    none. Zigzag (cells of C = Tl/2): src < r — every query sees the
    chunk's first cell only, two ``(C, C)`` calls (the kernels take
    S >= T); src > r — the second query cell sees the whole chunk, one
    ``(C, Tl)`` call."""
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    if layout == "zigzag":
        _check_zigzag(Tl)
    src = (r - hop) % R
    full = slice(0, Tl)
    if not causal:
        return (HopCall(full, full, False),)
    if src == r:
        return (HopCall(full, full, True),)
    if layout == "contiguous":
        return (HopCall(full, full, False),) if src < r else ()
    C = Tl // 2
    a, b = slice(0, C), slice(C, Tl)
    if src < r:
        return (HopCall(a, a, False), HopCall(b, a, False))
    return (HopCall(b, full, False),)


def hop_launches(r: int, R: int, layout: str = "contiguous",
                 causal: bool = True) -> int:
    """Kernel calls of rank ``r`` in one ring attention's forward (its
    backward makes as many dq and as many dkv launches): R non-causal;
    causal, r + 1 contiguous and R + r zigzag."""
    if not causal:
        return R
    return r + 1 if layout == "contiguous" else R + r


def _rows(x, sl: slice):
    """Slots ``sl`` of a ``[B, T, ...]`` tensor, contiguous."""
    return x[:, sl].contiguous()


# ---------------------------------------------------------------------------
# the ring over the flash kernels
# ---------------------------------------------------------------------------

def _shift(tensors, group) -> list:
    """Each tensor to the next rank on the ring of ``group``, the
    previous rank's into new tensors (one exchange, a tag a tensor)."""
    from ..distributed.communication import exchange
    R, i = group.nranks, group.rank
    to, frm = group.ranks[(i + 1) % R], group.ranks[(i - 1) % R]
    outs = [torch.empty_like(t) for t in tensors]
    exchange([(t.contiguous(), to, j) for j, t in enumerate(tensors)],
             [(o, frm, j) for j, o in enumerate(outs)], group)
    return outs


class _GroupRing:
    """The cp line of a process group: this process plays its own rank,
    and a shift is one exchange with its neighbours."""

    def __init__(self, group):
        self.group, self.R, self.ranks = group, group.nranks, (group.rank,)

    def shift(self, held: list) -> list:
        return [tuple(_shift(held[0], self.group))]


class _LoopRing:
    """R virtual ranks in one process: a shift hands virtual rank r's
    tensors to rank r + 1, as they are."""

    def __init__(self, R: int):
        self.R, self.ranks = R, tuple(range(R))

    def shift(self, held: list) -> list:
        return [held[i - 1] for i in range(self.R)]


def _fold_fwd(calls, qs, kc, vc, sm_scale: float, impl: str, lse, o):
    """A hop's forward calls, each merged into ``(lse, o)`` (the
    accumulation type) at its query slots."""
    for c in calls:
        oh, lh = _fwd_run(None, _rows(qs, c.q), _rows(kc, c.kv),
                          _rows(vc, c.kv), c.causal, sm_scale, impl)
        la, oa = lse[:, :, c.q], o[:, c.q]
        new = torch.logaddexp(la, lh.to(la.dtype))
        oa.mul_(torch.exp(la - new).transpose(1, 2)[..., None])
        oa.add_(oh.to(oa.dtype)
                * torch.exp(lh.to(la.dtype) - new).transpose(1, 2)[..., None])
        la.copy_(new)


def _fold_bwd(calls, qs, kc, vc, o, do, lse, sm_scale: float, impl: str,
              dq, dk, dv):
    """A hop's dq and dkv calls on the merged (o, lse), each added to
    the accumulators at its slots."""
    for c in calls:
        qh, kh, vh = _rows(qs, c.q), _rows(kc, c.kv), _rows(vc, c.kv)
        doh, lh = _rows(do, c.q), lse[:, :, c.q].contiguous()
        dqh, delta = _dq_run(qh, kh, vh, _rows(o, c.q), doh, lh, c.causal,
                             sm_scale, impl)
        dkh, dvh = _dkv_run(qh, kh, vh, doh, lh, delta, c.causal, impl)
        dq[:, c.q] += dqh.to(dq.dtype)
        dk[:, c.kv] += dkh.to(dk.dtype)
        dv[:, c.kv] += dvh.to(dv.dtype)


def _cat(xs: list, dim: int):
    return xs[0] if len(xs) == 1 else torch.cat(xs, dim)


class _Ring(torch.autograd.Function):
    """The ring for the ranks ``ring`` plays (``_GroupRing``: this rank;
    ``_LoopRing``: all R), whose parts q, k and v hold in rank order
    along the sequence: at hop s each played rank folds the chunk it
    holds, then the chunks shift."""

    @staticmethod
    def forward(ctx, q, k, v, ring, causal, sm_scale, layout, impl):
        R, n = ring.R, len(ring.ranks)
        Tl = q.shape[1] // n
        part = lambda x, i: x[:, i * Tl:(i + 1) * Tl]      # noqa: E731
        qs = prescale_q(q.detach().contiguous(), sm_scale)
        k, v = k.detach().contiguous(), v.detach().contiguous()
        states = [_acc_state(part(q, i)) for i in range(n)]
        held = [(part(k, i), part(v, i)) for i in range(n)]
        for s in range(R):
            for i, r in enumerate(ring.ranks):
                _fold_fwd(hop_schedule(r, s, R, Tl, layout, causal),
                          part(qs, i), *held[i], sm_scale, impl, *states[i])
            if s < R - 1:
                held = ring.shift(held)
        out = _cat([o for _, o in states], 1).to(q.dtype)
        lse = _cat([lse for lse, _ in states], 2)
        ctx.save_for_backward(qs, k, v, out, lse)
        ctx.args = (ring, causal, sm_scale, layout, impl)
        return out

    @staticmethod
    def backward(ctx, do):
        qs, k, v, o, lse = ctx.saved_tensors
        ring, causal, sm_scale, layout, impl = ctx.args
        R, n = ring.R, len(ring.ranks)
        Tl, at = qs.shape[1] // n, acc_dtype(qs.dtype)
        part = lambda x, i: x[:, i * Tl:(i + 1) * Tl]      # noqa: E731
        do = do.contiguous()
        dq = torch.zeros(qs.shape, dtype=at, device=qs.device)
        zero = lambda x: torch.zeros(x.shape, dtype=at,     # noqa: E731
                                     device=x.device)
        held = [(part(k, i), part(v, i), zero(part(k, i)), zero(part(v, i)))
                for i in range(n)]
        for s in range(R):
            for i, r in enumerate(ring.ranks):
                _fold_bwd(hop_schedule(r, s, R, Tl, layout, causal),
                          part(qs, i), *held[i][:2], part(o, i), part(do, i),
                          lse[:, :, i * Tl:(i + 1) * Tl], sm_scale, impl,
                          part(dq, i), *held[i][2:])
            # the dk / dv accumulators travel with their chunk
            if s < R - 1:
                held = ring.shift(held)
        # after the last hop they go home, to the chunk's rank (the next)
        home = ring.shift([h[2:] for h in held])
        dt = qs.dtype
        return (dq.to(dt), _cat([d for d, _ in home], 1).to(dt),
                _cat([d for _, d in home], 1).to(dt), None, None, None, None,
                None)


def _acc_state(q):
    B, Tl, H, D = q.shape
    at = acc_dtype(q.dtype)
    return (torch.full((B, H, Tl), -math.inf, dtype=at, device=q.device),
            torch.zeros((B, Tl, H, D), dtype=at, device=q.device))


def _scale(q, sm_scale):
    return 1.0 / math.sqrt(q.shape[-1]) if sm_scale is None else \
        float(sm_scale)


def ring_attention(q, k, v, *, axis="cp", causal: bool = True,
                   sm_scale=None, layout: str = "contiguous",
                   impl: str = "auto"):
    """Ring attention (see the module docstring) on this rank's q
    ``[B, Tl, H, Dh]`` and k / v ``[B, Tl, Hkv, Dh]``; returns
    ``[B, Tl, H, Dh]`` in q's dtype. ``axis``: a mesh axis name of the
    global hybrid mesh or a ``Group``. ``impl`` as the flash kernels'
    (``"kernel"`` raises on anything they cannot take)."""
    check_impl(impl)
    if layout not in _LAYOUTS:
        raise ValueError(f"layout must be one of {_LAYOUTS}, got {layout!r}")
    group = axis_group(axis)
    if group is None or group.nranks == 1:
        return flash_attention(q, k, v, causal, sm_scale, impl)
    return _Ring.apply(q, k, v, _GroupRing(group), bool(causal),
                       _scale(q, sm_scale), layout, impl)


def ring_loopback(q, k, v, R: int, *, causal: bool = True, sm_scale=None,
                  layout: str = "contiguous", impl: str = "auto"):
    """``ring_attention``'s result for R virtual ranks in one process, on
    the whole sequence in natural order (``[B, T, H, Dh]``; zigzag lays
    it out and back here), differentiable: the same autograd Function,
    the ranks' chunks handed on in memory, so the same bits as the
    distributed ring."""
    check_impl(impl)
    T = q.shape[1]
    if T % R:
        raise ValueError(f"seq len {T} not divisible by cp {R}")
    perm = None
    if layout == "zigzag":
        perm = torch.as_tensor(zigzag_global_perm(T, R), device=q.device)
        q, k, v = (x.index_select(1, perm) for x in (q, k, v))
    out = _Ring.apply(q, k, v, _LoopRing(R), bool(causal),
                      _scale(q, sm_scale), layout, impl)
    if perm is not None:
        out = out.index_select(1, torch.argsort(perm))
    return out


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def _seq_to_heads(x, group):
    """``[B, Tl, H, D]`` -> ``[B, R·Tl, H/R, D]``: head group j to rank
    j, every rank's sequence part concatenated in rank order."""
    from ..distributed.communication import alltoall_single
    R = group.nranks
    B, Tl, H, D = x.shape
    send = x.reshape(B, Tl, R, H // R, D).permute(2, 0, 1, 3, 4).contiguous()
    recv = torch.empty_like(send)
    alltoall_single(send, recv, group=group)
    return recv.permute(1, 0, 2, 3, 4).reshape(B, R * Tl, H // R, D)


def _heads_to_seq(y, group):
    """The inverse: ``[B, T, H/R, D]`` -> ``[B, T/R, H, D]``."""
    from ..distributed.communication import alltoall_single
    R = group.nranks
    B, T, Hr, D = y.shape
    send = y.reshape(B, R, T // R, Hr, D).transpose(0, 1).contiguous()
    recv = torch.empty_like(send)
    alltoall_single(send, recv, group=group)
    return recv.permute(1, 2, 0, 3, 4).reshape(B, T // R, R * Hr, D)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _seq_to_heads(x, group)

    @staticmethod
    def backward(ctx, g):
        return _heads_to_seq(g.contiguous(), ctx.group), None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        ctx.group = group
        return _heads_to_seq(y, group)

    @staticmethod
    def backward(ctx, g):
        return _seq_to_heads(g.contiguous(), ctx.group), None


def ulysses_attention(q, k, v, *, axis="cp", causal: bool = True,
                      sm_scale=None, impl: str = "auto"):
    """Ulysses on this rank's sequence part: all-to-all seq -> heads,
    flash attention on the whole sequence for H/cp (and Hkv/cp,
    unrepeated) heads, all-to-all back. cp must divide both local head
    counts."""
    check_impl(impl)
    group = axis_group(axis)
    R = 1 if group is None else group.nranks
    if q.shape[2] % R or k.shape[2] % R:
        raise ValueError(
            f"ulysses needs cp degree {R} to divide local head counts "
            f"H={q.shape[2]}, Hkv={k.shape[2]}")
    if R == 1:
        return flash_attention(q, k, v, causal, sm_scale, impl)
    qg, kg, vg = (_SeqToHeads.apply(x.contiguous(), group)
                  for x in (q, k, v))
    out = flash_attention(qg, kg, vg, causal, sm_scale, impl)
    return _HeadsToSeq.apply(out.contiguous(), group)


def context_parallel_attention(q, k, v, mesh, *, impl: str = "ring",
                               causal: bool = True,
                               sm_scale: Optional[float] = None,
                               attn_impl: str = "auto"):
    """Attention over the cp line of the hybrid ``mesh`` on this rank's
    parts ``[B/dp, T/cp, H/tp, Dh]`` (k / v with Hkv/tp heads); returns
    this rank's output part. ``impl``: ``"ring"``, ``"zigzag"`` (the
    ring on the zigzag layout: the caller lays the sequence out with
    ``zigzag_global_perm``) or ``"ulysses"``; ``attn_impl``: the flash
    kernels' ``impl``."""
    if impl not in CP_KINDS:
        raise ValueError(f"impl must be one of {CP_KINDS}, got {impl!r}")
    group = mesh.group("cp")
    if impl == "ulysses":
        return ulysses_attention(q, k, v, axis=group, causal=causal,
                                 sm_scale=sm_scale, impl=attn_impl)
    return ring_attention(q, k, v, axis=group, causal=causal,
                          sm_scale=sm_scale, impl=attn_impl,
                          layout="zigzag" if impl == "zigzag"
                          else "contiguous")
