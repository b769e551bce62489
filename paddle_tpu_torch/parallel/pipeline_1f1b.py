"""1F1B and interleaved (VPP) pipeline schedules, lockstep form, one
process a rank.

Port of ``paddle_tpu/parallel/pipeline_1f1b.py``. The JAX module runs
the whole schedule as one traced scan in which every slot computes
every tick (masked work at fill and drain). Here each rank is a
process that holds its own slots (chunks ``v·S + s`` of a ``[V·S]``
chunk-major partition, ``split_chunks_round_robin``) and walks the
same ticks: slot ``k`` forwards microbatch ``t - k``, the loss head
runs on microbatch ``t - (K - 1)`` as it leaves the last slot
(``K = S·V``), and slot ``k`` back-props microbatch ``t - (2K - 1) +
k``. A slot whose microbatch is out of range is skipped rather than
computed, and sends nothing. Each tick ends with one ``exchange`` of
the messages the ranks' slots send to their neighbours.

The per-op math is shared with ``pipeline_async`` (this module's
``_forward``, ``_backward``, ``_head``):

* F runs the stage without autograd and keeps only its input;
* B re-runs the stage forward with autograd from that input and
  back-props the cotangent (the JAX package's ``jax.vjp`` in B; with
  ``cfg.remat`` the stage function checkpoints each layer, so its
  recompute runs as well);
* the head's loss and its gradients are taken per microbatch as it
  leaves the last slot.

Gradients are summed in f32 per chunk in microbatch order, the order
the JAX docstring states, so this executor and ``pipeline_async``'s
``1f1b`` variant give the same bits. ``dx`` (the cotangent of the
stage-0 input) is what the embedding's backward takes.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

__all__ = ["pipeline_train_1f1b", "schedule_ticks", "schedule_efficiency",
           "split_chunks_round_robin"]


def schedule_ticks(num_stages: int, num_microbatches: int,
                   virtual_chunks: int = 1,
                   schedule: str = "lockstep") -> int:
    """Ticks of a schedule: ``"lockstep"`` (this module) ``M + 2·S·V -
    1``; ``"1f1b"`` / ``"zb"`` (``pipeline_async``) the validated
    builder's count (``2·(V·M + S - 1)`` for 1f1b, ``3·M + S - 1`` for
    zb at M >= S)."""
    S = int(num_stages) * int(virtual_chunks)
    M = int(num_microbatches)
    if schedule == "lockstep":
        return M + 2 * S - 1
    from .pipeline_async import build_schedule
    return build_schedule(int(num_stages), M, int(virtual_chunks),
                          schedule).ticks


def schedule_efficiency(num_stages: int, num_microbatches: int,
                        virtual_chunks: int = 1,
                        schedule: str = "lockstep") -> float:
    """Useful-work fraction of a schedule, the JAX package's model:
    lockstep ``M / (M + 2S - 1)``; rank-asymmetric 1f1b ``VM / (VM + S -
    1)`` (the builder must accept the geometry); zb ``3VM / ticks``."""
    S, M = int(num_stages), int(num_microbatches)
    V = int(virtual_chunks)
    if S < 1 or M < 1:
        raise ValueError("num_stages and num_microbatches must be >= 1")
    if schedule == "lockstep":
        return M / (M + 2 * S - 1)
    if schedule == "1f1b":
        from .pipeline_async import build_schedule
        build_schedule(S, M, V, "1f1b")
        return V * M / (V * M + S - 1)
    if schedule == "zb":
        ticks = schedule_ticks(S, M, V, schedule="zb")
        return 3 * V * M / ticks
    raise ValueError(f"schedule must be 'lockstep', '1f1b' or 'zb', "
                     f"got {schedule!r}")


def split_chunks_round_robin(layer_params, num_layers: int,
                             num_stages: int, virtual_chunks: int = 1):
    """Layers -> ``V·S`` chunks in chunk-major order (chunk ``k = v·S +
    s`` holds layers ``[k·L/(VS), (k+1)·L/(VS))`` and sits on rank
    ``s``): stacked ``[L, ...]`` tensors (a dict of them) become ``[V·S,
    L/(VS), ...]`` views; a list of per-layer weights becomes a list of
    ``V·S`` lists."""
    VS = num_stages * virtual_chunks
    if num_layers % VS:
        raise ValueError(f"layers {num_layers} not divisible by "
                         f"stages*chunks {VS}")
    n = num_layers // VS
    if isinstance(layer_params, (list, tuple)):
        return [list(layer_params[k * n:(k + 1) * n]) for k in range(VS)]
    return _map(lambda p: p.reshape((VS, n) + tuple(p.shape[1:])),
                layer_params)


# ---------------------------------------------------------------------------
# trees and the per-op math shared with pipeline_async
# ---------------------------------------------------------------------------

def _map(fn, *trees):
    a = trees[0]
    if isinstance(a, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, (list, tuple)):
        return [_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _zeros_f32(tree):
    return _map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), tree)


def _add_f32(acc, grads) -> None:
    """``acc += grads`` leaf by leaf, each gradient widened to f32."""
    for a, g in zip(_leaves(acc), grads):
        a.add_(g.float())


def _forward(stage_fn, p, x, dt) -> torch.Tensor:
    """F: the stage without autograd (only its input is kept)."""
    with torch.no_grad():
        return stage_fn(p, x).to(dt)


def _backward(stage_fn, p, x, ct, dt, *, want_dp: bool = True,
              keep: bool = False):
    """B: the stage forward again with autograd from ``x``, then the
    cotangent ``ct`` back through it. Returns ``(dx, dps, kept)``:
    ``dps`` the leaves' gradients (None when not ``want_dp``), ``kept``
    the output whose graph stays alive for a later ``_weight_grads``
    (zb's W) when ``keep``."""
    with torch.enable_grad():
        xi = x.detach().requires_grad_(True)
        y = stage_fn(p, xi)
        ct = ct.to(y.dtype)
        if want_dp:
            outs = torch.autograd.grad(y, [xi] + _leaves(p), ct)
            return outs[0].to(dt), list(outs[1:]), None
        (dx,) = torch.autograd.grad(y, [xi], ct, retain_graph=keep)
    return dx.to(dt), None, ((y, ct) if keep else None)


def _weight_grads(p, kept) -> List[torch.Tensor]:
    """W: the leaves' gradients from B's kept graph (no forward)."""
    y, ct = kept
    return list(torch.autograd.grad(y, _leaves(p), ct))


def _head(head_fn, hp, y, aux_m, dt):
    """The loss head on one microbatch: ``(loss, dy, dhp)``."""
    with torch.enable_grad():
        yi = y.detach().requires_grad_(True)
        loss = head_fn(hp, yi, aux_m)
        outs = torch.autograd.grad(loss, [yi] + _leaves(hp))
    return loss.detach(), outs[0].to(dt), list(outs[1:])


class _Run:
    """What one executor call shares between its ticks: this rank's
    place on the pipeline, the activation shape and the messages of the
    current tick (``send`` / ``expect``, posted together by
    ``exchange``; a message to this rank itself lands at once)."""

    def __init__(self, mesh, S: int, x, stage_params):
        from ..distributed import communication as C
        self.C = C
        self.S = S
        if mesh is None or mesh.pp_degree != S:
            raise ValueError(
                f"the pipeline needs a mesh whose pp axis is "
                f"num_stages={S}, got {mesh!r}")
        self.mesh = mesh
        self.r = mesh.axis_index("pp")
        self.g = mesh.group("pp")
        self.M = int(x.shape[0])
        self.mb_shape = tuple(x.shape[1:])
        self.dt = x.dtype
        self.dev = _leaves(stage_params)[0].device
        self.first, self.last = self.r == 0, self.r == S - 1
        self.sends: List[Tuple[torch.Tensor, int, int]] = []
        self.recvs: List[Tuple[Any, int, int]] = []
        self.inbox: Dict[Any, torch.Tensor] = {}

    def peer(self, s: int) -> int:
        return self.g.ranks[s % self.S]

    def send(self, t: torch.Tensor, to_stage: int, key) -> None:
        if to_stage % self.S == self.r:
            self.inbox[key] = t
        else:
            self.sends.append((t, self.peer(to_stage), _tag(key)))

    def expect(self, key, from_stage: int) -> None:
        if from_stage % self.S != self.r:
            self.recvs.append((key, self.peer(from_stage), _tag(key)))

    def exchange(self) -> None:
        if not self.sends and not self.recvs:
            return
        bufs = [(torch.empty(self.mb_shape, dtype=self.dt, device=self.dev),
                 key, peer, tag) for key, peer, tag in self.recvs]
        self.C.exchange(self.sends, [(b, peer, tag)
                                     for b, _, peer, tag in bufs], self.g)
        for b, key, _, _ in bufs:
            self.inbox[key] = b
        self.sends, self.recvs = [], []

    def loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss summed over pp (only the last rank's is non-zero) and
        dp, scaled by ``1 / (M·dp)``: the global mean, on every rank."""
        C, mesh = self.C, self.mesh
        C.all_reduce(loss, C.ReduceOp.SUM, self.g)
        if mesh.dp_degree > 1:
            C.all_reduce(loss, C.ReduceOp.SUM, mesh.group("dp"))
        return loss * (1.0 / (self.M * mesh.dp_degree))


def _tag(key) -> int:
    """A message's tag from its key ``(kind, chunk or slot, m)``: one a
    destination slot and direction, so two messages between the same
    ranks in one tick cannot cross."""
    kind, k, _ = key
    return 2 * int(k) + (0 if kind == "f" else 1)


def pipeline_train_1f1b(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    head_fn: Callable[[Any, torch.Tensor, Any], torch.Tensor],
    stage_params: List[Any],
    head_params: Any,
    x: torch.Tensor,
    aux: Any,
    *,
    num_stages: int,
    virtual_chunks: int = 1,
    mesh,
):
    """One fused forward + backward under the lockstep 1F1B schedule,
    on this rank's part of the pipeline.

    Args:
      stage_fn: ``(chunk_params, x_mb) -> y_mb`` for one chunk.
      head_fn: ``(head_params, y_mb, aux_mb) -> scalar`` loss of one
        microbatch.
      stage_params: this rank's ``V`` chunks, ``[chunk v·S + s for v]``
        (each a tree of tensors, the leaves gradients are taken for).
      head_params: the loss head's tree (read on the last rank).
      x: ``[M, mb, ...]`` stage-0 inputs; only the first rank reads its
        values, the others take its shape and dtype (a ``meta`` tensor
        will do).
      aux: ``[M, ...]`` per-microbatch extras (labels), read on the last
        rank.
      mesh: the ``HybridMesh``; its pp axis is the pipeline.

    Returns ``(loss, grads_stage, grads_head, dx)``, the JAX executor's
    tuple before its dp reduction: the loss the mean over microbatches
    and dp rows (on every rank); the chunks' and the head's gradients
    (None off the last rank) as this rank's f32 sums over its
    microbatches, in microbatch order; ``dx`` ``[M, mb, ...]`` on the
    first rank (None elsewhere), unscaled. The caller reduces the sums
    over dp once, scales them by ``1/(M·dp)`` and casts them
    (``models.llama.grads_1f1b``; the trainer reduce-scatters them at
    ZeRO 2-3).
    """
    S, V = int(num_stages), int(virtual_chunks)
    run = _Run(mesh, S, x, stage_params)
    M, r, dt, K = run.M, run.r, run.dt, S * V
    if len(stage_params) != V:
        raise ValueError(f"need this rank's {V} chunks, got "
                         f"{len(stage_params)}")
    gacc = [_zeros_f32(p) for p in stage_params]
    ghead = _zeros_f32(head_params) if run.last else None
    loss = torch.zeros((), dtype=torch.float32, device=run.dev)
    dxbuf = [None] * M if run.first else None
    saved: Dict[Tuple[int, int], torch.Tensor] = {}
    for t in range(M + 2 * K - 1):
        for v in range(V):                      # forwards (and the head)
            k, p = v * S + r, stage_params[v]
            m = t - k
            if not 0 <= m < M:
                continue
            xin = x[m] if k == 0 else run.inbox.pop(("f", k, m))
            saved[(k, m)] = xin
            y = _forward(stage_fn, p, xin, dt)
            if k == K - 1:
                lm, dy, dh = _head(head_fn, head_params, y, aux[m], dt)
                loss += lm.float()
                _add_f32(ghead, dh)
                run.inbox[("b", k, m)] = dy
            else:
                run.send(y, r + 1, ("f", k + 1, m))
        for v in range(V):                      # backwards
            k, p = v * S + r, stage_params[v]
            m = t - (2 * K - 1) + k
            if not 0 <= m < M:
                continue
            dx, dps, _ = _backward(stage_fn, p, saved.pop((k, m)),
                                   run.inbox.pop(("b", k, m)), dt)
            _add_f32(gacc[v], dps)
            if k == 0:
                dxbuf[m] = dx
            else:
                run.send(dx, r - 1, ("b", k - 1, m))
        for v in range(V):                      # next tick's arrivals
            k = v * S + r
            if k > 0 and 0 <= t + 1 - k < M:
                run.expect(("f", k, t + 1 - k), r - 1)
            mb = t + 1 - (2 * K - 1) + k
            if k < K - 1 and 0 <= mb < M:
                run.expect(("b", k, mb), r + 1)
        run.exchange()
    dx = torch.stack(dxbuf) if run.first else None
    return run.loss(loss), gacc, ghead, dx
