"""GPipe over the pipeline ranks, one process a rank.

Port of ``paddle_tpu/parallel/pipeline_spmd.py``. The JAX package runs
the whole pipeline as one traced scan and lets autodiff produce the
reverse pipeline. Here each rank forwards every microbatch through its
stage with autograd (receiving from the rank below, sending to the rank
above), keeps all M graphs (GPipe's O(M) live activations), and the
backward walks the microbatches in reverse order (as the transposed
scan does): the cotangent comes from the rank above (or the loss on
the last rank), back through the kept graph, ``dx`` goes to the rank
below. The gradients are summed in the parameters' dtype, as autodiff
of the scan sums them.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .pipeline_1f1b import _leaves, _map

__all__ = ["microbatch", "stack_stage_params", "pipeline_spmd"]


def stack_stage_params(params_list):
    """Per-stage trees stacked into one tree with a leading stage axis."""
    return _map(lambda *xs: torch.stack(xs), *params_list)


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """``[B, ...] -> [M, B/M, ...]``."""
    B = x.shape[0]
    if B % num_microbatches:
        raise ValueError(f"batch {B} not divisible by {num_microbatches}")
    return x.reshape((num_microbatches, B // num_microbatches)
                     + tuple(x.shape[1:]))


class _GPipe(torch.autograd.Function):
    """This rank's stage over all microbatches; see ``pipeline_spmd``."""

    @staticmethod
    def forward(ctx, run, x, *leaves):
        from .pipeline_1f1b import _Run
        ctx.run = run
        pr: _Run = run.pipe
        p = run.unflatten([q.detach().requires_grad_(q.requires_grad)
                           for q in leaves])
        ctx.p_leaves = _leaves(p)
        ctx.graphs = []
        with torch.enable_grad():
            for m in range(pr.M):
                if pr.first:
                    xm = x[m]
                else:
                    pr.expect(("f", 0, m), pr.r - 1)
                    pr.exchange()
                    xm = pr.inbox.pop(("f", 0, m))
                xm = xm.detach().requires_grad_(True)
                y = run.stage_fn(p, xm)
                ctx.graphs.append((xm, y))
                if not pr.last:
                    pr.send(y.detach(), pr.r + 1, ("f", 0, m))
                    pr.exchange()
        if pr.last:
            return torch.stack([y.detach() for _, y in ctx.graphs])
        return torch.zeros((), dtype=torch.float32, device=pr.dev)

    @staticmethod
    def backward(ctx, ct):
        pr = ctx.run.pipe
        grads: List[Optional[torch.Tensor]] = [None] * len(ctx.p_leaves)
        dxs = [None] * pr.M
        for m in reversed(range(pr.M)):
            xm, y = ctx.graphs.pop()
            if pr.last:
                ct_m = ct[m]
            else:
                pr.expect(("b", 0, m), pr.r + 1)
                pr.exchange()
                ct_m = pr.inbox.pop(("b", 0, m))
            want = [xm] + [q for q in ctx.p_leaves if q.requires_grad]
            outs = iter(torch.autograd.grad(y, want, ct_m.to(y.dtype)))
            dx = next(outs)
            del xm, y
            for i, q in enumerate(ctx.p_leaves):
                if q.requires_grad:
                    g = next(outs)
                    grads[i] = g if grads[i] is None else grads[i] + g
            if pr.first:
                dxs[m] = dx
            else:
                pr.send(dx.to(pr.dt), pr.r - 1, ("b", 0, m))
                pr.exchange()
        dx = torch.stack(dxs) if pr.first else None
        return (None, dx, *grads)


class _GPipeRun:
    def __init__(self, stage_fn, tree, pipe):
        self.stage_fn, self.tree, self.pipe = stage_fn, tree, pipe

    def unflatten(self, leaves):
        it = iter(leaves)
        return _map(lambda _: next(it), self.tree)


def pipeline_spmd(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    num_stages: int,
    mesh,
    remat: bool = True,
):
    """Run ``x``'s microbatches through the ``num_stages`` pipeline
    ranks of ``mesh``'s pp axis, this rank's stage being
    ``stage_fn(stage_params, state)``.

    ``x`` is ``[M, mb, ...]``: the first rank reads its values (and gets
    its gradient back), the others only its shape and dtype (a ``meta``
    tensor will do). ``remat`` checkpoints the whole stage (the JAX
    argument; the Llama stage checkpoints each layer itself and passes
    False).

    Returns, on the last rank, the ``[M, mb, ...]`` outputs; on the
    other ranks a 0-d zero. Both carry this rank's part of the
    backward: ``.backward()`` through them (from the loss on the last
    rank, directly on the others) runs the reverse pipeline, each rank
    at once, and leaves the stage's gradients in ``.grad``.
    """
    from .pipeline_1f1b import _Run
    fn = stage_fn
    if remat:
        fn = lambda p, h: checkpoint(stage_fn, p, h, use_reentrant=False)
    pipe = _Run(mesh, int(num_stages), x, stage_params)
    run = _GPipeRun(fn, stage_params, pipe)
    return _GPipe.apply(run, x if pipe.first else None,
                        *_leaves(stage_params))
