"""Rank bodies of the port's context-parallel tests, run in processes
started by ``paddle_tpu_torch.distributed.spawn``. This module imports
torch, numpy and the port only, so no rank imports JAX; the tests compare
what the ranks return with the JAX package in the pytest process."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import context_parallel as CP
from paddle_tpu_torch.parallel import init_hybrid_mesh


def _join():
    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    return dist.get_rank()


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:      # the test reads the type and message
        return f"{type(e).__name__}: {e}"
    return "no exception"


def _part(x: np.ndarray, hm, heads: bool = True) -> torch.Tensor:
    """This rank's part ``[B, T/cp, H/tp, D]`` of a global array."""
    cp, tp = hm.cp_degree, hm.tp_degree
    T, H = x.shape[1] // cp, x.shape[2] // tp
    i, j = hm.axis_index("cp"), hm.axis_index("tp")
    return torch.from_numpy(
        x[:, i * T:(i + 1) * T, j * H:(j + 1) * H].copy())


# ---------------------------------------------------------------------------
# tests/test_torch_context_parallel.py
# ---------------------------------------------------------------------------

def attention_cases(inputs, cases):
    """``cases``: ``(name, mesh kwargs, fn, kind, causal)`` with ``fn``
    ``"entry"`` (``context_parallel_attention``, ``impl="auto"``) or
    ``"flash"`` (``ring_attention`` itself with ``impl="reference"``);
    on CPU tensors both run the ring over the flash kernels' plain
    counterparts. ``inputs[name]``: global q, k, v, do (zigzag cases
    already laid out). Returns, per case this rank is in, its coords and
    its parts of o, dq, dk, dv and the collective counters; ``flash``
    cases also run twice (``bitwise``)."""
    _join()
    meshes = [(c, init_hybrid_mesh(**c[1], set_global=False))
              for c in cases]
    out = {"cases": {}}
    for (name, _, fn, kind, causal), hm in meshes:
        if not hm.is_member:
            continue
        q, k, v, do = (_part(x, hm) for x in inputs[name])
        leaves = [t.requires_grad_() for t in (q, k, v)]

        def run():
            if fn == "entry":
                return CP.context_parallel_attention(
                    *leaves, hm, impl=kind, causal=causal)
            return CP.ring_attention(
                *leaves, axis=hm.group("cp"), causal=causal,
                layout="zigzag" if kind == "zigzag" else "contiguous",
                impl="reference")

        dist.reset_collective_stats()
        o = run()
        grads = torch.autograd.grad(o, leaves, do)
        rec = {"coords": (hm.axis_index("cp"), hm.axis_index("tp")),
               "o": o.detach().numpy(),
               "grads": [g.numpy() for g in grads],
               "stats": dist.collective_stats()}
        if fn == "flash":
            o2 = run()
            g2 = torch.autograd.grad(o2, leaves, do)
            rec["bitwise"] = torch.equal(o, o2) and all(
                torch.equal(a, b) for a, b in zip(grads, g2))
        out["cases"][name] = rec
    hm = init_hybrid_mesh(cp=4, set_global=False)
    q, k, v, _ = (_part(x, hm) for x in inputs[cases[0][0]])
    # cp 4 does not divide 2 kv heads; an odd part under zigzag
    out["ulysses_heads"] = _raises(lambda: CP.ulysses_attention(
        q, k[:, :, :2], v[:, :, :2], axis=hm.group("cp")))
    out["zigzag_odd"] = _raises(lambda: CP.ring_attention(
        q[:, :-1], k[:, :-1], v[:, :-1], axis=hm.group("cp"),
        layout="zigzag"))
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_context_parallel_train.py
# ---------------------------------------------------------------------------

def _record_rope(rec: list):
    """Wrap the fused rope entries llama calls to record the positions
    they are given."""
    from paddle_tpu_torch.ops.kernels import fused_norm_rope as NR
    plain, sharded = TL.fused_rope, NR.fused_rope_sharded

    def one(q, k, positions, *a, **kw):
        rec.append(positions.detach().clone())
        return plain(q, k, positions, *a, **kw)

    def shard(q, k, positions, *a, **kw):
        rec.append(positions.detach().clone())
        return sharded(q, k, positions, *a, **kw)
    TL.fused_rope, NR.fused_rope_sharded = one, shard
    return lambda: (setattr(TL, "fused_rope", plain),
                    setattr(NR, "fused_rope_sharded", sharded))


def _cfg(kw):
    return TL.LlamaConfig.tiny(dtype=torch.float32, **kw)


def _logits(params, batch, cfg, hm):
    """``forward``'s logits of this rank's part, all-gathered over cp
    and tp into the global ``[B/dp, T, V]`` (in the layout's order)."""
    from paddle_tpu_torch.distributed.communication import all_gather_cat
    with torch.no_grad():
        x = TL.forward(params, batch["tokens"], cfg, hm)
        if hm.tp_degree > 1:
            x = all_gather_cat(x.contiguous(), 2, hm.group("tp"))
        if hm.cp_degree > 1:
            x = all_gather_cat(x.contiguous(), 1, hm.group("cp"))
    return x.numpy()


def train_cases(np_params, np_batch, cases, steps, extras=True):
    """``cases``: ``(name, mesh kwargs, zero_stage, LlamaConfig
    kwargs)``. Each case (meshes made first, so disjoint ones run at
    once) records ``forward``'s gathered logits and ``loss_fn`` on this
    rank's dp rows before training, then ``steps`` steps of
    ``make_train_step``: losses, the gathered params (rank 0), the
    positions the rope saw in the first step, the collective counters.
    With ``extras``: ``fleet.init(sep_degree=2)`` training, and the
    refusals."""
    rank = _join()
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    out = {"rank": rank, "cases": {}}
    meshes = [(c, init_hybrid_mesh(**c[1], set_global=False))
              for c in cases]
    for (name, shape, stage, kw), hm in meshes:
        if not hm.is_member:
            continue
        cfg = _cfg(kw)
        rec = {"coords": {a: hm.axis_index(a) for a in hm.axis_names}}
        params = TL.shard_params(TL.params_from_jax(np_params, device="cpu"),
                                 cfg, hm)
        n = batch["tokens"].shape[0] // hm.dp_degree
        r = hm.axis_index("dp")
        mine = {k: v[r * n:(r + 1) * n] for k, v in batch.items()}
        rec["logits"] = _logits(params, mine, cfg, hm)
        with torch.no_grad():
            rec["loss_fn"] = float(TL.loss_fn(params, mine, cfg, hm))
        del params
        step, init = TL.make_train_step(cfg, mesh=hm, zero_stage=stage,
                                        device="cpu")
        state = init(TL.params_from_jax(np_params, device="cpu"))
        seen = []
        undo = _record_rope(seen)
        dist.reset_collective_stats()
        losses = []
        try:
            for i in range(steps):
                state, loss = step(state, batch)
                losses.append(float(loss))
                if i == 0:
                    rec["positions"] = [p.numpy() for p in seen]
        finally:
            undo()
        rec["stats"] = dist.collective_stats()
        rec["losses"] = losses
        params = TL.gather_params(state, cfg, hm)
        if rank == 0:
            rec["params"] = params
        out["cases"][name] = rec
    if extras:
        out["fleet"] = _fleet(np_params, batch, steps)
        out.update(_refusals(np_params, batch))
    dist.destroy_process_group()
    return out


def _fleet(np_params, batch, steps):
    """``fleet.init`` with sep_degree 2 and dp_degree 2: the step on the
    mesh it builds (zigzag, ZeRO 1)."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 1,
                               "pp_degree": 1, "sep_degree": 2}
    hm = fleet.init(is_collective=True, strategy=strategy, device="cpu")
    cfg = _cfg({"context_parallel": "zigzag"})
    step, init = TL.make_train_step(cfg, mesh=hm, zero_stage=1, device="cpu")
    state = init(TL.params_from_jax(np_params, device="cpu"))
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return {"degrees": (hm.dp_degree, hm.cp_degree, hm.tp_degree),
            "losses": losses}


def _refusals(np_params, batch):
    """cp with a pipeline, an ep axis, a cp axis with no
    ``context_parallel``, Ulysses whose cp does not divide the heads."""
    out = {}
    hm = init_hybrid_mesh(pp=2, cp=2, set_global=False)
    cfg = _cfg({"context_parallel": "ring", "pp_stages": 2})
    out["pp"] = _raises(lambda: TL.make_train_step(cfg, mesh=hm,
                                                   device="cpu"))
    hm = init_hybrid_mesh(ep=2, set_global=False)
    out["ep"] = _raises(lambda: TL.make_train_step(_cfg({}), mesh=hm,
                                                   device="cpu"))
    hm = init_hybrid_mesh(cp=2, set_global=False)
    out["none"] = _raises(lambda: TL.make_train_step(_cfg({}), mesh=hm,
                                                     device="cpu"))
    hm = init_hybrid_mesh(cp=4, set_global=False)
    cfg = _cfg({"context_parallel": "ulysses"})
    step, init = TL.make_train_step(cfg, mesh=hm, device="cpu")
    state = init(TL.params_from_jax(np_params, device="cpu"))
    out["ulysses_heads"] = _raises(lambda: step(state, batch))
    return out
