"""Rank bodies of the port's expert-parallel tests, run in processes
started by ``paddle_tpu_torch.distributed.spawn``. This module imports
torch, numpy and the port only, so no rank imports JAX; the tests compare
what the ranks return with the JAX package in the pytest process."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch import prng
from paddle_tpu_torch.incubate import moe as TM
from paddle_tpu_torch.incubate.moe import functional as TF
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ
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


def _meshes(cases):
    """Every case's mesh, made in one order on every rank (each makes the
    process groups of every mesh), so disjoint meshes run at once."""
    return [(c, init_hybrid_mesh(**c[1], set_global=False)) for c in cases]


def _rows(x: np.ndarray, hm) -> torch.Tensor:
    """This rank's dp rows of a global array."""
    n = x.shape[0] // hm.dp_degree
    r = hm.axis_index("dp")
    return torch.from_numpy(x[r * n:(r + 1) * n].copy())


def _experts(x: np.ndarray, hm, dim: int = 0) -> torch.Tensor:
    """This rank's ep shard of a global expert stack."""
    n = x.shape[dim] // hm.ep_degree
    r = hm.axis_index("ep")
    return torch.from_numpy(np.take(x, range(r * n, (r + 1) * n),
                                    axis=dim).copy())


# ---------------------------------------------------------------------------
# tests/test_torch_expert_parallel.py
# ---------------------------------------------------------------------------

def functional_cases(inputs, cases, layer_inputs, layer_cases):
    """``cases``: ``(name, mesh kwargs, capacity_factor)``; ``inputs``:
    global x ``[S, D]``, gate_w, the three expert stacks, the cotangent
    of y, and ``[S, E]`` logits. Per case this rank is in: ``moe_ffn``
    with ``ep_axis="ep"`` on its dp rows and ep shard (y, aux, the
    dropped count, the gradients of ``dp·<y, ct> + aux``: x rows, router,
    its experts), then ``top_k_gating`` of its rows with ``dp_axis`` at
    the same capacity, under the default and the random policy.
    ``layer_cases``: ``(name, mesh kwargs, gate type, key seed)`` for
    ``MoELayer`` (``layer_inputs``: the JAX layers' states by gate type,
    x ``[B, T, D]`` and the cotangent)."""
    _join()
    x, gate_w, wg, wu, wd, ct, logits = inputs
    out = {"cases": {}, "layer": {}}
    S = x.shape[0]
    E, k = gate_w.shape[1], 2
    for (name, _, cf), hm in _meshes(cases):
        if not hm.is_member:
            continue
        dp = hm.dp_degree
        leaves = [_rows(x, hm), torch.from_numpy(gate_w.copy())] + [
            _experts(w, hm) for w in (wg, wu, wd)]
        leaves = [t.requires_grad_() for t in leaves]
        with hm, TF.record_dropped() as drops:
            y, aux = TF.moe_ffn(*leaves, top_k=k, capacity_factor=cf,
                                ep_axis="ep")
        ((y * _rows(ct, hm)).sum() * dp + aux).backward()
        cap = TF.default_capacity(S, E, k, cf)
        gating = {}
        for policy, key in (("all", None), ("random", prng.key(7))):
            d, c, a = TF.top_k_gating(_rows(logits, hm), k, cap, key=key,
                                      second_policy=policy,
                                      dp_axis=hm.group("dp"))
            gating[policy] = (d.numpy(), c.numpy(), float(a))
        out["cases"][name] = {
            "coords": (hm.axis_index("dp"), hm.axis_index("ep")),
            "y": y.detach().numpy(), "aux": float(aux.detach()),
            "dropped": [float(v) for v in drops],
            "grads": [t.grad.numpy() for t in leaves], "gating": gating}
    for (name, _, kind, seed), hm in _meshes(layer_cases):
        if not hm.is_member:
            continue
        states, lx, lct = layer_inputs
        layer = TM.MoELayer(lx.shape[-1], num_expert=wg.shape[0],
                            d_hidden=wg.shape[2], device="cpu",
                            gate={"type": kind, "top_k": 2})
        layer.load_jax_state(states[kind])
        xr = _rows(lx, hm).requires_grad_()
        with hm:
            y = layer(xr, key=None if seed is None else prng.key(seed))
        ((y * _rows(lct, hm)).sum() * hm.dp_degree + layer.l_aux).backward()
        out["layer"][name] = {
            "coords": (hm.axis_index("dp"), hm.axis_index("ep")),
            "y": y.detach().numpy(), "aux": float(layer.l_aux.detach()),
            "dx": xr.grad.numpy(),
            "grads": {n: p.grad.numpy()
                      for n, p in layer.named_parameters()}}
    # refusals: an expert count ep does not divide
    hm = init_hybrid_mesh(ep=4, set_global=False)
    if hm.is_member:
        xs = torch.from_numpy(x[:, :]).float()
        with hm:
            out["uneven"] = _raises(lambda: TF.moe_expert_compute(
                xs, torch.zeros(S, 6, 4), torch.zeros(S, 6, 4),
                *(torch.zeros(6, 2, 2) for _ in range(3)), ep_axis="ep"))
    dist.destroy_process_group()
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_expert_parallel_train.py
# ---------------------------------------------------------------------------

def _replicated(name: str) -> bool:
    return ".experts." not in name


def _local_leaves(params) -> dict:
    """``{name: numpy}`` of a trainer's rank-local params."""
    out = {k: params[k].detach().numpy()
           for k in ("embed", "final_norm", "lm_head")}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            if isinstance(v, dict):
                for kk, vv in v.items():
                    out[f"layers.{i}.{k}.{kk}"] = vv.detach().numpy()
            else:
                out[f"layers.{i}.{k}"] = v.detach().numpy()
    return out


def train_cases(np_params, np_batch, cases, steps):
    """``cases``: ``(name, mesh kwargs, Qwen2MoeConfig kwargs)``. Per case
    this rank is in: ``forward``'s logits and aux and ``loss_fn``'s value
    at the initial params (its dp rows, its vocab shard), the dropped
    counts of that forward, ``steps`` steps of ``make_train_step``, the
    gathered params (the mesh's first rank) and this rank's local leaves
    (for the bitwise check across ep peers). Then ``fleet.init`` with
    ep_degree 2 trains, and the refusals."""
    rank = _join()
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    out = {"rank": rank, "cases": {}}
    for (name, _, kw), hm in _meshes(cases):
        if not hm.is_member:
            continue
        cfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32, **kw)
        step, init = TQ.make_train_step(cfg, mesh=hm, device="cpu")
        state = init(TQ.params_from_jax(np_params, device="cpu"))
        rows = {k: _rows(v, hm) for k, v in np_batch.items()}
        with torch.no_grad(), TF.record_dropped() as drops:
            logits, aux = TQ.forward(state["params"], rows["tokens"], cfg,
                                     mesh=hm)
            value = TQ.loss_fn(state["params"], rows, cfg, mesh=hm)
        # the step's gradient: the rank's loss backward, averaged over dp
        TQ.loss_fn(state["params"], rows, cfg, mesh=hm).backward()
        grads = TL._tree_map(lambda p: p.grad, state["params"])
        for g in TL._tree_leaves(grads):
            dist.all_reduce(g, dist.ReduceOp.AVG, hm.group("dp"))
        grads = TQ.gather_params(grads, cfg, hm)
        for p in TL._tree_leaves(state["params"]):
            p.grad = None
        rec = {"coords": dict(dp=hm.axis_index("dp"),
                              ep=hm.axis_index("ep"),
                              tp=hm.axis_index("tp")),
               "logits": logits.numpy(), "aux": float(aux),
               "loss_fn": float(value),
               "dropped": [float(v) for v in drops[:cfg.num_hidden_layers]]}
        dist.reset_collective_stats()
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        rec["stats"] = dist.collective_stats()
        rec["losses"] = losses
        rec["local"] = _local_leaves(state["params"])
        params = TQ.gather_params(state, cfg, hm)
        if hm.coords == (0,) * len(hm.coords):
            rec["params"], rec["grads"] = params, grads
        out["cases"][name] = rec
    out["fleet"] = _fleet(batch, steps)
    out.update(_refusals(np_params, batch))
    dist.destroy_process_group()
    return out


def _fleet(batch, steps):
    """``fleet.init`` with ep_degree 2 over the world (dp the rest): a
    Qwen2-MoE step from a seeded init that trains."""
    from paddle_tpu_torch.distributed import fleet
    strategy = fleet.DistributedStrategy()
    n = dist.get_world_size()
    strategy.hybrid_configs = {"dp_degree": n // 2, "ep_degree": 2}
    hm = fleet.init(is_collective=True, strategy=strategy, device="cpu")
    cfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32)
    step, init = TQ.make_train_step(cfg, mesh=hm, device="cpu")
    state = init(torch.Generator().manual_seed(0))
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return {"shape": dict(hm.shape), "losses": losses}


def _refusals(np_params, batch):
    out = {}
    cfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32)
    for name, shape, kw in (
            ("pp", dict(pp=2), {}), ("cp", dict(cp=2), {}),
            ("uneven_experts", dict(ep=8), {}),
            ("uneven_ffn", dict(tp=2), {"moe_intermediate_size": 33}),
            ("dropless_kernel", dict(dp=2),
             {"moe_impl": "dropless", "use_grouped_matmul": "kernel"})):
        hm = init_hybrid_mesh(**shape, set_global=False)
        if hm.is_member:
            c = dataclasses.replace(cfg, **kw)
            out[name] = _raises(lambda: TQ.make_train_step(c, mesh=hm,
                                                           device="cpu"))
    # dropless on a sharded mesh runs the einsum path, as JAX's rule says
    hm = init_hybrid_mesh(dp=2, set_global=False)
    if hm.is_member:
        rows = {k: v[hm.axis_index("dp") * 2:][:2] for k, v in batch.items()}
        params = TQ.shard_params(TQ.params_from_jax(np_params, device="cpu"),
                                 cfg, hm)
        with torch.no_grad():
            out["dropless_on_dp"] = [float(TQ.loss_fn(
                params, rows, TQ.Qwen2MoeConfig.tiny(dtype=torch.float32,
                                                     moe_impl=m), mesh=hm))
                for m in ("einsum", "dropless")]
    return out
