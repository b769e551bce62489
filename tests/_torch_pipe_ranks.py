"""Rank bodies of the port's pipeline tests, run in processes started by
``paddle_tpu_torch.distributed.spawn``. This module imports torch, numpy
and the port only, so no rank imports JAX; the tests compare what the
ranks return with the JAX package in the pytest process."""
from __future__ import annotations

import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import init_hybrid_mesh

#: the JAX pipeline tests' geometry is ``LlamaConfig.tiny`` at T 16
BASE = dict(dtype=torch.float32)


def _join(fleet_pp: int = 0):
    torch.set_num_threads(1)
    if fleet_pp:
        # join through fleet.init, whose pp_degree builds the global mesh
        from paddle_tpu_torch.distributed import fleet
        s = fleet.DistributedStrategy()
        s.hybrid_configs = {"dp_degree": 2, "pp_degree": fleet_pp,
                            "mp_degree": 2}
        mesh = fleet.init(is_collective=True, strategy=s, device="cpu")
        return dist.get_rank(), mesh
    dist.init_parallel_env(device="cpu")
    return dist.get_rank(), None


def _cfg(pp, kw, dtype=None):
    base = dict(BASE, **({"dtype": dtype} if dtype is not None else {}))
    return TL.LlamaConfig.tiny(pp_stages=pp, **base, **kw)


def _p2p(stats) -> dict:
    return {k: stats.get(k, {"calls": 0, "bytes": 0}) for k in ("send",
                                                              "recv")}


def _grads(cfg, hm, np_params, batch):
    """``(loss, grads)`` of this rank's params: ``grads_1f1b`` for the
    fused schedules, GPipe's ``loss_fn`` backward otherwise (dp 1)."""
    params = TL.shard_params(TL.params_from_jax(np_params, device="cpu"),
                             cfg, hm)
    if cfg.pp_schedule != "gpipe":
        loss, g = TL.grads_1f1b(params, batch, cfg, hm)
        return float(loss), g
    leaves = TL._train_params(params, "cpu")
    value = TL.loss_fn(leaves, TL._pipe_rows(batch, cfg, hm), cfg, hm)
    value.backward()
    loss = value.detach().float().clone()
    dist.all_reduce(loss, group=hm.group("pp"))
    return float(loss), TL._tree_map(lambda p: p.grad, leaves)


def _meshes(cases):
    """Every case's mesh, made by every rank in the same order before any
    case runs (a case's ``first`` rank offsets its ranks), so cases on
    disjoint ranks run at the same time."""
    return [init_hybrid_mesh(dp=dp, pp=pp, tp=tp, set_global=False,
                             ranks=range(first, first + dp * pp * tp))
            for _, dp, pp, tp, *_, first in cases]


def grad_cases(np_params, np_batches, cases):
    """``cases``: ``(name, dp, pp, tp, cfg kwargs, batch key, first
    rank)``. Per case this rank is in: the loss, its p2p counters, and
    (the case's first rank) the gathered gradients."""
    rank, _ = _join()
    out = {"rank": rank, "cases": {}}
    for (name, dp, pp, tp, kw, bkey, first), hm in zip(cases,
                                                       _meshes(cases)):
        if not hm.is_member:
            continue
        cfg = _cfg(pp, kw)
        batch = {k: torch.from_numpy(v.copy())
                 for k, v in np_batches[bkey].items()}
        dist.reset_collective_stats()
        loss, g = _grads(cfg, hm, np_params, batch)
        rec = {"loss": loss, "p2p": _p2p(dist.collective_stats()),
               "pp": hm.axis_index("pp")}
        g = TL.gather_params(g, cfg, hm)
        if rank == first:
            rec["grads"] = g
        out["cases"][name] = rec
    out["bf16"] = _bf16_pin(np_params, np_batches["pp2_m4"])
    dist.destroy_process_group()
    return out


def _bf16_pin(np_params, np_batch):
    """zb at pp 2, M 4 in bf16: the schedule's sums are f32, the p2p
    messages bf16, and each returned gradient is its f32 sum scaled and
    cast once."""
    from paddle_tpu_torch.distributed import communication as C
    hm = init_hybrid_mesh(pp=2, set_global=False)
    if not hm.is_member:
        return None
    cfg = _cfg(2, dict(pp_schedule="zb", num_microbatches=4),
               dtype=torch.bfloat16)
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    bf16 = TL._tree_map(lambda t: t.to(torch.bfloat16),
                        TL.params_from_jax(np_params, device="cpu"))
    params = TL.shard_params(bf16, cfg, hm)
    leaves = TL._train_params(params, "cpu")
    rows = TL._pipe_rows(batch, cfg, hm)
    C.reset_collective_stats()
    _, sums = TL._pipe_grads(leaves, rows, cfg, hm)
    p2p = _p2p(C.collective_stats())
    _, grads = TL.grads_1f1b(params, batch, cfg, hm)
    inv = 1.0 / cfg.num_microbatches
    return {"sum_dtypes": sorted({str(s.dtype) for s in sums}),
            "grad_dtypes": sorted({str(g.dtype)
                                   for g in TL._tree_leaves(grads)}),
            "cast_once": all(torch.equal(g, (s * inv).to(torch.bfloat16))
                             for g, s in zip(TL._tree_leaves(grads), sums)),
            "p2p": p2p}


def train_cases(np_params, np_batches, cases, steps, grad_case=None):
    """``cases``: ``(name, dp, pp, tp, zero_stage, cfg kwargs, batch
    key, first rank)``; each trains ``steps`` steps of
    ``make_train_step(mesh=...)``. Per case: losses, p2p counters, bytes
    at rest and (the case's first rank) the gathered params.
    ``grad_case`` ``(cfg kwargs, batch key)``: the gradients of a zb
    step on the dp 2 x pp 2 x tp 2 mesh ``fleet.init`` builds from its
    ``pp_degree`` (the world joins through it)."""
    rank, mesh = _join(fleet_pp=2 if grad_case else 0)
    out = {"rank": rank, "cases": {}}
    for (name, dp, pp, tp, stage, kw, bkey, first), hm in zip(
            cases, _meshes(cases)):
        if not hm.is_member:
            continue
        cfg = _cfg(pp, kw)
        batch = {k: torch.from_numpy(v.copy())
                 for k, v in np_batches[bkey].items()}
        step, init = TL.make_train_step(cfg, mesh=hm, zero_stage=stage,
                                        device="cpu")
        state = init(TL.params_from_jax(np_params, device="cpu"))
        rec = {"moment_bytes": sum(t.numel() * t.element_size() for t in
                                   TL._tree_leaves([state["opt"]["mu"],
                                                    state["opt"]["nu"]])),
               "param_bytes": sum(t.numel() * t.element_size() for t in
                                  TL._tree_leaves(state["params"]))}
        dist.reset_collective_stats()
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        stats = dist.collective_stats()
        rec.update(losses=losses, p2p=_p2p(stats), pp=hm.axis_index("pp"),
                   all_reduce=stats.get("all_reduce",
                                        {"calls": 0, "bytes": 0}))
        params = TL.gather_params(state, cfg, hm)
        if rank == first:
            rec["params"] = params
        out["cases"][name] = rec
    if grad_case is None:
        dist.destroy_process_group()
        return out
    out["fleet_shape"] = dict(mesh.shape)
    kw, bkey = grad_case
    cfg = _cfg(2, kw)
    batch = {k: torch.from_numpy(v.copy())
             for k, v in np_batches[bkey].items()}
    loss, g = _grads(cfg, mesh, np_params, batch)
    g = TL.gather_params(g, cfg, mesh)
    out["fleet_3d"] = {"loss": loss, "grads": g if rank == 0 else None}
    dist.destroy_process_group()
    return out
