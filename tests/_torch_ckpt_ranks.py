"""Rank bodies of ``tests/test_torch_checkpoint_dist.py``, run in processes
started by ``paddle_tpu_torch.distributed.spawn``. This module imports
torch, numpy and the port only, so no rank imports JAX; the test compares
what the ranks return with the JAX package in the pytest process."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.distributed import checkpoint as C
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.models import qwen2_moe as TQ
from paddle_tpu_torch.parallel import init_hybrid_mesh

KV_HEADS = 4      # so that the tp 4 target divides them
# (name, model, mesh, ZeRO stage, config kwargs): each trains 4 steps,
# saving after step 2 (async) while step 3 updates in place, and resumes
# from that checkpoint into a state drawn from other weights
CASES = (
    ("z1", "llama", dict(dp=2, tp=2), 1, {}),
    ("z3", "llama", dict(dp=2, tp=2), 3, {}),
    ("pp", "llama", dict(dp=2, pp=2), 0,
     dict(pp_stages=2, pp_schedule="1f1b", num_microbatches=2)),
    ("qwen", "qwen", dict(dp=2, ep=2), 0, {}),
)
# the targets z1's checkpoint loads into: (name, mesh, ZeRO stage)
RESHARD = (("tp4", dict(tp=4), 0), ("dp4_z3", dict(dp=4), 3))


def _llama_cfg(**kw):
    return dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32,
                                                   **kw),
                               num_key_value_heads=KV_HEADS)


def _trainer(model, hm, stage, kw, np_params):
    if model == "qwen":
        cfg = TQ.Qwen2MoeConfig.tiny(dtype=torch.float32, **kw)
        step, init = TQ.make_train_step(cfg, mesh=hm, device="cpu")
        gather, layout = TQ.gather_params, TQ.checkpoint_layout
    else:
        cfg = _llama_cfg(**kw)
        step, init = TL.make_train_step(cfg, mesh=hm, zero_stage=stage,
                                        device="cpu")
        gather, layout = TL.gather_params, TL.checkpoint_layout
    source = (TL.params_from_jax(np_params, device="cpu")
              if np_params is not None else torch.Generator().manual_seed(7))
    state = init(source)
    # a copy: on the CPU a replicated leaf's numpy shares the live tensor
    return (step, state,
            lambda st: TL._tree_map(np.copy, gather(st, cfg, hm)),
            lambda st: layout(st, cfg, hm))


def _batch(np_batch):
    return {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}


def _case(case, hm, params, batches, root):
    name, model, _, stage, kw = case
    step, state, gather, layout = _trainer(model, hm, stage, kw, params)
    losses, saved = [], None
    for s in range(4):
        state, loss = step(state, _batch(batches[s]))
        losses.append(float(loss))
        if s == 1:
            ck = C.save_checkpoint(state, root, 2, keep=1, async_save=True,
                                   layout=layout(state))
            saved = gather(state)
    ck.wait_until_finished()
    final = gather(state)
    del state
    # resume into a state drawn from other weights
    step, fresh, gather, layout = _trainer(model, hm, stage, kw, None)
    at = C.load_latest_checkpoint(fresh, root, layout=layout(fresh))
    loaded = gather(fresh)
    rec = {"at": at, "step": fresh["step"], "count": fresh["opt"]["count"],
           "losses": losses, "resumed": []}
    for s in (2, 3):
        fresh, loss = step(fresh, _batch(batches[s]))
        rec["resumed"].append(float(loss))
    rec.update(saved=saved, loaded=loaded, final=final,
               resumed_params=gather(fresh))
    return rec


def ckpt_cases(np_params, np_qparams, batches, root):
    """Every case of ``CASES`` on this rank, then z1's checkpoint loaded
    into each ``RESHARD`` target and, on rank 0, into one device. Rank 0
    returns the gathered params (numpy) of each."""
    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    meshes = [init_hybrid_mesh(**c[2], set_global=False) for c in CASES]
    targets = [init_hybrid_mesh(**t[1], set_global=False) for t in RESHARD]
    out = {"rank": rank, "cases": {}, "reshard": {}}
    for case, hm in zip(CASES, meshes):
        params = np_qparams if case[1] == "qwen" else np_params
        rec = _case(case, hm, params, batches, os.path.join(root, case[0]))
        if rank != 0:
            rec = {k: v for k, v in rec.items() if k in ("losses",
                                                          "resumed")}
        out["cases"][case[0]] = rec
    z1 = os.path.join(root, "z1")
    for (name, _, stage), hm in zip(RESHARD, targets):
        _, state, gather, layout = _trainer("llama", hm, stage, {}, None)
        at = C.load_latest_checkpoint(state, z1, layout=layout(state))
        got = gather(state)
        if rank == 0:
            out["reshard"][name] = {"at": at, "params": got,
                                    "step": state["step"],
                                    "count": state["opt"]["count"]}
    if rank == 0:
        cfg = _llama_cfg()
        _, init = TL.make_train_step(cfg, device="cpu")
        state = init(torch.Generator().manual_seed(7))
        at = C.load_latest_checkpoint(state, z1)
        out["reshard"]["one_device"] = {
            "at": at, "params": TL.params_to_numpy(state["params"]),
            "step": state["step"], "count": state["opt"]["count"]}
    dist.destroy_process_group()
    return out
