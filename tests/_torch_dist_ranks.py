"""Rank bodies of the port's parallel tests, run in processes started by
``paddle_tpu_torch.distributed.spawn``. This module imports torch, numpy
and the port only, so no rank imports JAX; the tests compare what the
ranks return with the JAX package in the pytest process."""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch import distributed as dist
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.parallel import init_hybrid_mesh


def _join():
    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    return dist.get_rank()


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in TL._tree_leaves(tree))


def _raises(fn) -> str:
    try:
        fn()
    except Exception as e:      # the test reads the type and message
        return f"{type(e).__name__}: {e}"
    return "no exception"


def train_cases(np_params, np_batch, cases, steps, refusals=False):
    """``cases``: ``(name, dp, tp, zero_stage[, LlamaConfig kwargs])``.
    Each case trains
    ``steps`` steps of ``make_train_step(mesh=...)`` from ``np_params``
    on ``np_batch`` (global). Returns, per case this rank is in: losses,
    the gathered params (rank 0), state bytes at rest, the collective
    counters; and, with ``refusals`` (a world of 4), the refusals."""
    rank = _join()
    batch = {k: torch.from_numpy(v.copy()) for k, v in np_batch.items()}
    out = {"rank": rank, "cases": {}}
    for name, dp, tp, stage, *kw in cases:
        hm = init_hybrid_mesh(dp=dp, tp=tp, set_global=False)
        if not hm.is_member:
            continue
        cfg = TL.LlamaConfig.tiny(dtype=torch.float32, **(kw[0] if kw
                                                           else {}))
        step, init = TL.make_train_step(cfg, mesh=hm, zero_stage=stage,
                                        device="cpu")
        state = init(TL.params_from_jax(np_params, device="cpu"))
        rec = {"param_bytes": _bytes(state["params"]),
               "moment_bytes": _bytes([state["opt"]["mu"],
                                       state["opt"]["nu"]]),
               "coords": hm.coords}
        dist.reset_collective_stats()
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        rec["stats"] = dist.collective_stats()
        rec["losses"] = losses
        params = TL.gather_params(state, cfg, hm)
        if rank == 0:
            rec["params"] = params
        out["cases"][name] = rec
    if refusals:
        out.update(_refusals(TL.LlamaConfig.tiny(dtype=torch.float32),
                             np_params, batch))
    dist.destroy_process_group()
    return out


def _refusals(cfg, np_params, batch):
    """A sequence tp does not divide, a pipeline axis, kv heads tp does
    not divide."""
    out = {}
    hm = init_hybrid_mesh(dp=1, tp=2, set_global=False)
    if hm.is_member:
        step, init = TL.make_train_step(cfg, mesh=hm, device="cpu")
        state = init(TL.params_from_jax(np_params, device="cpu"))
        odd = {k: v[:, :15] for k, v in batch.items()}
        out["odd_T"] = _raises(lambda: step(state, odd))
    hm = init_hybrid_mesh(dp=1, pp=2, set_global=False)
    out["pp"] = _raises(lambda: TL.make_train_step(cfg, mesh=hm,
                                                   device="cpu"))
    hm = init_hybrid_mesh(tp=4, set_global=False)
    out["kv_heads"] = _raises(lambda: TL.make_train_step(cfg, mesh=hm,
                                                         device="cpu"))
    return out


# ---------------------------------------------------------------------------
# tests/test_torch_distributed.py
# ---------------------------------------------------------------------------

def _val(r: int) -> torch.Tensor:
    """Rank r's [2, 3] f32 operand: arange(6) * (r + 1) + r."""
    return (torch.arange(6, dtype=torch.float32).reshape(2, 3) * (r + 1)
            + r)


def collectives(mesh_shapes, ce_inputs, grad_inputs):
    """Every collective of the Paddle API on a 4-rank world, the mesh
    grids of ``mesh_shapes``, the f / g and sequence pairs' gradients
    and the vocab-parallel cross entropy at tp 2."""
    from paddle_tpu_torch.distributed import functional as DF
    from paddle_tpu_torch.ops.fused import vocab_parallel_cross_entropy
    r = _join()
    n = dist.get_world_size()
    out = {"rank": r, "backend": dist.get_backend(),
           "in_sys_modules": sorted(m for m in __import__("sys").modules
                                    if m.split(".")[0] in ("jax",
                                                           "paddle_tpu"))}
    dist.reset_collective_stats()
    for op in ("sum", "max", "min", "prod", "avg"):
        t = _val(r)
        dist.all_reduce(t, op)
        out[f"all_reduce_{op}"] = t.numpy()
    out["all_gather"] = np.stack([t.numpy() for t in
                                  dist.all_gather([], _val(r))])
    objs = []
    dist.all_gather_object(objs, {"rank": r})
    out["all_gather_object"] = objs
    t = _val(r)
    dist.broadcast(t, src=2)
    out["broadcast"] = t.numpy()
    t = _val(r)
    dist.reduce(t, dst=1, op="sum")
    out["reduce"] = t.numpy()
    t = torch.zeros(2, 3)
    dist.scatter(t, [_val(i) * 10 for i in range(n)] if r == 0 else None,
                 src=0)
    out["scatter"] = t.numpy()
    got = dist.gather(_val(r), [], dst=3)
    out["gather"] = np.stack([t.numpy() for t in got]) if r == 3 else got
    outs = dist.alltoall([_val(r) + 100 * j for j in range(n)], [])
    out["alltoall"] = np.stack([t.numpy() for t in outs])
    src = torch.arange(8, dtype=torch.float32) + 10 * r
    dst = torch.empty(8)
    dist.alltoall_single(src, dst)
    out["alltoall_single"] = dst.numpy()
    t = torch.empty(2, 3)
    dist.reduce_scatter(t, [_val(r) + j for j in range(n)])
    out["reduce_scatter"] = t.numpy()
    # a ring of p2p messages: even ranks send first
    t, got = _val(r), torch.empty(2, 3)
    nxt, prv = (r + 1) % n, (r - 1) % n
    if r % 2 == 0:
        dist.send(t, nxt)
        dist.recv(got, prv)
    else:
        dist.recv(got, prv)
        task = dist.isend(t, nxt)
        task.wait()
    out["ring"] = got.numpy()
    dist.barrier()
    sub = dist.new_group([1, 3])
    t = _val(r)
    if sub.is_member():
        dist.all_reduce(t, "sum", group=sub)
    out["subgroup"] = (t.numpy(), sub.rank, sub.nranks)
    objs = [{"from": r, "x": [r]}] if r == 1 else [None]
    dist.broadcast_object_list(objs, src=1)
    out["broadcast_object_list"] = objs
    part = []
    dist.scatter_object_list(part, list(range(8)) if r == 0 else None, 0)
    out["scatter_object_list"] = part
    out["stats"] = dist.collective_stats()
    # the hybrid mesh's grid and its axes' lines
    grids = {}
    for dp, pp, tp in mesh_shapes:
        hm = init_hybrid_mesh(dp=dp, pp=pp, tp=tp, set_global=False)
        grids[(dp, pp, tp)] = {
            "grid": hm.grid, "coords": hm.coords,
            "lines": {a: hm.group(a).ranks for a in hm.axis_names},
            "degrees": (hm.dp_degree, hm.pp_degree, hm.tp_degree,
                        hm.world_size)}
    out["grids"] = grids
    # axis-named collectives over a (dp 2, tp 2) global mesh
    hm = init_hybrid_mesh(dp=2, tp=2)
    x = _val(r)
    out["functional"] = {
        "all_reduce_tp": DF.all_reduce(x, "tp").numpy(),
        "all_reduce_dp_max": DF.all_reduce(x, "dp", "max").numpy(),
        "all_gather_tp": DF.all_gather(x, "tp", axis=1).numpy(),
        "all_gather_tp_stacked": DF.all_gather(x, "tp", tiled=False).numpy(),
        "reduce_scatter_dp": DF.reduce_scatter(
            torch.arange(4.0) * (r + 1), "dp").numpy(),
        "all_to_all_tp": DF.all_to_all(
            torch.arange(4.0).reshape(2, 2) + 10 * r, "tp", 0, 1).numpy(),
        "ppermute_dp": DF.ppermute(x, "dp", [(0, 1)]).numpy(),
        "send_recv_next_tp": DF.send_recv_next(x, "tp", 2).numpy(),
        "axis_index": (DF.axis_index("dp"), DF.axis_index("tp")),
        "pp_identity": DF.all_reduce(x, "pp").numpy(),
    }
    out["grads"] = _pair_grads(hm, grad_inputs)
    out["ce"] = _vocab_ce(hm, ce_inputs, vocab_parallel_cross_entropy)
    dist.destroy_process_group()
    return out


def _pair_grads(hm, inp):
    """The f / g pair around a column- then a row-parallel product, and
    the sequence pair around the same products, on this rank's tp
    shards; with the dense autograd values of the same function."""
    from paddle_tpu_torch.distributed.sequence_parallel import (
        all_gather_sequence, reduce_scatter_sequence)
    from paddle_tpu_torch.parallel import (identity_fwd_psum_bwd,
                                           psum_fwd_identity_bwd)
    tp, i = hm.tp_degree, hm.axis_index("tp")
    x = torch.tensor(inp["x"], dtype=torch.float64)       # [B, T, D]
    w1 = torch.tensor(inp["w1"], dtype=torch.float64)     # [D, F]
    w2 = torch.tensor(inp["w2"], dtype=torch.float64)     # [F, D]
    c = torch.tensor(inp["c"], dtype=torch.float64)       # [B, T, D]
    F_, T = w1.shape[1] // tp, x.shape[1] // tp
    out = {}
    # Megatron f / g: replicated x in, replicated y out
    xl = x.clone().requires_grad_()
    w1l = w1[:, i * F_:(i + 1) * F_].clone().requires_grad_()
    w2l = w2[i * F_:(i + 1) * F_].clone().requires_grad_()
    y = psum_fwd_identity_bwd(
        torch.tanh(identity_fwd_psum_bwd(xl) @ w1l) @ w2l)
    (y * c).sum().backward()
    out["fg"] = {"y": y.detach().numpy(), "dx": xl.grad.numpy(),
                 "dw1": w1l.grad.numpy(), "dw2": w2l.grad.numpy()}
    # the sequence pair: this rank's rows in, its rows out
    xs = x[:, i * T:(i + 1) * T].clone().requires_grad_()
    w1s = w1[:, i * F_:(i + 1) * F_].clone().requires_grad_()
    w2s = w2[i * F_:(i + 1) * F_].clone().requires_grad_()
    ys = reduce_scatter_sequence(
        torch.tanh(all_gather_sequence(xs) @ w1s) @ w2s)
    (ys * c[:, i * T:(i + 1) * T]).sum().backward()
    out["seq"] = {"y": ys.detach().numpy(), "dx": xs.grad.numpy(),
                  "dw1": w1s.grad.numpy(), "dw2": w2s.grad.numpy()}
    # dense autograd
    xd, w1d, w2d = (t.clone().requires_grad_() for t in (x, w1, w2))
    yd = torch.tanh(xd @ w1d) @ w2d
    (yd * c).sum().backward()
    out["dense"] = {"y": yd.detach().numpy(), "dx": xd.grad.numpy(),
                    "dw1": w1d.grad.numpy(), "dw2": w2d.grad.numpy()}
    return out


def _vocab_ce(hm, inp, vpce):
    """This rank's vocab shard of f32 logits: the per-token NLL and the
    logits' gradient of ``sum(nll * g)``."""
    tp, i = hm.tp_degree, hm.axis_index("tp")
    logits = torch.tensor(inp["logits"])
    vl = logits.shape[-1] // tp
    local = logits[..., i * vl:(i + 1) * vl].clone().requires_grad_()
    nll = vpce(local, torch.tensor(inp["labels"]), "tp")
    (nll * torch.tensor(inp["g"])).sum().backward()
    return {"nll": nll.detach().numpy(), "grad": local.grad.numpy()}


# ---------------------------------------------------------------------------
# tests/test_torch_fleet_api.py
# ---------------------------------------------------------------------------

def fleet_api(mpu_in, dp_in, levels):
    """The ``mpu`` layers at tp 4 on their shards of dense weights,
    ``DataParallel`` over ranks 0-1 (half the rows each), ``fleet.init``'s
    degrees, and ``group_sharded_parallel`` at each of ``levels`` against
    an unsharded step."""
    from paddle_tpu_torch.distributed import fleet
    r = _join()
    out = {"rank": r}
    out["mpu"] = _mpu(r, mpu_in)
    out["dp"] = _data_parallel(r, dp_in)
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 2, "mp_degree": 2,
                               "pp_degree": 1, "sharding_degree": 1}
    hm = fleet.init(is_collective=True, strategy=strategy, device="cpu")
    m = torch.nn.Linear(2, 2)
    out["fleet_tp"] = {
        "degrees": (hm.dp_degree, hm.pp_degree, hm.tp_degree),
        "hcg_is_mesh": fleet.get_hybrid_communicate_group() is hm,
        "model_kept": fleet.distributed_model(m) is m,
        "workers": (fleet.worker_num(), fleet.worker_index(),
                    fleet.is_first_worker())}
    fleet.barrier_worker()
    hm = fleet.init(strategy=fleet.DistributedStrategy(), device="cpu")
    out["fleet_dp"] = {
        "degrees": (hm.dp_degree, hm.pp_degree, hm.tp_degree),
        "wrapped": type(fleet.distributed_model(m)).__name__}
    out["sharded"] = {lv: _group_sharded(r, dp_in, lv) for lv in levels}
    dist.destroy_process_group()
    return out


def _mpu(r, inp):
    from paddle_tpu_torch.distributed import mpu
    from paddle_tpu_torch.distributed import sequence_parallel as sp
    hm = init_hybrid_mesh(tp=4)
    t = lambda a: torch.tensor(a)     # noqa: E731
    w1, b1, w2, b2 = (t(inp[k]) for k in ("w1", "b1", "w2", "b2"))
    x, c = t(inp["x"]).requires_grad_(), t(inp["c"])
    col = mpu.ColumnParallelLinear(16, 32, gather_output=False,
                                   device="cpu")
    row = mpu.RowParallelLinear(32, 16, input_is_parallel=True,
                                device="cpu")
    with torch.no_grad():
        col.weight.copy_(w1[:, r * 8:(r + 1) * 8])
        col.bias.copy_(b1[r * 8:(r + 1) * 8])
        row.weight.copy_(w2[r * 8:(r + 1) * 8])
        row.bias.copy_(b2)
    y = row(col(x))
    (y * c).sum().backward()
    res = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
           "dw1": col.weight.grad.numpy(), "db1": col.bias.grad.numpy(),
           "dw2": row.weight.grad.numpy(), "db2": row.bias.grad.numpy()}
    col_g = mpu.ColumnParallelLinear(16, 32, gather_output=True,
                                     device="cpu")
    row_s = mpu.RowParallelLinear(32, 16, input_is_parallel=False,
                                  device="cpu")
    with torch.no_grad():
        col_g.weight.copy_(col.weight)
        col_g.bias.copy_(col.bias)
        row_s.weight.copy_(row.weight)
        row_s.bias.copy_(row.bias)
        res["gathered"] = row_s(col_g(x)).numpy()
    emb = mpu.VocabParallelEmbedding(64, 8, device="cpu")
    with torch.no_grad():
        emb.weight.copy_(t(inp["table"])[r * 16:(r + 1) * 16])
    e = emb(t(inp["tokens"]))
    (e * t(inp["ce"])).sum().backward()
    res["emb"] = e.detach().numpy()
    res["demb"] = emb.weight.grad.numpy()
    logits = t(inp["logits"])[:, r * 5:(r + 1) * 5].requires_grad_()
    nll = mpu.ParallelCrossEntropy()(logits, t(inp["labels"]))
    nll.sum().backward()
    res["nll"] = nll.detach().numpy()
    res["dlogits"] = logits.grad.numpy()
    res["split"] = mpu.split(x.detach(), axis=1).numpy()
    res["bad_width"] = _raises(
        lambda: mpu.ColumnParallelLinear(16, 30, device="cpu"))
    # sequence parallelism: this rank's 2 of 8 rows through the pair of
    # linears and a marked norm weight
    xs = t(inp["xs"])[:, r * 2:(r + 1) * 2].clone().requires_grad_()
    cs = sp.ColumnSequenceParallelLinear(16, 32, gather_output=False,
                                         device="cpu")
    rs = sp.RowSequenceParallelLinear(32, 16, input_is_parallel=True,
                                      device="cpu")
    nw = torch.nn.Parameter(t(inp["nw"]))
    nw.sequence_parallel = True
    holder = torch.nn.Module()
    holder.nw = nw
    handles = sp.register_sequence_parallel_allreduce_hooks(holder)
    with torch.no_grad():
        cs.weight.copy_(col.weight)
        cs.bias.copy_(col.bias)
        rs.weight.copy_(row.weight)
        rs.bias.copy_(row.bias)
    ys = rs(cs(xs * nw))
    (ys * t(inp["cs"])[:, r * 2:(r + 1) * 2]).sum().backward()
    res["seq"] = {"y": ys.detach().numpy(), "dx": xs.grad.numpy(),
                  "dnw": nw.grad.numpy(), "hooks": len(handles),
                  "dw1": cs.weight.grad.numpy()}
    res["marked"] = sp.mark_sequence_parallel(t(inp["xs"])).numpy()
    return res


def _two_layer(inp, dtype=torch.float32):
    from paddle_tpu_torch.models._layers import Linear
    m = torch.nn.Sequential(Linear(4, 6), torch.nn.ReLU(), Linear(6, 3))
    with torch.no_grad():
        for i, k in ((0, "l1"), (2, "l2")):
            m[i].weight.copy_(torch.tensor(inp[k + "_w"]))
            m[i].bias.copy_(torch.tensor(inp[k + "_b"]))
    return m.to(dtype)


def _data_parallel(r, inp):
    from paddle_tpu_torch.distributed import DataParallel
    hm = init_hybrid_mesh(dp=2, ranks=[0, 1], set_global=False)
    if not hm.is_member:
        return None
    model = DataParallel(_two_layer(inp), group=hm.group("dp"))
    x, y = (torch.tensor(inp[k])[r * 4:(r + 1) * 4] for k in ("x", "y"))
    loss = ((model(x) - y) ** 2).mean()
    loss.backward()
    synced = {n: p.grad.clone().numpy()
              for n, p in model._layers.named_parameters()}
    model._layers.zero_grad()
    with model.no_sync():
        ((model(x) - y) ** 2).mean().backward()
    local = {n: p.grad.clone().numpy()
             for n, p in model._layers.named_parameters()}
    model.apply_collective_grads()
    applied = {n: p.grad.clone().numpy()
               for n, p in model._layers.named_parameters()}
    return {"synced": synced, "local": local, "applied": applied,
            "scaled": float(model.scale_loss(loss))}


def _group_sharded(r, inp, level, steps=3):
    from paddle_tpu_torch import optimizer as O
    from paddle_tpu_torch.distributed import group_sharded_parallel
    from paddle_tpu_torch.distributed.communication import all_gather_cat
    hm = init_hybrid_mesh(dp=2, ranks=[0, 1])
    if not hm.is_member:
        return None
    x, y = (torch.tensor(inp[k]) for k in ("x", "y"))
    ref = _two_layer(inp)
    ref_opt = O.AdamW(learning_rate=1e-2, parameters=ref.parameters())
    model = _two_layer(inp)
    opt = O.AdamW(learning_rate=1e-2, parameters=model.parameters())
    model, opt, _ = group_sharded_parallel(model, opt, level=level)
    for _ in range(steps):
        ((ref(x) - y) ** 2).mean().backward()
        ref_opt.step()
        ref_opt.clear_grad()
        rows = slice(r * 4, (r + 1) * 4)
        ((model(x[rows]) - y[rows]) ** 2).mean().backward()
        opt.step()
        opt.clear_grad()
    out = {"at_rest": [int(p.numel()) for p in model.parameters()],
           "moment_numel": [int(m.numel()) for m in
                            opt._accumulators["moment1"].values()]}
    got = []
    for p in model.parameters():
        if hasattr(p, "zero_slice"):
            got.append(all_gather_cat(p.zero_slice, p.zero_dim,
                                      hm.group("dp")).numpy())
        else:
            got.append(p.detach().numpy())
    out["params"] = got
    out["ref"] = [p.detach().numpy() for p in ref.parameters()]
    return out
