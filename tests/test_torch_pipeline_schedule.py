"""The port's pipeline schedule builder and its helpers against the JAX
package's, no world spawned: every field of ``build_schedule`` (the op,
chunk and microbatch grid, the ring slots and depths, the inject / emit
flags, the arrival routing) over a grid of (S, M, V, variant), the
rejections with their messages, ``schedule_legality`` and its table,
``schedule_ticks`` / ``schedule_efficiency`` in all three models,
``split_chunks_round_robin``, ``microbatch`` and ``stack_stage_params``.
Contract: exact (integers, the same floats, the same messages)."""
from importlib import import_module

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.parallel import pipeline_1f1b as J1
from paddle_tpu.parallel import pipeline_async as JA
from paddle_tpu_torch.parallel import pipeline_1f1b as T1
from paddle_tpu_torch.parallel import pipeline_async as TA

# both packages export a function of the module's name
JS = import_module("paddle_tpu.parallel.pipeline_spmd")
TS = import_module("paddle_tpu_torch.parallel.pipeline_spmd")

FIELDS = ("num_stages", "num_microbatches", "virtual_chunks", "variant",
          "ticks", "depth_x", "depth_c", "depth_r", "kind", "chunk", "mb",
          "slot_x", "slot_c", "slot_r", "inject", "emit", "store_up",
          "store_dn")
GRID = [(S, M, V, var) for S in (1, 2, 3, 4) for M in (0, 1, 2, 3, 4, 5, 8)
        for V in (1, 2) for var in ("1f1b", "zb")]


def _build(mod, *args):
    try:
        return mod.build_schedule(*args), None
    except ValueError as e:
        return None, str(e)


@pytest.mark.parametrize("S,M,V,variant", GRID)
def test_build_schedule_equals_jax(S, M, V, variant):
    """Every table and property, or the same rejection."""
    got, got_err = _build(TA, S, M, V, variant)
    want, want_err = _build(JA, S, M, V, variant)
    assert got_err == want_err
    if want is None:
        return
    for f in FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        else:
            assert a == b, f
    assert got.useful_ticks_per_rank == want.useful_ticks_per_rank
    assert got.efficiency == want.efficiency
    assert got.op_counts() == want.op_counts()


@pytest.mark.parametrize("variant", ["zigzag", "1F1B", ""])
def test_unknown_variant_rejected_as_jax(variant):
    with pytest.raises(ValueError) as got:
        TA.build_schedule(2, 4, 1, variant)
    with pytest.raises(ValueError) as want:
        JA.build_schedule(2, 4, 1, variant)
    assert str(got.value) == str(want.value)


def test_tables_and_codes_equal_jax():
    assert (TA.IDLE, TA.OP_F, TA.OP_B, TA.OP_FH, TA.OP_W) == \
        (JA.IDLE, JA.OP_F, JA.OP_B, JA.OP_FH, JA.OP_W)
    assert TA.KIND_NAMES == JA.KIND_NAMES
    assert TA.VARIANTS == JA.VARIANTS
    assert TA.PP_SCHEDULES == JA.PP_SCHEDULES
    assert {k: v.to_dict() for k, v in TA.SCHEDULE_INFO.items()} == \
        {k: v.to_dict() for k, v in JA.SCHEDULE_INFO.items()}


@pytest.mark.parametrize("name", ["1f1b", "1f1b_async", "zb", "gpipe"])
def test_schedule_legality_equals_jax(name):
    for S in (1, 2, 3, 4):
        for M in (0, 1, 3, 4, 6):
            for V in (1, 2, 3):
                for dp, tp in ((1, 1), (2, 2)):
                    kw = dict(num_stages=S, num_microbatches=M,
                              virtual_chunks=V, dp=dp, tp=tp)
                    assert TA.schedule_legality(name, **kw) == \
                        JA.schedule_legality(name, **kw), (S, M, V)


MODEL_GRID = [(S, M, V) for S in (1, 2, 3, 4, 8) for M in (1, 2, 4, 5, 8, 16)
              for V in (1, 2)]


@pytest.mark.parametrize("schedule", ["lockstep", "1f1b", "zb"])
def test_ticks_and_efficiency_equal_jax(schedule):
    for S, M, V in MODEL_GRID:
        def both(fn_t, fn_j):
            try:
                a = fn_t(S, M, V, schedule=schedule)
            except ValueError as e:
                a = ("raises", str(e))
            try:
                b = fn_j(S, M, V, schedule=schedule)
            except ValueError as e:
                b = ("raises", str(e))
            assert a == b, (schedule, S, M, V, a, b)
        both(T1.schedule_ticks, J1.schedule_ticks)
        both(T1.schedule_efficiency, J1.schedule_efficiency)
    for bad in ("wat", "gpipe"):
        with pytest.raises(ValueError, match="schedule"):
            T1.schedule_efficiency(2, 8, schedule=bad)


@pytest.mark.parametrize("S,V", [(1, 1), (2, 1), (2, 2), (4, 1), (3, 2)])
def test_split_chunks_round_robin_equals_jax(S, V):
    L = 12
    rs = np.random.default_rng(S * 10 + V)
    tree = {"w": rs.standard_normal((L, 3, 2)).astype(np.float32),
            "n": {"g": rs.standard_normal((L, 4)).astype(np.float32)}}
    want = J1.split_chunks_round_robin(
        {"w": jnp.asarray(tree["w"]), "n": {"g": jnp.asarray(tree["n"]["g"])}},
        L, S, V)
    got = T1.split_chunks_round_robin(
        {"w": torch.from_numpy(tree["w"]),
         "n": {"g": torch.from_numpy(tree["n"]["g"])}}, L, S, V)
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    assert np.array_equal(got["n"]["g"].numpy(), np.asarray(want["n"]["g"]))
    # per-layer lists split the same way: chunk k = v*S + s
    layers = [{"w": torch.from_numpy(tree["w"][i])} for i in range(L)]
    chunks = T1.split_chunks_round_robin(layers, L, S, V)
    for k, chunk in enumerate(chunks):
        stacked = np.stack([lp["w"].numpy() for lp in chunk])
        assert np.array_equal(stacked, np.asarray(want["w"][k]))


def test_split_chunks_round_robin_rejects_as_jax():
    with pytest.raises(ValueError) as got:
        T1.split_chunks_round_robin({"w": torch.zeros(4, 2)}, 4, 3, 1)
    with pytest.raises(ValueError) as want:
        J1.split_chunks_round_robin({"w": jnp.zeros((4, 2))}, 4, 3, 1)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("B,M", [(8, 1), (8, 4), (6, 3), (5, 5)])
def test_microbatch_equals_jax(B, M):
    x = np.arange(B * 3 * 2, dtype=np.float32).reshape(B, 3, 2)
    assert np.array_equal(TS.microbatch(torch.from_numpy(x), M).numpy(),
                          np.asarray(JS.microbatch(jnp.asarray(x), M)))


def test_microbatch_rejects_as_jax():
    with pytest.raises(ValueError) as got:
        TS.microbatch(torch.zeros(6, 2), 4)
    with pytest.raises(ValueError) as want:
        JS.microbatch(jnp.zeros((6, 2)), 4)
    assert str(got.value) == str(want.value)


def test_stack_stage_params_equals_jax():
    rs = np.random.default_rng(7)
    stages = [{"a": rs.standard_normal((2, 3)).astype(np.float32),
               "b": [rs.standard_normal(4).astype(np.float32)]}
              for _ in range(3)]
    want = JS.stack_stage_params([
        {"a": jnp.asarray(s["a"]), "b": [jnp.asarray(s["b"][0])]}
        for s in stages])
    got = TS.stack_stage_params([
        {"a": torch.from_numpy(s["a"]), "b": [torch.from_numpy(s["b"][0])]}
        for s in stages])
    assert np.array_equal(got["a"].numpy(), np.asarray(want["a"]))
    assert np.array_equal(got["b"][0].numpy(), np.asarray(want["b"][0]))
