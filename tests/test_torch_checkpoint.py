"""The port's train-state checkpoints (``distributed.checkpoint``) on one
process, against the JAX package's ``distributed/checkpoint.py``.

Bitwise round trips of every leaf kind and of the trainer's nested
state; the ``step_<n>`` layout and ``keep`` rule held to the JAX
module's (through orbax) on one sequence of saves; an async save owning
its bits before the next in-place step; two ranks' parts of one leaf
both restored (the trap of a writer that keeps one copy a key); the
commit protocol; and the slice as a whole: on ``LlamaConfig.tiny``, two
steps, a save, a load into a fresh state and two more steps equal four
straight steps bitwise, and the JAX package's same sequence through its
orbax ``save_checkpoint`` / ``load_latest_checkpoint`` within the train
step's contract (``tests/test_torch_train.py``: losses rtol / atol
1e-5, params rtol 1e-5, atol 3e-5). Each step's batch is drawn from
``seed + step``, so a resumed run sees the batches it would have."""
import os

import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401  (a worker's share of the cores)

import jax
import jax.numpy as jnp

from paddle_tpu.distributed import checkpoint as JC
from paddle_tpu.models import llama as JL
from paddle_tpu.parallel import init_hybrid_mesh
from paddle_tpu_torch.distributed import checkpoint as C
from paddle_tpu_torch.distributed import extras, io as dist_io
from paddle_tpu_torch.models import llama as TL

B, T, SEED = 2, 16, 40


def _leaf_state():
    g = torch.Generator().manual_seed(0)
    return {
        "f32": torch.randn(3, 5, generator=g),
        "bf16": torch.randn(4, 8, generator=g).to(torch.bfloat16),
        "i32": torch.randint(-9, 9, (6,), generator=g, dtype=torch.int32),
        "i64": torch.tensor(2 ** 40 + 3),
        "scalar": torch.tensor(1.5, dtype=torch.float32),
        "bool": torch.tensor([True, False, True]),
        "nested": {"list": [torch.arange(4.0), {"x": torch.ones(2, 2)}]},
        "count": 7, "name": "adamw", "lr": 3e-4,
    }


def _zeroed(tree):
    if isinstance(tree, dict):
        return {k: _zeroed(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeroed(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return None


def _equal(a, b):
    fa, fb = dict(C._flatten(a)), dict(C._flatten(b))
    assert sorted(fa) == sorted(fb)
    for p, x in fa.items():
        y = fb[p]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, p
            assert torch.equal(x.view(-1).view(torch.uint8) if x.dim()
                               else x.reshape(1).view(torch.uint8),
                               y.view(-1).view(torch.uint8) if y.dim()
                               else y.reshape(1).view(torch.uint8)), p
        else:
            assert x == y, p


@pytest.mark.parametrize("async_save", [False, True])
def test_round_trip_every_leaf_kind_bitwise(tmp_path, async_save):
    state = _leaf_state()
    ck = C.save_state_dict(state, str(tmp_path / "ck"),
                           async_save=async_save)
    ck.wait_until_finished()
    target = _zeroed(state)
    ptrs = [t.data_ptr() for _, t in C._flatten(target)
            if isinstance(t, torch.Tensor)]
    got = C.load_state_dict(target, str(tmp_path / "ck"))
    assert got is target
    _equal(target, state)
    # filled in place: the live tensors, not new ones
    assert ptrs == [t.data_ptr() for _, t in C._flatten(target)
                    if isinstance(t, torch.Tensor)]


def test_distributed_top_level_save_load(tmp_path):
    state = _leaf_state()
    dist_io.save_state_dict(state, str(tmp_path / "ck"))
    target = _zeroed(state)
    extras.load_state_dict(target, str(tmp_path / "ck"))
    _equal(target, state)
    with pytest.raises(ValueError):
        extras.load_state_dict(target)
    for fn in (dist_io.save_persistables, dist_io.load_persistables):
        with pytest.raises(NotImplementedError):
            fn()


def test_load_refuses_what_does_not_fit(tmp_path):
    C.save_state_dict({"w": torch.ones(4, 2)}, str(tmp_path / "ck"))
    with pytest.raises(ValueError, match="global shape"):
        C.load_state_dict({"w": torch.zeros(2, 4)}, str(tmp_path / "ck"))
    with pytest.raises(TypeError):
        C.load_state_dict({"w": torch.zeros(4, 2, dtype=torch.float64)},
                          str(tmp_path / "ck"))
    with pytest.raises(KeyError):
        C.load_state_dict({"v": torch.zeros(4, 2)}, str(tmp_path / "ck"))


def test_async_save_keeps_its_bits_under_in_place_updates(tmp_path):
    w = torch.randn(256, 256)
    want = w.clone()
    ck = C.save_state_dict({"w": w}, str(tmp_path / "ck"), async_save=True)
    w.mul_(3.0).add_(1.0)          # the next step, in place
    ck.wait_until_finished()
    got = {"w": torch.zeros(256, 256)}
    C.load_state_dict(got, str(tmp_path / "ck"))
    assert torch.equal(got["w"], want)


def test_two_ranks_parts_of_one_key_both_come_back(tmp_path):
    """Two ranks hold different halves (and one replicated leaf) under
    one name; a writer keeping one copy a key would lose a half."""
    full = torch.arange(24.0).reshape(4, 6)
    path = str(tmp_path / "ck")
    saves = []
    for rank in (1, 0):        # rank 1 first (it waits for the commit)
        layout = {"w": C.Slice("w", (4, 6), (0, 3 * rank), True),
                  "b": C.Slice("b", (3,), (0,), rank == 0),
                  "mine": None}
        state = {"w": full[:, 3 * rank:3 * rank + 3].clone(),
                 "b": torch.ones(3) * 5, "mine": torch.ones(1) * rank,
                 "step": 4}
        saves.append(C._save_rank(state, path, layout, rank, 2, 0, "tok-1",
                                  async_save=rank == 1))
        if rank == 1:
            assert not os.path.exists(path)
    saves[0].wait_until_finished()
    assert sorted(os.listdir(path)) == [
        "COMMIT", "objects.pkl", "rank_0.bin", "rank_0.json",
        "rank_0.tok-1.done", "rank_1.bin", "rank_1.json",
        "rank_1.tok-1.done"]
    whole = {"w": torch.zeros(4, 6), "b": torch.zeros(3), "step": 0}
    C.load_state_dict(whole, path)
    assert torch.equal(whole["w"], full) and whole["step"] == 4
    # into a different split: rows over two targets
    rows = {"w": torch.zeros(2, 6)}
    C.load_state_dict(rows, path, layout={"w": C.Slice("w", (4, 6), (2, 0))})
    assert torch.equal(rows["w"], full[2:])
    # a part missing: the coverage check refuses
    os.remove(os.path.join(path, "rank_1.json"))
    with pytest.raises(ValueError, match="cover"):
        C.load_state_dict({"w": torch.zeros(4, 6)}, path)


def test_commit_ignores_a_crashed_saves_markers(tmp_path):
    """A marker of another save (a crashed attempt's) does not commit a
    new one; the commit drops it and an earlier checkpoint is
    replaced."""
    path = str(tmp_path / "step_3")
    tmp = path + ".partial"
    os.makedirs(tmp)
    open(os.path.join(tmp, "rank_1.old-1.done"), "w").close()
    C.save_state_dict({"w": torch.ones(2)}, path)      # an older step_3
    C._save_rank({"w": torch.ones(2)}, path, {}, 0, 1, 0, "new-1", False)
    assert C.checkpoint_steps(str(tmp_path)) == [(3, path)]
    assert open(os.path.join(path, "COMMIT")).read() == "new-1"
    assert not any(n.endswith("old-1.done") for n in os.listdir(path))


def _keep_sequence(save, steps_of, root, keep):
    seen = []
    for step in (0, 1, 2, 5, 3, 7):
        save(root, step, keep)
        seen.append(sorted(s for s, _ in steps_of(root)))
    return seen


@pytest.mark.parametrize("keep", [1, 2, 3, None])
def test_keep_pruning_equals_jax(tmp_path, keep):
    pytest.importorskip("orbax.checkpoint")

    def jax_save(root, step, keep):
        JC.save_checkpoint({"w": jnp.ones((2,)) * step}, root, step,
                           keep=keep)

    def port_save(root, step, keep):
        C.save_checkpoint({"w": torch.ones(2) * step}, root, step,
                          keep=keep)

    want = _keep_sequence(jax_save, JC.checkpoint_steps,
                          str(tmp_path / "jax"), keep)
    got = _keep_sequence(port_save, C.checkpoint_steps,
                         str(tmp_path / "port"), keep)
    assert got == want
    st = {"w": torch.zeros(2)}
    assert C.load_latest_checkpoint(st, str(tmp_path / "port")) == 7
    assert torch.equal(st["w"], torch.ones(2) * 7)


def test_keep_zero_raises_and_empty_root_is_minus_one(tmp_path):
    for mod, w in ((C, torch.ones(2)), (JC, jnp.ones((2,)))):
        with pytest.raises(ValueError, match="keep"):
            mod.save_checkpoint({"w": w}, str(tmp_path / "k"), 1, keep=0)
    assert C.load_latest_checkpoint({"w": torch.ones(2)},
                                    str(tmp_path / "none")) == -1
    assert JC.load_latest_checkpoint({"w": jnp.ones((2,))},
                                     str(tmp_path / "none")) == -1
    assert C.latest_checkpoint(str(tmp_path / "none")) is None


def test_restart_attempt_reads_the_launcher(monkeypatch):
    monkeypatch.delenv("PADDLE_RESTART_ATTEMPT", raising=False)
    assert C.restart_attempt() == 0
    monkeypatch.setenv("PADDLE_RESTART_ATTEMPT", "2")
    assert C.restart_attempt() == 2 == JC.restart_attempt()


# ---------------------------------------------------------------------------
# the slice: a tiny Llama resumed from a checkpoint, vs four straight steps
# and vs the JAX package's save / resume
# ---------------------------------------------------------------------------

def _jcfg():
    return JL.LlamaConfig.tiny(dtype=jnp.float32, remat=True,
                               use_flash_attention=True,
                               use_fused_norm_rope=True)


def np_batch(cfg, step):
    """Step ``step``'s batch, from ``SEED + step``."""
    rng = np.random.default_rng(SEED + step)
    toks = rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _jax_resumed(np_params, root):
    """The JAX step: 2 steps, orbax save, a fresh state loaded from it, 2
    more steps; the losses and final params."""
    cfg = _jcfg()
    mesh = init_hybrid_mesh(dp=1, pp=1, tp=1, set_global=False).mesh
    with mesh:
        step, init = JL.make_train_step(cfg, mesh)
        state = init(jax.random.PRNGKey(0))
        losses = []
        for s in range(4):
            if s == 2:
                flat, tdef = jax.tree_util.tree_flatten_with_path(state)
                keys = [jax.tree_util.keystr(p) for p, _ in flat]
                JC.save_checkpoint(dict(zip(keys, (x for _, x in flat))),
                                   root, 1)
                fresh = jax.tree_util.tree_leaves(
                    init(jax.random.PRNGKey(1)))
                template = dict(zip(keys, fresh))
                assert JC.load_latest_checkpoint(template, root) == 1
                state = jax.tree_util.tree_unflatten(
                    tdef, [template[k] for k in keys])
            b = {k: jnp.asarray(v) for k, v in np_batch(cfg, s).items()}
            state, loss = step(state, b)
            losses.append(float(loss))
        return losses, jax.tree_util.tree_map(np.asarray, state["params"])


def test_tiny_llama_resume_is_bitwise_and_matches_jax(tmp_path):
    cfg = _jcfg()
    np_params = jax.tree_util.tree_map(
        np.asarray, JL.init_params(cfg, jax.random.PRNGKey(0)))
    tcfg = TL.LlamaConfig.tiny(dtype=torch.float32)
    step, init = TL.make_train_step(tcfg, device="cpu")

    def tb(s):
        return {k: torch.from_numpy(v) for k, v in
                np_batch(cfg, s).items()}

    straight = init(TL.params_from_jax(np_params, device="cpu"))
    want_losses = [float(step(straight, tb(s))[1]) for s in range(4)]

    state = init(TL.params_from_jax(np_params, device="cpu"))
    losses = [float(step(state, tb(s))[1]) for s in range(2)]
    root = str(tmp_path / "port")
    C.save_checkpoint(state, root, 1, keep=1,
                      async_save=True).wait_until_finished()
    # a fresh state from other weights, filled by the checkpoint
    fresh = init(torch.Generator().manual_seed(3))
    assert C.load_latest_checkpoint(fresh, root) == 1
    assert fresh["step"] == 2 and fresh["opt"]["count"] == 2
    _equal(fresh, state)
    losses += [float(step(fresh, tb(s))[1]) for s in range(2, 4)]
    assert losses == want_losses
    _equal(fresh, straight)

    jlosses, jparams = _jax_resumed(np_params, str(tmp_path / "jax"))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    got = TL.params_to_numpy(fresh["params"])
    for path, want in jax.tree_util.tree_leaves_with_path(jparams):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g, want, err_msg=str(path), rtol=1e-5,
                                   atol=3e-5)
