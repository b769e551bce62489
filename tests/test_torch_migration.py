"""KV-chain migration, the host cold tier and the engine's fleet-facing
surface of the PyTorch port, held against the JAX package.

Each test runs the JAX function beside the port's on the same seeded
inputs (a tiny 2-layer f32 Llama, page 4, as tests/test_migration.py):

* chain fingerprints and ``affinity_summary`` equal the JAX trie's,
  after eviction and a defrag remap too;
* a chain exported whole and in chunks (with a defrag between chunks)
  decodes to JAX ``generate()``'s tokens exactly, and blobs cross the
  packages both ways;
* bf16 blobs travel as uint16 bits; mismatched page sizes and dtypes
  raise ValueError; abort and end are idempotent;
* the cold tier spills and rewarms bitwise, with the JAX engine's
  counters on the same traffic; ``ColdTier`` is a bounded LRU;
* ``on_chain_complete``, ``inject``, ``close(hand_back=True)`` and
  ``alive`` follow the JAX engine's contract.
"""
import dataclasses
import functools
import pickle
import threading

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.inference.paged_kv import PagePool as JPagePool
from paddle_tpu.models import llama as JL
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.prefix_cache import PrefixCache as JPrefixCache
from paddle_tpu.serving.prefix_cache import \
    prefix_fingerprints as j_fingerprints
from paddle_tpu_torch.inference.paged_kv import PagePool
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import (COMPLETED, QUEUED, ColdTier,
                                      PrefixCache, ServingEngine,
                                      prefix_fingerprints)

JCFG = dataclasses.replace(
    JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                        remat=False), num_hidden_layers=2)
TCFG = dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32),
                           num_hidden_layers=2)
ENGINE_KW = dict(max_batch=4, page_size=4, max_prompt_len=16,
                 max_new_tokens_cap=16)
HEADER = list(range(1, 9))              # 8 tokens = 2 full pages


@pytest.fixture(scope="module")
def jparams():
    return JL.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return TL.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                              device="cpu")


@functools.lru_cache(maxsize=None)
def _gen_jit(n):
    return jax.jit(lambda p, t: JL.generate(p, t, JCFG, max_new_tokens=n))


def _ref(jparams, prompt, n):
    """JAX generate() continuation (prompt stripped)."""
    out = _gen_jit(n)(jparams, jnp.asarray(prompt, jnp.int32)[None])
    return np.asarray(out)[0, len(prompt):]


def _engine(tparams, cfg=TCFG, **kw):
    return ServingEngine(tparams, cfg, device="cpu", **{**ENGINE_KW, **kw})


def _fp(prompt, ps=4):
    return int(prefix_fingerprints(np.asarray(prompt, np.int32), ps,
                                   max_depth=64)[-1])


def _arr(*xs):
    return np.asarray(xs, np.int32)


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# fingerprints and the affinity summary
# ---------------------------------------------------------------------------

def _trie_ops(pool_cls, cache_cls, case):
    """One of JAX test_prefix_cache.py's affinity scenarios, run on one
    package's trie; returns what the test compares."""
    pool = pool_cls(total_pages=16, page_size=2)
    pc = cache_cls(pool)
    out = []
    if case == "fingerprints":
        prompt = _arr(1, 2, 3, 4, 5)
        nodes = pc.insert(prompt, [], pool.alloc(2))[0]
        out.append(pc.affinity_summary(max_depth=2))
        got = pc.acquire(prompt)
        out.append(pc.affinity_summary(max_depth=2))
        pc.match_pages(prompt)          # a peek is not a hit
        out.append(pc.affinity_summary(2))
        pc.release(got)
        pc.release(nodes)
        out.append(pc.affinity_summary(max_depth=1))
    elif case == "evicted":
        p_a, p_b = _arr(1, 2, 3, 4, 9), _arr(7, 8, 9)
        a = pc.insert(p_a, [], pool.alloc(2))[0]
        b = pc.insert(p_b, [], pool.alloc(1))[0]
        pc.release(a)
        pc.release(b)
        pc.release(pc.acquire(p_b))     # B is hotter and newer
        out.append(pc.affinity_summary(2))
        out.append(pc.evict(2))         # chain A (LRU) fully gone
        out.append(pc.affinity_summary(2))
    else:                               # "defrag"
        prompt = _arr(1, 2, 3, 4, 5)
        nodes = pc.insert(prompt, [], [9, 12])[0]
        got = pc.acquire(prompt)
        out.append(pc.affinity_summary(2))
        pc.remap({9: 1, 12: 2})
        out.append(pc.affinity_summary(2))
        got2 = pc.acquire(prompt)
        out.append([nd.page for nd in got2])
        out.append(pc.chain_by_fingerprint(
            prefix_fingerprints(prompt, 2, 2)[-1])[-1].page)
        for n in (got2, got, nodes):
            pc.release(n)
    return out


@pytest.mark.parametrize("case", ["fingerprints", "evicted", "defrag"])
def test_fingerprints_and_affinity_summary_match_jax(case):
    for prompt in (_arr(1, 2, 3, 4, 5), _arr(7, 8, 9),
                   np.arange(1, 40, dtype=np.int32)):
        for ps, depth in ((2, 2), (4, 64)):
            assert prefix_fingerprints(prompt, ps, depth) == \
                j_fingerprints(prompt, ps, depth)
    got = _trie_ops(PagePool, PrefixCache, case)
    want = _trie_ops(JPagePool, JPrefixCache, case)
    assert got == want
    if case == "evicted":
        fa = prefix_fingerprints(_arr(1, 2, 3, 4, 9), 2, 2)
        assert not set(fa) & set(got[2]), "evicted chain still advertised"


# ---------------------------------------------------------------------------
# whole and chunked migration
# ---------------------------------------------------------------------------

def test_chunked_equals_whole_blob_with_defrag_mid_transfer(jparams,
                                                            tparams):
    """The chunked protocol equals the whole blob bitwise, with the
    source defragmented (pages moved) between chunks, and both adopted
    chains decode to JAX generate()'s tokens (JAX
    test_migration.py:156)."""
    src = _engine(tparams)
    via_blob = _engine(tparams)
    via_chunks = _engine(tparams)
    try:
        # a request admitted first and retired (no full page cached)
        # leaves a hole below the chain: the defrag mid-transfer moves it
        warm = HEADER + [50, 51, 52]
        h_low = src.submit(_arr(90, 91, 92), 12)
        src.submit(_arr(*warm), 4).result(timeout=300)
        h_low.result(timeout=300)
        blob = pickle.loads(pickle.dumps(src.export_chain(_fp(warm))))
        assert blob["k"].dtype == np.float32
        assert blob["k"].shape == (2, 2, 2, 4, 16)
        assert via_blob.adopt_chain(blob) == {"matched_pages": 0,
                                              "adopted_pages": 2}

        hdr = src.export_chain_begin(_fp(warm))
        assert hdr["tokens"] == blob["tokens"]
        st = via_chunks.adopt_chain_begin(
            {"page_size": hdr["page_size"], "tokens": hdr["tokens"]})
        assert via_chunks.audit() == [] and src.audit() == []
        before = [nd.page for nd in src.prefix_cache.chain_by_fingerprint(
            _fp(warm))]
        assert src.defragment() > 0
        after = [nd.page for nd in src.prefix_cache.chain_by_fingerprint(
            _fp(warm))]
        assert before != after, "the defrag did not move the chain"
        ks, vs = [], []
        for i in range(st["matched_pages"], len(hdr["tokens"])):
            ch = src.export_chain_chunk(hdr["xid"], i, 1)
            ks.append(ch["k"])
            vs.append(ch["v"])
            via_chunks.adopt_chain_chunk(st["aid"], ch["start"], ch["k"],
                                         ch["v"])
            assert via_chunks.audit() == []
        assert via_chunks.adopt_chain_commit(st["aid"])[
            "adopted_pages"] == 2
        src.export_chain_end(hdr["xid"])
        np.testing.assert_array_equal(np.concatenate(ks, 2), blob["k"])
        np.testing.assert_array_equal(np.concatenate(vs, 2), blob["v"])

        cont = HEADER + [60, 61]
        ref = _ref(jparams, cont, 6)
        for eng in (via_blob, via_chunks):
            np.testing.assert_array_equal(
                eng.submit(_arr(*cont), 6).result(timeout=300), ref)
            assert eng.snapshot()["counters"]["prefix_hit_tokens"] == 8
            assert eng.audit() == []
        assert src.audit() == []
    finally:
        for eng in (src, via_blob, via_chunks):
            eng.close()


@pytest.fixture(scope="module")
def jengine(jparams):
    eng = JEngine(jparams, JCFG, **ENGINE_KW)
    yield eng
    eng.close()


def test_jax_blob_adopted_by_port_engine(jparams, tparams, jengine):
    warm = HEADER + [40, 41]
    jengine.submit(_arr(*warm), 3).result(timeout=300)
    blob = pickle.loads(pickle.dumps(jengine.export_chain(_fp(warm))))
    with _engine(tparams) as eng:
        assert eng.adopt_chain(blob)["adopted_pages"] == 2
        assert eng.audit() == []
        back = eng.export_chain(_fp(warm))      # the same bytes, in order
        np.testing.assert_array_equal(back["k"], blob["k"])
        np.testing.assert_array_equal(back["v"], blob["v"])
        cont = HEADER + [70, 71, 72]
        np.testing.assert_array_equal(
            eng.submit(_arr(*cont), 8).result(timeout=300),
            _ref(jparams, cont, 8))
        assert eng.snapshot()["counters"]["prefix_hit_tokens"] == 8
        assert eng.audit() == []


def test_port_blob_adopted_by_jax_engine(jparams, tparams, jengine):
    warm = [9, 8, 7, 6, 5, 4, 3, 2, 1, 11]
    with _engine(tparams) as eng:
        eng.submit(_arr(*warm), 3).result(timeout=300)
        blob = pickle.loads(pickle.dumps(eng.export_chain(_fp(warm))))
    assert jengine.adopt_chain(blob)["adopted_pages"] == 2
    assert jengine.audit() == []
    back = jengine.export_chain(_fp(warm))
    np.testing.assert_array_equal(back["k"], blob["k"])
    np.testing.assert_array_equal(back["v"], blob["v"])
    hits0 = jengine.snapshot()["counters"]["prefix_hit_tokens"]
    cont = warm[:8] + [33, 34]
    np.testing.assert_array_equal(
        jengine.submit(_arr(*cont), 8).result(timeout=300),
        _ref(jparams, cont, 8))
    assert jengine.snapshot()["counters"]["prefix_hit_tokens"] - hits0 == 8
    assert jengine.audit() == []


def test_bf16_blob_round_trip_as_uint16_bits(tparams):
    """A bf16 pool exports its bit patterns as uint16; another bf16
    engine adopts them (or the same bits as int16 or an ml_dtypes
    bfloat16 array) into the same bytes, and decodes the same tokens."""
    cfg = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    params = _bf16(tparams)
    warm = HEADER + [20, 21]
    src = _engine(params, cfg)
    try:
        src.submit(_arr(*warm), 3).result(timeout=300)
        blob = pickle.loads(pickle.dumps(src.export_chain(_fp(warm))))
        assert blob["k"].dtype == np.uint16 and blob["v"].dtype == np.uint16
        pages = [nd.page for nd in
                 src.prefix_cache.chain_by_fingerprint(_fp(warm))]
        bits = src._kp[:, :, pages].view(torch.int16).numpy()
        np.testing.assert_array_equal(blob["k"].view(np.int16), bits)
        cont = HEADER + [60, 61]
        want = src.submit(_arr(*cont), 6).result(timeout=300)
        for view in (np.uint16, np.int16, ml_dtypes.bfloat16):
            b = dict(blob, k=blob["k"].view(view), v=blob["v"].view(view))
            with _engine(params, cfg) as dst:
                assert dst.adopt_chain(b)["adopted_pages"] == 2
                back = dst.export_chain(_fp(warm))
                np.testing.assert_array_equal(back["k"], blob["k"])
                np.testing.assert_array_equal(back["v"], blob["v"])
                np.testing.assert_array_equal(
                    dst.submit(_arr(*cont), 6).result(timeout=300), want)
                assert dst.audit() == []
    finally:
        src.close()


def test_mismatched_blobs_raise_value_error(tparams):
    """Page size, dtype and shape mismatches raise ValueError before any
    page is allocated."""
    warm = HEADER + [20, 21]
    with _engine(tparams) as src:
        src.submit(_arr(*warm), 3).result(timeout=300)
        blob = src.export_chain(_fp(warm))
    bf = dataclasses.replace(TCFG, dtype=torch.bfloat16)
    bparams = _bf16(tparams)
    bad_f32 = [dict(blob, page_size=8),
               dict(blob, k=blob["k"].view(np.uint32)),
               dict(blob, k=blob["k"].astype(np.float64),
                    v=blob["v"].astype(np.float64)),
               dict(blob, k=blob["k"][:, :, :1])]
    bad_bf16 = [dict(blob),
                dict(blob, k=blob["k"].astype(np.float16),
                     v=blob["v"].astype(np.float16))]
    for params, cfg, blobs in ((tparams, TCFG, bad_f32),
                               (bparams, bf, bad_bf16)):
        with _engine(params, cfg) as eng:
            free = eng.pool.free_pages
            for b in blobs:
                with pytest.raises(ValueError):
                    eng.adopt_chain(b)
            with pytest.raises(ValueError, match="page-size"):
                eng.adopt_chain_begin({"page_size": 8,
                                       "tokens": blob["tokens"]})
            assert eng.pool.free_pages == free
            assert eng.audit() == []


def test_abort_and_export_end_are_idempotent(tparams):
    warm = HEADER + [20, 21]
    with _engine(tparams) as src, _engine(tparams) as dst:
        src.submit(_arr(*warm), 3).result(timeout=300)
        hdr = src.export_chain_begin(_fp(warm))
        assert all(nd.refs == 1 for nd in
                   src.prefix_cache.chain_by_fingerprint(_fp(warm)))
        assert src.audit() == []
        free = dst.pool.free_pages
        st = dst.adopt_chain_begin(hdr)
        assert dst.pool.free_pages == free - 2 and dst.audit() == []
        ch = src.export_chain_chunk(hdr["xid"], 0, 1)
        dst.adopt_chain_chunk(st["aid"], 0, ch["k"], ch["v"])
        for _ in range(2):
            dst.adopt_chain_abort(st["aid"])
            src.export_chain_end(hdr["xid"])
            assert dst.pool.free_pages == free
            assert src.audit() == [] and dst.audit() == []
        assert all(nd.refs == 0 for nd in
                   src.prefix_cache.chain_by_fingerprint(_fp(warm)))
        assert dst.prefix_cache.cached_pages == 0
        with pytest.raises(KeyError):
            dst.adopt_chain_commit(st["aid"])
        # an uncached chain exports nothing; a cached one adopts nothing
        assert src.export_chain(12345) is None
        assert src.export_chain_begin(12345) is None
        assert src.adopt_chain_begin(hdr) == {"aid": None,
                                              "matched_pages": 2,
                                              "need": 0}


# ---------------------------------------------------------------------------
# the cold tier
# ---------------------------------------------------------------------------

COLD_KW = dict(max_batch=1, page_size=4, max_prompt_len=16,
               max_new_tokens_cap=8, total_pages=8, cold_tier_bytes=1 << 20)
COLD_COUNTERS = ("cold_spills", "cold_hits", "cold_hit_pages",
                 "prefix_hits", "prefix_misses", "prefix_hit_tokens",
                 "completed")


def _cold_traffic(eng):
    """JAX test_migration.py:254's traffic: p1, p2, p3 (each evicting
    the chain before it on an 8-page pool), then p1 again."""
    p1, p2, p3 = (list(range(b, b + 12)) for b in (1, 101, 201))
    outs = [eng.submit(_arr(*p1), 4).result(timeout=300)]
    before = eng.export_chain(_fp(p1))      # p1's 2 attachable pages
    outs += [eng.submit(_arr(*p), 4).result(timeout=300) for p in (p2, p3)]
    spilled = eng.snapshot()["counters"]["cold_spills"]
    assert eng.export_chain(_fp(p1)) is None    # evicted
    outs.append(eng.submit(_arr(*p1), 4).result(timeout=300))
    after = eng.export_chain(_fp(p1))       # rewarmed: the same bytes
    np.testing.assert_array_equal(after["k"], before["k"])
    np.testing.assert_array_equal(after["v"], before["v"])
    snap = eng.snapshot()
    assert eng.audit() == []
    return outs, spilled, snap


def test_cold_tier_spill_rewarm_bitwise_counters_match_jax(jparams,
                                                           tparams):
    teng = _engine(tparams, **COLD_KW)
    jeng = JEngine(jparams, JCFG, **COLD_KW)
    try:
        t_outs, t_spilled, t_snap = _cold_traffic(teng)
        j_outs, j_spilled, j_snap = _cold_traffic(jeng)
    finally:
        teng.close()
        jeng.close()
    p1 = list(range(1, 13))
    np.testing.assert_array_equal(t_outs[0], _ref(jparams, p1, 4))
    np.testing.assert_array_equal(t_outs[3], t_outs[0])
    for t, j in zip(t_outs, j_outs):
        np.testing.assert_array_equal(t, j)
    assert t_spilled >= 3 and t_spilled == j_spilled
    c = t_snap["counters"]
    assert c["cold_hits"] == 1 and c["cold_hit_pages"] == 2
    assert {k: c[k] for k in COLD_COUNTERS} == \
        {k: j_snap["counters"][k] for k in COLD_COUNTERS}
    assert t_snap["gauges"]["cold_tier"] == j_snap["gauges"]["cold_tier"]
    assert t_snap["gauges"]["cold_tier"]["bytes"] > 0
    assert t_snap["histograms"]["cold_adopt_s"]["count"] == 1
    assert teng.pool.used_pages == 0


def test_cold_tier_rewarms_a_request_submitted_during_admission(tparams):
    """A request that lands between the loop's rewarm look and its
    admission waits one loop turn and is rewarmed, instead of being
    admitted cold: p1 is submitted from inside ``Scheduler.admit``."""
    eng = _engine(tparams, **COLD_KW)
    try:
        p1, p2, p3 = (list(range(b, b + 12)) for b in (1, 101, 201))
        first = eng.submit(_arr(*p1), 4).result(timeout=300)
        for p in (p2, p3):
            eng.submit(_arr(*p), 4).result(timeout=300)
        assert eng.export_chain(_fp(p1)) is None    # spilled
        late, submitted = {}, threading.Event()
        admit = eng.scheduler.admit

        def admit_after_a_late_submit(*a, **kw):
            if not submitted.is_set():
                late["h"] = eng.submit(_arr(*p1), 4)
                submitted.set()
            return admit(*a, **kw)
        eng.scheduler.admit = admit_after_a_late_submit
        assert submitted.wait(60)   # the loop's next admission
        out = late["h"].result(timeout=300)
        with eng._tick_lock:        # the tick's counters are in
            pass
        c = eng.snapshot()["counters"]
        assert (c["cold_hits"], c["cold_hit_pages"]) == (1, 2)
        np.testing.assert_array_equal(out, first)
        assert eng.audit() == []
    finally:
        eng.close()


def test_cold_tier_bounded_lru():
    """JAX test_migration.py:291 on the port's ColdTier (torch CPU
    tensors, bytes counted as numpy counts them)."""
    tier = ColdTier(64)                     # bytes: far below one page
    k = torch.zeros((2, 2, 1, 4, 8))
    assert not tier.put(1, (1, 2, 3, 4), k, k)
    assert tier.stats()["entries"] == 0
    one = 2 * np.zeros((2, 2, 1, 4, 8), np.float32).nbytes
    tier2 = ColdTier(2 * one)               # room for exactly two
    for fp in (1, 2, 3):
        assert tier2.put(fp, (fp,), k, k)
    st = tier2.stats()
    assert st["entries"] == 2 and st["drops"] == 1
    assert st["bytes"] == 2 * one
    assert tier2.get(1) is None             # oldest was dropped
    assert tier2.get(3) is not None
    assert tier2.pop(3) is not None and tier2.stats()["hits"] == 1


# ---------------------------------------------------------------------------
# the fleet-facing surface
# ---------------------------------------------------------------------------

def test_on_chain_complete_info_matches_jax(jparams, tparams):
    prompts = [HEADER + [30, 31], HEADER + [30, 31, 32, 33, 34],
               [5, 6, 7], list(range(40, 52))]
    got = {}
    for name, make in (
            ("port", lambda fn: _engine(tparams, on_chain_complete=fn)),
            ("jax", lambda fn: JEngine(jparams, JCFG, **ENGINE_KW,
                                       on_chain_complete=fn))):
        events = []
        eng = make(lambda req, info: events.append(
            (req.prompt.tolist(), info)))
        try:
            for p in prompts:
                eng.submit(_arr(*p), 2).result(timeout=300)
        finally:
            eng.close()
        got[name] = events
    assert got["port"] == got["jax"]
    assert [len(info["fps"]) for _, info in got["port"]] == [2, 3, 3]
    assert got["port"][1][1]["fp"] == _fp(prompts[1])


def test_inject_hand_back_and_alive_follow_jax_contract(jparams, tparams):
    """JAX test_serving.py's hand-back drain on the port, with inject's
    counter contract: accepted injections count ``submitted``, refusals
    ``rejected``."""
    rng = np.random.RandomState(7)
    p_run = rng.randint(0, TCFG.vocab_size, (4,)).astype(np.int32)
    p_q = [rng.randint(0, TCFG.vocab_size, (5,)).astype(np.int32)
           for _ in range(2)]
    eng = _engine(tparams, max_batch=1)
    assert eng.alive
    h_run = eng.submit(p_run, 12)
    next(iter(h_run))                   # admitted and decoding
    h_queued = [eng.submit(p, 8) for p in p_q]
    handed = eng.close(drain=True, hand_back=True)
    assert not eng.alive
    assert h_run.status == COMPLETED
    np.testing.assert_array_equal(h_run.result(), _ref(jparams, p_run, 12))
    assert [r.id for r in handed] == [h.id for h in h_queued]
    for r, h in zip(handed, h_queued):
        assert r.state == QUEUED and not r.done.is_set()
        assert h.tokens_so_far == []
    c = eng.snapshot()["counters"]
    assert c["handed_back"] == 2 and c["cancelled"] == 0
    assert eng.close(hand_back=True) == []      # returned once only
    # a closed engine refuses an injection and counts it rejected
    assert eng.inject(handed[0]) is False
    c2 = eng.snapshot()["counters"]
    assert (c2["rejected"], c2["submitted"]) == (c["rejected"] + 1,
                                                 c["submitted"])
    eng2 = _engine(tparams)
    try:
        too_long = type(handed[0])(np.arange(30, dtype=np.int32), 4)
        assert eng2.inject(too_long) is False
        for r in handed:
            assert eng2.inject(r)
        for p, h in zip(p_q, h_queued):
            np.testing.assert_array_equal(h.result(timeout=300),
                                          _ref(jparams, p, 8))
            assert h.status == COMPLETED
        c = eng2.snapshot()["counters"]
        assert (c["submitted"], c["rejected"]) == (2, 1)
    finally:
        assert eng2.close() == []
    eng3 = _engine(tparams)
    with pytest.raises(ValueError, match="hand_back"):
        eng3.close(drain=False, hand_back=True)
    eng3.close()
