"""The serving fleet of the PyTorch port (``paddle_tpu_torch/serving/
fleet``), held against the JAX package's fleet and ``generate()``.

Tiny 2-layer f32 Llama, page 4, as tests/test_fleet.py, weights carried
over from the JAX params. Routing and re-dispatch must be invisible to a
request's math: every greedy stream equals JAX ``generate()`` whatever
replica (or sequence of replicas, across a drain or a kill) served it.
Where a test compares routing with a JAX fleet, both fleets read fresh
summaries and loads on every pick (``health_ttl_s=0``), and every wait
is on a result or an event, never a sleep; counts are compared, never
durations.
"""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import llama as JL
from paddle_tpu.serving import ServingEngine as JEngine
from paddle_tpu.serving.fleet import ServingFleet as JFleet
from paddle_tpu.serving.fleet.router import _rendezvous as j_rendezvous
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import (Request, RequestHandle,
                                      ServingEngine, locktrace)
from paddle_tpu_torch.serving.fleet import (DRAINING, GONE, SERVING,
                                            ServingFleet)
from paddle_tpu_torch.serving.fleet.router import _rendezvous

JCFG = dataclasses.replace(
    JL.LlamaConfig.tiny(dtype=jnp.float32, use_flash_attention=False,
                        remat=False), num_hidden_layers=2)
TCFG = dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32),
                           num_hidden_layers=2)
ENGINE_KW = dict(max_batch=4, page_size=4, max_prompt_len=16,
                 max_new_tokens_cap=16)
V = TCFG.vocab_size


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


_REFS = {}


def _ref(jparams, prompt, n):
    """JAX generate() continuation (prompt stripped), memoized."""
    key = (tuple(int(t) for t in prompt), int(n))
    if key not in _REFS:
        out = _gen_jit(n)(jparams, jnp.asarray(prompt, jnp.int32)[None])
        _REFS[key] = np.asarray(out)[0, len(prompt):]
    return _REFS[key]


def _factory(tparams, engines=None, **kw):
    kw = {**ENGINE_KW, **kw}

    def make():
        eng = ServingEngine(tparams, TCFG, device="cpu", **kw)
        if engines is not None:
            engines.append(eng)
        return eng
    return make


def _fleet(tparams, n=2, engines=None, **fkw):
    ekw = fkw.pop("engine_kw", {})
    return ServingFleet(_factory(tparams, engines, **ekw), replicas=n, **fkw)


def _jfleet(jparams, n=2, **fkw):
    ekw = {**ENGINE_KW, **fkw.pop("engine_kw", {})}
    return JFleet(lambda: JEngine(jparams, JCFG, **ekw), replicas=n, **fkw)


def _record_dispatch(fleet) -> list:
    """Record the replica name each dispatch (submit or re-dispatch)
    chose, in order."""
    names = []
    orig = fleet.router._dispatch

    def rec(req, exclude=()):
        name = orig(req, exclude)
        names.append(name)
        return name
    fleet.router._dispatch = rec
    return names


def _settle(fleet) -> None:
    """Wait for every live replica's tick in flight to end: a handle
    resolves inside the tick, before the tick's counters are in, and the
    tick holds the engine's tick lock to its end."""
    for rep in fleet.replicas():
        eng = rep.engine
        if eng is not None:
            with eng._tick_lock:
                pass


def _arr(rng, n):
    return rng.randint(0, V, (n,)).astype(np.int32)


# ---------------------------------------------------------------------------
# tokens: the fleet serves JAX generate()'s streams
# ---------------------------------------------------------------------------

def test_fleet_matches_jax_generate(tparams, jparams):
    """2 replicas, requests spread by round-robin: every stream equals
    JAX generate() token for token, and both replicas served."""
    rng = np.random.RandomState(0)
    specs = [(_arr(rng, int(rng.randint(2, 12))), int(rng.randint(2, 10)))
             for _ in range(8)]
    with _fleet(tparams, n=2, policy="round_robin") as fleet:
        handles = [fleet.submit(p, m) for p, m in specs]
        outs = [h.result(timeout=120) for h in handles]
    snap = fleet.snapshot()     # closed: the replicas' final snapshots
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    served = {name: h["counters"]["completed"]
              for name, h in snap["replicas"].items()}
    assert sum(served.values()) == len(specs)
    assert all(v > 0 for v in served.values()), served


def test_fleet_lifecycle_and_generations(tparams):
    with _fleet(tparams, n=2) as fleet:
        reps = fleet.replicas()
        assert [r.state for r in reps] == [SERVING, SERVING]
        assert fleet.generation == 2            # one bump per join
        r2 = fleet.join(role="decode")
        assert fleet.generation == 3 and r2.state == SERVING
        assert r2.role == "decode"
        fleet.drain(r2.name)
        assert r2.state == GONE and fleet.generation == 4
        # GONE replicas still answer health() for postmortems
        h = r2.health()
        assert h["state"] == GONE and not h["alive"]
        assert r2.name not in [r.name for r in fleet.router._candidates()]
        assert r2.engine is None and r2.final_snapshot() is not None
    assert all(r.state == GONE for r in fleet.replicas())


# ---------------------------------------------------------------------------
# routing: the same decisions as a JAX fleet
# ---------------------------------------------------------------------------

def test_rendezvous_matches_jax():
    rng = np.random.RandomState(7)
    for _ in range(1000):
        fp = int(rng.randint(0, 2 ** 62, dtype=np.int64)) \
            * int(rng.randint(1, 5))
        name = "r" + str(int(rng.randint(0, 1000))) \
            + "".join(chr(c) for c in rng.randint(33, 127,
                                                  int(rng.randint(0, 6))))
        assert _rendezvous(fp, name) == j_rendezvous(fp, name), (fp, name)


def _session_run(fleet, headers, rng_seed):
    """3 sessions x 4 turns; each turn waits on its replies. Returns the
    dispatch names and the fleet snapshot."""
    rng = np.random.RandomState(rng_seed)
    names = _record_dispatch(fleet)
    for _ in range(4):
        hs = [fleet.submit(np.concatenate([head, _arr(rng, 4)]), 3)
              for head in headers]
        for h in hs:
            h.result(timeout=120)
    _settle(fleet)
    return names, fleet.snapshot()


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_session_routing_matches_jax_fleet(tparams, jparams, policy):
    """Affinity keeps each session on one replica (one cold prefill a
    session) where round-robin scatters them; the replica chosen for
    every request and the router counters equal a JAX fleet's on the
    same request sequence."""
    rng = np.random.RandomState(1)
    headers = [_arr(rng, 8) for _ in range(3)]
    with _fleet(tparams, n=2, policy=policy, health_ttl_s=0) as fleet:
        names, snap = _session_run(fleet, headers, 11)
    with _jfleet(jparams, n=2, policy=policy, health_ttl_s=0) as jfleet:
        jnames, jsnap = _session_run(jfleet, headers, 11)
    assert names == jnames
    assert snap["router"] == jsnap["router"]
    for r in ("r0", "r1"):
        for k in ("completed", "prefix_hits", "prefix_misses"):
            assert snap["replicas"][r]["counters"][k] == \
                jsnap["replicas"][r]["counters"][k], (r, k)
    hits = sum(h["counters"]["prefix_hits"]
               for h in snap["replicas"].values())
    misses = sum(h["counters"]["prefix_misses"]
                 for h in snap["replicas"].values())
    if policy == "affinity":
        assert (hits, misses) == (9, 3)
        assert snap["router"]["routed_affinity"] > 0
        # every session stayed on one replica
        for s in range(3):
            assert len(set(names[s::3])) == 1, names
    else:
        assert misses > 3


def test_consistent_hash_fallback_matches_jax(tparams, jparams):
    """Before a chain is cached anywhere, requests sharing a header agree
    on one replica — the one the JAX router picks."""
    rng = np.random.RandomState(2)
    head = _arr(rng, 8)
    reqs = [np.concatenate([head, _arr(rng, 4)]) for _ in range(5)]
    with _fleet(tparams, n=3, health_ttl_s=0) as fleet:
        router = fleet.router
        picks = [router._pick(Request(p, 2), router._candidates())[0].name
                 for p in reqs]
    with _jfleet(jparams, n=3, health_ttl_s=0) as jfleet:
        from paddle_tpu.serving import Request as JRequest
        jr = jfleet.router
        jpicks = [jr._pick(JRequest(p, 2), jr._candidates())[0].name
                  for p in reqs]
    assert len(set(picks)) == 1, picks
    assert picks == jpicks


def test_role_pools_route_prefill_vs_decode(tparams):
    """Prompt-dominated requests land on the prefill replica,
    decode-dominated ones on the decode replica (each result awaited
    before the next submit)."""
    with _fleet(tparams, n=2, roles=["prefill", "decode"],
                policy="least_loaded", health_ttl_s=0) as fleet:
        reps = {r.role: r for r in fleet.replicas()}
        rng = np.random.RandomState(3)
        fleet.submit(_arr(rng, 14), 2).result(timeout=120)
        fleet.submit(_arr(rng, 2), 12).result(timeout=120)
        _settle(fleet)
        c_pre = reps["prefill"].engine.snapshot()["counters"]
        c_dec = reps["decode"].engine.snapshot()["counters"]
    assert c_pre["completed"] == 1 and c_dec["completed"] == 1
    assert c_pre["tokens_out"] == 2
    assert c_dec["tokens_out"] == 12


# ---------------------------------------------------------------------------
# drain / kill / re-dispatch
# ---------------------------------------------------------------------------

def test_drain_redispatches_queued_and_drops_nothing(tparams, jparams):
    rng = np.random.RandomState(4)
    specs = [(_arr(rng, 4), 12) for _ in range(10)]
    with _fleet(tparams, n=2, policy="round_robin",
                engine_kw=dict(max_batch=2)) as fleet:
        handles = [fleet.submit(p, m) for p, m in specs]
        victim = fleet.replicas()[0]
        handed = fleet.drain(victim.name)
        outs = [h.result(timeout=120) for h in handles]
        snap = fleet.snapshot()
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    assert victim.state == GONE
    # 5 requests round-robined onto a 2-slot replica: some were queued
    assert len(handed) > 0
    assert snap["router"]["redispatched"] == len(handed)
    assert snap["router"]["redispatch_failed"] == 0
    assert snap["fleet"]["handed_back"] == len(handed)


def test_redispatch_is_exactly_once_per_request(tparams):
    rng = np.random.RandomState(5)
    with _fleet(tparams, n=2, policy="round_robin",
                engine_kw=dict(max_batch=1)) as fleet:
        specs = [(_arr(rng, 3), 14) for _ in range(8)]
        handles = [fleet.submit(p, m) for p, m in specs]
        names = [r.name for r in fleet.replicas()]
        fleet.drain(names[0])       # queued -> re-dispatched to names[1]
        fleet.drain(names[1])       # re-dispatch AGAIN -> must fail them
        resolved = 0
        for h in handles:
            try:
                h.result(timeout=120)
                resolved += 1
            except RuntimeError as e:
                assert "re-dispatch" in str(e)
        snap = fleet.snapshot()
    assert resolved + snap["router"]["redispatch_failed"] == len(specs)
    assert snap["router"]["redispatch_failed"] > 0


def test_kill_one_replica_end_to_end(tparams, jparams):
    """2 replicas, 10 requests, one killed mid-traffic: every stream
    equals JAX generate(), nothing fails re-dispatch, and the survivor's
    armed sentinel stays clean."""
    rng = np.random.RandomState(6)
    specs = [(_arr(rng, int(rng.randint(2, 12))), int(rng.randint(4, 14)))
             for _ in range(10)]
    fleet = _fleet(tparams, n=2)
    fleet.arm_sentinels()
    handles, killed = [], {}
    for i, (p, m) in enumerate(specs):
        if i == len(specs) // 2:
            victim = fleet.replicas(SERVING)[0]
            killed["handed"] = len(fleet.kill(victim.name))
            killed["name"] = victim.name
        handles.append(fleet.submit(p, m))
    outs = [h.result(timeout=120) for h in handles]
    snap = fleet.snapshot()
    sentinels = {r.name: r.sentinel_report() for r in fleet.replicas()}
    fleet.close()
    for (p, m), out in zip(specs, outs):
        np.testing.assert_array_equal(out, _ref(jparams, p, m))
    assert snap["replicas"][killed["name"]]["state"] == GONE
    assert snap["router"]["redispatch_failed"] == 0
    assert snap["fleet"]["kills"] == 1
    survivor = [n for n in sentinels if n != killed["name"]]
    assert survivor and all(sentinels[n]["clean"] and sentinels[n]["armed"]
                            for n in survivor), sentinels


# ---------------------------------------------------------------------------
# aggregated observability
# ---------------------------------------------------------------------------

_COMPARED = ("submitted", "admitted", "completed", "rejected",
             "tokens_out", "prefills", "prefix_hits", "prefix_misses",
             "handed_back")


def _scrape(fleet):
    fleet.generate(np.asarray([1, 2, 3], np.int32), 4)
    _settle(fleet)
    return fleet.expose(), fleet.flight_view()


def _samples(text) -> dict:
    out = {}
    for ln in text.splitlines():
        if ln and not ln.startswith("#"):
            name, _, val = ln.rpartition(" ")
            out[name] = float(val)
    return out


def test_fleet_expose_single_scrape_matches_jax(tparams, jparams):
    with _fleet(tparams, n=2, health_ttl_s=0) as fleet:
        text, view = _scrape(fleet)
    with _jfleet(jparams, n=2, health_ttl_s=0) as jfleet:
        jtext, _ = _scrape(jfleet)
    lines = text.splitlines()
    types = [ln for ln in lines if ln.startswith("# TYPE")]
    assert len(types) == len(set(types))
    for r in ("r0", "r1"):
        assert any(f'replica="{r}"' in ln and "_submitted_total" in ln
                   for ln in lines)
    assert any(ln.startswith("paddle_serving_fleet_generation ")
               for ln in lines)
    got, want = _samples(text), _samples(jtext)
    fleet_level = [k for k in want if k.startswith(
        ("paddle_serving_fleet_", "paddle_serving_router_"))]
    assert fleet_level
    per_replica = [k for k in want
                   if any(f"paddle_serving_{c}_total{{" in k
                          for c in _COMPARED)]
    assert len(per_replica) == 2 * len(_COMPARED)
    for k in fleet_level + per_replica:
        assert got[k] == want[k], (k, got.get(k), want[k])
    assert set(view) == {"r0", "r1"}
    assert all("ticks" in v and v["state"] == SERVING
               for v in view.values())
    assert sum(len(v["ticks"]) for v in view.values()) >= 1


def test_replica_health_feeds_router_load(tparams):
    with _fleet(tparams, n=2) as fleet:
        rep = fleet.replicas()[0]
        h = rep.health()
        assert h["alive"] and h["state"] == SERVING
        assert "gauges" in h and "free_pages" in h["gauges"]
        assert rep.load() < float("inf")
        rep.state = DRAINING        # never a routing candidate
        assert rep.load() == float("inf")
        assert not rep.serving
        rep.state = SERVING


# ---------------------------------------------------------------------------
# prefill -> decode handoff
# ---------------------------------------------------------------------------

def _migration_event(fleet, n: int) -> threading.Event:
    """An event set once ``n`` chains were handed off."""
    ev = threading.Event()
    orig = fleet.router.note_migration

    def note(fps, name):
        orig(fps, name)
        if fleet.counters["migrations"] >= n:   # counted before the note
            ev.set()
    fleet.router.note_migration = note
    return ev


def test_prefill_to_decode_handoff(tparams, jparams):
    """Turn 1 (prompt-heavy) is served by the prefill replica; its chain
    migrates to the decode replica; turn 2 (decode-heavy) routes there by
    the migration record, attaches the whole chain and decodes JAX
    generate()'s tokens."""
    rng = np.random.RandomState(8)
    first = _arr(rng, 12)                       # 3 pages of 4
    with _fleet(tparams, n=2, roles=["prefill", "decode"],
                prefill_len_ratio=2.0, health_ttl_s=0) as fleet:
        assert fleet.auto_migrate
        ev = _migration_event(fleet, 1)
        reps = {r.role: r for r in fleet.replicas()}
        out1 = fleet.submit(first, 4).result(timeout=120)
        assert ev.wait(60)
        assert fleet.counters["migrations"] == 1
        assert fleet.counters["migration_failed"] == 0
        turn2 = np.concatenate([first, out1, _arr(rng, 2)])[:15]
        c0 = reps["decode"].engine.snapshot()["counters"]
        out2 = fleet.submit(turn2, 12).result(timeout=120)
        _settle(fleet)
        c1 = reps["decode"].engine.snapshot()["counters"]
        assert fleet.router.counters["routed_migrated"] == 1
        assert c1["completed"] - c0["completed"] == 1
        assert c1["prefix_hit_tokens"] - c0["prefix_hit_tokens"] == 12
        assert reps["decode"].engine.audit() == []
        assert reps["prefill"].engine.audit() == []
    np.testing.assert_array_equal(out1, _ref(jparams, first, 4))
    np.testing.assert_array_equal(out2, _ref(jparams, turn2, 12))


# ---------------------------------------------------------------------------
# the fleet under the schedule fuzzer
# ---------------------------------------------------------------------------

def _corrupt(eng) -> None:
    """The seeded invariant error of the JAX postmortem test: a cached
    node's refcount drifts, so the next tick's audit fails the engine."""
    with eng._tick_lock:
        nodes = eng.prefix_cache.nodes()
        assert nodes
        nodes[0].refs += 3


def _fuzz_run(tparams, jparams, flight_dir, scenario, seed):
    """One seeded run; returns the fleet's counters after close."""
    rng = np.random.RandomState(9)
    prompts = [_arr(rng, int(rng.randint(5, 13))) for _ in range(10)]
    new = 4
    engines = []
    tr = locktrace.enable(fuzzer=locktrace.ScheduleFuzzer(seed))
    try:
        roles = (["prefill", "decode", "decode"]
                 if scenario == "migrate" else None)
        fleet = _fleet(tparams, n=3, engines=engines, roles=roles,
                       policy="least_loaded", prefill_len_ratio=0.1,
                       engine_kw=dict(flight_dir=flight_dir))
        if scenario == "crash":
            # r1 caches a chain first, so there is a refcount to corrupt
            primer = Request(prompts[0], new)
            assert fleet.replica("r1").inject(primer)
            RequestHandle(primer).result(timeout=120)
        results = [None] * len(prompts)

        def submitter(lo, hi):
            for j in range(lo, hi):
                locktrace.fuzz_point("fuzz.submit")
                try:
                    results[j] = fleet.submit(prompts[j], new)
                except RuntimeError as e:
                    results[j] = e
        half = len(prompts) // 2
        ts = [threading.Thread(target=submitter, args=(0, half)),
              threading.Thread(target=submitter, args=(half, len(prompts)))]
        for t in ts:
            t.start()
        # the disturbance runs concurrently with the submitters
        if scenario == "drain":
            fleet.drain("r1")
        elif scenario == "crash":
            _corrupt(engines[1])
            victim = Request(prompts[1], new)     # r1 ticks at least once
            if fleet.replica("r1").inject(victim):
                with pytest.raises(Exception, match="invariant"):
                    RequestHandle(victim).result(timeout=120)
            assert fleet.reap() == ["r1"]
        elif scenario == "migrate" and seed % 2:
            locktrace.fuzz_point("fuzz.drain-decode")
            fleet.drain("r2")
        for t in ts:
            t.join()
        completed = []
        for j, r in enumerate(results):
            assert r is not None and not isinstance(r, Exception), (j, r)
            try:
                toks = r.result(timeout=120)    # a hang raises TimeoutError
            except TimeoutError:
                raise
            except Exception as e:
                # the fail-fast contract of a crashed engine only
                assert scenario == "crash" and "invariant" in str(e), e
                continue
            np.testing.assert_array_equal(toks,
                                          _ref(jparams, prompts[j], new))
            completed.append(r.id)
        for t in threading.enumerate():       # the handoffs in flight
            if t.name.startswith("migrate-"):
                t.join()
        if scenario != "crash":
            assert len(completed) == len(prompts)
        for rep in fleet.replicas(SERVING):
            assert rep.engine.audit() == [], rep.name
        fleet.close()
        # after close: a retirement's "request" span follows its handle's
        # resolution on the engine's worker, which close() joins
        served = [sp.args["req"] for e in engines for sp in e.tracer.spans()
                  if sp.name == "request" and sp.args["state"] == "completed"]
        assert len(served) == len(set(served)), "a request served twice"
        assert set(completed) <= set(served)
    finally:
        locktrace.disable()
    assert tr.inversions == [], tr.inversions
    return dict(fleet.counters), dict(fleet.router.counters)


@pytest.mark.parametrize("scenario", ["drain", "crash", "migrate"])
def test_fleet_under_schedule_fuzzer(tparams, jparams, tmp_path, scenario):
    """The port's real fleet and engines under the port's ScheduleFuzzer,
    3 seeds a scenario, two threads submitting while the disturbance
    runs: a drain of r1; a seeded invariant error in r1, then ``reap()``;
    the prefill->decode handoff, odd seeds draining a decode replica.
    Every handle resolves (no hang); completed streams equal JAX
    generate(); no request completes on two engines; every survivor's
    audit is clean; the lock tracer sees no order inversion."""
    for seed in range(3):
        fc, rc = _fuzz_run(tparams, jparams, str(tmp_path), scenario, seed)
        if scenario == "drain":
            assert rc["redispatch_failed"] == 0
            assert fc["drains"] == 1
        if scenario == "crash":
            assert fc["kills"] == 1
        if scenario == "migrate":
            assert fc["migration_failed"] == 0
            if seed % 2 == 0:
                assert fc["migrations"] > 0
