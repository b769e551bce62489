"""The static concurrency analysis of the PyTorch port
(``paddle_tpu_torch/analysis/concurrency.py``), held against the JAX
package's ``paddle_tpu/analysis/concurrency.py``.

* Parity: on the same sources (the synthetic classes of
  tests/test_concurrency_lint.py, the demo sources, the JAX serving
  tree and the port's serving tree, each read as text) both analyses
  return the same result: findings (rule, path, line, message naming
  the attribute), suppressions, annotations, lock inventory and
  lock-order edges.
* The port's serving tree (``fleet/proc/`` included) scans clean:
  no CC001 / CC003 / CC004, every annotation with its reason, and the
  lock-order edges pinned below.
* Mutation: a removed lock acquisition in the port's router trips
  CC001; the demo counter passes clean and fails mutated, statically
  and under the schedule fuzzer; the seeded inversion trips the static
  cycle check and the runtime tracer.
* The fleet fuzzer passes over the port's ServingFleet / FleetRouter /
  Replica for the drain, crash and migrate protocols.
* The one fault the lint found in the port's tree (the adopt paths
  read the KV pools outside the tick lock, where the JAX engine reads
  them under it) stays fixed.
"""
import dataclasses
import textwrap
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from paddle_tpu.analysis import concurrency as jcc
from paddle_tpu_torch.analysis import concurrency as cc
from paddle_tpu_torch.models import llama as TL
from paddle_tpu_torch.serving import ServingEngine, locktrace
from paddle_tpu_torch.serving.prefix_cache import prefix_fingerprints

REPO = Path(__file__).resolve().parents[1]


def _method(code):
    """Indent a dedented snippet to GUARDED's method level."""
    return "\n" + textwrap.indent(textwrap.dedent(code), " " * 8)


# the synthetic classes of tests/test_concurrency_lint.py
GUARDED = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []
            self._worker = threading.Thread(
                target=self._loop, name="box", daemon=True)

        def _loop(self):
            while True:
                with self._lock:
                    self._items.append(1)

        def drain(self):
            with self._lock:
                out, self._items = self._items, []
            return out
"""
_LOCKED_DRAIN = ("            with self._lock:\n"
                 "                out, self._items = self._items, []\n")
_ANNOTATED = GUARDED.replace(
    "    class Box:",
    '    class Box:\n'
    '        _CC_LOCK_FREE_READS = {"_items": "snapshot readers"}')
_HOOK = _method("""
    def set_hook(self, trie):
        trie.on_evict = self._on_evict

    def _on_evict(self):
        self._items.pop()
""")
SYNTHETIC = {
    "clean": GUARDED,
    "lock_free_write": GUARDED.replace(
        _LOCKED_DRAIN, "            out, self._items = self._items, []\n"),
    "lock_free_read": GUARDED + _method("""
        def peek(self):
            return len(self._items)
    """),
    "noqa_reason": GUARDED.replace(
        _LOCKED_DRAIN, "            out, self._items = self._items, []  "
        "# noqa: CC001(worker joined before drain)\n"),
    "noqa_no_reason": GUARDED.replace(
        _LOCKED_DRAIN, "            out, self._items = self._items, []  "
        "# noqa: CC001\n"),
    "lock_free_reads_read": _ANNOTATED + _method("""
        def peek(self):
            return len(self._items)
    """),
    "lock_free_reads_write": _ANNOTATED + _method("""
        def clobber(self):
            self._items = []
    """),
    "hook_unannotated": GUARDED + _HOOK,
    "hook_requires": GUARDED.replace(
        "    class Box:",
        '    class Box:\n'
        '        _CC_REQUIRES = {"_on_evict": ["_lock", "trie hook"]}')
    + _HOOK,
}


def _both(items):
    """Both packages' ``analyze_sources`` on the same items."""
    return jcc.analyze_sources(items), cc.analyze_sources(items)


def _read_tree(root: Path):
    return [(str(p.relative_to(REPO)), p.read_text())
            for p in sorted(root.rglob("*.py"))]


# ---------------------------------------------------------------------------
# parity with the JAX analysis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_synthetic_findings_equal_jax(name):
    src = textwrap.dedent(SYNTHETIC[name])
    want, got = _both([("synthetic.py", src)])
    assert got == want
    # the cases mean what their names say
    rules = got["by_rule"]
    expect = {"clean": (0, 0), "lock_free_write": (1, 0),
              "lock_free_read": (1, 0), "noqa_reason": (0, 0),
              "noqa_no_reason": (0, 1), "lock_free_reads_read": (0, 0),
              "lock_free_reads_write": (1, 0), "hook_unannotated": (1, 0),
              "hook_requires": (0, 0)}[name]
    assert (min(rules["CC001"], 1), rules["CC004"]) == expect, got


@pytest.mark.parametrize("which", ["counter", "counter_mutated", "order"])
def test_demo_findings_equal_jax(which):
    port_src, jax_src = {
        "counter": (cc.DEMO_COUNTER_SRC, jcc.DEMO_COUNTER_SRC),
        "counter_mutated": (
            cc.mutate_remove_with(cc.DEMO_COUNTER_SRC, method="add"),
            jcc.mutate_remove_with(jcc.DEMO_COUNTER_SRC, method="add")),
        "order": (cc.DEMO_ORDER_SRC, jcc.DEMO_ORDER_SRC)}[which]
    # the demos differ only in the package their import line names
    assert port_src.replace("paddle_tpu_torch.", "paddle_tpu.") == jax_src
    items = [("demo.py", port_src)]
    assert cc.analyze_sources(items) == jcc.analyze_sources(items)


@pytest.mark.parametrize("tree", ["paddle_tpu/serving",
                                  "paddle_tpu_torch/serving"])
def test_serving_tree_findings_equal_jax(tree):
    items = _read_tree(REPO / tree)
    assert len(items) >= 10
    want, got = _both(items)
    assert got == want
    assert got["lock_order"]["edges"]        # the comparison saw edges


def test_mutation_helper_equals_jax():
    src = (REPO / "paddle_tpu_torch/serving/fleet/router.py").read_text()
    for method, nth in (("note_migration", 0), (None, 0), (None, 3)):
        assert cc.mutate_remove_with(src, method, nth) == \
            jcc.mutate_remove_with(src, method, nth)


# ---------------------------------------------------------------------------
# the port's serving tree scans clean
# ---------------------------------------------------------------------------

PORT_EDGES = [
    ("ServingEngine._tick_lock", "Scheduler._lock"),
    ("ServingEngine._tick_lock", "ServingMetrics._lock"),
]


def test_port_serving_tree_scans_clean():
    res = cc.check_tree()
    assert res["files"] == len(_read_tree(REPO / "paddle_tpu_torch/serving"))
    assert any("fleet/proc/" in s["path"] for s in res["lock_free_reads"])
    assert res["findings"] == [], res["findings"]
    assert res["errors"] == 0
    assert res["by_rule"]["CC001"] == res["by_rule"]["CC003"] == \
        res["by_rule"]["CC004"] == 0
    # every suppression and every annotation carries its reason
    for s in res["suppressed"] + res["lock_free_reads"] + res["requires"]:
        assert s["reason"], s
    for role in ("ServingEngine._tick_lock", "Scheduler._lock",
                 "ServingFleet._lock", "FleetRouter._lock",
                 "Replica._lock", "ProcReplica._lock",
                 "ProcServingFleet._lock", "WorkerTransport._lock",
                 "ServingMetrics._lock"):
        assert role in res["locks"], sorted(res["locks"])


def test_port_lock_order_edges():
    res = cc.check_tree()
    assert res["lock_order"]["cycles"] == []
    edges = [(a, b) for a, b, _p, _ln in res["lock_order"]["edges"]]
    assert edges == PORT_EDGES


def test_port_annotations_mirror_jax():
    """The port carries the JAX tree's sanctioned lock-free reads,
    caller-must-hold contracts and suppressions, with their reasons."""
    port = cc.check_tree()
    jres = jcc.check_tree()

    def lfr(res):
        return {(d["class"], d["attr"]): d["reason"]
                for d in res["lock_free_reads"]}

    def sup(res):
        return sorted((s["rule"], s["reason"]) for s in res["suppressed"])
    assert lfr(port) == lfr(jres)
    assert [(r["class"], r["method"], r["lock"], r["reason"])
            for r in port["requires"]] == \
        [(r["class"], r["method"], r["lock"], r["reason"])
         for r in jres["requires"]]
    assert sup(port) == sup(jres)


# ---------------------------------------------------------------------------
# mutation: caught statically and dynamically
# ---------------------------------------------------------------------------

def test_mutated_port_router_trips_static_pass():
    path = "paddle_tpu_torch/serving/fleet/router.py"
    mutated = cc.mutate_remove_with((REPO / path).read_text(),
                                    method="note_migration")
    res = cc.analyze_source(mutated, path)
    assert any(f["rule"] == "CC001" and "_migrated" in f["message"]
               for f in res["findings"]), res["findings"]


def test_mutated_port_proc_replica_trips_static_pass():
    path = "paddle_tpu_torch/serving/fleet/proc/replica.py"
    # inject's second acquisition: the registration of the outstanding
    # request (the first guards lock-free-read state only)
    mutated = cc.mutate_remove_with((REPO / path).read_text(),
                                    method="inject", nth=1)
    res = cc.analyze_source(mutated, path)
    assert any(f["rule"] == "CC001" and "_outstanding" in f["message"]
               for f in res["findings"]), res["findings"]


def test_mutate_remove_with_raises_when_no_acquire():
    with pytest.raises(ValueError):
        cc.mutate_remove_with("class A:\n    def f(self):\n        pass\n",
                              method="f")


def test_demo_counter_clean_and_mutated():
    for seed in range(5):
        r = cc.run_counter_demo(cc.DEMO_COUNTER_SRC, seed)
        assert r["ok"], r
    mutated = cc.mutate_remove_with(cc.DEMO_COUNTER_SRC, method="add")
    assert cc.analyze_source(mutated, "demo_counter.py")["by_rule"][
        "CC001"] >= 1
    assert any(not cc.run_counter_demo(mutated, seed)["ok"]
               for seed in range(20)), \
        "fuzzer failed to surface the removed-lock race in 20 seeds"


def test_seeded_inversion_caught_statically_and_at_runtime():
    res = cc.analyze_source(cc.DEMO_ORDER_SRC, "demo_order.py")
    assert res["by_rule"]["CC003"] >= 1
    assert ["DemoPair._a", "DemoPair._b"] in res["lock_order"]["cycles"]
    rep = cc.run_order_demo(cc.DEMO_ORDER_SRC)
    assert rep["inversions"], rep
    inv = rep["inversions"][0]
    assert {inv["held"], inv["acquiring"]} == {"DemoPair._a", "DemoPair._b"}


# ---------------------------------------------------------------------------
# fleet protocol fuzzing over the port's fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scenario", ["drain", "crash", "migrate"])
def test_fuzz_port_fleet_protocols_across_seeds(scenario):
    for seed in range(7):
        r = cc.fuzz_fleet_scenario(seed, scenario=scenario)
        assert r["ok"], (scenario, seed, r["failures"])
        assert r["completed"] >= 1


def test_fuzz_port_fleet_migration_observes_migrations():
    r = cc.fuzz_fleet_scenario(0, scenario="migrate")
    assert r["ok"], r["failures"]
    assert r["fleet"]["migrations"] > 0


# ---------------------------------------------------------------------------
# the fault the lint found: the adopt paths read the pools unlocked
# ---------------------------------------------------------------------------

TCFG = dataclasses.replace(TL.LlamaConfig.tiny(dtype=torch.float32),
                           num_hidden_layers=2)
ENGINE_KW = dict(max_batch=4, page_size=4, max_prompt_len=16,
                 max_new_tokens_cap=16)
HEADER = list(range(1, 9))              # 8 tokens = 2 full pages


def test_adopt_paths_read_the_pools_under_the_tick_lock():
    """The KV pools are rebound by every tick; the JAX engine reads them
    only under the tick lock, and so must the port's adopt_chain and
    adopt_chain_chunk (CC001 on ``_kp``/``_vp`` before the fix). Every
    read of a pool on this thread while the probe watches must find the
    tick lock held BY this thread (the lock tracer's per-thread
    stack)."""
    tr = locktrace.enable()
    unlocked, watch = [], [False]

    class Probe(ServingEngine):
        def __getattribute__(self, name):
            if name in ("_kp", "_vp") and watch[0] and \
                    threading.current_thread() is threading.main_thread():
                held = [n for n, _ in tr._stack()]
                if "ServingEngine._tick_lock" not in held:
                    unlocked.append(name)
            return object.__getattribute__(self, name)
    try:
        params = TL.init_params(TCFG, torch.Generator().manual_seed(0),
                                device="cpu")
        src = ServingEngine(params, TCFG, device="cpu", **ENGINE_KW)
        dst = Probe(params, TCFG, device="cpu", **ENGINE_KW)
        dst2 = Probe(params, TCFG, device="cpu", **ENGINE_KW)
        try:
            src.generate(HEADER + [50, 51, 52], 4)
            fp = int(prefix_fingerprints(
                np.asarray(HEADER + [50, 51, 52], np.int32), 4, 8)[-1])
            blob = src.export_chain(fp)
            hdr = src.export_chain_begin(fp)
            watch[0] = True
            assert dst.adopt_chain(blob) == {"matched_pages": 0,
                                             "adopted_pages": 2}
            st = dst2.adopt_chain_begin(hdr)
            for i in range(2):
                ch = src.export_chain_chunk(hdr["xid"], i, 1)
                dst2.adopt_chain_chunk(st["aid"], ch["start"], ch["k"],
                                       ch["v"])
            assert dst2.adopt_chain_commit(st["aid"])["adopted_pages"] == 2
            watch[0] = False
            src.export_chain_end(hdr["xid"])
        finally:
            for e in (src, dst, dst2):
                e.close()
    finally:
        locktrace.disable()
    assert unlocked == [], unlocked
