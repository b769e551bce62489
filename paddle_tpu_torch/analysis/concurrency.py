"""Concurrency analysis for the threaded serving stack.

Port of ``paddle_tpu/analysis/concurrency.py``; on the same sources its
findings and lock-order edges equal the JAX module's. Three cooperating
layers:

1. **Static guarded-by lint** (CC001): per-class AST pass over
   ``paddle_tpu_torch/serving/`` (``fleet/proc/`` included) that
   discovers every ``threading.Lock`` / ``RLock`` attribute (seen
   through the :func:`~paddle_tpu_torch.serving.locktrace.wrap_lock`
   construction hook), computes which ``self.*``
   attributes are accessed under ``with self._lock`` vs. outside it,
   and errors on accesses reachable from a thread-entry function
   (``Thread(target=...)``, RPC pump callbacks, public API methods)
   that bypass the inferred owning lock. Justified lock-free reads are
   sanctioned per-line (``# noqa: CC001(reason)``) or per-attribute
   (class-level ``_CC_LOCK_FREE_READS = {"attr": "reason"}`` — reads
   only; writes still flag).
2. **Static lock-order analysis** (CC003): the acquisition graph —
   which lock ROLES (``"ServingEngine._tick_lock"``) are taken while
   which are held, across classes via ``self.attr = KnownClass(...)``
   attribute types — with cycles (and plain-``Lock`` re-acquisition)
   reported as deadlocks. The runtime twin lives in
   ``paddle_tpu_torch/serving/locktrace.py`` (:class:`LockTracer`).
3. **Deterministic interleaving fuzzer**: seeded schedule
   perturbation replaying the fleet drain / crash / migration
   protocols against the port's REAL fleet/router/replica code with a
   stdlib fake engine, asserting exactly-once / zero-drop / bitwise
   invariants under every seed (:func:`fuzz_fleet_scenario`).

Every rule is mutation-tested: :func:`mutate_remove_with` deletes a
real lock acquisition on a COPY of the source, and the tests assert
the static pass and the fuzzer both catch it.

Scope and honest limits: the guarded-by
pass is per-class (``self.*`` state only — cross-object accesses like
``rep.engine.x`` are the callee class's problem), module-level and
function-local locks (``transport._spawn_lock``, worker relay ``reg``)
are out of scope, and ``threading.Condition`` attributes are treated
as thread-safe primitives rather than locks (their mutex cannot be
wrapped or modelled without tracking ``wait()`` release semantics).

Module-level imports are stdlib-only (no torch); the fuzz harness
imports the serving fleet lazily inside the function. CC002 (named,
daemon threads) is a source-lint rule of the JAX package and is listed
in ``RULES`` for the shared rule table only.
"""
from __future__ import annotations

import ast
import os
import re
import threading
import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

__all__ = [
    "RULES", "analyze_source", "analyze_sources", "analyze_tree",
    "check_tree", "mutate_remove_with",
    "DEMO_COUNTER_SRC", "DEMO_ORDER_SRC",
    "run_counter_demo", "run_order_demo", "fuzz_fleet_scenario",
]

RULES = {
    "CC001": "lock-free access to a lock-guarded attribute",
    "CC002": "threading.Thread(...) must pass name= and daemon= "
             "(enforced by source_lint)",
    "CC003": "lock acquisition-order cycle",
    "CC004": "CC-series noqa without a justification",
}

_NOQA_CC = re.compile(r"#\s*noqa:\s*(CC\d{3})\s*(?:\(([^)]*)\))?")
_LOCK_CTORS = {"Lock", "RLock"}
# Thread-safe primitives: attributes built from these ctors are never
# guarded-by candidates (they synchronize themselves).
_SAFE_CTORS = {"Event", "Condition", "Semaphore", "BoundedSemaphore",
               "Barrier", "local", "Queue", "SimpleQueue", "LifoQueue",
               "PriorityQueue", "count"}
# self.ATTR.m(...) with m here counts as a WRITE of ATTR.
_MUTATORS = {"append", "appendleft", "add", "extend", "insert", "pop",
             "popleft", "popitem", "remove", "discard", "clear",
             "update", "setdefault", "sort", "reverse"}


# ===================================================================
# data model
# ===================================================================

@dataclass
class _Access:
    attr: str
    kind: str               # "read" | "write"
    line: int
    held: FrozenSet[str]    # lexically held lock attrs at the access


@dataclass
class _MethodInfo:
    name: str
    entry: bool = False     # thread entry / stored callback
    public: bool = False
    accesses: List[_Access] = field(default_factory=list)
    # (callee_method, lexical_held, line)
    self_calls: List[Tuple[str, FrozenSet[str], int]] = \
        field(default_factory=list)
    # (self_attr, method, lexical_held, line)
    attr_calls: List[Tuple[str, str, FrozenSet[str], int]] = \
        field(default_factory=list)
    # (lock_attr, lexical_held_before, line)
    acquires: List[Tuple[str, FrozenSet[str], int]] = \
        field(default_factory=list)


@dataclass
class _ClassInfo:
    name: str
    path: str
    line: int
    method_names: Set[str] = field(default_factory=set)
    locks: Dict[str, str] = field(default_factory=dict)    # attr->kind
    safe: Set[str] = field(default_factory=set)
    attr_ctor: Dict[str, str] = field(default_factory=dict)
    lock_free_reads: Dict[str, str] = field(default_factory=dict)
    # method -> (lock_attr, reason): caller-must-hold contracts the
    # entry detector cannot see (e.g. a callback the callee only
    # fires while holding the lock)
    requires: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    entries: Set[str] = field(default_factory=set)
    methods: Dict[str, _MethodInfo] = field(default_factory=dict)


def _self_attr(node) -> Optional[str]:
    """``self.X`` -> ``"X"`` (one level only), else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _call_names(value: ast.AST) -> List[str]:
    out = []
    for n in ast.walk(value):
        if isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Attribute):
                out.append(f.attr)
            elif isinstance(f, ast.Name):
                out.append(f.id)
    return out


# ===================================================================
# per-method scanner
# ===================================================================

class _Scan:
    """Recursive statement walker carrying the lexically-held lock
    set. One instance per (real or synthetic) method."""

    def __init__(self, ci: _ClassInfo, mname: str, record: bool):
        self.ci = ci
        self.mi = ci.methods[mname]
        self.record = record
        # shared across a real method and its nested synthetics so a
        # later ``Thread(target=_go)`` resolves the local fn name
        self.entry_locals: Set[str] = set()
        self.local_fns: Dict[str, str] = {}

    def run(self, body: List[ast.stmt]) -> None:
        for s in body:
            self.stmt(s, frozenset())
        for nm in self.entry_locals:
            syn = self.local_fns.get(nm)
            if syn and syn in self.ci.methods:
                self.ci.methods[syn].entry = True

    # ----------------------------------------------------- statements
    def stmt(self, node: ast.stmt, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            new = set(held)
            for item in node.items:
                lk = _self_attr(item.context_expr)
                if lk is not None and lk in self.ci.locks:
                    if self.record:
                        self.mi.acquires.append(
                            (lk, frozenset(held),
                             item.context_expr.lineno))
                    new.add(lk)
                else:
                    self.expr(item.context_expr, held)
                if item.optional_vars is not None:
                    self._write(item.optional_vars, held)
            for s in node.body:
                self.stmt(s, frozenset(new))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            syn = f"{self.mi.name}.<{node.name}>"
            self.ci.methods[syn] = _MethodInfo(name=syn)
            sub = _Scan(self.ci, syn, True)
            sub.entry_locals = self.entry_locals
            sub.local_fns = self.local_fns
            self.local_fns[node.name] = syn
            for s in node.body:
                sub.stmt(s, frozenset())
            for d in node.decorator_list:
                self.expr(d, held)
        elif isinstance(node, ast.Assign):
            if isinstance(node.value, ast.Lambda) and any(
                    isinstance(t, (ast.Attribute, ast.Subscript))
                    for t in node.targets):
                # lambda stored on an object: deferred callback — runs
                # on some other thread with NO locks held
                self._synthetic_lambda(node.value, entry=True)
            else:
                self.expr(node.value, held)
            for t in node.targets:
                self._write(t, held)
        elif isinstance(node, ast.AugAssign):
            self.expr(node.value, held)
            self._write(node.target, held, also_read=True)
        elif isinstance(node, ast.AnnAssign):
            if node.value is not None:
                self.expr(node.value, held)
                self._write(node.target, held)
        else:
            self._generic(node, held)

    def _generic(self, node: ast.AST, held: FrozenSet[str]) -> None:
        for ch in ast.iter_child_nodes(node):
            self._dispatch(ch, held)

    def _dispatch(self, ch: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(ch, ast.stmt):
            self.stmt(ch, held)
        elif isinstance(ch, ast.expr):
            self.expr(ch, held)
        else:   # ExceptHandler, comprehension, keyword, withitem, ...
            self._generic(ch, held)

    # ---------------------------------------------------- expressions
    def expr(self, node: Optional[ast.AST],
             held: FrozenSet[str]) -> None:
        if node is None:
            return
        if isinstance(node, ast.Call):
            self._call(node, held)
            return
        if isinstance(node, ast.Attribute):
            x = _self_attr(node)
            if x is not None:
                if x in self.ci.method_names:
                    # bare ``self.m`` reference: callback entry AND a
                    # potential call site with the current held set
                    self.ci.entries.add(x)
                    if self.record:
                        self.mi.self_calls.append(
                            (x, frozenset(held), node.lineno))
                else:
                    kind = "write" if isinstance(node.ctx, ast.Store) \
                        else "read"
                    self._access(x, kind, node.lineno, held)
                return
            self.expr(node.value, held)
            return
        if isinstance(node, ast.Lambda):
            # inline lambda (sort key, map fn): assume immediate call
            # under the current held set; STORED lambdas are routed to
            # _synthetic_lambda by the Assign/keyword handlers
            self.expr(node.body, held)
            return
        self._generic(node, held)

    def _call(self, node: ast.Call, held: FrozenSet[str]) -> None:
        f = node.func
        fname = f.attr if isinstance(f, ast.Attribute) else (
            f.id if isinstance(f, ast.Name) else "")
        if fname == "Thread":
            for kw in node.keywords:
                if kw.arg == "target":
                    t = _self_attr(kw.value)
                    if t is not None and t in self.ci.method_names:
                        self.ci.entries.add(t)
                    elif isinstance(kw.value, ast.Name):
                        self.entry_locals.add(kw.value.id)
        handled_func = False
        if isinstance(f, ast.Attribute):
            base = f.value
            if isinstance(base, ast.Name) and base.id == "self":
                if f.attr in self.ci.method_names:
                    if self.record:
                        self.mi.self_calls.append(
                            (f.attr, frozenset(held), node.lineno))
                else:
                    # calling a stored callback / data attribute
                    self._access(f.attr, "read", node.lineno, held)
                handled_func = True
            else:
                a = _self_attr(base)
                if a is not None:
                    if a in self.ci.locks or a in self.ci.safe:
                        pass    # self._cond.notify() / queue.put(...)
                    else:
                        kind = "write" if f.attr in _MUTATORS \
                            else "read"
                        self._access(a, kind, node.lineno, held)
                        if self.record:
                            self.mi.attr_calls.append(
                                (a, f.attr, frozenset(held),
                                 node.lineno))
                    handled_func = True
        if not handled_func:
            self.expr(f, held)
        for arg in node.args:
            self.expr(arg, held)
        for kw in node.keywords:
            if isinstance(kw.value, ast.Lambda) and kw.arg and (
                    kw.arg == "target" or kw.arg.startswith("on_")):
                self._synthetic_lambda(kw.value, entry=True)
            else:
                self.expr(kw.value, held)

    def _synthetic_lambda(self, lam: ast.Lambda, entry: bool) -> None:
        syn = f"{self.mi.name}.<lambda@{lam.lineno}>"
        while syn in self.ci.methods:
            syn += "'"
        self.ci.methods[syn] = _MethodInfo(name=syn, entry=entry)
        sub = _Scan(self.ci, syn, True)
        sub.entry_locals = self.entry_locals
        sub.local_fns = self.local_fns
        sub.expr(lam.body, frozenset())

    # ------------------------------------------------------- accesses
    def _access(self, x: str, kind: str, line: int,
                held: FrozenSet[str]) -> None:
        if not self.record:
            return
        if x in self.ci.locks or x in self.ci.safe or \
                x in self.ci.method_names:
            return
        self.mi.accesses.append(_Access(x, kind, line, frozenset(held)))

    def _root_self_attr(self, node: ast.AST,
                        held: FrozenSet[str]) -> Optional[str]:
        """Root attr of ``self.X[...].y`` chains; scans subscript
        indices as reads along the way."""
        prev: Optional[ast.Attribute] = None
        cur = node
        while True:
            if isinstance(cur, ast.Subscript):
                self.expr(cur.slice, held)
                cur = cur.value
            elif isinstance(cur, ast.Attribute):
                prev = cur
                cur = cur.value
            else:
                break
        if isinstance(cur, ast.Name) and cur.id == "self" and \
                prev is not None:
            return prev.attr
        return None

    def _write(self, t: ast.AST, held: FrozenSet[str],
               also_read: bool = False) -> None:
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                self._write(e, held, also_read)
            return
        if isinstance(t, ast.Starred):
            self._write(t.value, held, also_read)
            return
        if isinstance(t, (ast.Attribute, ast.Subscript)):
            x = self._root_self_attr(t, held)
            if x is not None:
                if also_read:
                    self._access(x, "read", t.lineno, held)
                self._access(x, "write", t.lineno, held)
            else:
                # non-self target (obj.attr = .., d[k] = ..): reads
                if isinstance(t, ast.Subscript):
                    self.expr(t.value, held)
                    self.expr(t.slice, held)
                else:
                    self.expr(t.value, held)
        # bare Name targets are locals: ignored


# ===================================================================
# per-class scan
# ===================================================================

def _scan_class(node: ast.ClassDef, path: str) -> _ClassInfo:
    ci = _ClassInfo(name=node.name, path=path, line=node.lineno)
    # pass 1: method names, lock/safe/typed attrs, declarations
    for item in node.body:
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            ci.method_names.add(item.name)
        elif isinstance(item, ast.Assign):
            for t in item.targets:
                if isinstance(t, ast.Name) and \
                        t.id == "_CC_LOCK_FREE_READS" and \
                        isinstance(item.value, ast.Dict):
                    for k, v in zip(item.value.keys,
                                    item.value.values):
                        if isinstance(k, ast.Constant) and \
                                isinstance(v, ast.Constant):
                            ci.lock_free_reads[str(k.value)] = \
                                str(v.value)
                elif isinstance(t, ast.Name) and \
                        t.id == "_CC_REQUIRES" and \
                        isinstance(item.value, ast.Dict):
                    for k, v in zip(item.value.keys,
                                    item.value.values):
                        if isinstance(k, ast.Constant) and \
                                isinstance(v, (ast.List, ast.Tuple)) \
                                and len(v.elts) == 2 and all(
                                    isinstance(e, ast.Constant)
                                    for e in v.elts):
                            ci.requires[str(k.value)] = (
                                str(v.elts[0].value),
                                str(v.elts[1].value))
    for n in ast.walk(node):
        if not isinstance(n, ast.Assign):
            continue
        names = None
        for t in n.targets:
            x = _self_attr(t)
            if x is None:
                continue
            if names is None:
                names = _call_names(n.value)
            if any(c in _LOCK_CTORS for c in names):
                ci.locks[x] = "RLock" if "RLock" in names else "Lock"
            elif any(c in _SAFE_CTORS for c in names):
                ci.safe.add(x)
            elif isinstance(n.value, ast.Call):
                f = n.value.func
                ci.attr_ctor[x] = f.attr if isinstance(
                    f, ast.Attribute) else (
                    f.id if isinstance(f, ast.Name) else "")
    # pass 2: scan each direct method
    for item in node.body:
        if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        mi = ci.methods.setdefault(item.name, _MethodInfo(item.name))
        mi.public = not item.name.startswith("_")
        # __init__ runs single-threaded before the object escapes:
        # its DIRECT accesses are exempt; nested fns (worker loops
        # spawned from __init__) are still scanned fully.
        sc = _Scan(ci, item.name, record=(item.name != "__init__"))
        sc.run(item.body)
    for e in ci.entries:
        if e in ci.methods:
            ci.methods[e].entry = True
    return ci


# ===================================================================
# whole-tree analysis
# ===================================================================

def _inherited(ci: _ClassInfo) -> Dict[str, Optional[FrozenSet[str]]]:
    """Per-method inherited-held set: the intersection over all call
    sites of (caller_inherited | site_held). Entry + public methods
    are roots pinned at the empty set (any thread may call them with
    nothing held). ``None`` = unreachable from any root."""
    pinned = {m: frozenset({lk}) for m, (lk, _r) in
              ci.requires.items() if lk in ci.locks}
    roots = {m for m, mi in ci.methods.items()
             if (mi.entry or mi.public) and m not in pinned}
    inh: Dict[str, Optional[FrozenSet[str]]] = {
        m: (frozenset() if m in roots else None) for m in ci.methods}
    inh.update(pinned)
    changed = True
    while changed:
        changed = False
        for mname, mi in ci.methods.items():
            cur = inh[mname]
            if cur is None:
                continue
            for callee, held, _ln in mi.self_calls:
                if callee not in inh or callee in roots \
                        or callee in pinned:
                    continue
                eff = cur | held
                old = inh[callee]
                new = eff if old is None else (old & eff)
                if new != old:
                    inh[callee] = new
                    changed = True
    return inh


def _guards(ci: _ClassInfo,
            inh: Dict[str, Optional[FrozenSet[str]]]
            ) -> Dict[str, str]:
    """attr -> inferred owning lock. Candidate iff the attr is ever
    written (outside __init__) AND some access — read or write — runs
    with a lock held (so deleting the lock from the one writer still
    leaves a locked READ pinning the guard: mutation-testable)."""
    written = set()
    cnt: Dict[str, Counter] = {}
    for mname, mi in ci.methods.items():
        base = inh.get(mname) or frozenset()
        for acc in mi.accesses:
            if acc.kind == "write":
                written.add(acc.attr)
            eff = (acc.held | base) & set(ci.locks)
            if eff:
                c = cnt.setdefault(acc.attr, Counter())
                for lk in eff:
                    c[lk] += 1
    return {a: cnt[a].most_common(1)[0][0]
            for a in written if a in cnt}


def _sccs(nodes, adj):
    index: Dict[str, int] = {}
    low: Dict[str, int] = {}
    onstk: Set[str] = set()
    stk: List[str] = []
    out: List[List[str]] = []
    counter = [0]

    def strong(v):
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stk.append(v)
        onstk.add(v)
        for w in adj.get(v, ()):
            if w not in index:
                strong(w)
                low[v] = min(low[v], low[w])
            elif w in onstk:
                low[v] = min(low[v], index[w])
        if low[v] == index[v]:
            comp = []
            while True:
                w = stk.pop()
                onstk.discard(w)
                comp.append(w)
                if w == v:
                    break
            out.append(comp)

    for v in sorted(nodes):
        if v not in index:
            strong(v)
    return out


def analyze_sources(items: List[Tuple[str, str]]) -> dict:
    """Run the full static suite over ``[(path, source), ...]``.
    Returns the suite dict (see :func:`check_tree`)."""
    classes: List[_ClassInfo] = []
    noqa: Dict[str, Dict[int, List[Tuple[str, str]]]] = {}
    for path, src in items:
        tree = ast.parse(src, filename=path)
        for ln, line in enumerate(src.splitlines(), 1):
            for m in _NOQA_CC.finditer(line):
                noqa.setdefault(path, {}).setdefault(ln, []).append(
                    (m.group(1), (m.group(2) or "").strip()))
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes.append(_scan_class(node, path))

    findings: Set[Tuple[str, str, int, str]] = set()
    inh_by_class: Dict[str, Dict[str, Optional[FrozenSet[str]]]] = {}

    # ---- CC001 guarded-by ------------------------------------------
    for ci in classes:
        if not ci.locks:
            continue
        inh = inh_by_class[ci.name] = _inherited(ci)
        guards = _guards(ci, inh)
        for mname, mi in ci.methods.items():
            base = inh.get(mname)
            if base is None:        # not reachable from any entry
                continue
            for acc in mi.accesses:
                g = guards.get(acc.attr)
                if g is None or g in (acc.held | base):
                    continue
                if acc.kind == "read" and \
                        acc.attr in ci.lock_free_reads:
                    continue
                findings.add((
                    "CC001", ci.path, acc.line,
                    f"lock-free {acc.kind} of {ci.name}.{acc.attr} "
                    f"in {mname}() (guarded by {ci.name}.{g})"))

    # ---- CC003 lock order ------------------------------------------
    registry = {ci.name: ci for ci in classes}
    lock_kind = {f"{ci.name}.{a}": k
                 for ci in classes for a, k in ci.locks.items()}
    attr_types = {ci.name: {a: c for a, c in ci.attr_ctor.items()
                            if c in registry}
                  for ci in classes}
    acq: Dict[Tuple[str, str], Set[str]] = {}
    for ci in classes:
        for mname, mi in ci.methods.items():
            acq[(ci.name, mname)] = {
                f"{ci.name}.{lk}" for lk, _h, _ln in mi.acquires}
    changed = True
    while changed:
        changed = False
        for ci in classes:
            for mname, mi in ci.methods.items():
                cur = acq[(ci.name, mname)]
                n0 = len(cur)
                for callee, _h, _ln in mi.self_calls:
                    cur |= acq.get((ci.name, callee), set())
                for a, meth, _h, _ln in mi.attr_calls:
                    tcls = attr_types.get(ci.name, {}).get(a)
                    if tcls is not None:
                        cur |= acq.get((tcls, meth), set())
                if len(cur) != n0:
                    changed = True

    edges: Dict[Tuple[str, str], Tuple[str, int]] = {}

    def _edge(a: str, b: str, path: str, ln: int) -> None:
        if a == b and lock_kind.get(a) == "RLock":
            return              # RLock re-entry is legal
        edges.setdefault((a, b), (path, ln))

    for ci in classes:
        inh = inh_by_class.get(ci.name, {})
        for mname, mi in ci.methods.items():
            base = inh.get(mname) or frozenset()
            for lk, held, ln in mi.acquires:
                for h in held | base:
                    _edge(f"{ci.name}.{h}", f"{ci.name}.{lk}",
                          ci.path, ln)
            for callee, held, ln in mi.self_calls:
                eff = held | base
                if not eff:
                    continue
                for r in acq.get((ci.name, callee), ()):
                    for h in eff:
                        _edge(f"{ci.name}.{h}", r, ci.path, ln)
            for a, meth, held, ln in mi.attr_calls:
                eff = held | base
                if not eff:
                    continue
                tcls = attr_types.get(ci.name, {}).get(a)
                if tcls is None:
                    continue
                for r in acq.get((tcls, meth), ()):
                    for h in eff:
                        _edge(f"{ci.name}.{h}", r, ci.path, ln)

    adj: Dict[str, Set[str]] = {}
    nodes: Set[str] = set()
    for (a, b) in edges:
        nodes.add(a)
        nodes.add(b)
        adj.setdefault(a, set()).add(b)
    cycles = [sorted(c) for c in _sccs(nodes, adj) if len(c) > 1]
    cycles += [[v] for v in sorted(nodes) if (v, v) in edges]
    for cyc in cycles:
        first = min((a, b) for (a, b) in edges
                    if a in cyc and b in cyc)
        path, ln = edges[first]
        findings.add((
            "CC003", path, ln,
            "lock-order cycle: " + " -> ".join(cyc + [cyc[0]])))

    # ---- noqa discipline -------------------------------------------
    suppressed: List[dict] = []
    kept: List[dict] = []
    for rule, path, ln, msg in sorted(findings):
        codes = dict(noqa.get(path, {}).get(ln, []))
        if rule in codes:
            suppressed.append({"rule": rule, "path": path,
                               "line": ln, "message": msg,
                               "reason": codes[rule]})
        else:
            kept.append({"rule": rule, "path": path, "line": ln,
                         "message": msg})
    for path, per_line in sorted(noqa.items()):
        for ln, ents in sorted(per_line.items()):
            for code, reason in ents:
                if not reason:
                    kept.append({
                        "rule": "CC004", "path": path, "line": ln,
                        "message": f"noqa: {code} lacks a "
                                   f"justification (use # noqa: "
                                   f"{code}(reason))"})
    kept.sort(key=lambda f: (f["path"], f["line"], f["rule"]))
    by_rule = Counter(f["rule"] for f in kept)
    lfr = [{"class": ci.name, "path": ci.path, "attr": a,
            "reason": r}
           for ci in classes
           for a, r in sorted(ci.lock_free_reads.items())]
    reqs = [{"class": ci.name, "path": ci.path, "method": m,
             "lock": lk, "reason": r}
            for ci in classes
            for m, (lk, r) in sorted(ci.requires.items())]
    return {
        "files": len(items),
        "classes": sorted(ci.name for ci in classes if ci.locks),
        "locks": dict(sorted(lock_kind.items())),
        "findings": kept,
        "by_rule": {r: by_rule.get(r, 0) for r in RULES},
        "suppressed": suppressed,
        "lock_free_reads": lfr,
        "requires": reqs,
        "lock_order": {
            "edges": [[a, b, p, ln]
                      for (a, b), (p, ln) in sorted(edges.items())],
            "cycles": cycles,
        },
        "errors": len(kept),
    }


def analyze_source(src: str, path: str = "<src>") -> dict:
    return analyze_sources([(path, src)])


def _serving_root() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "serving")


def analyze_tree(root: Optional[str] = None) -> dict:
    root = root or _serving_root()
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    items = []
    for dirpath, _dirs, files in sorted(os.walk(root)):
        for fn in sorted(files):
            if not fn.endswith(".py"):
                continue
            p = os.path.join(dirpath, fn)
            with open(p, "r", encoding="utf-8") as fh:
                items.append((os.path.relpath(p, repo), fh.read()))
    return analyze_sources(items)


def check_tree(root: Optional[str] = None) -> dict:
    """Static guarded-by + lock-order over ``paddle_tpu_torch/serving/``
    (the whole tree, ``fleet/proc/`` included)."""
    return analyze_tree(root)


# ===================================================================
# mutation helper
# ===================================================================

def mutate_remove_with(src: str, method: Optional[str] = None,
                       nth: int = 0) -> str:
    """Return ``src`` with the ``nth`` ``with self.<attr>:`` block
    (inside ``method``, or anywhere when None) replaced by its bare
    body — the seeded race for mutation tests."""
    tree = ast.parse(src)
    state = {"i": 0, "done": False}

    def lockish(w: ast.With) -> bool:
        return len(w.items) == 1 and \
            _self_attr(w.items[0].context_expr) is not None

    class _T(ast.NodeTransformer):
        def __init__(self):
            self.depth = 0

        def visit_FunctionDef(self, node):
            hit = (node.name == method)
            if hit:
                self.depth += 1
            self.generic_visit(node)
            if hit:
                self.depth -= 1
            return node

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_With(self, node):
            self.generic_visit(node)
            if state["done"] or (method is not None and
                                 self.depth == 0):
                return node
            if not lockish(node):
                return node
            if state["i"] == nth:
                state["done"] = True
                return node.body
            state["i"] += 1
            return node

    tree = _T().visit(tree)
    if not state["done"]:
        raise ValueError(
            f"no with-block #{nth} found in method={method!r}")
    ast.fix_missing_locations(tree)
    return ast.unparse(tree)


# ===================================================================
# demo protocols (mutation-test substrate)
# ===================================================================

DEMO_COUNTER_SRC = '''\
import threading

from paddle_tpu_torch.serving.locktrace import fuzz_point, wrap_lock


class DemoCounter:
    """Known-good locked counter. Mutation tests remove add()'s lock:
    the surviving locked accesses in reset()/total() keep _value
    guarded, so the static pass flags the unlocked read-modify-write,
    and the fuzz window between read and write loses updates."""

    def __init__(self):
        self._lock = wrap_lock(threading.Lock(), "DemoCounter._lock")
        self._value = 0

    def add(self, n):
        with self._lock:
            v = self._value
            fuzz_point("demo.counter.window")
            self._value = v + n

    def reset(self):
        with self._lock:
            old = self._value
            self._value = 0
        return old

    def total(self):
        with self._lock:
            return self._value
'''

DEMO_ORDER_SRC = '''\
import threading

from paddle_tpu_torch.serving.locktrace import wrap_lock


class DemoPair:
    """Seeded lock-order inversion: ab() takes _a then _b, ba() takes
    them in the opposite order — the classic two-thread deadlock."""

    def __init__(self):
        self._a = wrap_lock(threading.Lock(), "DemoPair._a")
        self._b = wrap_lock(threading.Lock(), "DemoPair._b")
        self.hits = 0

    def ab(self):
        with self._a:
            with self._b:
                self.hits += 1

    def ba(self):
        with self._b:
            with self._a:
                self.hits += 1
'''


def run_counter_demo(src: str, seed: int, threads: int = 2,
                     iters: int = 120) -> dict:
    """Execute (possibly mutated) DEMO_COUNTER_SRC under the seeded
    schedule fuzzer: N threads hammer add(1); returns
    ``{"expected", "got", "ok"}``. The unmutated source is ok for
    EVERY seed; the removed-lock mutant loses updates."""
    from ..serving import locktrace

    locktrace.enable(fuzzer=locktrace.ScheduleFuzzer(seed))
    try:
        ns: dict = {}
        exec(compile(src, "<demo_counter>", "exec"), ns)
        c = ns["DemoCounter"]()

        def _hammer():
            for _ in range(iters):
                c.add(1)

        ts = [threading.Thread(target=_hammer, name=f"demo-add-{i}",
                               daemon=True) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30.0)
        got = int(c.total())
        want = threads * iters
        return {"expected": want, "got": got, "ok": got == want}
    finally:
        locktrace.disable()


def run_order_demo(src: str) -> dict:
    """Execute DEMO_ORDER_SRC under the LockTracer and drive both
    acquisition orders SEQUENTIALLY on one thread — the inversion is
    detected from the two-direction edge set, so no second thread
    (and no actual deadlock risk) is needed. Returns the tracer
    report; ``report["inversions"]`` is non-empty for DemoPair."""
    from ..serving import locktrace

    tr = locktrace.enable()
    try:
        ns: dict = {}
        exec(compile(src, "<demo_order>", "exec"), ns)
        p = ns["DemoPair"]()
        p.ab()
        p.ba()
        return tr.report()
    finally:
        locktrace.disable()


# ===================================================================
# fleet protocol fuzzing (real fleet/router/replica, fake engine)
# ===================================================================

def _expected_tokens(prompt, n: int) -> List[int]:
    base = int(sum(int(x) for x in prompt)) % 9973
    return [(base * 31 + i * 7) % 1021 for i in range(int(n))]


def _chain_fp(prompt) -> int:
    fp = 1469598103934665603
    for x in prompt:
        fp = ((fp ^ int(x)) * 1099511628211) % (1 << 64)
    return fp


class _Shim:
    pass


class _FakeEngine:
    """Stdlib-only ServingEngine stand-in satisfying the full
    Replica/router-facing surface (inject/close/snapshot/gauges/
    chain export-adopt/on_chain_complete), so the schedule fuzzer
    drives the REAL fleet/router/replica protocol code without torch:
    tokens are a pure function of the prompt (bitwise-checkable), the
    close() modes mirror the engine contract (hand_back returns the
    untaken queue; drain serves it; neither touches in-flight work),
    and crash() reproduces the fail-fast contract (queued requests
    errored immediately, nothing handed back)."""

    def __init__(self, name: str = "eng"):
        self.name = name
        self._cv = threading.Condition()
        self._q: List = []                  # queued, not yet taken
        self._closing = False
        self._dead: Optional[BaseException] = None
        self._busy = 0                      # taken, not yet finished
        self.served: List[int] = []         # request ids finished HERE
        self.chains: Dict[int, List[int]] = {}
        self.counters = {k: 0 for k in (
            "submitted", "admitted", "completed", "handed_back",
            "tokens_out", "prefix_hits", "prefix_misses")}
        self.on_chain_complete = None
        self.metrics = None
        self.sentinel = None
        self.postmortem_path = None
        self.flight = _Shim()
        self.flight.ticks = lambda: []
        self.scheduler = _Shim()
        self.scheduler.max_batch = 4
        self.pool = _Shim()
        self.pool.page_size = 8
        self._t = threading.Thread(target=self._loop,
                                   name=f"fake-engine-{name}",
                                   daemon=True)
        self._t.start()

    # ------------------------------------------------------- surface ----
    @property
    def alive(self) -> bool:
        return self._dead is None and self._t.is_alive()

    def warm_programs(self) -> None:
        pass

    def arm_sentinel(self) -> None:
        pass

    def affinity_summary(self, max_depth: int = 2) -> dict:
        return {}

    def gauges(self) -> dict:
        with self._cv:
            return {"queued": len(self._q),
                    "occupancy": self._busy / 4.0}

    def snapshot(self) -> dict:
        with self._cv:
            return {"counters": dict(self.counters),
                    "gauges": {"queued": len(self._q),
                               "occupancy": self._busy / 4.0}}

    def inject(self, req) -> bool:
        from ..serving import locktrace
        locktrace.fuzz_point("fake.inject")
        with self._cv:
            if self._closing or self._dead is not None:
                return False
            self._q.append(req)
            self.counters["submitted"] += 1
            self.counters["admitted"] += 1
            self._cv.notify_all()
        return True

    def close(self, drain: bool = True,
              hand_back: bool = False) -> List:
        handed: List = []
        with self._cv:
            self._closing = True
            if self._dead is None:
                if hand_back:
                    handed = list(self._q)
                    self._q.clear()
                    self.counters["handed_back"] += len(handed)
                elif not drain:
                    for r in self._q:
                        r.error = RuntimeError(
                            f"engine {self.name}: cancelled at close")
                        r.finish("cancelled")
                    self._q.clear()
            self._cv.notify_all()
        self._t.join(timeout=30.0)
        return handed

    def crash(self) -> None:
        with self._cv:
            self._dead = RuntimeError("injected crash")
            self._cv.notify_all()

    def export_chain(self, fp: int, max_depth: int = 64):
        from ..serving import locktrace
        with self._cv:
            if self._dead is not None:
                raise RuntimeError(f"engine {self.name} is dead")
            toks = self.chains.get(int(fp))
        locktrace.fuzz_point("fake.export")
        if toks is None:
            return None
        return {"fp": int(fp), "tokens": list(toks)}

    def adopt_chain(self, blob: dict) -> dict:
        from ..serving import locktrace
        locktrace.fuzz_point("fake.adopt")
        with self._cv:
            if self._dead is not None:
                raise RuntimeError(f"engine {self.name} is dead")
            self.chains[int(blob["fp"])] = list(blob["tokens"])
        return {"fp": int(blob["fp"]),
                "pages": len(blob["tokens"])}

    # -------------------------------------------------------- worker ----
    def _loop(self) -> None:
        while True:
            req = None
            with self._cv:
                while not self._q and not self._closing \
                        and self._dead is None:
                    self._cv.wait(0.02)
                if self._dead is not None:
                    # fail-fast contract: error the queue, hand back
                    # nothing (suspect state must not be retried
                    # silently)
                    for r in self._q:
                        r.error = RuntimeError(
                            f"engine {self.name} died: {self._dead}")
                        r.finish("cancelled")
                    self._q.clear()
                    return
                if self._q:
                    req = self._q.pop(0)
                    self._busy += 1
                elif self._closing:
                    return
            if req is None:
                continue
            try:
                self._serve(req)
            finally:
                with self._cv:
                    self._busy -= 1
                    self._cv.notify_all()

    def _serve(self, req) -> None:
        from ..serving import locktrace
        toks = _expected_tokens(req.prompt, req.max_new_tokens)
        for i, t in enumerate(toks):
            locktrace.fuzz_point("fake.token")
            if i == 0:
                req.first_token_t = time.monotonic()
            req.tokens.append(int(t))
            req.stream.put(int(t))
        fp = _chain_fp(req.prompt)
        hook = self.on_chain_complete
        with self._cv:
            self.served.append(req.id)
            self.chains[fp] = list(toks)
            self.counters["completed"] += 1
            self.counters["tokens_out"] += len(toks)
        req.finish("completed")
        if hook is not None:
            hook(req, {"fp": fp, "fps": [fp]})


def fuzz_fleet_scenario(seed: int, scenario: str = "drain",
                        requests: int = 12,
                        max_new_tokens: int = 4) -> dict:
    """Replay one fleet protocol under seeded schedule perturbation
    against the port's REAL ServingFleet/FleetRouter/Replica code.

    scenario:
      * ``drain``   — graceful leave concurrent with submits: the
        handed-back queue re-dispatches to survivors exactly once.
      * ``crash``   — SIGKILL-shaped engine death + reap concurrent
        with submits: fail-fast errors, survivors unaffected.
      * ``migrate`` — prefill/decode roles + auto-migration: chain
        handoff runs on the fleet's background thread while decode
        traffic flows; ODD seeds crash a decode replica mid-run.

    Invariants asserted every run: every accepted request's handle
    RESOLVES (zero drops), completed handles match the expected
    tokens bitwise, no request id is served twice (exactly-once), no
    re-dispatch failures on drain, migration bookkeeping drains, and
    the LockTracer observes zero order inversions. Returns a result
    dict with ``ok``/``failures`` (reproduce with the same seed).
    """
    if scenario not in ("drain", "crash", "migrate"):
        raise ValueError(f"unknown scenario {scenario!r}")
    from ..serving import locktrace
    from ..serving.fleet.fleet import ServingFleet

    engines: List[_FakeEngine] = []

    def factory():
        e = _FakeEngine(name=f"e{len(engines)}")
        engines.append(e)
        return e

    tr = locktrace.enable(fuzzer=locktrace.ScheduleFuzzer(seed))
    failures: List[str] = []
    try:
        roles = (["prefill", "decode", "decode"]
                 if scenario == "migrate" else None)
        fleet = ServingFleet(factory, replicas=3, roles=roles,
                             policy="least_loaded",
                             prefill_len_ratio=0.1, warm=False)
        prompts = [[(seed + 3 * j) % 97 + 1, (7 * j) % 89 + 1,
                    j + 1, 5] for j in range(requests)]
        results: List = [None] * requests
        try:
            def _submitter(lo: int, hi: int) -> None:
                for j in range(lo, hi):
                    locktrace.fuzz_point("fuzz.submit")
                    try:
                        results[j] = fleet.submit(
                            prompts[j], max_new_tokens)
                    except RuntimeError as e:
                        results[j] = e

            ts = [threading.Thread(target=_submitter,
                                   args=(0, requests // 2),
                                   name="fuzz-submit-0", daemon=True),
                  threading.Thread(target=_submitter,
                                   args=(requests // 2, requests),
                                   name="fuzz-submit-1", daemon=True)]
            for t in ts:
                t.start()
            # the disturbance runs CONCURRENTLY with the submitters
            if scenario == "drain":
                fleet.drain("r1")
            elif scenario == "crash":
                engines[1].crash()
                fleet.reap()
            elif scenario == "migrate" and seed % 2 == 1:
                locktrace.fuzz_point("fuzz.crash-decode")
                engines[2].crash()
            for t in ts:
                t.join(timeout=30.0)
            if scenario == "migrate" and seed % 2 == 1:
                fleet.reap()
            # let background migration threads settle
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                with fleet._lock:
                    busy = len(fleet._migrating)
                if not busy:
                    break
                time.sleep(0.002)
            else:
                failures.append("migration bookkeeping never drained")

            completed = 0
            for j, r in enumerate(results):
                if r is None:
                    failures.append(f"req {j}: submitter never ran")
                elif isinstance(r, Exception):
                    failures.append(f"req {j}: rejected: {r}")
                else:
                    try:
                        toks = r.result(timeout=30.0)
                    except TimeoutError:
                        failures.append(f"req {j}: DROPPED (handle "
                                        f"never resolved)")
                        continue
                    except Exception:
                        if scenario in ("crash", "migrate"):
                            continue    # fail-fast errors are the
                            # contract when an engine dies mid-run
                        failures.append(f"req {j}: unexpected error")
                        continue
                    exp = _expected_tokens(prompts[j], max_new_tokens)
                    if [int(x) for x in toks] != exp:
                        failures.append(
                            f"req {j}: tokens diverge: {list(toks)} "
                            f"!= {exp}")
                    completed += 1

            served: List[int] = []
            for e in engines:
                served += e.served
            if len(served) != len(set(served)):
                failures.append("a request was served on two engines")
            if scenario == "drain":
                if fleet.router.counters.get("redispatch_failed", 0):
                    failures.append("drain hand-back re-dispatch "
                                    "failed")
                if completed != requests:
                    failures.append(
                        f"drain dropped work: {completed}/{requests} "
                        f"completed")
            if scenario == "migrate":
                src = engines[0]
                for e in engines[1:]:
                    for fp, toks in e.chains.items():
                        if fp in src.chains and \
                                toks != src.chains[fp]:
                            failures.append(
                                f"migrated chain {fp} diverges")
                if seed % 2 == 0 and \
                        fleet.counters["migrations"] == 0:
                    failures.append("no chain migrated on a healthy "
                                    "decode pool")
            inv = tr.inversions
            if inv:
                failures.append(f"lock-order inversion: {inv}")
            counters = dict(fleet.counters)
        finally:
            fleet.close()
        return {"ok": not failures, "seed": seed,
                "scenario": scenario, "failures": failures,
                "completed": completed, "served": len(served),
                "fleet": counters, "report": tr.report()}
    finally:
        locktrace.disable()
