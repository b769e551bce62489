"""Rank-asymmetric 1F1B / zero-bubble pipeline schedules, one process a
rank.

Port of ``paddle_tpu/parallel/pipeline_async.py``. Its host half — the
op codes, ``SCHEDULE_INFO`` / ``schedule_legality``, ``Schedule`` and
``build_schedule`` (a greedy list scheduler for V = 1 and the fixed
interleaved order for V > 1, a dependency replay, interval-coloured
rings) — is numpy only and copied here line for line, so the tables
are the JAX package's.

The executor ``pipeline_train_async`` differs in form: the JAX one is
one traced scan whose body switches on each rank's op code inside a
``shard_map``; here every rank is a process that walks its own column
of the table, tick by tick:

* F runs the stage on the saved input (the injected microbatch on the
  first rank) without autograd and sends the output up; F+head on the
  last rank runs the loss head and keeps its cotangent;
* B runs the stage forward again with autograd from the saved input and
  back-props the saved cotangent, sending ``dx`` down (on the first
  rank, keeping it for the embedding's backward); under ``zb`` it
  computes only ``dx`` and keeps the graph in the residual ring;
* W (``zb``) takes the weight gradients from that kept graph: no
  second forward;
* each tick's sends and receives to the pipeline neighbours are posted
  together through ``distributed.communication.exchange``, so a ring of
  blocking sends cannot deadlock; idle ticks send nothing.

Saved inputs, cotangents and kept graphs live in rings of the depths
``build_schedule`` gives (the O(S), M-independent bound). Gradients are
summed in f32 per chunk in microbatch order, the JAX order; the caller
reduces the sums over dp once, after the schedule, and scales and casts
them once (``models.llama.grads_1f1b``, the trainer).
"""

import dataclasses
from functools import lru_cache
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["IDLE", "OP_F", "OP_B", "OP_FH", "OP_W", "KIND_NAMES",
           "VARIANTS", "PP_SCHEDULES", "ScheduleInfo", "SCHEDULE_INFO",
           "schedule_legality", "Schedule", "build_schedule",
           "pipeline_train_async"]

# op codes, as the JAX package numbers them
IDLE, OP_F, OP_B, OP_FH, OP_W = 0, 1, 2, 3, 4
KIND_NAMES = {IDLE: "idle", OP_F: "F", OP_B: "B", OP_FH: "F+head",
              OP_W: "W"}
VARIANTS = ("1f1b", "zb")

#: what each pp_schedule config value means: LlamaConfig.pp_schedule ->
#: (schedule-model name spoken by schedule_ticks/schedule_efficiency,
#: executor variant — None = the lockstep pipeline_1f1b executor).
PP_SCHEDULES = {
    "1f1b": ("lockstep", None),
    "1f1b_async": ("1f1b", "1f1b"),
    "zb": ("zb", "zb"),
}


@dataclasses.dataclass(frozen=True)
class ScheduleInfo:
    """Queryable metadata for one ``pp_schedule`` value — the legality
    constraints and cost facts of each schedule, copied from the JAX
    package (its planner prices schedules from this table);
    ``schedule_legality`` below is derived from the same fields the
    executors enforce.

    ``work_units_per_mb_stage``: relative compute units one microbatch
    costs one stage (F=1, fused backward=3), as the JAX package prices
    them. ``lockstep_masked_work``: in the JAX lockstep scan every slot
    runs every tick (the port's lockstep executor skips masked slots).
    """
    name: str                   # LlamaConfig.pp_schedule value
    model: str                  # schedule_ticks/schedule_efficiency name
    executor: Optional[str]     # pipeline_async variant; None = lockstep
    requires_dp1_tp1: bool      # True only for a schedule whose stage
    #                             body cannot compose dp/tp (none today)
    supports_vpp: bool          # virtual_chunks > 1 allowed
    vpp_needs_divisible_M: bool  # V>1 requires M % S == 0
    min_stages: int
    work_units_per_mb_stage: float
    lockstep_masked_work: bool

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


#: pp_schedule name -> ScheduleInfo. Consistent with PP_SCHEDULES by
#: construction (asserted at import below).
SCHEDULE_INFO: Dict[str, ScheduleInfo] = {
    "1f1b": ScheduleInfo(
        name="1f1b", model="lockstep", executor=None,
        requires_dp1_tp1=False, supports_vpp=True,
        vpp_needs_divisible_M=False, min_stages=1,
        work_units_per_mb_stage=4, lockstep_masked_work=True),
    "1f1b_async": ScheduleInfo(
        name="1f1b_async", model="1f1b", executor="1f1b",
        requires_dp1_tp1=False, supports_vpp=True,
        vpp_needs_divisible_M=True, min_stages=2,
        work_units_per_mb_stage=4, lockstep_masked_work=False),
    "zb": ScheduleInfo(
        name="zb", model="zb", executor="zb",
        requires_dp1_tp1=False, supports_vpp=False,
        vpp_needs_divisible_M=True, min_stages=2,
        work_units_per_mb_stage=4.5, lockstep_masked_work=False),
}
assert set(SCHEDULE_INFO) == set(PP_SCHEDULES) and all(
    (i.model, i.executor) == PP_SCHEDULES[n]
    for n, i in SCHEDULE_INFO.items())

#: executor variant -> pp_schedule name (build_schedule speaks variant)
_VARIANT_TO_SCHEDULE = {v: n for n, (_, v) in PP_SCHEDULES.items()
                        if v is not None}


def schedule_legality(name: str, *, num_stages: int,
                      num_microbatches: int, virtual_chunks: int = 1,
                      dp: int = 1, tp: int = 1) -> Optional[str]:
    """None when ``(schedule, geometry)`` is legal, else the reason it
    is not. ``build_schedule`` raises exactly these reasons for its
    subset. ``dp``/``tp`` are accepted for any schedule (the executors
    compose both); the parameters remain so a schedule that cannot
    compose can gate on them via ``requires_dp1_tp1``.
    """
    info = SCHEDULE_INFO.get(name)
    if info is None:
        return (f"variant must be one of {tuple(SCHEDULE_INFO)}, "
                f"got {name!r}")
    S, M, V = int(num_stages), int(num_microbatches), int(virtual_chunks)
    if M < 1 or V < 1:
        return "need num_microbatches >= 1, virtual_chunks >= 1"
    if S < info.min_stages:
        if info.min_stages >= 2:
            return ("rank-asymmetric schedules need num_stages >= 2 "
                    "(pp=1 has no pipeline bubble — use the plain or "
                    "lockstep path)")
        return f"need num_stages >= {info.min_stages}"
    if V > 1 and not info.supports_vpp:
        return ("zb W-deferral with virtual_chunks > 1 (ZB-V-style "
                "schedules) is not supported — the reference's "
                "pipeline_zero_bubble.py ZB-H1 is V=1 too; use "
                "variant='1f1b' for interleaved VPP")
    if V > 1 and info.vpp_needs_divisible_M and M % S:
        return (f"interleaved V>1 needs num_microbatches divisible by "
                f"num_stages (the reference's VPP constraint), got "
                f"M={M} S={S}")
    if info.requires_dp1_tp1 and (int(dp) > 1 or int(tp) > 1):
        return (f"schedule {name!r} currently requires every non-pp "
                f"mesh axis to be size 1; got dp={dp} tp={tp}")
    return None


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One built rank-asymmetric schedule: the static op/routing tables
    the executor walks, plus the bookkeeping tests pin.

    All tables are int32 ``[ticks, S]`` (tick-major; rank ``s`` walks
    column ``s``): ``kind`` (op codes above), ``chunk``/``mb``
    (which (virtual chunk, microbatch) the op touches), ``slot_x`` /
    ``slot_c`` (saved-activation / saved-cotangent ring slots the op
    reads — for F with ``inject`` set, the slot it WRITES the injected
    input to), ``slot_r`` (zb only: the residual-ring slot B WRITES its
    kept graph to and W READS it from — what lets W
    skip the stage-forward replay), ``inject`` (F consumes ``x[mb]``
    instead of an arrival), ``emit`` (B's dx is the stage-0 embedding
    cotangent), ``store_up`` / ``store_dn`` (ring slot where this rank
    stores the value arriving on the up/down ppermute at the END of
    the tick; -1 = none/discard).
    """
    num_stages: int
    num_microbatches: int
    virtual_chunks: int
    variant: str
    ticks: int
    depth_x: int          # saved-activation ring depth (max over ranks)
    depth_c: int          # saved-cotangent ring depth
    depth_r: int          # saved-residual ring depth (zb; 0 otherwise)
    kind: np.ndarray
    chunk: np.ndarray
    mb: np.ndarray
    slot_x: np.ndarray
    slot_c: np.ndarray
    slot_r: np.ndarray
    inject: np.ndarray
    emit: np.ndarray
    store_up: np.ndarray
    store_dn: np.ndarray

    @property
    def useful_ticks_per_rank(self) -> int:
        per_mb = 3 if self.variant == "zb" else 2
        return per_mb * self.virtual_chunks * self.num_microbatches

    @property
    def efficiency(self) -> float:
        """Non-idle fraction of each rank's ticks — the schedule-bubble
        measure the reference's 1F1B/ZB numbers are quoted in."""
        return self.useful_ticks_per_rank / self.ticks

    def op_counts(self) -> Dict[str, int]:
        """rank-tick counts per op kind over the whole schedule."""
        out = {}
        for code, name in KIND_NAMES.items():
            out[name] = int((self.kind == code).sum())
        return out


def _f_dest(S: int, V: int, v: int, s: int, m: int
            ) -> Optional[Tuple[int, int, int]]:
    """Where chunk (v, s)'s F output lands: (v, s+1) one rank up, or
    the ring wrap (v+1, 0) from the last rank to rank 0. None for the
    last chunk's F (= FH — the loss head consumes it locally).

    The ONE statement of the forward routing: both schedule builders
    AND the store_up table construction use it (``_validate``
    re-states it independently, on purpose — it is the check)."""
    if v == V - 1 and s == S - 1:
        return None
    if s == S - 1:
        return (v + 1, 0, m)
    return (v, s + 1, m)


def _b_dest(S: int, V: int, v: int, s: int, m: int
            ) -> Optional[Tuple[int, int, int]]:
    """Where B's dx cotangent lands: (v, s-1) one rank down, or the
    wrap (v-1, S-1) from rank 0 back to the last rank. None at chunk
    (0, 0) — that dx is the embedding cotangent (emitted)."""
    if v == 0 and s == 0:
        return None
    if s == 0:
        return (v - 1, S - 1, m)
    return (v, s - 1, m)


def _interleaved_order(S: int, s: int, M: int, V: int
                       ) -> List[Tuple[str, int, int]]:
    """Rank ``s``'s fixed op order for interleaved V>1 — the
    reference's VPP pattern (pipeline_parallel.py:1372, same shape as
    Megatron's interleaved 1F1B): microbatches run in groups of S;
    forwards cycle chunks 0..V-1 per group, backwards cycle V-1..0;
    warmup = 2(S-s-1) + (V-1)S + 1 forwards (the Megatron count, +1
    because the steady-state pair here is F-then-B against our 1-tick
    arrival latency), then strict F,B pairs, then the backward drain.
    Greedy choice cannot reproduce this pattern (it deadlocks against
    the wrap dependencies), so V>1 uses the fixed order and — like
    the reference — requires M % S == 0."""
    total = V * M

    def f_op(k):
        return (k // S) % V, (k // (S * V)) * S + k % S

    def b_op(k):
        return V - 1 - ((k // S) % V), (k // (S * V)) * S + k % S

    warmup = min(2 * (S - s - 1) + (V - 1) * S + 1, total)
    ops: List[Tuple[str, int, int]] = [
        ("F",) + f_op(k) for k in range(warmup)]
    for k in range(total - warmup):
        ops.append(("F",) + f_op(warmup + k))
        ops.append(("B",) + b_op(k))
    for k in range(total - warmup, total):
        ops.append(("B",) + b_op(k))
    return ops


def _fixed_order_schedule(S: int, M: int, V: int
                          ) -> List[List[Tuple[int, int, int]]]:
    """Earliest-feasible tick assignment of the fixed interleaved op
    order: each rank executes its list strictly in order, idling while
    the next op's input has not arrived (1-tick neighbour latency)."""
    orders = {s: _interleaved_order(S, s, M, V) for s in range(S)}
    ptr = {s: 0 for s in range(S)}
    act_arr: Dict[Tuple[int, int, int], int] = {}
    ct_arr: Dict[Tuple[int, int, int], int] = {}
    grid: List[List[Tuple[int, int, int]]] = []
    limit = 8 * (2 * V * M + 2 * S * V) + 64
    t = 0
    while any(ptr[s] < len(orders[s]) for s in range(S)):
        if t >= limit:
            raise AssertionError(
                f"fixed-order schedule stalled for S={S} M={M} V={V}")
        row: List[Tuple[int, int, int]] = []
        for s in range(S):
            op = (IDLE, 0, 0)
            if ptr[s] < len(orders[s]):
                what, v, m = orders[s][ptr[s]]
                if what == "F":
                    ready = (v == 0 and s == 0) or \
                        act_arr.get((v, s, m), t) <= t - 1
                    if ready:
                        kind = (OP_FH if (v == V - 1 and s == S - 1)
                                else OP_F)
                        op = (kind, v, m)
                else:
                    if ct_arr.get((v, s, m), t) <= t - 1:
                        op = (OP_B, v, m)
            row.append(op)
        for s, (kind, v, m) in enumerate(row):
            if kind == IDLE:
                continue
            ptr[s] += 1
            if kind == OP_FH:
                ct_arr[(v, s, m)] = t          # head ct, local
            elif kind == OP_F:
                act_arr[_f_dest(S, V, v, s, m)] = t
            elif kind == OP_B:
                dst = _b_dest(S, V, v, s, m)
                if dst is not None:            # (0,0): dx -> embedding
                    ct_arr[dst] = t
        grid.append(row)
        t += 1
    return grid


def _greedy_schedule(S: int, M: int, variant: str
                     ) -> List[List[Tuple[int, int, int]]]:
    """Greedy list scheduler for V=1 -> grid[t][s] = (kind, 0, m)
    (interleaved V>1 goes through ``_fixed_order_schedule`` instead —
    greedy choice deadlocks against the ring-wrap dependencies there).

    Per tick, per rank, priority order:
      1. B, microbatch FIFO (the critical path);
      2. forced W when the deferred-W backlog hits S (bounds the
         saved-tensor ring at O(S) — the ZB-H1 memory discipline);
      3. F in microbatch order (injected at rank 0, arrival-gated
         elsewhere), capped at S - s in-flight microbatches per rank
         (the classic 1F1B warmup depth — what bounds activation
         memory independent of M);
      4. any W (bubble filler — the entire point of ZB);
      5. idle.
    """
    zb = variant == "zb"
    fdone: Dict[Tuple[int, int, int], int] = {}
    bdone: Dict[Tuple[int, int, int], int] = {}
    wdone: Dict[Tuple[int, int, int], int] = {}
    act_arr: Dict[Tuple[int, int, int], int] = {}
    ct_arr: Dict[Tuple[int, int, int], int] = {}
    total = S * M * (3 if zb else 2)
    done = 0
    grid: List[List[Tuple[int, int, int]]] = []
    limit = 6 * (3 * M + 2 * S) + 64
    t = 0

    def w_backlog(s, t):
        return sorted(
            (bdone[k], k) for k in bdone
            if k[1] == s and k not in wdone and bdone[k] <= t - 1)

    while done < total:
        if t >= limit:
            raise AssertionError(
                f"schedule builder did not converge for S={S} M={M} "
                f"variant={variant!r} after {limit} ticks")
        row: List[Tuple[int, int, int]] = []
        for s in range(S):
            op = (IDLE, 0, 0)
            # -- 1. B -------------------------------------------------
            cand_b = [
                m for m in range(M)
                if (0, s, m) in fdone and (0, s, m) not in bdone
                and ct_arr.get((0, s, m), t) <= t - 1]
            if cand_b:
                op = (OP_B, 0, min(cand_b))
            elif zb and len(w_backlog(s, t)) >= S:
                _, (v, _s, m) = w_backlog(s, t)[0]
                op = (OP_W, v, m)
            if op[0] == IDLE:
                # -- 3. F ---------------------------------------------
                inflight = sum(
                    1 for m in range(M)
                    if (0, s, m) in fdone and (0, s, m) not in bdone)
                if inflight < S - s:
                    m = next((m for m in range(M)
                              if (0, s, m) not in fdone), None)
                    if m is not None and (
                            s == 0
                            or act_arr.get((0, s, m), t) <= t - 1):
                        op = (OP_FH if s == S - 1 else OP_F, 0, m)
            if op[0] == IDLE and zb and w_backlog(s, t):
                # -- 4. W filler --------------------------------------
                _, (v, _s, m) = w_backlog(s, t)[0]
                op = (OP_W, v, m)
            row.append(op)
        # apply the whole tick's decisions, then record arrivals (end
        # of tick t -> usable from t + 1)
        for s, (kind, v, m) in enumerate(row):
            if kind in (OP_F, OP_FH):
                fdone[(v, s, m)] = t
                if kind == OP_FH:
                    ct_arr[(v, s, m)] = t      # head ct, local
                else:
                    act_arr[_f_dest(S, 1, v, s, m)] = t
                done += 1
            elif kind == OP_B:
                bdone[(v, s, m)] = t
                dst = _b_dest(S, 1, v, s, m)
                if dst is not None:            # (0,0): dx -> embedding
                    ct_arr[dst] = t
                done += 1
            elif kind == OP_W:
                wdone[(v, s, m)] = t
                done += 1
        grid.append(row)
        t += 1
    return grid


def _validate(grid, S: int, M: int, V: int, variant: str) -> None:
    """Replay the grid asserting every dependency with 1-tick latency.
    Independent of the greedy builder: a scheduling bug fails HERE, at
    build time, not as silently-wrong gradients."""
    zb = variant == "zb"
    fdone, bdone, wdone, act_arr, ct_arr = {}, {}, {}, {}, {}
    for t, row in enumerate(grid):
        assert len(row) == S
        for s, (kind, v, m) in enumerate(row):
            key = (v, s, m)
            if kind in (OP_F, OP_FH):
                assert key not in fdone, f"double F {key}"
                if v == 0 and s == 0:
                    for mp in range(m):   # injects strictly in order
                        assert (0, 0, mp) in fdone, (t, key)
                else:
                    assert act_arr.get(key, t) <= t - 1, \
                        f"F{key} @t{t}: input not arrived"
                assert (kind == OP_FH) == (v == V - 1 and s == S - 1)
            elif kind == OP_B:
                assert key in fdone and fdone[key] < t, (t, key)
                assert ct_arr.get(key, t) <= t - 1, \
                    f"B{key} @t{t}: cotangent not arrived"
                assert key not in bdone
            elif kind == OP_W:
                assert zb and key in bdone and bdone[key] < t, (t, key)
                assert key not in wdone
            else:
                assert kind == IDLE
            # arrivals (same bookkeeping as the builder)
            if kind in (OP_F, OP_FH):
                fdone[key] = t
                if kind == OP_FH:
                    ct_arr[key] = t
                elif s == S - 1:
                    act_arr[(v + 1, 0, m)] = t
                else:
                    act_arr[(v, s + 1, m)] = t
            elif kind == OP_B:
                bdone[key] = t
                if s == 0 and v > 0:
                    ct_arr[(v - 1, S - 1, m)] = t
                elif s > 0:
                    ct_arr[(v, s - 1, m)] = t
            elif kind == OP_W:
                wdone[key] = t
    want = {(v, s, m) for v in range(V) for s in range(S)
            for m in range(M)}
    assert set(fdone) == want, "missing forwards"
    assert set(bdone) == want, "missing backwards"
    if zb:
        assert set(wdone) == want, "missing deferred weight grads"


def _alloc_slots(intervals: List[Tuple[int, int, Any]]
                 ) -> Tuple[Dict[Any, int], int]:
    """Greedy interval-graph coloring: values -> ring slots. A slot
    whose value was last READ at tick e is reusable by a value STORED
    at the end of tick e or later (stores happen end-of-tick, reads
    during the following ticks). Returns (value -> slot, depth)."""
    slots_free_at: List[int] = []
    assign: Dict[Any, int] = {}
    for store, last_read, key in sorted(intervals):
        for i, free_at in enumerate(slots_free_at):
            if free_at <= store:
                assign[key] = i
                slots_free_at[i] = last_read
                break
        else:
            assign[key] = len(slots_free_at)
            slots_free_at.append(last_read)
    return assign, len(slots_free_at)


@lru_cache(maxsize=None)
def build_schedule(num_stages: int, num_microbatches: int,
                   virtual_chunks: int = 1,
                   variant: str = "1f1b") -> Schedule:
    """Build + validate + register-allocate one schedule (cached)."""
    S, M, V = int(num_stages), int(num_microbatches), int(virtual_chunks)
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, "
                         f"got {variant!r}")
    # legality lives in one table (schedule_legality / SCHEDULE_INFO);
    # the builder raises exactly its reasons
    reason = schedule_legality(
        _VARIANT_TO_SCHEDULE[variant], num_stages=S,
        num_microbatches=M, virtual_chunks=V)
    if reason is not None:
        raise ValueError(reason)
    zb = variant == "zb"
    if V > 1:
        grid = _fixed_order_schedule(S, M, V)
    else:
        grid = _greedy_schedule(S, M, variant)
    _validate(grid, S, M, V, variant)
    T = len(grid)

    # -- op-time lookup ----------------------------------------------
    ftick, btick, wtick = {}, {}, {}
    for t, row in enumerate(grid):
        for s, (kind, v, m) in enumerate(row):
            if kind in (OP_F, OP_FH):
                ftick[(v, s, m)] = t
            elif kind == OP_B:
                btick[(v, s, m)] = t
            elif kind == OP_W:
                wtick[(v, s, m)] = t

    # -- saved-value intervals per rank ------------------------------
    # ACT(v,s,m): stage input. Stored at arrival (end of the sender's F
    # tick) or, for stage-0 chunk-0 injects, during its own F tick;
    # read by F (non-inject) and B (W consumes the residual ring, not
    # the input — it never replays the stage forward).
    # CT(v,s,m): incoming cotangent. Stored at arrival / the FH tick;
    # read by B and (zb) W.
    # RES(v,s,m) (zb): B's kept graph. Stored during the
    # B tick, read once by W — the interval that prices the W-replay
    # cut's memory.
    x_assign: Dict[int, Dict[Tuple[int, int], int]] = {}
    c_assign: Dict[int, Dict[Tuple[int, int], int]] = {}
    r_assign: Dict[int, Dict[Tuple[int, int], int]] = {}
    depth_x = depth_c = 1
    depth_r = 0
    for s in range(S):
        xiv, civ, riv = [], [], []
        for v in range(V):
            for m in range(M):
                f_t = ftick[(v, s, m)]
                last = wtick[(v, s, m)] if zb else btick[(v, s, m)]
                if v == 0 and s == 0:
                    store = f_t
                else:
                    if s == 0:
                        store = ftick[(v - 1, S - 1, m)]
                    else:
                        store = ftick[(v, s - 1, m)]
                xiv.append((store, btick[(v, s, m)], (v, m)))
                if v == V - 1 and s == S - 1:
                    c_store = f_t  # head ct, written during FH
                else:
                    if s == S - 1:
                        c_store = btick[(v + 1, 0, m)]
                    else:
                        c_store = btick[(v, s + 1, m)]
                civ.append((c_store, last, (v, m)))
                if zb:
                    riv.append((btick[(v, s, m)], wtick[(v, s, m)],
                                (v, m)))
        xa, dx = _alloc_slots(xiv)
        ca, dc = _alloc_slots(civ)
        x_assign[s], c_assign[s] = xa, ca
        depth_x, depth_c = max(depth_x, dx), max(depth_c, dc)
        if zb:
            ra, dr = _alloc_slots(riv)
            r_assign[s] = ra
            depth_r = max(depth_r, dr)

    # -- tables ------------------------------------------------------
    kind = np.zeros((T, S), np.int32)
    chunk = np.zeros((T, S), np.int32)
    mb = np.zeros((T, S), np.int32)
    slot_x = np.zeros((T, S), np.int32)
    slot_c = np.zeros((T, S), np.int32)
    slot_r = np.zeros((T, S), np.int32)
    inject = np.zeros((T, S), np.int32)
    emit = np.zeros((T, S), np.int32)
    store_up = np.full((T, S), -1, np.int32)
    store_dn = np.full((T, S), -1, np.int32)
    for t, row in enumerate(grid):
        for s, (k, v, m) in enumerate(row):
            kind[t, s], chunk[t, s], mb[t, s] = k, v, m
            if k == IDLE:
                continue
            slot_x[t, s] = x_assign[s][(v, m)]
            if k in (OP_B, OP_W) or (k == OP_FH):
                slot_c[t, s] = c_assign[s][(v, m)]
            if zb and k in (OP_B, OP_W):
                slot_r[t, s] = r_assign[s][(v, m)]
            if k in (OP_F, OP_FH) and v == 0 and s == 0:
                inject[t, s] = 1
            if k == OP_B and v == 0 and s == 0:
                emit[t, s] = 1
        # arrival routing (the same _f_dest/_b_dest the builders
        # scheduled with): rank r receives the up value from rank
        # (r-1)%S and the down value from rank (r+1)%S, end of tick t
        for r in range(S):
            k, v, m = row[(r - 1) % S]
            if k == OP_F:  # FH is consumed locally by the head
                tgt = _f_dest(S, V, v, (r - 1) % S, m)
                assert tgt is not None and tgt[1] == r
                store_up[t, r] = x_assign[r][(tgt[0], tgt[2])]
            k, v, m = row[(r + 1) % S]
            if k == OP_B:
                tgt = _b_dest(S, V, v, (r + 1) % S, m)
                if tgt is not None:  # None: (0,0) dx -> embedding
                    assert tgt[1] == r
                    store_dn[t, r] = c_assign[r][(tgt[0], tgt[2])]
    return Schedule(
        num_stages=S, num_microbatches=M, virtual_chunks=V,
        variant=variant, ticks=T, depth_x=depth_x, depth_c=depth_c,
        depth_r=depth_r, kind=kind, chunk=chunk, mb=mb, slot_x=slot_x,
        slot_c=slot_c, slot_r=slot_r, inject=inject, emit=emit,
        store_up=store_up, store_dn=store_dn)



# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def pipeline_train_async(
    stage_fn: Callable[[Any, Any], Any],
    head_fn: Callable[[Any, Any, Any], Any],
    stage_params: Any,
    head_params: Any,
    x: Any,
    aux: Any,
    *,
    num_stages: int,
    virtual_chunks: int = 1,
    variant: str = "1f1b",
    mesh: Any,
    _schedule: Optional[Schedule] = None,
):
    """One fused forward + backward under a rank-asymmetric schedule,
    on this rank's part of the pipeline.

    Same arguments and return as ``pipeline_1f1b.pipeline_train_1f1b``
    (this rank's ``V`` chunks, ``x`` read on the first rank, ``aux`` on
    the last; ``(loss, grads_stage, grads_head, dx)``). This rank walks
    column ``pp`` of ``build_schedule(S, M, V, variant)`` (or
    ``_schedule``): F, B, F+head and, for ``zb``, W, with the rings of
    the table's depths; idle ticks cost nothing.
    """
    import torch

    from .pipeline_1f1b import (_Run, _add_f32, _backward, _forward,
                                _head, _weight_grads, _zeros_f32)
    S, V = int(num_stages), int(virtual_chunks)
    run = _Run(mesh, S, x, stage_params)
    M, r, dt = run.M, run.r, run.dt
    if mesh.cp_degree > 1 or mesh.ep_degree > 1:
        raise NotImplementedError(
            "rank-asymmetric schedules compose dp/tp/pp only; cp and ep "
            "must be size 1")
    if len(stage_params) != V:
        raise ValueError(f"need this rank's {V} chunks, got "
                         f"{len(stage_params)}")
    sched = _schedule if _schedule is not None else build_schedule(
        S, M, V, variant)
    zb = sched.variant == "zb"
    sx = [None] * sched.depth_x
    sc = [None] * sched.depth_c
    sr = [None] * max(sched.depth_r, 1)
    gacc = [_zeros_f32(p) for p in stage_params]
    ghead = _zeros_f32(head_params) if run.last else None
    loss = torch.zeros((), dtype=torch.float32, device=run.dev)
    dxbuf = [None] * M if run.first else None
    for t in range(sched.ticks):
        kind = int(sched.kind[t, r])
        v, m = int(sched.chunk[t, r]), int(sched.mb[t, r])
        sl_x, sl_c = int(sched.slot_x[t, r]), int(sched.slot_c[t, r])
        sl_r = int(sched.slot_r[t, r])
        p = stage_params[v] if kind != IDLE else None
        if kind in (OP_F, OP_FH):
            if sched.inject[t, r]:
                sx[sl_x] = x[m]
            y = _forward(stage_fn, p, sx[sl_x], dt)
            if kind == OP_FH:
                lm, dy, dh = _head(head_fn, head_params, y, aux[m], dt)
                loss += lm.float()
                _add_f32(ghead, dh)
                sc[sl_c] = dy
            else:
                run.send(y, r + 1, ("f", 0, t))
        elif kind == OP_B:
            dx, dps, kept = _backward(stage_fn, p, sx[sl_x], sc[sl_c], dt,
                                      want_dp=not zb, keep=zb)
            sx[sl_x] = None
            if zb:
                sr[sl_r] = kept
            else:
                sc[sl_c] = None
                _add_f32(gacc[v], dps)
            if sched.emit[t, r]:
                dxbuf[m] = dx
            else:
                run.send(dx, r - 1, ("b", 0, t))
        elif kind == OP_W:
            _add_f32(gacc[v], _weight_grads(p, sr[sl_r]))
            sr[sl_r] = sc[sl_c] = None
        if sched.store_up[t, r] >= 0:
            run.expect(("f", 0, t), r - 1)
        if sched.store_dn[t, r] >= 0:
            run.expect(("b", 0, t), r + 1)
        run.exchange()
        if sched.store_up[t, r] >= 0:
            sx[int(sched.store_up[t, r])] = run.inbox.pop(("f", 0, t))
        if sched.store_dn[t, r] >= 0:
            sc[int(sched.store_dn[t, r])] = run.inbox.pop(("b", 0, t))
    dx = torch.stack(dxbuf) if run.first else None
    return run.loss(loss), gacc, ghead, dx
