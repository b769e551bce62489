"""WorkerTransport: the RPC/queue transport under one worker process.

Port of ``paddle_tpu/serving/fleet/proc/transport.py``. One transport
owns one spawned worker: a command queue in, an event queue out, and a
parent-side pump thread that demultiplexes event frames (wire.py
schema) into

* rpc replies — resolved onto the waiting caller's Event (per-call
  timeout: a worker that never ACKs raises :class:`TransportTimeout`,
  it cannot wedge the caller);
* streaming ``tok``/``done`` frames — handed to the ``on_frame``
  callback (ProcReplica feeds the parent-side Request) AFTER enforcing
  the per-request frame order (fseq must count 0,1,2,... and the done
  frame must carry the final count; a violating frame is counted in
  ``frame_violations`` and DROPPED rather than corrupting a caller's
  token stream);
* death — a worker that exits (or is SIGKILLed) is detected by the
  pump, which first DRAINS every frame already in flight (tokens the
  worker emitted before dying must still reach their handles), then
  fails all outstanding rpc waiters with :class:`WorkerDied` and fires
  ``on_death`` exactly once — unless :meth:`expect_exit` announced a
  deliberate shutdown, because a drained worker exiting is not a
  crash.

Spawn discipline: workers start with the ``spawn`` method only — a
forked child of a parent that holds a CUDA context cannot use CUDA. The
worker env is exported around ``Process.start()`` under a module lock so
the child inherits it even before ``worker_main`` re-asserts it.
"""
from __future__ import annotations

import itertools
import multiprocessing as mp
import os
import queue
import threading
from typing import Callable, Optional

from ...locktrace import wrap_lock
from .worker import worker_main

__all__ = ["WorkerTransport", "TransportError", "TransportTimeout",
           "WorkerDied"]


class TransportError(RuntimeError):
    """Base: rpc failed (remote exception, protocol violation)."""


class TransportTimeout(TransportError):
    """The worker did not ACK within the rpc timeout."""


class WorkerDied(TransportError):
    """The worker process exited while the call was outstanding."""


_spawn_lock = threading.Lock()
_DIED = object()        # waiter resolution marker for a dead worker


class WorkerTransport:
    _CC_LOCK_FREE_READS = {
        "_dead": "monotonic None->reason flag written under _lock; "
                 "unlocked pre-checks only race toward one rpc/cast "
                 "observing death a beat late, and those paths re-check "
                 "or fail on the queue anyway",
    }

    def __init__(self, spec, name: str = "w", *,
                 start_timeout: float = 180.0,
                 on_frame: Optional[Callable] = None,
                 on_death: Optional[Callable] = None,
                 on_event: Optional[Callable] = None):
        self.name = str(name)
        self.on_frame = on_frame
        self.on_death = on_death
        # out-of-band worker events (``("evt", kind, payload)`` frames,
        # e.g. chain_complete) — called as on_event(kind, payload) from
        # the pump thread; keep it cheap/non-blocking
        self.on_event = on_event
        self._ctx = mp.get_context("spawn")
        self._cmd = self._ctx.Queue()
        self._evt = self._ctx.Queue()
        self._lock = wrap_lock(threading.Lock(), "WorkerTransport._lock")
        self._seq = itertools.count(1)
        self._waiters: dict = {}    # seq -> [Event, ok, payload]
        self._fseq: dict = {}       # rid -> next expected frame seq
        self.frame_violations = 0
        self._dead: Optional[str] = None
        self._expect_exit = False
        self._death_fired = False
        self._ready_evt = threading.Event()
        self.ready: Optional[dict] = None
        self._fatal: Optional[str] = None
        with _spawn_lock:
            # export the worker env around start() so the child
            # inherits it even before worker_main re-asserts it
            saved = {k: os.environ.get(k) for k in spec.env}
            os.environ.update(
                {str(k): str(v) for k, v in spec.env.items()})
            try:
                self._proc = self._ctx.Process(
                    target=worker_main, args=(spec, self._cmd,
                                              self._evt),
                    daemon=True, name=f"fleet-proc-{self.name}")
                self._proc.start()
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        self._pump = threading.Thread(target=self._pump_loop,
                                      daemon=True,
                                      name=f"pump-{self.name}")
        self._pump.start()
        if not self._ready_evt.wait(start_timeout):
            self.kill()
            raise TransportTimeout(
                f"worker {self.name} not ready after {start_timeout}s")
        if self.ready is None:
            raise WorkerDied(
                f"worker {self.name} died during startup"
                + (f":\n{self._fatal}" if self._fatal else ""))

    # ------------------------------------------------------------- pump ----
    def _pump_loop(self) -> None:
        while True:
            try:
                msg = self._evt.get(timeout=0.25)
            except queue.Empty:
                if not self._proc.is_alive():
                    # the worker is gone — but frames it emitted before
                    # dying may still sit in the queue buffer: deliver
                    # them FIRST so completed requests resolve instead
                    # of being re-dispatched
                    self._drain_remaining()
                    self._mark_dead("worker process exited")
                    return
                continue
            except (EOFError, OSError):
                self._mark_dead("event queue closed")
                return
            self._feed(msg)
            if msg[0] == "fatal":
                continue    # keep pumping: death detection closes out

    def _drain_remaining(self) -> None:
        while True:
            try:
                self._feed(self._evt.get_nowait())
            except (queue.Empty, EOFError, OSError):
                return

    def _feed(self, msg) -> None:
        """Demultiplex ONE event frame (also the unit-test entry for
        frame-order enforcement — no process needed)."""
        kind = msg[0]
        if kind == "ready":
            self.ready = msg[1]
            self._ready_evt.set()
        elif kind == "reply":
            _, seq, ok, payload = msg
            with self._lock:
                slot = self._waiters.pop(seq, None)
            if slot is not None:
                slot[1], slot[2] = ok, payload
                slot[0].set()
        elif kind in ("tok", "done"):
            rid, fseq = int(msg[1]), int(msg[2])
            with self._lock:
                expect = self._fseq.get(rid, 0)
                if fseq != expect:
                    self.frame_violations += 1
                    return          # drop: never corrupt a stream
                if kind == "tok":
                    self._fseq[rid] = fseq + 1
                else:
                    self._fseq.pop(rid, None)
            if self.on_frame is not None:
                self.on_frame(msg)
        elif kind == "evt":
            if self.on_event is not None:
                try:
                    self.on_event(msg[1], msg[2])
                except Exception:
                    pass    # a policy callback must not kill the pump
        elif kind == "fatal":
            self._fatal = msg[1]
            self._ready_evt.set()   # unblock a waiting constructor

    def _mark_dead(self, why: str) -> None:
        with self._lock:
            if self._dead is not None:
                return
            self._dead = why
            waiters = list(self._waiters.values())
            self._waiters.clear()
            fire = (not self._expect_exit) and not self._death_fired
            if fire:
                self._death_fired = True
        self._ready_evt.set()
        for slot in waiters:
            slot[1], slot[2] = _DIED, why
            slot[0].set()
        if fire and self.on_death is not None:
            self.on_death()

    # -------------------------------------------------------------- api ----
    @property
    def alive(self) -> bool:
        return self._dead is None and self._proc.is_alive()

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid

    def expect_exit(self) -> None:
        """Announce a deliberate shutdown: the coming process exit is
        not a crash (``on_death`` stays unfired)."""
        with self._lock:
            self._expect_exit = True

    def rpc(self, op: str, payload: Optional[dict] = None, *,
            timeout: float = 30.0):
        """Request/reply with the worker; raises TransportTimeout on a
        worker that never ACKs, WorkerDied when it exits mid-call, and
        TransportError carrying the remote traceback string when the
        op itself raised."""
        if self._dead is not None:
            raise WorkerDied(
                f"worker {self.name} is dead ({self._dead})")
        seq = next(self._seq)
        slot = [threading.Event(), None, None]
        with self._lock:
            self._waiters[seq] = slot
        try:
            self._cmd.put(("rpc", seq, op, payload or {}))
        except (ValueError, OSError) as e:
            with self._lock:
                self._waiters.pop(seq, None)
            raise WorkerDied(f"command queue closed: {e}") from e
        if not slot[0].wait(timeout):
            with self._lock:
                self._waiters.pop(seq, None)
            raise TransportTimeout(
                f"worker {self.name}: {op!r} not acknowledged "
                f"after {timeout}s")
        if slot[1] is _DIED:
            raise WorkerDied(
                f"worker {self.name} died during {op!r}: {slot[2]}")
        if not slot[1]:
            raise TransportError(
                f"worker {self.name}: {op!r} failed: {slot[2]}")
        return slot[2]

    def cast(self, op: str, payload: Optional[dict] = None) -> None:
        """One-way, best-effort (e.g. cancel)."""
        if self._dead is not None:
            return
        try:
            self._cmd.put(("cast", op, payload or {}))
        except (ValueError, OSError):
            pass

    def kill(self) -> None:
        """SIGKILL the worker (the crash-injection path; the pump
        converts it into drain-on-failure via ``on_death``)."""
        try:
            self._proc.kill()
        except Exception:
            pass

    def stop(self, timeout: float = 10.0) -> None:
        """Deliberate shutdown: stop frame + join; escalates to kill.
        Callers send the ``shutdown`` rpc first (engine drain)."""
        self.expect_exit()
        try:
            self._cmd.put(("stop",))
        except (ValueError, OSError):
            pass
        self._proc.join(timeout)
        if self._proc.is_alive():
            self.kill()
            self._proc.join(5.0)
        self._pump.join(timeout=2.0)
        # release the queue feeder threads' resources
        for q in (self._cmd, self._evt):
            try:
                q.close()
                q.join_thread()
            except Exception:
                pass
