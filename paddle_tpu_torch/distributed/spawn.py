"""Start one process a rank and collect what each returns.

Port of ``paddle_tpu/distributed/extras.py:102-126`` ``spawn``, the
launcher the tests and ``chip_smoke.py`` use. Each rank is a ``spawn``ed
process (never ``fork``: the parent may hold threads and a CUDA
context) with its rank in the environment (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``) and a
rendezvous in a fresh ``file://`` store (``PADDLE_INIT_METHOD``), so two
worlds started side by side never race for a port. The rank calls
``distributed.init_parallel_env()`` itself.

``spawn(func, args, nprocs)`` returns ``[func(*args) of rank 0, ...]``
(pickled through a file a rank). When a rank fails, the others are
stopped and ``SpawnError`` names every failed rank's exit code and
traceback.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Optional

__all__ = ["spawn", "SpawnError", "SpawnContext"]


class SpawnError(RuntimeError):
    pass


def _entry(payload: str, env, prefix):
    os.environ.update(env)
    try:
        with open(payload, "rb") as f:
            func, args = pickle.load(f)
        result = func(*args)
    except BaseException:
        with open(prefix + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    with open(prefix + ".pkl", "wb") as f:
        pickle.dump(result, f)


class SpawnContext:
    """The started ranks; ``join()`` waits for them and returns their
    results (``spawn(join=False)`` returns this)."""

    def __init__(self, procs, tmp: str):
        self.processes = procs
        self._tmp = tmp

    def _stop(self) -> None:
        for p in self.processes:
            if p.is_alive():
                p.terminate()
        for p in self.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()

    def join(self, timeout_s: Optional[float] = None) -> list:
        t0 = time.monotonic()
        try:
            while True:
                codes = [p.exitcode for p in self.processes]
                if any(c not in (None, 0) for c in codes):
                    break
                if all(c == 0 for c in codes):
                    return [self._result(r)
                            for r in range(len(self.processes))]
                if timeout_s is not None and \
                        time.monotonic() - t0 > timeout_s:
                    raise SpawnError(
                        f"ranks still running after {timeout_s} s: "
                        + ", ".join(str(r) for r, c in enumerate(codes)
                                    if c is None))
                time.sleep(0.05)
            self._stop()
            raise SpawnError(self._failures())
        finally:
            self._stop()
            shutil.rmtree(self._tmp, ignore_errors=True)

    def _result(self, rank: int):
        with open(os.path.join(self._tmp, f"rank{rank}.pkl"), "rb") as f:
            return pickle.load(f)

    def _failures(self) -> str:
        out = []
        for r, p in enumerate(self.processes):
            err = os.path.join(self._tmp, f"rank{r}.err")
            if os.path.exists(err):
                with open(err) as f:
                    tb = f.read()
                out.append(f"rank {r} exit code {p.exitcode}:\n{tb}")
            elif p.exitcode not in (0, None):
                out.append(f"rank {r} exit code {p.exitcode}")
        return "spawned ranks failed:\n" + "\n".join(out)


def spawn(func, args=(), nprocs: int = -1, join: bool = True,
          daemon: bool = False, *, timeout_s: Optional[float] = None,
          **options):
    """Run ``func(*args)`` in ``nprocs`` rank processes (``PADDLE_NPROCS``
    when -1). ``func`` must be importable by name (a module's top-level
    function). Returns the ranks' results in rank order (``join=False``:
    a ``SpawnContext``); ``timeout_s`` bounds the wait."""
    n = nprocs if nprocs > 0 else int(os.environ.get("PADDLE_NPROCS", "1"))
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="paddle_spawn_")
    store = os.path.join(tmp, "store")
    # the function and its arguments go through a file: a start writes
    # only a few bytes down the child's pipe, so the parent never waits
    # for one rank's imports before it starts the next
    payload = os.path.join(tmp, "payload.pkl")
    with open(payload, "wb") as f:
        pickle.dump((func, args), f)
    procs = []
    for rank in range(n):
        renv = {"RANK": str(rank), "WORLD_SIZE": str(n),
                "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(n),
                "PADDLE_TRAINER_ID": str(rank),
                "PADDLE_TRAINERS_NUM": str(n),
                "PADDLE_INIT_METHOD": "file://" + store}
        p = ctx.Process(target=_entry, daemon=daemon,
                        args=(payload, renv,
                              os.path.join(tmp, f"rank{rank}")))
        p.start()
        procs.append(p)
    sc = SpawnContext(procs, tmp)
    return sc.join(timeout_s) if join else sc
