"""paddle_tpu_torch.distributed.launch — multi-process / multi-node
launcher.

Port of ``paddle_tpu/distributed/launch`` (reference:
python/paddle/distributed/launch/main.py, the ``python -m
paddle.distributed.launch`` CLI). The launcher spawns one process per
local rank, wires torch's rendezvous environment — ``MASTER_ADDR`` /
``MASTER_PORT`` (a fresh port per attempt or generation: the last one's
socket may linger), ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE`` — with Paddle's views of it (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_LOCAL_RANK``,
``PADDLE_CURRENT_ENDPOINT``), which ``env.init_parallel_env`` reads, and
``PADDLE_RESTART_ATTEMPT``, which ``checkpoint.restart_attempt`` reads.
An inherited ``PADDLE_INIT_METHOD`` (``spawn``'s ``file://`` store) is
not passed on: a restarted job would meet the last one's keys there.

Failures propagate: any child dying non-zero tears the node's job down
and its code becomes the launcher's. ``--max_restarts N`` restarts the
whole job; across nodes the launchers agree on restarts through a
generation counter on a ``TCPStore`` at ``master_port + 1``.

Usage:
    python -m paddle_tpu_torch.distributed.launch --nproc 4 train.py [args]
    python -m paddle_tpu_torch.distributed.launch --nnodes 2 --node_rank 0 \\
        --master 10.0.0.1:6379 --nproc 1 train.py
"""
from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional

__all__ = ["build_parser", "launch", "main"]

_TAG = "[paddle_tpu_torch launch]"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="spawn a multi-process job wired for "
                    "torch.distributed / init_parallel_env")
    p.add_argument("--nnodes", type=int, default=1,
                   help="number of nodes (hosts) in the job")
    p.add_argument("--node_rank", type=int, default=0,
                   help="rank of this node in [0, nnodes)")
    p.add_argument("--master", type=str, default=None,
                   help="rendezvous host:port (default: localhost:auto "
                        "for single-node)")
    p.add_argument("--nproc", "--nproc_per_node", dest="nproc", type=int,
                   default=1, help="processes to spawn on this node")
    p.add_argument("--log_dir", type=str, default=None,
                   help="write per-rank stdout/stderr to "
                        "<log_dir>/workerlog.<rank> (restart attempts "
                        "append .<attempt>)")
    p.add_argument("--max_restarts", type=int, default=0,
                   help="elastic: restart the whole job up to N times "
                        "after a failed worker (reference: fleet elastic "
                        "manager)")
    p.add_argument("--env", action="append", default=[],
                   help="extra KEY=VALUE env for the children")
    p.add_argument("script", help="training script to run")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p


def launch(args: Optional[List[str]] = None) -> int:
    """Run the job; with --max_restarts N, a failed attempt is retried
    with a fresh rendezvous (the elastic-manager restart loop, scoped to
    whole-job restarts: the ranks' collectives cannot go on with a
    partial world). Multi-node jobs agree on restarts through a
    rendezvous-generation counter on a TCPStore
    (``_launch_elastic_multinode``)."""
    ns = build_parser().parse_args(args)
    attempts = max(int(getattr(ns, "max_restarts", 0)), 0) + 1
    if attempts > 1 and ns.nnodes > 1:
        return _launch_elastic_multinode(ns, attempts)
    rc = 1
    for attempt in range(attempts):
        rc = _launch_once(ns, attempt)
        if rc == 0 or rc == 130:
            return rc
        if attempt + 1 < attempts:
            print(f"{_TAG} attempt {attempt} failed (exit {rc}); "
                  f"restarting ({attempts - attempt - 1} retries left)",
                  file=sys.stderr, flush=True)
    return rc


def _launch_elastic_multinode(ns, attempts: int) -> int:
    """Multi-node elastic restart (reference: the elastic manager,
    fleet/elastic/manager.py:125,218 — restart events agreed across
    nodes; the world size is fixed).

    Every launcher joins a TCPStore rendezvous hosted by node 0 at
    ``master_port + 1``. Per GENERATION g: launchers meet at
    ``elastic_<g>_go``, spawn workers against a generation's rendezvous
    port (``master_port + 2 + g``), and watch both their children and the
    shared ``elastic_fail_<g>`` counter. Any worker death anywhere flags
    the counter; every launcher then tears down its local workers and
    joins the next generation, whose workers resume from the newest
    checkpoint (``PADDLE_RESTART_ATTEMPT`` / ``load_latest_checkpoint``).
    """
    from ..store import TCPStore
    if ns.master is None:
        raise SystemExit("--master host:port is required for multi-node "
                         "jobs")
    host, _, port_s = ns.master.partition(":")
    port = int(port_s)
    store = TCPStore(host, port + 1, is_master=(ns.node_rank == 0),
                     world_size=ns.nnodes, timeout=60.0)

    def leave(rc):
        # a departing launcher (success, interrupt, retries exhausted)
        # says so, or peers would wait at the next rendezvous
        try:
            store.set("elastic_abort", str(rc).encode())
        except Exception:
            pass
        return rc

    def peer_left() -> bool:
        try:
            store.get("elastic_abort", decode=False)
            return True
        except KeyError:
            return False
        except Exception:
            return True  # master launcher (store host) gone

    def join_generation(gen, timeout=600.0) -> bool:
        """Check in for generation ``gen`` and POLL for the go signal,
        re-checking the abort key each tick (a blocking wait would hang
        on a peer that left after the check)."""
        try:
            n = store.add(f"elastic_{gen}_in", 1)
            if n == ns.nnodes:
                store.set(f"elastic_{gen}_go", b"1")
        except Exception:
            return False  # store gone: master left
        deadline = time.time() + timeout
        while True:
            try:
                store.get(f"elastic_{gen}_go", decode=False)
                return True
            except KeyError:
                pass
            except Exception:
                return False
            if peer_left() or time.time() > deadline:
                return False
            time.sleep(0.2)

    rc = 1
    try:
        for gen in range(attempts):
            if gen and peer_left():
                print(f"{_TAG} node {ns.node_rank}: a peer launcher left "
                      "the job; not restarting", file=sys.stderr)
                return leave(rc)
            if not join_generation(gen):
                return leave(rc)
            rc = _launch_once(ns, gen, master_override=(host, port + 2 + gen),
                              store=store)
            if rc == 0 or rc == 130:
                return leave(rc)
            if gen + 1 < attempts:
                print(f"{_TAG} node {ns.node_rank}: generation {gen} "
                      f"failed (exit {rc}); rejoining rendezvous "
                      f"({attempts - gen - 1} retries left)",
                      file=sys.stderr, flush=True)
        return leave(rc)
    finally:
        store.close()


def _child_env(ns, rank: int, local_rank: int, world: int, addr: str,
               port: int, attempt: int) -> dict:
    env = dict(os.environ)
    env.pop("PADDLE_INIT_METHOD", None)
    env.update({
        "MASTER_ADDR": addr,
        "MASTER_PORT": str(port),
        "RANK": str(rank),
        "WORLD_SIZE": str(world),
        "LOCAL_RANK": str(local_rank),
        "LOCAL_WORLD_SIZE": str(ns.nproc),
        # Paddle's views (ParallelEnv reads these)
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(world),
        "PADDLE_LOCAL_RANK": str(local_rank),
        "PADDLE_CURRENT_ENDPOINT": f"{socket.gethostname()}:{rank}",
        # elastic: which restart attempt this is (scripts resume from
        # their last checkpoint when > 0)
        "PADDLE_RESTART_ATTEMPT": str(attempt),
    })
    for kv in ns.env:
        k, _, v = kv.partition("=")
        env[k] = v
    return env


def _launch_once(ns, attempt: int = 0, master_override=None,
                 store=None) -> int:
    world = ns.nnodes * ns.nproc
    if master_override is not None:
        addr, port = master_override
    elif ns.master is not None:
        addr, _, port_s = ns.master.partition(":")
        port = int(port_s)
    elif ns.nnodes > 1:
        raise SystemExit("--master host:port is required for multi-node "
                         "jobs")
    else:
        # fresh port per attempt: the old rendezvous socket may linger
        addr, port = "127.0.0.1", _free_port()

    procs: List[subprocess.Popen] = []
    logs = []
    base_rank = ns.node_rank * ns.nproc
    for local_rank in range(ns.nproc):
        rank = base_rank + local_rank
        env = _child_env(ns, rank, local_rank, world, addr, port, attempt)
        out = None
        if ns.log_dir:
            os.makedirs(ns.log_dir, exist_ok=True)
            suffix = f".{attempt}" if attempt else ""
            out = open(os.path.join(ns.log_dir,
                                    f"workerlog.{rank}{suffix}"), "wb")
            logs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-u", ns.script, *ns.script_args],
            env=env, stdout=out, stderr=out))

    rc = _watch(procs, store=store, gen=attempt, base_rank=base_rank)
    for f in logs:
        f.close()
    return rc


def _kill_all(procs: List[subprocess.Popen]) -> None:
    for q in procs:
        if q.poll() is None:
            q.terminate()
    deadline = time.time() + 10
    for q in procs:
        try:
            q.wait(timeout=max(0.1, deadline - time.time()))
        except subprocess.TimeoutExpired:
            q.kill()
            q.wait()


def _watch(procs: List[subprocess.Popen], store=None, gen: int = 0,
           base_rank: int = 0) -> int:
    """Failure propagation (reference launch watchdog): the first
    non-zero exit kills every other local worker and becomes the job's
    exit code. With a rendezvous ``store``, failures also propagate
    ACROSS nodes through the ``elastic_fail_<gen>`` counter."""
    try:
        while True:
            alive = False
            for i, p in enumerate(procs):
                code = p.poll()
                if code is None:
                    alive = True
                elif code != 0:
                    print(f"{_TAG} rank {base_rank + i} exited with code "
                          f"{code}; stopping the job", file=sys.stderr,
                          flush=True)
                    if store is not None:
                        try:
                            store.add(f"elastic_fail_{gen}", 1)
                        except Exception:
                            pass  # master launcher gone: local teardown
                    _kill_all(procs)
                    return code
            if not alive:
                return 0
            if store is not None:
                try:
                    failed = store.add(f"elastic_fail_{gen}", 0) > 0
                except Exception:
                    failed = False
                if failed:
                    # a REMOTE worker died: tear down this node's
                    # workers and rejoin the rendezvous
                    _kill_all(procs)
                    return 1
            time.sleep(0.1)
    except KeyboardInterrupt:
        for q in procs:
            if q.poll() is None:
                q.send_signal(signal.SIGINT)
        for q in procs:
            q.wait()
        return 130


def main() -> None:
    raise SystemExit(launch())
