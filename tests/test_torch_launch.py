"""The port's launcher (``python -m paddle_tpu_torch.distributed.launch``)
against every case of ``tests/test_launch.py``, the JAX launcher's tests.

Each test spawns REAL subprocesses: torch workers on the CPU, joined
over gloo by ``init_parallel_env`` from the launcher's environment
(``MASTER_ADDR`` / ``MASTER_PORT`` / ``RANK`` / ``WORLD_SIZE`` and
Paddle's views of them). The two elastic tests run the whole loop: a
job that trains and checkpoints every step (``distributed.checkpoint``)
loses a rank on attempt 0, the launcher (or two launchers agreeing
through a ``TCPStore``) restarts it, and the script resumes from the
newest checkpoint via ``PADDLE_RESTART_ATTEMPT`` and
``load_latest_checkpoint``, not from step 0."""
import os
import socket
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    # one thread a worker: several workers share the test's cores
    env["OMP_NUM_THREADS"] = "1"
    for k in ("PADDLE_INIT_METHOD", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE"):
        env.pop(k, None)
    return env


def _run_launch(args, script_body, tmp_path, name="worker.py",
                timeout=120):
    script = tmp_path / name
    script.write_text(textwrap.dedent(script_body))
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         *args, str(script)],
        capture_output=True, text=True, env=_env(), timeout=timeout)


def test_two_process_collective(tmp_path):
    res = _run_launch(["--nproc", "2", "--log_dir", str(tmp_path / "lg")],
                      """
        import torch
        from paddle_tpu_torch import distributed as dist
        dist.init_parallel_env(device="cpu")
        assert dist.get_world_size() == 2, dist.get_world_size()
        assert dist.get_backend() == "gloo"
        parts = dist.all_gather([], torch.ones(2) * (dist.get_rank() + 1))
        g = torch.stack(parts)
        assert g.shape == (2, 2), g.shape
        assert float(g.sum()) == 6.0, g
        print("RANK_OK", dist.get_rank())
        dist.destroy_process_group()
        """, tmp_path)
    assert res.returncode == 0, res.stderr
    logs = ""
    for i in range(2):
        logs += (tmp_path / "lg" / f"workerlog.{i}").read_text()
    assert "RANK_OK 0" in logs and "RANK_OK 1" in logs


def test_failure_propagates_and_kills_peers(tmp_path):
    res = _run_launch(["--nproc", "2"], """
        import os, sys, time
        if os.environ["RANK"] == "1":
            sys.exit(3)           # rank 1 dies immediately
        time.sleep(600)           # rank 0 would hang forever
        """, tmp_path, timeout=60)
    assert res.returncode == 3  # child's code becomes the job's code
    assert "rank 1 exited with code 3" in res.stderr


def test_env_wiring_single_proc(tmp_path):
    res = _run_launch(["--nproc", "1", "--env", "MY_FLAG=7"], """
        import os
        assert os.environ["PADDLE_TRAINER_ID"] == "0"
        assert os.environ["PADDLE_TRAINERS_NUM"] == "1"
        assert os.environ["WORLD_SIZE"] == "1"
        assert os.environ["RANK"] == "0"
        assert os.environ["LOCAL_RANK"] == "0"
        assert os.environ["LOCAL_WORLD_SIZE"] == "1"
        assert os.environ["MASTER_ADDR"] == "127.0.0.1"
        assert int(os.environ["MASTER_PORT"]) > 0
        assert os.environ["PADDLE_RESTART_ATTEMPT"] == "0"
        assert "PADDLE_INIT_METHOD" not in os.environ
        assert os.environ["MY_FLAG"] == "7"
        print("ENV_OK")
        """, tmp_path)
    assert res.returncode == 0, res.stderr
    assert "ENV_OK" in res.stdout


def test_elastic_restart_retries_and_succeeds(tmp_path):
    """Elastic: worker fails on attempt 0, succeeds on attempt 1 — the
    launcher restarts the whole job, on a fresh rendezvous port."""
    res = _run_launch(["--nproc", "1", "--max_restarts", "2",
                       "--env", f"MARK_DIR={tmp_path}"], """
        import os, sys
        attempt = int(os.environ["PADDLE_RESTART_ATTEMPT"])
        with open(os.path.join(os.environ["MARK_DIR"],
                               f"port.{attempt}"), "w") as f:
            f.write(os.environ["MASTER_PORT"])
        if attempt == 0:
            sys.exit(7)     # first attempt dies
        print("RECOVERED on attempt", attempt)
        """, tmp_path)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "RECOVERED on attempt 1" in res.stdout
    assert "restarting" in res.stderr
    assert not (tmp_path / "port.2").exists()
    assert (tmp_path / "port.0").read_text() != \
        (tmp_path / "port.1").read_text()


def test_watchdog_abort_restarts_a_gloo_job(tmp_path):
    """The gloo helpers join a world at the launcher's endpoint; on
    attempt 0 rank 1 stalls outside any collective and its watchdog
    aborts it (SIGABRT); the launcher stops rank 0, blocked in a barrier
    behind it, and restarts the job, which then finishes."""
    res = _run_launch(["--nproc", "2", "--max_restarts", "1", "--log_dir",
                       str(tmp_path / "lg")], """
        import os, resource, time
        from paddle_tpu_torch import distributed as dist
        from paddle_tpu_torch.distributed.checkpoint import restart_attempt
        resource.setrlimit(resource.RLIMIT_CORE, (0, 0))
        rank = int(os.environ["RANK"])
        dist.gloo_init_parallel_env(
            rank, int(os.environ["WORLD_SIZE"]),
            f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}")
        assert dist.get_backend() == "gloo"
        dist.gloo_barrier()
        if restart_attempt() == 0 and rank == 1:
            dist.Watchdog(timeout=0.5, on_timeout="abort").start()
            time.sleep(60)                      # the stall
        dist.gloo_barrier()
        print("DONE", rank, restart_attempt())
        dist.gloo_release()
        """, tmp_path)
    assert res.returncode == 0, (res.stdout, res.stderr)
    assert "rank 1 exited with code -6" in res.stderr
    assert "restarting" in res.stderr
    assert "paddle_tpu_torch watchdog" in (
        tmp_path / "lg" / "workerlog.1").read_text()
    for r in (0, 1):
        assert f"DONE {r} 1" in (tmp_path / "lg" /
                                 f"workerlog.{r}.1").read_text()


def test_elastic_exhausts_restarts(tmp_path):
    res = _run_launch(["--nproc", "1", "--max_restarts", "1"], """
        import sys
        sys.exit(9)
        """, tmp_path)
    assert res.returncode == 9


def test_multinode_requires_master(tmp_path):
    script = tmp_path / "noop.py"
    script.write_text("print('hi')")
    res = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nnodes", "2", "--node_rank", "0", "--nproc", "1",
         str(script)],
        capture_output=True, text=True, env=_env(), timeout=60)
    assert res.returncode != 0
    assert "--master" in res.stderr


# the training script of the two elastic tests: every rank holds the same
# state, checkpoints every step and, on attempt 0, CRASH_RANK dies right
# after step 3's checkpoint
_RESUME = """
    import os
    import torch
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import (
        restart_attempt, save_checkpoint, load_latest_checkpoint)

    torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu")
    rank = dist.get_rank()
    crash = int(os.environ["CRASH_RANK"])
    assert dist.get_world_size() == int(os.environ["WANT_WORLD"])
    attempt = restart_attempt()
    root = os.environ["CKPT_DIR"]

    state = {"w": torch.zeros(4, dtype=torch.float32),
             "step": torch.zeros((), dtype=torch.int32)}
    start = load_latest_checkpoint(state, root) + 1
    if attempt == 0:
        assert start == 0, start
    else:
        # the restart must CONTINUE, not retrain from scratch
        assert start >= 3, f"resumed at {start}"
        assert float(state["w"].sum()) > 0

    for step in range(start, 6):
        state["w"] = state["w"] + 1.0          # "training"
        state["step"] = torch.tensor(step, dtype=torch.int32)
        save_checkpoint(state, root, step)
        if attempt == 0 and step == 3 and rank == crash:
            os._exit(13)                        # simulated crash

    if rank == 0:
        with open(os.path.join(os.environ["MARK_DIR"], "done.txt"),
                  "w") as f:
            f.write(f"attempt={attempt} start={start} "
                    f"w={float(state['w'][0])}")
    print("TRAINED", rank, "from", start)
    dist.destroy_process_group()
"""


def _check_marker(tmp_path):
    marker = (tmp_path / "done.txt").read_text()
    assert "attempt=1" in marker, marker
    # resumed at >= step 4 (step 3's checkpoint was committed pre-crash)
    assert any(f"start={s}" in marker for s in (4, 5)), marker
    # w counts one increment per step across BOTH attempts: exactly 6
    assert "w=6.0" in marker, marker


def test_elastic_restart_resumes_from_checkpoint(tmp_path):
    """A 2-proc job checkpoints every step; rank 0 is killed mid-run on
    attempt 0; the launcher restarts the job (--max_restarts 1) and the
    script resumes from the newest checkpoint."""
    ck = tmp_path / "ckpt"
    res = _run_launch(
        ["--nproc", "2", "--max_restarts", "1",
         "--env", f"CKPT_DIR={ck}", "--env", f"MARK_DIR={tmp_path}",
         "--env", "CRASH_RANK=0", "--env", "WANT_WORLD=2"],
        _RESUME, tmp_path, timeout=180)
    assert res.returncode == 0, (res.stdout, res.stderr)
    _check_marker(tmp_path)


def _free_port():
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def test_multinode_elastic_restart_resumes(tmp_path):
    """TWO launchers (2 'nodes' x 2 procs) agree on restarts through the
    TCPStore rendezvous-generation counter. A worker on node 1 dies on
    attempt 0; BOTH launchers tear down, rejoin, respawn generation 1 on
    a fresh rendezvous port, and the job resumes from the newest
    checkpoint and finishes rc=0."""
    master = f"127.0.0.1:{_free_port()}"
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent(_RESUME))
    env = _env()
    env.update(CKPT_DIR=str(tmp_path / "ckpt"), MARK_DIR=str(tmp_path),
               CRASH_RANK="2", WANT_WORLD="4")
    launchers = [
        subprocess.Popen(
            [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
             "--nnodes", "2", "--node_rank", str(node),
             "--master", master, "--nproc", "2", "--max_restarts", "1",
             str(script)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for node in (0, 1)]
    try:
        outs = [p.communicate(timeout=240) for p in launchers]
    finally:
        for p in launchers:
            if p.poll() is None:
                p.kill()
    rcs = [p.returncode for p in launchers]
    assert rcs == [0, 0], (rcs, outs[0][1][-2000:], outs[1][1][-2000:])
    _check_marker(tmp_path)
