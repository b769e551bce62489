"""The port's ``TCPStore``, ``Watchdog`` and auto-tuner against the JAX
package's.

The store cases are the JAX store's tests (``tests/test_native_runtime.py``
and ``tests/test_advice_fixes.py``) on the port's store, which stands on
``torch.distributed.TCPStore``. The watchdog cases
(``tests/test_watchdog_tuner_ckpt.py``) run on both packages' classes.
The tuner's candidates, memory and cost estimates and its search equal
the JAX module's exactly, the JAX defaults' rates (125e12 FLOP/s, 40e9
B/s) passed to the port explicitly, as the port carries no rate."""
import io
import threading
import time

import pytest
import torch

from paddle_tpu.distributed import auto_tuner as JT
from paddle_tpu.distributed.watchdog import Watchdog as JaxWatchdog
from paddle_tpu_torch.distributed import auto_tuner as TT
from paddle_tpu_torch.distributed.store import TCPStore
from paddle_tpu_torch.distributed.watchdog import Watchdog

# ---------------------------------------------------------------- store ----


def test_tcp_store_set_get_add_barrier():
    master = TCPStore(is_master=True, world_size=2)
    client = TCPStore(host="127.0.0.1", port=master.port, world_size=2)
    master.set("k", {"rank": 0})
    assert client.get("k") == {"rank": 0}
    assert client.add("cnt", 5) == 5
    assert master.add("cnt", 2) == 7
    assert client.add("cnt", 0) == 7           # add 0 reads the counter
    errs = []

    def other():
        try:
            client.barrier("b1")
        except Exception as e:  # pragma: no cover
            errs.append(e)

    t = threading.Thread(target=other)
    t.start()
    master.barrier("b1")
    t.join(timeout=10)
    assert not t.is_alive() and not errs
    client.close()
    master.close()


def test_tcp_store_wait_blocks_until_set():
    master = TCPStore(is_master=True)
    client = TCPStore(host="127.0.0.1", port=master.port)
    done = threading.Event()

    def waiter():
        client.wait("late-key")
        done.set()

    t = threading.Thread(target=waiter, daemon=True)
    t.start()
    assert not done.wait(0.2)
    master.set("late-key", b"v")
    assert done.wait(10)
    with pytest.raises(TimeoutError):
        client.wait("never", timeout=0.2)
    client.close()
    master.close()


def test_store_stop_with_connected_client_does_not_deadlock():
    master = TCPStore(is_master=True, world_size=2)
    client = TCPStore(host="127.0.0.1", port=master.port, world_size=2)
    client.set("k", b"v")
    done = threading.Event()

    def closer():
        master.close()
        done.set()

    t = threading.Thread(target=closer, daemon=True)
    t.start()
    assert done.wait(timeout=10), "TCPStore.close() deadlocked with a " \
                                  "connected client"
    client.close()
    with pytest.raises(ConnectionError):
        client.get("k")


def test_store_get_value_larger_than_1mb():
    master = TCPStore(is_master=True, world_size=1)
    try:
        big = b"x" * ((1 << 20) + 12345)
        master.set("big", big)
        assert master.get("big", decode=False) == big
        # missing keys raise KeyError at once (torch's get would block)
        t0 = time.monotonic()
        with pytest.raises(KeyError):
            master.get("nope")
        assert time.monotonic() - t0 < 5
    finally:
        master.close()


def test_store_port_zero_only_on_the_master():
    with pytest.raises(ValueError):
        TCPStore(port=0, is_master=False)


# ------------------------------------------------------------- watchdog ----

WATCHDOGS = pytest.mark.parametrize("cls", [Watchdog, JaxWatchdog],
                                    ids=["port", "jax"])


@WATCHDOGS
def test_watchdog_fires_on_stall_and_not_on_heartbeats(cls):
    log = io.StringIO()
    fired = []
    wd = cls(timeout=0.4, on_timeout=fired.append, log_stream=log)
    with wd:
        for _ in range(6):  # healthy loop: heartbeats keep it quiet
            time.sleep(0.1)
            wd.heartbeat(step=1)
        assert not wd.fired
        time.sleep(0.9)  # stall > timeout
    assert wd.fired and fired and fired[0]["last_step"] == 1
    assert "watchdog" in log.getvalue()
    assert "Thread" in log.getvalue() or "File" in log.getvalue()


@WATCHDOGS
def test_watchdog_stop_prevents_firing(cls):
    fired = []
    wd = cls(timeout=0.3, on_timeout=fired.append)
    wd.start()
    wd.stop()
    time.sleep(0.5)
    assert not fired


@WATCHDOGS
def test_watchdog_rejects_bad_timeout(cls):
    with pytest.raises(ValueError):
        cls(timeout=0)
    with pytest.raises(ValueError):
        cls(timeout=1.0, on_timeout="explode")


def test_watchdog_raise_in_main_interrupts():
    wd = Watchdog(timeout=0.2, on_timeout="raise_in_main",
                  log_stream=io.StringIO())
    with pytest.raises(KeyboardInterrupt):
        with wd:
            time.sleep(5)
    assert wd.fired


# ----------------------------------------------------------- auto-tuner ----

RATES = dict(flops_per_sec=125e12, link_bytes_per_sec=40e9)
JAX_RATES = dict(flops_per_sec=125e12, ici_bytes_per_sec=40e9)
LLAMA7B = dict(hidden=4096, layers=32, ffn=11008, vocab=32000, heads=32,
               seq_len=2048, global_batch=32)
SMALL = dict(hidden=64, layers=4, ffn=128, vocab=256, heads=4,
             global_batch=8, seq_len=64)


def _fields(c):
    return (c.dp, c.tp, c.pp, c.zero, c.microbatches, c.mem_bytes,
            c.step_cost, c.feasible, c.reason)


@pytest.mark.parametrize("n", [1, 4, 8, 32])
@pytest.mark.parametrize("desc", [LLAMA7B, SMALL], ids=["llama7b", "small"])
def test_estimates_equal_jax(desc, n):
    tm, jm = TT.ModelDesc(**desc), JT.ModelDesc(**desc)
    assert tm.n_params == jm.n_params
    tc, jc = TT.candidates(n, tm), JT.candidates(n, jm)
    assert [_fields(c) for c in tc] == [_fields(c) for c in jc]
    assert tc
    for a, b in zip(tc, jc):
        assert TT.estimate_memory(tm, a) == JT.estimate_memory(jm, b)
        assert TT.estimate_step_cost(tm, a, **RATES) == \
            JT.estimate_step_cost(jm, b, **JAX_RATES)


@pytest.mark.parametrize("n,hbm", [(1, 16e9), (32, 16e9), (8, 80e9),
                                   (4, 16e9)])
@pytest.mark.parametrize("desc", [LLAMA7B, SMALL], ids=["llama7b", "small"])
def test_search_equals_jax(desc, n, hbm):
    got = TT.search(n, TT.ModelDesc(**desc), hbm_bytes=hbm, **RATES)
    want = JT.search(n, JT.ModelDesc(**desc), hbm_bytes=hbm)
    assert [_fields(c) for c in got] == [_fields(c) for c in want]


def test_search_prunes_infeasible_single_card():
    assert TT.search(1, TT.ModelDesc(**LLAMA7B), hbm_bytes=16e9,
                     **RATES) == []
    res = TT.search(32, TT.ModelDesc(**LLAMA7B), hbm_bytes=16e9, **RATES)
    assert res and res[0].world == 32
    assert all(c.mem_bytes <= 16e9 for c in res)


def test_bubble_penalizes_small_microbatch_pp():
    m = TT.ModelDesc(**LLAMA7B)
    few = TT.estimate_step_cost(m, TT.Candidate(dp=1, tp=1, pp=8,
                                                microbatches=1), **RATES)
    many = TT.estimate_step_cost(m, TT.Candidate(dp=1, tp=1, pp=8,
                                                 microbatches=8), **RATES)
    assert many < few


def test_measure_rerank_hook():
    calls = []

    def fake_measure(c):
        calls.append(c)
        return 1.0 if c.tp == 1 else 0.5  # pretend tp wins

    res = TT.search(4, TT.ModelDesc(**SMALL), hbm_bytes=16e9,
                    measure=fake_measure, top_k=3, **RATES)
    assert calls, "measure hook not invoked"
    assert res[0].step_cost == min(c.step_cost for c in res[:3])
    want = JT.search(4, JT.ModelDesc(**SMALL), hbm_bytes=16e9,
                     measure=fake_measure, top_k=3)
    assert [_fields(c) for c in res] == [_fields(c) for c in want]


def test_rates_and_card_memory_are_required():
    m = TT.ModelDesc(**SMALL)
    with pytest.raises(TypeError):
        TT.search(4, m, hbm_bytes=16e9)
    with pytest.raises(TypeError):
        TT.estimate_step_cost(m, TT.Candidate(dp=1, tp=1, pp=1))
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="hbm_bytes"):
            TT.search(4, m, **RATES)
