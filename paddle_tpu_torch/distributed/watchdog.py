"""Training watchdog: hang / stall detection for collective steps.

Port of ``paddle_tpu/distributed/watchdog.py`` (reference:
paddle/phi/core/distributed/comm_task_manager.cc:43-59, a loop thread
that aborts a communicator whose task outlives its timeout, with a
rank/op dump).

The observable unit is the train STEP: a daemon thread fed by step
heartbeats; if no heartbeat lands within ``timeout``, it fires: dumps the
live Python stacks of every thread (where the host is stuck: a
collective, the data, a save) and either invokes a user callback,
interrupts the main thread, or hard-aborts the process so that the
launcher (``distributed.launch``, which tears the job down on the first
failure) can restart it. A process that aborts with a large address
space may spend long writing a core file: a launched worker that does
not want one sets ``resource.setrlimit(resource.RLIMIT_CORE, (0, 0))``.

Usage::

    wd = Watchdog(timeout=300, on_timeout="abort")
    wd.start()
    for batch in loader:
        state, loss = step(state, batch)
        wd.heartbeat(step=state["step"])
    wd.stop()
"""
from __future__ import annotations

import faulthandler
import io
import os
import sys
import threading
import time
from typing import Callable, Optional, Union

__all__ = ["Watchdog"]


class Watchdog:
    """Heartbeat-timeout stall detector for the training loop."""

    def __init__(self, timeout: float = 300.0,
                 on_timeout: Union[str, Callable] = "abort",
                 check_interval: Optional[float] = None,
                 log_stream=None):
        """on_timeout: "abort" (dump stacks + os.abort), "raise_in_main"
        (dump + interrupt the main thread), or a callable(info_dict)."""
        if timeout <= 0:
            raise ValueError("timeout must be positive")
        if not callable(on_timeout) and on_timeout not in ("abort",
                                                           "raise_in_main"):
            # validate now: an invalid action found at fire time would
            # die silently inside the daemon thread
            raise ValueError(
                f"on_timeout must be 'abort', 'raise_in_main', or a "
                f"callable, got {on_timeout!r}")
        self.timeout = float(timeout)
        self.on_timeout = on_timeout
        self.check_interval = check_interval or max(timeout / 10.0, 0.05)
        self._log = log_stream or sys.stderr
        self._last = time.monotonic()
        self._last_step = None
        self._stop = threading.Event()
        self._fired = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- producer side ------------------------------------------------------
    def heartbeat(self, step=None) -> None:
        self._last = time.monotonic()
        self._last_step = step

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Watchdog":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._last = time.monotonic()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="paddle_tpu_torch-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    # -- internals ----------------------------------------------------------
    def _loop(self):
        while not self._stop.wait(self.check_interval):
            stalled = time.monotonic() - self._last
            if stalled > self.timeout:
                self._fire(stalled)
                return

    def _fire(self, stalled: float):
        self._fired.set()
        info = {
            "stalled_seconds": stalled,
            "timeout": self.timeout,
            "last_step": self._last_step,
            "pid": os.getpid(),
        }
        try:
            self._log.write(
                f"[paddle_tpu_torch watchdog] no step heartbeat for "
                f"{stalled:.1f}s (timeout {self.timeout}s, last step "
                f"{self._last_step}); thread stacks follow\n")
            self._log.flush()
            try:
                self._log.fileno()
                faulthandler.dump_traceback(file=self._log)
            except (OSError, AttributeError, ValueError,
                    io.UnsupportedOperation):
                import traceback
                for tid, frame in sys._current_frames().items():
                    self._log.write(f"Thread {tid}:\n")
                    self._log.write(
                        "".join(traceback.format_stack(frame)))
            self._log.flush()
        except Exception:
            pass
        if callable(self.on_timeout):
            self.on_timeout(info)
        elif self.on_timeout == "raise_in_main":
            import _thread
            _thread.interrupt_main()
        else:
            os.abort()
