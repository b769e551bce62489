"""TCPStore rendezvous (reference: paddle/phi/core/distributed/store/
tcp_store.h).

Port of ``paddle_tpu/distributed/store.py``, on ``torch.distributed``'s
``TCPStore`` (the JAX package's server is its own native library). The
JAX store's semantics are kept where torch's differ: ``get`` of a
missing key raises ``KeyError`` at once (torch's blocks until its
timeout), values that are not ``bytes`` are pickled and ``get`` unpickles
unless ``decode=False``, ``add(key, 0)`` reads a counter, and
``wait(timeout=None)`` waits without end.
"""
from __future__ import annotations

import datetime
import pickle
import socket
from typing import Any, Optional

import torch.distributed as dist

__all__ = ["TCPStore"]

# the longest single wait handed to torch's store; wait(timeout=None)
# waits in such slices
_SLICE_S = 3600.0


def _td(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


class TCPStore:
    """paddle.distributed TCPStore-compatible client (+server on the
    master). API: set/get (bytes or pickled), add (int counter), wait,
    barrier, close. ``port=0`` on the master binds a free port (read it
    back as ``.port``)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 is_master: bool = False, world_size: int = 1,
                 timeout: float = 120.0):
        if port == 0 and not is_master:
            raise ValueError("port=0 (auto) only valid for the master")
        self.world_size = world_size
        self.host = host
        self._store = dist.TCPStore(
            socket.gethostbyname(host), port, None, is_master,
            timeout=_td(timeout), wait_for_workers=False)
        self.port = self._store.port

    def _live(self):
        if self._store is None:
            raise ConnectionError("TCPStore is closed")
        return self._store

    # -- raw kv -------------------------------------------------------------
    def set(self, key: str, value) -> None:
        data = bytes(value) if isinstance(value, (bytes, bytearray)) else \
            pickle.dumps(value)
        self._live().set(key, data)

    def get(self, key: str, decode: bool = True) -> Any:
        store = self._live()
        if not store.check([key]):
            raise KeyError(key)
        raw = store.get(key)
        return pickle.loads(raw) if decode else raw

    def add(self, key: str, delta: int = 1) -> int:
        return int(self._live().add(key, int(delta)))

    def wait(self, key: str, timeout: Optional[float] = None) -> None:
        """Block until ``key`` exists; ``TimeoutError`` after ``timeout``
        seconds (None: no limit)."""
        store = self._live()
        while True:
            span = _SLICE_S if timeout is None else timeout
            try:
                store.wait([key], _td(span))
                return
            except dist.DistStoreError:
                if timeout is not None:
                    raise TimeoutError(
                        f"TCPStore wait({key!r}) timed out after "
                        f"{timeout}s") from None

    # -- conveniences -------------------------------------------------------
    def barrier(self, name: str = "barrier") -> None:
        n = self.add(f"__{name}_in", 1)
        if n == self.world_size:
            self.set(f"__{name}_go", b"1")
        self.wait(f"__{name}_go")

    def close(self) -> None:
        """Drop this client (and, on the master, its server once no
        reference to it remains)."""
        self._store = None
