"""hapi callbacks: ``paddle_tpu/hapi/callbacks.py``.

The ``Callback`` protocol with ``CallbackList``, ``ProgBarLogger``,
``ModelCheckpoint``, ``EarlyStopping``, ``LRScheduler`` and
``config_callbacks``, driven by ``hapi.Model``. One divergence: the
``LRScheduler`` callback steps the optimizer's scheduler (its
``_lr_sched``), once an epoch or, with ``by_step=True``, after each
batch. The JAX package's reads an attribute its optimizer never sets
(``_lr_scheduler``), so there a scheduled ``fit`` trains at a constant
rate.
"""
from __future__ import annotations

import numbers
import os
import time
from typing import List, Optional

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "config_callbacks"]


class Callback:
    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params or {}

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None): ...
    def on_train_end(self, logs=None): ...
    def on_eval_begin(self, logs=None): ...
    def on_eval_end(self, logs=None): ...
    def on_predict_begin(self, logs=None): ...
    def on_predict_end(self, logs=None): ...
    def on_epoch_begin(self, epoch, logs=None): ...
    def on_epoch_end(self, epoch, logs=None): ...
    def on_train_batch_begin(self, step, logs=None): ...
    def on_train_batch_end(self, step, logs=None): ...
    def on_eval_batch_begin(self, step, logs=None): ...
    def on_eval_batch_end(self, step, logs=None): ...
    def on_predict_batch_begin(self, step, logs=None): ...
    def on_predict_batch_end(self, step, logs=None): ...


class CallbackList:
    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self.callbacks = list(callbacks or [])

    def append(self, cb):
        self.callbacks.append(cb)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def __getattr__(self, name):
        if name.startswith("on_"):
            def dispatch(*args, **kw):
                for cb in self.callbacks:
                    getattr(cb, name)(*args, **kw)
            return dispatch
        raise AttributeError(name)


class ProgBarLogger(Callback):
    """Prints per-epoch progress lines (reference ProgBarLogger, minus the
    terminal progress bar — logs go to stdout for CI friendliness)."""

    def __init__(self, log_freq: int = 1, verbose: int = 2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._start = time.time()

    def _fmt(self, logs):
        out = []
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                out.append(f"{k}: {v:.4f}")
            elif isinstance(v, (list, tuple, np.ndarray)):
                out.append(f"{k}: {np.asarray(v).ravel()}")
        return " - ".join(out)

    def on_train_batch_end(self, step, logs=None):
        if self.verbose >= 2 and step % self.log_freq == 0:
            print(f"step {step}/{self.steps or '?'} - {self._fmt(logs)}")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            dt = time.time() - self._start
            print(f"Epoch {epoch}: {self._fmt(logs)} ({dt:.1f}s)")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval: {self._fmt(logs)}")


class ModelCheckpoint(Callback):
    def __init__(self, save_freq: int = 1, save_dir: Optional[str] = None):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and epoch % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch))
            self.model.save(path)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self.model.save(os.path.join(self.save_dir, "final"))


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        if mode == "auto":
            mode = "max" if "acc" in monitor else "min"
        self.mode = mode
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        self.best = (self.baseline if self.baseline is not None
                     else (-np.inf if self.mode == "max" else np.inf))

    def _better(self, cur):
        if self.mode == "max":
            return cur > self.best + self.min_delta
        return cur < self.best - self.min_delta

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        cur = float(np.asarray(cur).ravel()[0])
        if self._better(cur):
            self.best = cur
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler each epoch/batch (reference
    LRScheduler callback; module docstring)."""

    def __init__(self, by_step: bool = False, by_epoch: bool = True):
        super().__init__()
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        return getattr(opt, "_lr_sched", None)

    def on_epoch_end(self, epoch, logs=None):
        s = self._sched()
        if self.by_epoch and s is not None:
            s.step()

    def on_train_batch_end(self, step, logs=None):
        s = self._sched()
        if self.by_step and s is not None:
            s.step()


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks or [])
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    cl = CallbackList(cbks)
    cl.set_model(model)
    cl.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [],
    })
    return cl
