"""High-level Model API: ``paddle_tpu/hapi/model.py`` (reference:
python/paddle/hapi/model.py:1082 ``fit``, :1808 ``predict``), the
Keras-style trainer over an ``nn.Module`` with metrics and callbacks.

The JAX package's loops, kept: ``_split_batch`` (a batch's last element
is the label), ``accumulate_grad_batches``, ``num_iters``,
``stop_training``, ``_metric_logs``, ``stack_outputs``, and a
``DataLoader`` built from a ``Dataset`` with ``drop_last=True`` in
``fit``, ``evaluate`` and ``predict`` alike (``fit``'s ``drop_last``
argument is not read). The model runs where the network's parameters
are: a ``DataLoader`` that ``Model`` builds puts its batches there
(``places``), and batches from any other iterable are moved there.

A train batch is forward, loss (a ``(outputs, labels)`` callable such as
``nn.CrossEntropyLoss``; a non-scalar loss is averaged), backward, then
``optimizer.step()`` and ``clear_grad()`` unless the batch only
accumulates; ``train_batch`` and ``eval_batch`` return ``loss.item()``,
one wait for the card a batch, as the JAX package's
``float(loss.numpy())`` is. Evaluation and prediction run under
``torch.no_grad()``; ``predict`` returns numpy arrays (bf16 outputs
widened to f32, which numpy can hold).

``prepare(amp_configs=...)`` raises for anything but None: the JAX
package accepts and ignores it, which would train in f32 where bf16 was
asked for. ``save`` / ``load`` go through ``framework.io``: the network's
parameters and buffers as ``.pdparams``, the optimizer's state as
``.pdopt``.
"""
from __future__ import annotations

import os
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..io.dataloader import DataLoader, _tree_to_device
from ..io.dataset import Dataset
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _numpy(o) -> np.ndarray:
    if isinstance(o, torch.Tensor):
        o = o.detach()
        if o.dtype in (torch.bfloat16, torch.float16):
            o = o.float()
        return o.cpu().numpy()
    return np.asarray(o)


class Model:
    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self.stop_training = False

    # -- setup --------------------------------------------------------------
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        if amp_configs is not None:
            raise NotImplementedError(
                "Model.prepare(amp_configs=...) is not implemented: the "
                "model would train in its own dtype, not the one asked for")
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(
                    f"metric {m!r} is not a paddle_tpu_torch.metric.Metric")
        return self

    def parameters(self):
        return self.network.parameters()

    def _device(self) -> torch.device:
        """Where the network's parameters are (the card when it has
        none)."""
        for p in self.network.parameters():
            return p.device
        return resolve_device(None)

    # -- per-batch ----------------------------------------------------------
    def _compute_loss(self, outputs, labels):
        outs = _to_list(outputs)
        lbls = _to_list(labels)
        loss = self._loss(*(outs + lbls))
        if isinstance(loss, (list, tuple)):
            loss = sum(loss)
        if loss.ndim > 0:
            loss = loss.mean()
        return loss

    def train_batch(self, inputs, labels=None, update=True):
        self.network.train()
        outputs = self.network(*_to_list(inputs))
        loss = self._compute_loss(outputs, labels)
        loss.backward()
        if update:
            self._optimizer.step()
            self._optimizer.clear_grad()
        metrics = self._update_metrics(outputs, labels)
        return [loss.item()], metrics

    @torch.no_grad()
    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        outputs = self.network(*_to_list(inputs))
        loss = self._compute_loss(outputs, labels)
        metrics = self._update_metrics(outputs, labels)
        return [loss.item()], metrics

    @torch.no_grad()
    def predict_batch(self, inputs):
        self.network.eval()
        out = self.network(*_to_list(inputs))
        return [_numpy(o) for o in _to_list(out)]

    def _update_metrics(self, outputs, labels):
        res = []
        out = _to_list(outputs)[0]
        lbl = _to_list(labels)[0] if labels is not None else None
        for m in self._metrics:
            m.update(*_to_list(m.compute(out, lbl)))
            res.append(m.accumulate())
        return res

    # -- loops --------------------------------------------------------------
    def _loader(self, data, batch_size, shuffle, num_workers):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=True,
                              places=self._device())
        return data  # assume iterable of batches

    def _metric_logs(self, prefix=""):
        logs = {}
        for m in self._metrics:
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = m.accumulate()
            vals = vals if isinstance(vals, list) else [vals]
            for n, v in zip(names, vals):
                logs[prefix + n] = v
        return logs

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        assert self._optimizer is not None and self._loss is not None, \
            "call prepare(optimizer, loss) before fit"
        loader = self._loader(train_data, batch_size, shuffle, num_workers)
        steps = len(loader) if hasattr(loader, "__len__") else None
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size, epochs=epochs,
            steps=steps, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir, metrics=self._metrics)
        dev = self._device()

        self.stop_training = False
        cbks.on_train_begin()
        it = 0
        logs = {}
        for epoch in range(epochs):
            for m in self._metrics:
                m.reset()
            cbks.on_epoch_begin(epoch)
            logs = {}
            for step, batch in enumerate(loader):
                cbks.on_train_batch_begin(step)
                ins, lbls = self._split_batch(_tree_to_device(batch, dev))
                update = (step + 1) % accumulate_grad_batches == 0
                losses, _ = self.train_batch(ins, lbls, update=update)
                logs = {"loss": losses[0], **self._metric_logs()}
                cbks.on_train_batch_end(step, logs)
                it += 1
                if (num_iters and it >= num_iters) or self.stop_training:
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                self.evaluate(eval_data, batch_size=batch_size,
                              verbose=verbose, callbacks=callbacks,
                              num_workers=num_workers)
            if (num_iters and it >= num_iters) or self.stop_training:
                break
        cbks.on_train_end(logs)
        return self

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_samples=None):
        loader = self._loader(eval_data, batch_size, False, num_workers)
        cbks = config_callbacks(
            callbacks, model=self, batch_size=batch_size,
            steps=len(loader) if hasattr(loader, "__len__") else None,
            log_freq=log_freq, verbose=verbose, metrics=self._metrics,
            mode="eval")
        dev = self._device()
        for m in self._metrics:
            m.reset()
        cbks.on_eval_begin()
        losses = []
        for step, batch in enumerate(loader):
            cbks.on_eval_batch_begin(step)
            ins, lbls = self._split_batch(_tree_to_device(batch, dev))
            l, _ = self.eval_batch(ins, lbls)
            losses.append(l[0])
            cbks.on_eval_batch_end(step, {"loss": l[0]})
        logs = {"loss": float(np.mean(losses)) if losses else 0.0,
                **self._metric_logs()}
        cbks.on_eval_end(logs)
        return logs

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._loader(test_data, batch_size, False, num_workers)
        dev = self._device()
        outputs = []
        for batch in loader:
            ins, _ = self._split_batch(_tree_to_device(batch, dev),
                                       has_labels=False)
            outputs.append(self.predict_batch(ins))
        if stack_outputs and outputs:
            n = len(outputs[0])
            return [np.concatenate([o[i] for o in outputs]) for i in range(n)]
        return outputs

    def _split_batch(self, batch, has_labels=True):
        if isinstance(batch, (list, tuple)):
            if len(batch) >= 2:
                # (x..., y) pairs: predict drops the trailing label a
                # labelled Dataset yields (reference predict does the same
                # via its _inputs spec)
                return batch[:-1], (batch[-1:] if has_labels else None)
            return batch, None
        return [batch], None

    # -- persistence --------------------------------------------------------
    def save(self, path, training=True):
        from ..framework import io as fio
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fio.save(self.network.state_dict(keep_vars=True), path + ".pdparams")
        if training and self._optimizer is not None:
            fio.save(self._optimizer.state_dict(), path + ".pdopt")

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..framework import io as fio
        dev = self._device()
        self.network.load_state_dict(
            fio.load(path + ".pdparams", device=dev),
            strict=not skip_mismatch)
        if not reset_optimizer and self._optimizer is not None and \
                os.path.exists(path + ".pdopt"):
            self._optimizer.set_state_dict(
                fio.load(path + ".pdopt", device=dev))
        return self

    def summary(self, input_size=None, dtype=None):
        from .summary import summary as _summary
        return _summary(self.network, input_size, dtypes=dtype)
