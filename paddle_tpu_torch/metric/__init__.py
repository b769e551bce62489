"""``metric`` of the PyTorch port: ``paddle_tpu/metric/__init__.py``.

``Metric`` with its ``compute`` / ``update`` / ``accumulate`` / ``reset``
/ ``name`` protocol, ``Accuracy`` (top-k), ``Precision``, ``Recall``,
``Auc`` and the functional ``accuracy``, as ``hapi.Model`` drives them.
``update`` and ``accumulate`` run on the host in numpy, as in the JAX
package. ``Accuracy.compute`` on a tensor runs where the tensor is
(``torch.topk`` over the logits, then the ``[N, maxk]`` correctness
matrix), so only that matrix crosses to the host; on numpy it is the
JAX package's ``argsort``. Ties among the logits may order differently
in the two (``np.argsort`` is not stable, ``topk``'s order among equals
is its own).
"""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    def __init__(self):
        pass

    @abc.abstractmethod
    def reset(self):
        ...

    @abc.abstractmethod
    def update(self, *args):
        ...

    @abc.abstractmethod
    def accumulate(self):
        ...

    @abc.abstractmethod
    def name(self):
        ...

    def compute(self, *args):
        """Optional fast-path computed inside the traced step; default
        passes predictions/labels through to update()."""
        return args


class Accuracy(Metric):
    """Top-k accuracy (metrics.py Accuracy)."""

    def __init__(self, topk=(1,), name=None):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def compute(self, pred, label):
        if isinstance(pred, torch.Tensor):
            label = torch.as_tensor(label, device=pred.device)
            if label.dim() == pred.dim() and label.shape[-1] == 1:
                label = label[..., 0]
            topk_idx = torch.topk(pred.detach(), self.maxk, dim=-1).indices
            return (topk_idx == label[..., None]).float()
        pred = _to_np(pred)
        label = _to_np(label)
        if label.ndim == pred.ndim and label.shape[-1] == 1:
            label = label[..., 0]
        # [N, maxk] correctness matrix
        topk_idx = np.argsort(-pred, axis=-1)[..., :self.maxk]
        return (topk_idx == label[..., None]).astype(np.float32)

    def update(self, correct):
        correct = _to_np(correct)
        num = correct.shape[0]
        for i, k in enumerate(self.topk):
            self.total[i] += correct[..., :k].any(axis=-1).sum()
        self.count += num
        res = self.total[0] / max(self.count, 1)
        return res

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = 0

    def accumulate(self):
        res = [t / max(self.count, 1) for t in self.total]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return self._name
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision over 0/1 predictions (metrics.py Precision)."""

    def __init__(self, name="precision"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    def __init__(self, name="recall"):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = (_to_np(preds).reshape(-1) > 0.5).astype(np.int64)
        labels = _to_np(labels).reshape(-1).astype(np.int64)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC via threshold bucketing (metrics.py Auc)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc"):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        if preds.ndim == 2 and preds.shape[1] == 2:
            preds = preds[:, 1]
        preds = preds.reshape(-1)
        labels = _to_np(labels).reshape(-1)
        idx = np.clip((preds * self.num_thresholds).astype(np.int64),
                      0, self.num_thresholds)
        for i, l in zip(idx, labels):
            if l:
                self._stat_pos[i] += 1
            else:
                self._stat_neg[i] += 1

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, np.int64)

    def accumulate(self):
        tot_pos = tot_neg = 0.0
        auc = 0.0
        # sweep thresholds high->low accumulating trapezoids
        for i in range(self.num_thresholds, -1, -1):
            p, n = self._stat_pos[i], self._stat_neg[i]
            auc += n * (tot_pos + p / 2.0)
            tot_pos += p
            tot_neg += n
        return auc / (tot_pos * tot_neg) if tot_pos and tot_neg else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1):
    """Functional top-k accuracy."""
    m = Accuracy(topk=(k,))
    return float(m.update(m.compute(input, label)))
