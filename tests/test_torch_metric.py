"""The port's ``metric`` against the JAX package's on seeded inputs.

``Accuracy`` (top-k, its ``compute`` on a tensor through ``torch.topk``
and on numpy through the JAX package's ``argsort``), ``Precision``,
``Recall``, ``Auc`` and the functional ``accuracy``: the logits are
tie-free (distinct draws of a continuous distribution), so the top-k
sets agree; counts are exact and the accumulated values equal the JAX
ones exactly (both divide the same integers in f64).
"""
import numpy as np
import pytest
import torch

from paddle_tpu import metric as JM
from paddle_tpu_torch import metric as TM


def _logits(seed, n=37, c=11):
    rs = np.random.RandomState(seed)
    pred = rs.randn(n, c).astype(np.float32)
    assert all(len(set(r)) == c for r in pred.tolist())   # tie-free
    label = rs.randint(0, c, (n, 1)).astype(np.int64)
    return pred, label


@pytest.mark.parametrize("topk", [(1,), (1, 5), (2, 3, 7)])
@pytest.mark.parametrize("as_tensor", [True, False])
def test_accuracy_matches_jax(topk, as_tensor):
    jm, tm = JM.Accuracy(topk=topk), TM.Accuracy(topk=topk)
    for seed in range(3):
        pred, label = _logits(seed)
        jc = jm.compute(pred, label)
        if as_tensor:
            tc = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
            assert isinstance(tc, torch.Tensor)
            assert tc.shape == (len(pred), max(topk))
        else:
            tc = tm.compute(pred, label)
        np.testing.assert_array_equal(
            tc.numpy() if as_tensor else tc, jc)
        assert tm.update(tc) == jm.update(jc)
    assert tm.accumulate() == jm.accumulate()
    assert tm.name() == jm.name()
    tm.reset()
    assert tm.count == 0 and tm.total == [0.0] * len(topk)


def test_accuracy_labels_without_trailing_axis():
    pred, label = _logits(7)
    tm = TM.Accuracy(topk=(1, 2))
    a = tm.compute(torch.from_numpy(pred), torch.from_numpy(label))
    b = tm.compute(torch.from_numpy(pred), torch.from_numpy(label[:, 0]))
    assert torch.equal(a, b)


@pytest.mark.parametrize("cls", ["Precision", "Recall"])
def test_precision_recall_match_jax(cls):
    rs = np.random.RandomState(3)
    jm, tm = getattr(JM, cls)(), getattr(TM, cls)()
    for _ in range(4):
        preds = rs.rand(50).astype(np.float32)
        labels = rs.randint(0, 2, 50)
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    assert tm.accumulate() == jm.accumulate()
    assert 0 < tm.accumulate() < 1 and tm.name() == jm.name()


@pytest.mark.parametrize("two_columns", [False, True])
def test_auc_matches_jax(two_columns):
    rs = np.random.RandomState(4)
    jm, tm = JM.Auc(num_thresholds=255), TM.Auc(num_thresholds=255)
    for _ in range(3):
        labels = rs.randint(0, 2, 64)
        p = np.clip(0.3 * labels + 0.7 * rs.rand(64), 0, 1).astype(
            np.float32)
        preds = np.stack([1 - p, p], 1) if two_columns else p
        jm.update(preds, labels)
        tm.update(torch.from_numpy(preds), torch.from_numpy(labels))
    np.testing.assert_array_equal(tm._stat_pos, jm._stat_pos)
    assert tm.accumulate() == jm.accumulate()
    assert 0.5 < tm.accumulate() <= 1.0


@pytest.mark.parametrize("k", [1, 3])
def test_functional_accuracy_matches_jax(k):
    pred, label = _logits(9)
    assert TM.accuracy(torch.from_numpy(pred), torch.from_numpy(label),
                       k=k) == JM.accuracy(pred, label, k=k)


def test_bf16_logits_read_on_the_host():
    pred, label = _logits(11)
    tm = TM.Precision()
    tm.update(torch.from_numpy(pred[:, 0]).bfloat16(),
              torch.from_numpy(label[:, 0] % 2))
    assert tm.tp + tm.fp > 0
