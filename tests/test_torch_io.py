"""The port's ``io`` (datasets, samplers, ``DataLoader``) against the JAX
package's.

* every dataset class on the same data, and ``random_split`` with an
  int seed, equal to the JAX package's;
* ``BatchSampler`` lengths with and without ``drop_last``; shuffled
  orders (``RandomSampler``, ``SubsetRandomSampler``) are permutations
  (both packages draw them from fresh entropy, so they are not compared
  across packages); ``DistributedBatchSampler``'s shards for 3 ranks x
  2 epochs with shuffle, bitwise the JAX ones;
* ``DataLoader`` batches with ``places="cpu"`` in all three modes
  (``num_workers=0``, threads, forked processes), bitwise the JAX
  loader's read through ``.numpy()`` (the port keeps numpy's int64 and
  f64 where the JAX package's tensors hold int32 and f32: the integers'
  values compared, the f64 of collated Python floats rounded to f32 and
  then compared bitwise), for tuple and dict samples and a custom
  ``collate_fn``;
* a worker's exception text, ``get_worker_info()`` and
  ``worker_init_fn`` inside a worker, an early ``break`` that stops the
  workers, ``IterableDataset`` batching, and the loader refusing to run
  on the CPU when nobody asked for it.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu.io as JIO
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import io as TIO

MODES = {"single": dict(num_workers=0),
         "threads": dict(num_workers=3, use_shared_memory=False),
         "processes": dict(num_workers=3)}


def _np(obj):
    """A batch tree as numpy (tensors of either package read through
    ``.numpy()``)."""
    if isinstance(obj, (Tensor, torch.Tensor)):
        return np.asarray(obj.numpy())
    if isinstance(obj, dict):
        return {k: _np(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_np(v) for v in obj)
    return obj


def _equal(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want)
        for a, b in zip(got, want):
            _equal(a, b)
    elif isinstance(want, np.ndarray):
        got = np.asarray(got)
        assert got.shape == want.shape
        if want.dtype.kind == "f":
            if got.dtype == np.float64 and want.dtype == np.float32:
                got = got.astype(np.float32)   # collated Python floats
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
        else:
            np.testing.assert_array_equal(got, want)
    else:
        assert got == want


class Pairs:
    """(f32 image, int label) samples; both packages' ``Dataset``."""

    def __init__(self, n=23, seed=0):
        rs = np.random.RandomState(seed)
        self.x = rs.randn(n, 3, 4, 5).astype(np.float32)
        self.y = rs.randint(0, 9, n).astype(np.int64)

    def __len__(self):
        return len(self.y)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


class JPairs(Pairs, JIO.Dataset):
    pass


class TPairs(Pairs, TIO.Dataset):
    pass


class Dicts(Pairs):
    def __getitem__(self, i):
        return {"image": self.x[i], "label": int(self.y[i]),
                "weight": float(i) / 4, "name": f"s{i}"}


class JDicts(Dicts, JIO.Dataset):
    pass


class TDicts(Dicts, TIO.Dataset):
    pass


def _collate(batch):
    return {"sum": np.stack([b[0] for b in batch]).sum(0),
            "labels": np.asarray([b[1] for b in batch]), "n": len(batch)}


def _batches(loader):
    return [_np(b) for b in loader]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("sample", ["tuple", "dict", "custom_collate"])
def test_dataloader_batches_bitwise_jax(mode, sample):
    kw = dict(batch_size=5, **MODES[mode])
    if sample == "custom_collate":
        kw["collate_fn"] = _collate
    jds, tds = ((JDicts(), TDicts()) if sample == "dict"
                else (JPairs(), TPairs()))
    want = _batches(JIO.DataLoader(jds, **kw))
    loader = TIO.DataLoader(tds, places="cpu", **kw)
    got = list(loader)
    assert len(got) == len(want) == len(loader) == 5
    for b in got:   # on the asked device, as torch tensors
        leaves = b.values() if isinstance(b, dict) else b
        assert all(t.device.type == "cpu" for t in leaves
                   if isinstance(t, torch.Tensor))
    _equal(_np(got), want)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dataloader_modes_agree_with_drop_last(mode):
    ds = TPairs(n=31)
    ref = _batches(TIO.DataLoader(ds, batch_size=4, drop_last=True,
                                  places="cpu"))
    got = _batches(TIO.DataLoader(ds, batch_size=4, drop_last=True,
                                  places="cpu", **MODES[mode]))
    assert len(got) == 7
    _equal(got, ref)


def test_dataloader_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here: the default device is the card")
    with pytest.raises(RuntimeError, match="CUDA"):
        TIO.DataLoader(TPairs())


class Boom(TPairs):
    def __getitem__(self, i):
        if i == 13:
            raise ValueError("sample 13 is bad")
        return super().__getitem__(i)


def test_worker_exception_text():
    loader = TIO.DataLoader(Boom(), batch_size=5, num_workers=2,
                            places="cpu")
    with pytest.raises(RuntimeError) as e:
        list(loader)
    msg = str(e.value)
    assert msg.startswith("DataLoader worker failed:\n")
    assert "ValueError: sample 13 is bad" in msg
    threaded = TIO.DataLoader(Boom(), batch_size=5, num_workers=2,
                              use_shared_memory=False, places="cpu")
    with pytest.raises(ValueError, match="sample 13"):
        list(threaded)


class WhoAmI(TIO.Dataset):
    def __len__(self):
        return 12

    def __getitem__(self, i):
        info = TIO.get_worker_info()
        return np.asarray([i, info.id, info.num_workers, os.getpid(),
                           int(os.environ.get("_TEST_INIT", -1))])


def _init(wid):
    os.environ["_TEST_INIT"] = str(100 + wid)


@pytest.mark.parametrize("shared", [True, False])
def test_worker_info_and_init_inside_workers(shared):
    loader = TIO.DataLoader(WhoAmI(), batch_size=2, num_workers=3,
                            use_shared_memory=shared, worker_init_fn=_init,
                            places="cpu")
    rows = torch.cat(list(loader)).numpy()
    assert rows[:, 0].tolist() == list(range(12))
    # batch b on worker b mod 3, in either mode's order
    if shared:
        assert rows[:, 1].tolist() == [(i // 2) % 3 for i in range(12)]
        assert len(set(rows[:, 3])) == 3 and os.getpid() not in rows[:, 3]
        assert rows[:, 4].tolist() == [100 + (i // 2) % 3
                                       for i in range(12)]
    assert (rows[:, 2] == 3).all()
    assert TIO.get_worker_info() is None
    os.environ.pop("_TEST_INIT", None)


def test_break_stops_the_workers():
    import multiprocessing as mp
    loader = TIO.DataLoader(TPairs(n=200), batch_size=2, num_workers=3,
                            prefetch_factor=1, places="cpu")
    for i, _ in enumerate(loader):
        if i == 2:
            break
    assert not [p for p in mp.active_children()
                if p.is_alive() and p.daemon]


class Stream(TIO.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32), i


class JStream(JIO.IterableDataset):
    def __iter__(self):
        for i in range(11):
            yield np.full(3, i, np.float32), i


@pytest.mark.parametrize("drop_last", [False, True])
def test_iterable_dataset_batches(drop_last):
    got = _batches(TIO.DataLoader(Stream(), batch_size=4,
                                  drop_last=drop_last, places="cpu"))
    want = _batches(JIO.DataLoader(JStream(), batch_size=4,
                                   drop_last=drop_last))
    assert len(got) == (2 if drop_last else 3)
    _equal(got, want)
    with pytest.raises(TypeError):
        len(TIO.DataLoader(Stream(), places="cpu"))


# --------------------------------------------------------------------------
# datasets
# --------------------------------------------------------------------------

def test_dataset_classes_match_jax():
    rs = np.random.RandomState(1)
    a = rs.randn(6, 2).astype(np.float32)
    b = rs.randint(0, 5, 6)
    td = TIO.TensorDataset([torch.from_numpy(a), torch.from_numpy(b)])
    jd = JIO.TensorDataset([Tensor(a), Tensor(b)])
    assert len(td) == len(jd) == 6
    for i in range(6):
        _equal(_np(td[i]), _np(jd[i]))
    with pytest.raises(AssertionError):
        TIO.TensorDataset([torch.zeros(3), torch.zeros(4)])

    tp, jp = TPairs(n=5), JPairs(n=5)
    tq, jq = TPairs(n=5, seed=2), JPairs(n=5, seed=2)
    for t, j in ((TIO.ComposeDataset([tp, tq]), JIO.ComposeDataset([jp, jq])),
                 (TIO.ConcatDataset([tp, tq]), JIO.ConcatDataset([jp, jq])),
                 (TIO.Subset(tp, [4, 0, 2]), JIO.Subset(jp, [4, 0, 2]))):
        assert len(t) == len(j)
        for i in range(len(t)):
            _equal(t[i], j[i])
    cat = TIO.ConcatDataset([tp, tq])
    _equal(cat[-1], tq[4])
    # (list() would ask an IterableDataset its len(), which raises)
    chain = [s for s in TIO.ChainDataset([Stream(), Stream()])]
    _equal(chain, [s for s in JIO.ChainDataset([JStream(), JStream()])])
    assert len(chain) == 22
    with pytest.raises(RuntimeError):
        Stream()[0]
    with pytest.raises(NotImplementedError):
        TIO.Dataset()[0]


@pytest.mark.parametrize("lengths", [[3, 5, 15], [0.5, 0.25, 0.25]])
def test_random_split_matches_jax(lengths):
    ts = TIO.random_split(TPairs(), lengths, generator=7)
    js = JIO.random_split(JPairs(), lengths, generator=7)
    assert [t.indices for t in ts] == [j.indices for j in js]
    assert sorted(i for t in ts for i in t.indices) == list(range(23))


# --------------------------------------------------------------------------
# samplers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [False, True])
def test_batch_sampler_lengths(drop_last, shuffle):
    ds = TPairs(n=23)
    bs = TIO.BatchSampler(ds, shuffle=shuffle, batch_size=5,
                          drop_last=drop_last)
    batches = list(bs)
    assert len(bs) == len(batches) == (4 if drop_last else 5)
    jbs = JIO.BatchSampler(JPairs(n=23), shuffle=shuffle, batch_size=5,
                           drop_last=drop_last)
    assert len(jbs) == len(bs)
    flat = [i for b in batches for i in b]
    if not drop_last:
        assert sorted(flat) == list(range(23))
    if not shuffle:
        assert batches == list(jbs)


def test_shuffled_orders_are_permutations():
    ds = TPairs(n=40)
    for _ in range(3):
        perm = list(TIO.RandomSampler(ds))
        assert sorted(perm) == list(range(40))
    draws = list(TIO.RandomSampler(ds, replacement=True, num_samples=100))
    assert len(draws) == 100 and all(0 <= i < 40 for i in draws)
    sub = list(TIO.SubsetRandomSampler([3, 9, 11, 20]))
    assert sorted(sub) == [3, 9, 11, 20]
    w = TIO.WeightedRandomSampler([0.0, 1.0, 0.0, 3.0], 50)
    picks = list(w)
    assert len(w) == len(picks) == 50 and set(picks) <= {1, 3}
    assert list(TIO.SequenceSampler(ds)) == list(range(40))
    loader = TIO.DataLoader(ds, batch_size=8, shuffle=True, places="cpu")
    seen = np.concatenate([b[1].numpy() for b in loader])
    assert sorted(seen.tolist()) == sorted(ds.y.tolist())


@pytest.mark.parametrize("drop_last", [False, True])
def test_distributed_batch_sampler_shards_bitwise_jax(drop_last):
    ds, jds = TPairs(n=23), JPairs(n=23)
    for epoch in range(2):
        shards = []
        for rank in range(3):
            t = TIO.DistributedBatchSampler(ds, 3, num_replicas=3, rank=rank,
                                            shuffle=True, drop_last=drop_last)
            j = JIO.DistributedBatchSampler(jds, 3, num_replicas=3,
                                            rank=rank, shuffle=True,
                                            drop_last=drop_last)
            t.set_epoch(epoch)
            j.set_epoch(epoch)
            got = list(t)
            assert got == list(j) and len(t) == len(j) == len(got)
            shards.append([i for b in got for i in b])
        if not drop_last:   # together the ranks cover the data (padded)
            assert sorted(set(i for s in shards for i in s)) == list(
                range(23))
    assert shards != [sorted(s) for s in shards]


def test_distributed_batch_sampler_defaults_without_a_group():
    s = TIO.DistributedBatchSampler(TPairs(n=10), 4)
    assert (s.nranks, s.local_rank) == (1, 0)
    assert [i for b in s for i in b] == list(range(10))
