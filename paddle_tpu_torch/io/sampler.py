"""Samplers: ``paddle_tpu/io/sampler.py``.

The JAX package's draws, kept: ``RandomSampler``,
``SubsetRandomSampler`` and ``WeightedRandomSampler`` draw from
``np.random.default_rng(None)`` (fresh entropy, ``generator`` ignored),
so their orders differ from run to run; ``DistributedBatchSampler``
permutes with ``default_rng(epoch)``, so its shards are the same in
every run and in both packages. Its ``num_replicas`` / ``rank`` default
to ``torch.distributed``'s world size and rank when a process group is
initialised, else 1 / 0.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["Sampler", "SequenceSampler", "RandomSampler",
           "SubsetRandomSampler", "WeightedRandomSampler", "BatchSampler",
           "DistributedBatchSampler"]


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None,
                 generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples or len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = np.random.default_rng(None)
        if self.replacement:
            return iter(rng.integers(0, n, self.num_samples).tolist())
        perm = rng.permutation(n)[:self.num_samples]
        return iter(perm.tolist())

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices):
        self.indices = list(indices)

    def __iter__(self):
        rng = np.random.default_rng(None)
        return iter([self.indices[i]
                     for i in rng.permutation(len(self.indices))])

    def __len__(self):
        return len(self.indices)


class WeightedRandomSampler(Sampler):
    def __init__(self, weights, num_samples, replacement=True):
        self.weights = np.asarray(weights, np.float64)
        self.num_samples = num_samples
        self.replacement = replacement

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng(None)
        idx = rng.choice(len(self.weights), self.num_samples,
                         replace=self.replacement, p=p)
        return iter(idx.tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    def __init__(self, dataset=None, sampler=None, shuffle=False,
                 batch_size=1, drop_last=False):
        self.batch_size = batch_size
        self.drop_last = drop_last
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)

    def __iter__(self):
        batch = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Shards sample indices across data-parallel ranks (reference:
    python/paddle/io/dataloader/batch_sampler.py DistributedBatchSampler):
    rank r takes every ``num_replicas``-th index from r, the list padded
    with its own head to a multiple of ``num_replicas``."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        if num_replicas is None or rank is None:
            import torch.distributed as dist
            live = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if live else 1
            if rank is None:
                rank = dist.get_rank() if live else 0
        self.nranks = num_replicas
        self.local_rank = rank
        self.epoch = 0
        self.num_samples = int(math.ceil(len(dataset) / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.epoch)
            indices = rng.permutation(indices)
        indices = np.concatenate(
            [indices, indices[: self.total_size - len(indices)]])
        indices = indices[self.local_rank::self.nranks]
        batch = []
        for idx in indices.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch):
        self.epoch = epoch
