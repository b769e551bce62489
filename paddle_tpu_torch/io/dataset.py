"""Dataset abstractions: ``paddle_tpu/io/dataset.py``.

``TensorDataset`` takes torch tensors (or anything indexable along its
first axis); ``random_split`` shuffles with ``random.Random(generator)``
when ``generator`` is an int, as the JAX package does.
"""
from __future__ import annotations

import bisect

import numpy as np

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "ConcatDataset", "Subset", "random_split"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class IterableDataset(Dataset):
    def __iter__(self):
        raise NotImplementedError

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset does not support indexing")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    def __init__(self, tensors):
        assert all(t.shape[0] == tensors[0].shape[0] for t in tensors)
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        assert all(len(d) == len(self.datasets[0]) for d in self.datasets)

    def __len__(self):
        return len(self.datasets[0])

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            sample = d[idx]
            if isinstance(sample, (list, tuple)):
                out.extend(sample)
            else:
                out.append(sample)
        return tuple(out)


class ChainDataset(IterableDataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        offset = idx - (self.cumulative_sizes[ds_idx - 1] if ds_idx else 0)
        return self.datasets[ds_idx][offset]


class Subset(Dataset):
    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset, lengths, generator=None):
    import random as pyrandom
    total = len(dataset)
    lengths = list(lengths)
    if all(isinstance(l, float) and 0 <= l <= 1 for l in lengths):
        lengths = [int(total * l) for l in lengths]
        lengths[-1] = total - sum(lengths[:-1])
    assert sum(lengths) == total
    indices = list(range(total))
    pyrandom.Random(generator if isinstance(generator, int) else None).shuffle(indices)
    out, start = [], 0
    for l in lengths:
        out.append(Subset(dataset, indices[start:start + l]))
        start += l
    return out
