"""``io`` of the PyTorch port: the data pipeline
(``paddle_tpu/io/``): datasets, samplers and the ``DataLoader``, whose
batches land on the card (``dataloader.py``)."""
from .dataset import (Dataset, IterableDataset, TensorDataset, ComposeDataset,
                      ChainDataset, Subset, random_split, ConcatDataset)
from .sampler import (Sampler, SequenceSampler, RandomSampler,
                      WeightedRandomSampler, BatchSampler,
                      DistributedBatchSampler, SubsetRandomSampler)
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info)

__all__ = ["Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
           "ChainDataset", "Subset", "random_split", "ConcatDataset",
           "Sampler", "SequenceSampler", "RandomSampler",
           "WeightedRandomSampler", "BatchSampler", "DistributedBatchSampler",
           "SubsetRandomSampler", "DataLoader", "WorkerInfo",
           "default_collate_fn", "get_worker_info"]
