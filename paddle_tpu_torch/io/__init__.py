"""paddle.io for the port (port of ``paddle_tpu/io``): datasets, samplers,
the ``DataLoader`` with worker processes or threads, and the
``DeviceLoader`` that stages batches on the card ahead of the loop."""
from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         default_convert_fn, get_worker_info)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .device_prefetch import DeviceLoader
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = ["BatchSampler", "ChainDataset", "ComposeDataset", "ConcatDataset",
           "DataLoader", "Dataset", "DeviceLoader", "DistributedBatchSampler",
           "IterableDataset", "RandomSampler", "Sampler", "SequenceSampler",
           "Subset", "SubsetRandomSampler", "TensorDataset",
           "WeightedRandomSampler", "WorkerInfo", "default_collate_fn",
           "default_convert_fn", "get_worker_info", "random_split"]
