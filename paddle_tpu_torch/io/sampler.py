"""Samplers (port of ``paddle_tpu/io/sampler.py``; reference:
python/paddle/io/dataloader/sampler.py, batch_sampler.py): index-order
policy objects consumed by ``DataLoader``.

Every shuffle draws from numpy exactly as the JAX package does
(``np.random.default_rng(seed)``, the epoch as the seed once ``set_epoch``
pins it), so one seed and one epoch give both packages the same index
order. ``DistributedBatchSampler`` takes the world's size and this
process's rank from ``distributed.env`` unless given them, pads (or drops)
the epoch to a multiple of the ranks, and deals rank ``r`` every
``r``-th index, as the JAX sampler does.
"""
from __future__ import annotations

import math
from typing import Iterator, List, Optional, Sequence

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))

    def __len__(self):
        return len(self.data_source)


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement=False, num_samples=None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator
        # set_epoch seed (preemption-safe loops): when no
        # explicit generator was given, an epoch pinned here makes the
        # shuffle a pure function of the epoch number — two processes
        # (the original and its resumed successor) draw the SAME order
        self._epoch = None
        if not replacement and num_samples is not None and num_samples > len(data_source):
            raise ValueError("num_samples cannot exceed dataset size when replacement=False")

    def set_epoch(self, epoch: int):
        self._epoch = int(epoch)

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        seed = self.generator
        if seed is None and self._epoch is not None:
            seed = self._epoch
        rng = seed if isinstance(seed, np.random.Generator) else np.random.default_rng(seed)
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[: self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int, replacement=True):
        super().__init__()
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError("num_samples cannot exceed weight count when replacement=False")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        idx = np.random.default_rng().choice(
            len(self.weights), size=self.num_samples, replace=self.replacement, p=p
        )
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class SubsetRandomSampler(Sampler):
    def __init__(self, indices: Sequence[int]):
        super().__init__()
        self.indices = list(indices)

    def __iter__(self):
        perm = np.random.default_rng().permutation(len(self.indices))
        yield from (self.indices[i] for i in perm)

    def __len__(self):
        return len(self.indices)


class BatchSampler(Sampler):
    """Group a sampler's indices into batches (reference BatchSampler)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None, shuffle=False,
                 batch_size=1, drop_last=False):
        super().__init__()
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        if sampler is not None:
            if dataset is not None:
                raise ValueError("pass either dataset or sampler, not both")
            self.sampler = sampler
        else:
            if dataset is None:
                raise ValueError("either dataset or sampler is required")
            self.sampler = RandomSampler(dataset) if shuffle else SequenceSampler(dataset)
        self.batch_size = batch_size
        self.drop_last = drop_last

    def set_epoch(self, epoch: int):
        """Pin the wrapped sampler's shuffle to ``epoch`` (no-op for
        unshuffled samplers) — the resume-determinism hook the hapi fit
        loop drives once per epoch."""
        inner = getattr(self.sampler, "set_epoch", None)
        if inner is not None:
            inner(epoch)

    def __iter__(self) -> Iterator[List[int]]:
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
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank shard of the epoch (reference DistributedBatchSampler):
    pads/subsets so every rank sees the same number of batches; set_epoch
    reseeds the shuffle identically on all ranks. ``num_replicas`` and
    ``rank`` default to the data-parallel ones: the size of this rank's
    group over the mesh's ``dp`` and ``sharding`` axes and its place
    there, which is the world's size and rank unless ``mp``, ``sep`` or
    ``pp`` has more than one rank (then the ranks of one model replica
    read the same rows)."""

    def __init__(self, dataset, batch_size, num_replicas=None, rank=None,
                 shuffle=False, drop_last=False):
        from ..distributed import env as dist_env

        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.dataset = dataset
        self.batch_size = batch_size
        replicas = dist_env.get_mesh().members(dist_env.get_rank(),
                                               ("dp", "sharding"))
        self.nranks = (num_replicas if num_replicas is not None
                       else len(replicas))
        self.local_rank = (rank if rank is not None
                           else replicas.index(dist_env.get_rank()))
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        n = len(dataset)
        if drop_last:
            self.num_samples = n // self.nranks
        else:
            self.num_samples = int(math.ceil(n / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def __iter__(self):
        n = len(self.dataset)
        if self.shuffle:
            indices = np.random.default_rng(self.epoch).permutation(n).tolist()
        else:
            indices = list(range(n))
        if not self.drop_last:
            indices += indices[: self.total_size - len(indices)]
        else:
            indices = indices[: self.total_size]
        local = indices[self.local_rank::self.nranks]
        batch = []
        for idx in local:
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

    def set_epoch(self, epoch: int):
        self.epoch = epoch
