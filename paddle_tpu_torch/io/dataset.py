"""Dataset abstractions (port of ``paddle_tpu/io/dataset.py``; reference:
python/paddle/io/dataloader/dataset.py).

Map-style ``Dataset`` (``__getitem__``/``__len__``) and stream-style
``IterableDataset``, plus the combinators the reference ships:
``TensorDataset``, ``ComposeDataset``, ``ChainDataset``, ``ConcatDataset``,
``Subset`` and ``random_split``. Items are host values (numpy arrays,
numbers, CPU tensors): the loader's workers read them, and a worker never
touches the card. ``random_split`` draws from numpy as the JAX package
does, so one seed splits both packages' datasets alike.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Sequence

import numpy as np


class Dataset:
    """Map-style dataset: subclass and implement __getitem__ and __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError(f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    """Stream-style dataset: subclass and implement __iter__."""

    def __iter__(self):
        raise NotImplementedError(f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise TypeError("IterableDataset is not subscriptable")

    def __len__(self):
        # TypeError (not RuntimeError): list() probes __len__ via
        # operator.length_hint, which only tolerates TypeError
        raise TypeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Wrap equal-length tensors/arrays; item i is the tuple of row i (numpy
    rows; a tensor on the card is copied to the host once, here)."""

    def __init__(self, tensors: Sequence):
        arrays = [t.detach().cpu().numpy() if hasattr(t, "detach")
                  else np.asarray(t) for t in tensors]
        if any(len(a) != len(arrays[0]) for a in arrays):
            raise ValueError("all tensors must have the same first dimension")
        self.tensors = arrays

    def __getitem__(self, idx):
        return tuple(a[idx] for a in self.tensors)

    def __len__(self):
        return len(self.tensors[0])


class ComposeDataset(Dataset):
    """Zip several same-length map datasets; item i concatenates their fields."""

    def __init__(self, datasets: Sequence[Dataset]):
        if not datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        self.datasets = list(datasets)
        n = len(self.datasets[0])
        if any(len(d) != n for d in self.datasets):
            raise ValueError("all datasets must have the same length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets into one stream."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenate map datasets (reference ConcatDataset)."""

    def __init__(self, datasets: Iterable[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.cumulative_sizes: List[int] = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            if -idx > len(self):
                raise IndexError("index out of range")
            idx = len(self) + idx
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - start]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    """Split into non-overlapping subsets (reference random_split; fractional
    lengths follow the reference's round-robin remainder assignment)."""
    n = len(dataset)
    if all(isinstance(l, float) for l in lengths) and abs(sum(lengths) - 1.0) < 1e-6:
        sizes = [int(np.floor(n * frac)) for frac in lengths]
        rem = n - sum(sizes)
        for i in range(rem):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    if sum(lengths) != n:
        raise ValueError("sum of input lengths does not equal the dataset length")
    rng = np.random.default_rng(generator) if not isinstance(generator, np.random.Generator) else generator
    perm = rng.permutation(n)
    out, offset = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[offset:offset + l].tolist()))
        offset += l
    return out
