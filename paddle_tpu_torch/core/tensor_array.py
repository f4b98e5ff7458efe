"""Auxiliary tensor containers (port of ``paddle_tpu/core/tensor_array.py``;
reference ``paddle/phi/core/tensor_array.h`` TensorArray,
``selected_rows.h`` SelectedRows, ``string_tensor.h`` StringTensor).

``TensorArray`` is a growable list of tensors with ``stack``/``concat``.
``SelectedRows`` is the row-sparse interchange format of embedding
gradients: ``rows`` index a ``[height, ...]`` dense space and ``value``
holds their data; ``to_dense`` scatters them with ``index_add`` (rows may
repeat: their values add), ``merge`` sums repeated rows in the sorted
order of ``np.unique``, as the JAX container does. ``StringTensor`` is a
host-side numpy object array: strings stay in the input pipeline.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .tensor import Tensor, to_tensor, wrap

__all__ = ["SelectedRows", "StringTensor", "TensorArray"]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else to_tensor(x)


class TensorArray:
    """Growable list of same-rank tensors (reference TensorArray)."""

    def __init__(self, values: Optional[Sequence] = None):
        self._items: List[torch.Tensor] = [_tensor(v) for v in values or []]

    def append(self, t) -> "TensorArray":
        self._items.append(_tensor(t))
        return self

    write = append

    def read(self, i: int) -> Tensor:
        return self._items[i]

    def __getitem__(self, i):
        return self._items[i]

    def __len__(self):
        return len(self._items)

    def stack(self, axis: int = 0) -> Tensor:
        from ..ops.manipulation import stack

        return stack(self._items, axis)

    def concat(self, axis: int = 0) -> Tensor:
        from ..ops.manipulation import concat

        return concat(self._items, axis)

    def pop(self, i: int = -1) -> Tensor:
        return self._items.pop(i)


class SelectedRows:
    """Row-sparse value container (reference SelectedRows): ``rows`` are
    the touched indices of a ``[height, ...]`` dense space, ``value`` their
    data."""

    def __init__(self, rows, value, height: int):
        self.rows = _tensor(rows if isinstance(rows, torch.Tensor)
                            else np.asarray(rows))
        self.value = _tensor(value if isinstance(value, torch.Tensor)
                             else np.asarray(value))
        self.height = int(height)

    def to_dense(self) -> Tensor:
        v = self.value
        out = torch.zeros((self.height,) + tuple(v.shape[1:]), dtype=v.dtype,
                          device=v.device)
        return wrap(out.index_add(0, self.rows.to(v.device).long(), v))

    def merge(self) -> "SelectedRows":
        """Repeated rows summed (reference ``merge_selected_rows``), rows
        sorted."""
        idx = self.rows.detach().cpu().numpy()
        uniq, inv = np.unique(idx, return_inverse=True)
        v = self.value
        vals = torch.zeros((len(uniq),) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=v.device).index_add(
            0, torch.as_tensor(inv.reshape(-1), device=v.device), v)
        return SelectedRows(uniq.astype(np.int64), wrap(vals), self.height)

    def __repr__(self):
        return (f"SelectedRows(height={self.height}, "
                f"nnz_rows={self.rows.shape[0]})")


class StringTensor:
    """Host-side string tensor (reference StringTensor): a numpy object
    array with shape semantics."""

    def __init__(self, data, name: Optional[str] = None):
        self._data = np.asarray(data, dtype=object)
        self.name = name

    @property
    def shape(self):
        return list(self._data.shape)

    def numpy(self):
        return self._data

    def __getitem__(self, i):
        out = self._data[i]
        return out if isinstance(out, str) else StringTensor(out)

    def __len__(self):
        return self._data.shape[0]

    def __repr__(self):
        return f"StringTensor(shape={self.shape})"
