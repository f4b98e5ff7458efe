"""Search and sort ops (port of ``paddle_tpu/ops/search.py``).

Indices are int64 (the JAX package's are int32 on the TPU). ``sort`` and
``argsort`` are stable when asked; without ``stable`` the order of ties
is the device's, in both packages. ``topk`` breaks a tie toward the lower
index, as ``jax.lax.top_k`` does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs
from . import _common as c

__all__ = ["argmax", "argmin", "argsort", "bucketize", "index_sample",
           "kthvalue", "masked_fill", "mode", "nonzero", "searchsorted",
           "sort", "topk", "where"]


def _arg(fn, x, axis, keepdim, dtype):
    x = c.tensor(x)
    if axis is None:
        out = fn(x.reshape(-1))
        out = out.reshape((1,) * x.ndim) if keepdim else out
    else:
        out = fn(x, dim=int(axis), keepdim=keepdim)
    return out.to(c.dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    """The index of the first largest value over ``axis`` (of the
    flattened ``x`` when None)."""
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    x = c.tensor(x)
    return torch.argsort(x, dim=int(axis), descending=descending,
                         stable=stable)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    """The values of ``x`` sorted along ``axis`` (op ``sort``)."""
    (x,) = cast_inputs("sort", c.tensor(x))
    return torch.sort(x, dim=int(axis), descending=descending,
                      stable=stable).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):  # noqa: A002
    """The ``k`` largest (``largest=False``: smallest) values along
    ``axis`` (default: the last) and their indices; ties go to the lower
    index (op ``topk``)."""
    (x,) = cast_inputs("topk", c.tensor(x))
    k = int(c.scalar(k))
    ax = -1 if axis is None else int(axis)
    # a stable sort keeps tied values in index order, as lax.top_k does
    idx = torch.sort(x, dim=ax, descending=largest, stable=True).indices
    idx = idx.narrow(ax, 0, k)
    return torch.gather(x, ax, idx), idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index (op
    ``kthvalue``)."""
    (x,) = cast_inputs("kthvalue", c.tensor(x))
    order = torch.sort(x, dim=axis, stable=True)
    vals = order.values.select(axis, k - 1)
    idx = order.indices.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the last index where it stands; computed on the host, as in the JAX
    package."""
    t = c.tensor(x)
    v = np.moveaxis(t.detach().cpu().numpy(), axis, -1)
    flat = v.reshape(-1, v.shape[-1])
    vals, idxs = [], []
    for row in flat:
        uniq, counts = np.unique(row, return_counts=True)
        best = uniq[np.argmax(counts)]
        vals.append(best)
        idxs.append(np.where(row == best)[0][-1])
    vals = np.asarray(vals, dtype=v.dtype).reshape(v.shape[:-1])
    idxs = np.asarray(idxs, dtype=np.int64).reshape(v.shape[:-1])
    if keepdim:
        vals, idxs = np.expand_dims(vals, axis), np.expand_dims(idxs, axis)
    return (torch.from_numpy(np.ascontiguousarray(vals)).to(t.device),
            torch.from_numpy(np.ascontiguousarray(idxs)).to(t.device))


def nonzero(x, as_tuple=False):
    """The coordinates of the nonzero elements: ``[n, ndim]``, or one
    tensor per axis with ``as_tuple``."""
    x = c.tensor(x)
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Where each of ``values`` would go in ``sorted_sequence`` (each row
    of it, when it has more than one axis)."""
    seq = c.tensor(sorted_sequence)
    vals = c.tensor(values, seq)
    return torch.searchsorted(seq, vals, out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def index_sample(x, index):
    from .manipulation import index_sample as _index_sample

    return _index_sample(x, index)


def masked_fill(x, mask, value, name=None):
    from .manipulation import masked_fill as _masked_fill

    return _masked_fill(x, mask, value)


def where(condition, x=None, y=None, name=None):
    from .manipulation import where as _where

    return _where(condition, x, y)
