"""Tensor creation (port of ``paddle_tpu/ops/creation.py``).

Every op places what it makes on the default device (``set_device``'s,
else CUDA) unless it copies another tensor's layout (``*_like``, ``tril``,
``diag``), which stays on that tensor's device. A float result takes the
default float dtype unless ``dtype`` is given; integer ranges and index
lists are int64 (the JAX package narrows them to int32 on the TPU).
"""
from __future__ import annotations

import numpy as np
import torch

from ..amp.auto_cast import cast_inputs
from ..core.tensor import as_tensor, to_tensor
from ..device import DEFAULT_DEVICE, resolve_device
from . import _common as c

__all__ = ["arange", "assign", "clone", "complex", "diag", "diag_embed",
           "diagflat", "empty", "empty_like", "eye", "full",
           "full_batch_size_like", "full_like", "linspace", "logspace",
           "meshgrid", "one_hot", "ones", "ones_like", "tensor",
           "to_tensor", "tril", "tril_indices", "triu", "triu_indices",
           "zeros", "zeros_like"]


def _dev():
    return resolve_device(DEFAULT_DEVICE)


def tensor(data, dtype=None, place=None, stop_gradient=True):
    """``to_tensor``."""
    return to_tensor(data, dtype, place, stop_gradient)


def zeros(shape, dtype=None, name=None):
    return torch.zeros(c.shape(shape), dtype=c.dtype(dtype), device=_dev())


def ones(shape, dtype=None, name=None):
    return torch.ones(c.shape(shape), dtype=c.dtype(dtype), device=_dev())


def full(shape, fill_value, dtype=None, name=None):
    """``shape`` filled with ``fill_value``; with no ``dtype``, a tensor
    fill keeps its dtype and a number takes the default float dtype."""
    if dtype is None and isinstance(fill_value, torch.Tensor):
        dt = fill_value.dtype
    else:
        dt = c.dtype(dtype)
    return torch.full(c.shape(shape), c.scalar(fill_value), dtype=dt,
                      device=_dev())


def empty(shape, dtype=None, name=None):
    """Zeros, as in the JAX package (torch's would be uninitialized)."""
    return zeros(shape, dtype)


def zeros_like(x, dtype=None, name=None):
    x = c.tensor(x)
    return torch.zeros_like(x, dtype=c.dtype(dtype, x.dtype))


def ones_like(x, dtype=None, name=None):
    x = c.tensor(x)
    return torch.ones_like(x, dtype=c.dtype(dtype, x.dtype))


def full_like(x, fill_value, dtype=None, name=None):
    x = c.tensor(x)
    return torch.full_like(x, c.scalar(fill_value),
                           dtype=c.dtype(dtype, x.dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None):
    """``[start, end)`` by ``step``; int64 unless a bound or the step is a
    float (then the default float dtype)."""
    start, end, step = c.scalar(start), c.scalar(end), c.scalar(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        dtype = (None if any(isinstance(v, float) for v in (start, end, step))
                 else torch.int64)
    return torch.arange(start, end, step, dtype=c.dtype(dtype),
                        device=_dev())


def linspace(start, stop, num, dtype=None, name=None):
    dt = c.dtype(dtype)
    # computed in float64 and cast, as jnp.linspace's endpoints are exact
    out = torch.linspace(float(c.scalar(start)), float(c.scalar(stop)),
                         int(c.scalar(num)), dtype=torch.float64,
                         device=_dev())
    return out.to(dt)


def logspace(start, stop, num, base=10.0, dtype=None, name=None):
    exps = torch.linspace(float(c.scalar(start)), float(c.scalar(stop)),
                          int(c.scalar(num)), dtype=torch.float64,
                          device=_dev())
    return torch.pow(float(c.scalar(base)), exps).to(c.dtype(dtype))


def eye(num_rows, num_columns=None, dtype=None, name=None):
    cols = int(num_rows) if num_columns is None else int(num_columns)
    return torch.eye(int(num_rows), cols, dtype=c.dtype(dtype),
                     device=_dev())


def diag(x, offset=0, padding_value=0, name=None):
    """A 1-d ``x`` on the ``offset`` diagonal of a square matrix (the rest
    ``padding_value``), or a 2-d ``x``'s ``offset`` diagonal."""
    x = c.tensor(x)
    out = torch.diag(x, offset)
    if x.ndim == 1 and padding_value != 0:
        mask = torch.diag(torch.ones_like(x, dtype=torch.bool), offset)
        out = torch.where(mask, out, torch.full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None):
    return torch.diagflat(c.tensor(x), offset)


def diag_embed(x, offset=0, dim1=-2, dim2=-1, name=None):
    return torch.diag_embed(c.tensor(x), offset, dim1, dim2)


def tril(x, diagonal=0, name=None):
    (x,) = cast_inputs("tril", c.tensor(x))
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    (x,) = cast_inputs("triu", c.tensor(x))
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    """Grids of the 1-d inputs, ``ij`` indexed."""
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*[c.tensor(t) for t in tensors],
                               indexing="ij"))


def assign(x, output=None):
    """A copy of ``x``; with ``output``, written into it."""
    x = c.tensor(x) if isinstance(x, torch.Tensor) else as_tensor(
        np.asarray(x))
    (x,) = cast_inputs("assign", x)
    out = x.clone()
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return assign(x)


def complex(real, imag, name=None):  # noqa: A001 — paddle.complex
    real, imag = c.operands(real, imag)
    return torch.complex(real, imag)


def tril_indices(row, col, offset=0, dtype="int64"):
    r, cc = np.tril_indices(row, offset, col)
    return torch.as_tensor(np.stack([r, cc]), dtype=c.dtype(dtype),
                           device=_dev())


def triu_indices(row, col=None, offset=0, dtype="int64"):
    r, cc = np.triu_indices(row, offset, row if col is None else col)
    return torch.as_tensor(np.stack([r, cc]), dtype=c.dtype(dtype),
                           device=_dev())


def one_hot(x, num_classes, name=None):
    """``x``'s classes as one-hot rows in the default float dtype."""
    x = c.tensor(x)
    return torch.nn.functional.one_hot(x.long(), int(num_classes)).to(
        c.dtype(None))


def full_batch_size_like(input, shape, dtype, value, input_dim_idx=0,
                         output_dim_idx=0, name=None):
    """``full`` with one dim taken from ``input``'s shape."""
    shape = list(shape)
    shape[output_dim_idx] = c.tensor(input).shape[input_dim_idx]
    return full(shape, value, dtype=dtype)
