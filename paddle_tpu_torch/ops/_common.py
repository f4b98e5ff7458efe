"""What the functional ops share: reading their arguments.

An op takes ``Tensor`` s, plain torch tensors, numpy arrays, lists and
Python numbers where the JAX package takes them; a non-tensor operand
becomes a tensor on the default device, or on the device of the op's first
tensor operand.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import dtype as dtype_mod
from ..base import global_state
from ..core.tensor import as_tensor, plain


def tensor(x, like=None) -> torch.Tensor:
    """``x`` as a plain torch tensor: a tensor as it is (a ``Tensor``
    taken plain, so torch's methods keep their meaning inside the op),
    anything else copied onto ``like``'s device (default: the default
    device)."""
    if isinstance(x, torch.Tensor):
        return plain(x)

    return as_tensor(x, place=None if like is None else like.device)


def operands(x, y):
    """Two operands of a binary op: a Python number stays a number, a
    non-tensor array goes where the tensor operand lies."""
    if isinstance(x, torch.Tensor):
        x = tensor(x)
        return x, (y if isinstance(y, (int, float, bool, complex))
                   else tensor(y, x))
    if isinstance(y, torch.Tensor):
        y = tensor(y)
        return (x if isinstance(x, (int, float, bool, complex))
                else tensor(x, y)), y
    x = tensor(x)
    return x, tensor(y, x) if not isinstance(
        y, (int, float, bool, complex)) else y


def axes(axis):
    """Paddle's ``axis`` (None, an int, a list or a tensor) as torch's
    ``dim``: None, an int or a tuple."""
    if axis is None:
        return None
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    if isinstance(axis, (list, tuple)):
        return tuple(int(a) for a in axis)
    return int(axis)


def shape(s) -> tuple:
    """Paddle's ``shape`` (an int, a list of ints or 0-d tensors, or a
    tensor) as a tuple of ints."""
    if isinstance(s, torch.Tensor):
        s = s.tolist()
    if isinstance(s, (int, np.integer)):
        return (int(s),)
    return tuple(int(v) for v in s)


def dtype(d, default=None) -> torch.dtype:
    """``d`` as a torch dtype; None gives ``default``, else the default
    float dtype."""
    if d is None:
        return default if default is not None else \
            global_state.default_dtype()
    return dtype_mod.convert_dtype(d)


def scalar(v):
    """A 0-d or one-element tensor as a Python number; anything else
    unchanged."""
    if isinstance(v, torch.Tensor):
        return v.item()
    return v
