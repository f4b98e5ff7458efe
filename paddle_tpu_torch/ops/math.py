"""Element-wise arithmetic and reductions (port of ``paddle_tpu/ops/
math.py``, the subset the model paths reach).

``add``, ``subtract`` and ``multiply`` are gray ops under AMP, as the JAX
ones (the Tensor operators ``+``, ``-`` and ``*`` there) are. O2 computes
them in the AMP dtype, so an f32 normalization output meets a bf16 branch
in bf16, where torch alone would promote the result to f32. A Python
scalar operand stays a scalar.

``mean`` is black (f32 under AMP) and ``max`` gray, so under O2 a channel
mean over bf16 maps comes out f32 and a channel max bf16 (PP-LiteSeg's
UAFM). ``max`` sends a tie's gradient to every tied element in equal
shares, as ``jnp.max`` does (``torch.amax``; ``torch.max(dim)`` would send
it all to one index).
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs

__all__ = ["add", "max", "mean", "multiply", "subtract"]


def _axes(axis):
    if axis is None:
        return None
    return tuple(int(a) for a in axis) if isinstance(axis, (list, tuple)) \
        else (int(axis),)


def _cast(op, x, y):
    """``x`` and ``y`` cast for ``op``; a Python number passes as it is."""
    tensors = [t for t in (x, y) if isinstance(t, torch.Tensor)]
    cast = iter(cast_inputs(op, *tensors))
    return tuple(next(cast) if isinstance(t, torch.Tensor) else t
                 for t in (x, y))


def add(x, y):
    """``x + y`` (op ``add``)."""
    x, y = _cast("add", x, y)
    return x + y


def subtract(x, y):
    """``x - y`` (op ``subtract``)."""
    x, y = _cast("subtract", x, y)
    return x - y


def multiply(x, y):
    """``x * y`` (op ``multiply``)."""
    x, y = _cast("multiply", x, y)
    return x * y


def mean(x, axis=None, keepdim=False, name=None):
    """The mean over ``axis`` (all axes when None; op ``mean``)."""
    (x,) = cast_inputs("mean", x)
    return x.mean(dim=_axes(axis), keepdim=keepdim)


def max(x, axis=None, keepdim=False, name=None):
    """The largest value over ``axis`` (all axes when None; op ``max``);
    tied elements share the gradient equally."""
    (x,) = cast_inputs("max", x)
    return x.amax(dim=_axes(axis) or (), keepdim=keepdim)
