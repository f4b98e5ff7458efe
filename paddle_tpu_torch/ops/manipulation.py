"""Shape and layout ops (port of ``paddle_tpu/ops/manipulation.py``, the
subset the vision models reach): ``concat``, ``stack``, ``reshape`` and
``transpose``.

All four are gray ops under AMP, as in the JAX package: O1 leaves their
inputs' dtype, O2 computes them in the AMP dtype. So an f32 BatchNorm or
channel-mean output that meets bf16 tensors in a ``concat`` joins them in
bf16 (PP-LiteSeg's STDC blocks and UAFM), where ``torch.cat`` alone would
promote the result to f32.
"""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs

__all__ = ["concat", "reshape", "stack", "transpose"]


def concat(x, axis=0, name=None):
    """The tensors of ``x`` joined along ``axis`` (op ``concat``)."""
    return torch.cat(cast_inputs("concat", *x), dim=int(axis))


def stack(x, axis=0, name=None):
    """The tensors of ``x`` stacked on a new ``axis`` (op ``stack``)."""
    return torch.stack(cast_inputs("stack", *x), dim=int(axis))


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1), copied where its strides
    do not allow a view (op ``reshape``)."""
    (x,) = cast_inputs("reshape", x)
    return x.reshape([int(s) for s in shape])


def transpose(x, perm, name=None):
    """``x`` with its axes in the order ``perm``: a strided view (op
    ``transpose``)."""
    (x,) = cast_inputs("transpose", x)
    return x.permute([int(p) for p in perm])
