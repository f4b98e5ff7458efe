"""``einsum`` (port of ``paddle_tpu/ops/einsum_ops.py``): torch's, op
``einsum`` (white under AMP)."""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from . import _common as c

__all__ = ["einsum"]


def einsum(equation, *operands):
    """``equation`` over the operands, given spread out or as one list."""
    ops = list(operands)
    if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
        ops = list(ops[0])
    ops = cast_inputs("einsum", *(c.tensor(v) for v in ops))
    return torch.einsum(equation, *ops)
