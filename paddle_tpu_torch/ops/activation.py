"""Activations (port of ``paddle_tpu/ops/activation.py``, the subset the
Llama path reaches)."""
from __future__ import annotations

import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs

__all__ = ["swiglu"]


def swiglu(x, y=None):
    """SwiGLU gate: ``silu(x) * y``, or, without ``y``, ``silu(a) * b`` for
    the two halves ``[a | b]`` of x's last axis (the Llama MLP's packed
    gate/up projection). Op ``swiglu``: gray, so bf16 under AMP O2."""
    if y is None:
        (x,) = cast_inputs("swiglu", x)
        x, y = x.chunk(2, dim=-1)
    else:
        x, y = cast_inputs("swiglu", x, y)
    return TF.silu(x) * y
