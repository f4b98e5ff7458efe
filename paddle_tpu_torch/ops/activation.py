"""Activations (port of ``paddle_tpu/ops/activation.py``, the subset the
Llama, BERT and ResNet paths reach). ``gelu``, ``tanh`` and ``relu`` are
gray under AMP, as in the JAX package: O1 leaves their inputs' dtype, O2
computes them in the AMP dtype (so a BatchNorm's f32 output enters
``relu`` in bf16)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs

__all__ = ["gelu", "relu", "swiglu", "tanh"]


def gelu(x, approximate: bool = False):
    """GELU, by default in its exact form ``x·Φ(x)`` over erf (BERT's);
    ``approximate=True`` takes the tanh form (GPT's), as ``jax.nn.gelu``
    does."""
    (x,) = cast_inputs("gelu", x)
    return TF.gelu(x, approximate="tanh" if approximate else "none")


def relu(x):
    """``max(x, 0)``; its gradient is 0 at 0, as ``jax.nn.relu``'s."""
    (x,) = cast_inputs("relu", x)
    return TF.relu(x)


def tanh(x):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


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
