"""Activations (port of ``paddle_tpu/ops/activation.py``, the subset the
Llama, BERT and vision paths reach). ``gelu``, ``tanh``, ``relu``,
``relu6``, ``sigmoid``, ``silu`` and ``softplus`` are gray under AMP, as in
the JAX package: O1 leaves their inputs' dtype, O2 computes them in the
AMP dtype (so a BatchNorm's f32 output enters ``relu`` in bf16)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs

__all__ = ["gelu", "relu", "relu6", "sigmoid", "silu", "softplus", "swiglu",
           "tanh"]


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


def relu6(x, name=None):
    """``min(max(x, 0), 6)``; its gradient is 0 at both ends."""
    (x,) = cast_inputs("relu6", x)
    return TF.relu6(x)


def sigmoid(x, name=None):
    (x,) = cast_inputs("sigmoid", x)
    return torch.sigmoid(x)


def silu(x, name=None):
    """``x * sigmoid(x)``."""
    (x,) = cast_inputs("silu", x)
    return TF.silu(x)


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``log(1 + exp(beta * x)) / beta``, and ``x`` itself where ``beta * x
    > threshold``, as the JAX function selects."""
    (x,) = cast_inputs("softplus", x)
    bx = x * beta
    return torch.where(bx > threshold, x, TF.softplus(bx) / beta)


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
