"""Activations (port of ``paddle_tpu/ops/activation.py``): the JAX
functions' formulas in torch ops. ``softmax`` and ``log_softmax`` are black
under AMP (f32), as in the JAX package; the rest are gray: O1 leaves their
inputs' dtype, O2 computes them in the AMP dtype (so a BatchNorm's f32
output enters ``relu`` in bf16). ``rrelu`` draws its training slopes from
an explicit ``torch.Generator``."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ..amp.auto_cast import cast_inputs
from ..core.tensor import plain

__all__ = ["celu", "elu", "gelu", "hardshrink", "hardsigmoid", "hardswish",
           "hardtanh", "leaky_relu", "log_sigmoid", "log_softmax", "maxout",
           "mish", "prelu", "relu", "relu6", "rrelu", "selu", "sigmoid",
           "silu", "softmax", "softplus", "softshrink", "softsign",
           "swiglu", "tanh", "tanhshrink", "thresholded_relu"]


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


def tanh(x, name=None):
    (x,) = cast_inputs("tanh", x)
    return torch.tanh(x)


def swiglu(x, y=None):
    """SwiGLU gate: ``silu(x) * y``, or, without ``y``, ``silu(a) * b`` for
    the two halves ``[a | b]`` of x's last axis (the Llama MLP's packed
    gate/up projection). Op ``swiglu``: gray, so bf16 under AMP O2."""
    if y is None:
        (x,) = cast_inputs("swiglu", plain(x))
        x, y = x.chunk(2, dim=-1)
    else:
        x, y = cast_inputs("swiglu", x, y)
    return TF.silu(x) * y


def _unary(op_name, fn, doc):
    def op(x, name=None):
        (x,) = cast_inputs(op_name, x)
        return fn(x)

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = doc
    return op


mish = _unary("mish", lambda x: x * torch.tanh(TF.softplus(x)),
              "``x · tanh(softplus(x))``.")
hardswish = _unary("hardswish", TF.hardswish, "``x · relu6(x + 3) / 6``.")
hardsigmoid = _unary("hardsigmoid",
                     lambda x: torch.clamp(x / 6.0 + 0.5, 0.0, 1.0),
                     "``clip(x / 6 + 1/2, 0, 1)``, as the JAX function "
                     "writes it.")
softsign = _unary("softsign", lambda x: x / (1.0 + x.abs()),
                  "``x / (1 + |x|)``.")
tanhshrink = _unary("tanhshrink", lambda x: x - torch.tanh(x),
                    "``x - tanh(x)``.")
log_sigmoid = _unary("log_sigmoid", TF.logsigmoid,
                     "``log(sigmoid(x))`` = ``-softplus(-x)``.")


def leaky_relu(x, negative_slope=0.01, name=None):
    (x,) = cast_inputs("leaky_relu", x)
    return torch.where(x >= 0, x, negative_slope * x)


def elu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("elu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    (x,) = cast_inputs("celu", x)
    return torch.where(x > 0, x, alpha * torch.expm1(x / alpha))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    (x,) = cast_inputs("selu", x)
    return scale * torch.where(x > 0, x, alpha * torch.expm1(x))


def hardtanh(x, min=-1.0, max=1.0, name=None):  # noqa: A002 — Paddle's names
    (x,) = cast_inputs("hardtanh", x)
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("hardshrink", x)
    return torch.where(x.abs() > threshold, x, 0.0)


def softshrink(x, threshold=0.5, name=None):
    (x,) = cast_inputs("softshrink", x)
    return torch.where(x > threshold, x - threshold,
                       torch.where(x < -threshold, x + threshold, 0.0))


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    """``x`` where ``x > threshold``, else ``value``."""
    (x,) = cast_inputs("thresholded_relu", x)
    return torch.where(x > threshold, x, value)


def maxout(x, groups, axis=1, name=None):
    """The max over each run of ``groups`` channels of ``axis``."""
    (x,) = cast_inputs("maxout", plain(x))
    ax = axis % x.ndim
    c = x.shape[ax]
    shape = x.shape[:ax] + (c // groups, groups) + x.shape[ax + 1:]
    return x.reshape(shape).amax(dim=ax + 1)


def softmax(x, axis=-1, dtype=None, name=None):
    """Softmax over ``axis`` (op ``softmax``: f32 under AMP), in ``dtype``
    when one is given."""
    from ..base.dtype import convert_dtype

    (x,) = cast_inputs("softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def log_softmax(x, axis=-1, dtype=None, name=None):
    from ..base.dtype import convert_dtype

    (x,) = cast_inputs("log_softmax", x)
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight · x``: one slope, or one a
    channel (axis 1, or the last for a channels-last layout)."""
    x, weight = cast_inputs("prelu", x, weight)
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.ndim
    shape[1 if data_format in ("NCHW", "NCL", "NCDHW") else x.ndim - 1] = \
        weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=1.0 / 8.0, upper=1.0 / 3.0, training=False, name=None,
          generator=None):
    """Leaky ReLU whose negative slope is drawn uniformly from ``[lower,
    upper]`` a element while training (from ``generator``, or the
    process-wide dropout generator on ``x``'s device when it is None),
    ``(lower + upper) / 2`` otherwise."""
    (x,) = cast_inputs("rrelu", x)
    if not training:
        return torch.where(x >= 0, x, (lower + upper) / 2.0 * x)
    if generator is None:
        from ..base import global_state

        generator = global_state.dropout_generator(x.device)
    a = torch.empty(x.shape, dtype=x.dtype, device=x.device).uniform_(
        lower, upper, generator=generator)
    return torch.where(x >= 0, x, a * x)
