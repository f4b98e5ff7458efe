"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``), each a
``Layer`` over the port's functional of the same name: the ``_simple``
factory's parameterless ones (``ReLU``, ``ReLU6``, ``Sigmoid``, ``Tanh``,
``Silu`` (also named ``SiLU``), ``Swish``, ``Mish``, ``Hardswish``,
``Hardsigmoid``, ``Softsign``, ``Tanhshrink``, ``LogSigmoid``) and those
with settings (``GELU`` through ``ThresholdedReLU``); ``PReLU`` holds its
slopes as a parameter (``Constant(init)``)."""
from __future__ import annotations

from typing import Optional

import torch

from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..initializer import Constant
from .layers import Layer, building, held_generator

__all__ = ["CELU", "ELU", "GELU", "Hardshrink", "Hardsigmoid", "Hardswish",
           "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax", "Maxout",
           "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU", "SiLU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]


def _simple(name, fn_name=None, **defaults):
    """A parameterless layer class named ``name`` whose forward is the
    functional ``fn_name`` (default ``name.lower()``) with ``defaults``
    and the constructor's keywords."""
    fn = getattr(F, fn_name or name.lower())

    class _Act(Layer):
        def __init__(self, name=None, **kwargs):
            super().__init__()
            self._kwargs = {**defaults, **kwargs}

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Sigmoid = _simple("Sigmoid", "sigmoid")
Tanh = _simple("Tanh", "tanh")
Silu = _simple("Silu", "silu")
SiLU = Silu
Swish = _simple("Swish", "swish")
Mish = _simple("Mish", "mish")
Hardswish = _simple("Hardswish", "hardswish")
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
Softsign = _simple("Softsign", "softsign")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")


def _with(name, fn_name, *params):
    """A layer class named ``name`` whose constructor takes ``params``
    (``(name, default)`` pairs, then ``name=``) and whose forward is
    ``F.<fn_name>(x, *those values)``."""
    fn = getattr(F, fn_name)

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            kwargs.pop("name", None)
            values = dict(params)
            values.update(zip(values, args))
            values.update(kwargs)
            self._args = tuple(values[k] for k, _ in params)

        def forward(self, x):
            return fn(x, *self._args)

        def extra_repr(self) -> str:
            return ", ".join(f"{k}={v}" for (k, _), v in zip(params,
                                                             self._args))

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


GELU = _with("GELU", "gelu", ("approximate", False))
LeakyReLU = _with("LeakyReLU", "leaky_relu", ("negative_slope", 0.01))
ELU = _with("ELU", "elu", ("alpha", 1.0))
CELU = _with("CELU", "celu", ("alpha", 1.0))
SELU = _with("SELU", "selu", ("scale", 1.0507009873554805),
             ("alpha", 1.6732632423543772))
Hardtanh = _with("Hardtanh", "hardtanh", ("min", -1.0), ("max", 1.0))
Hardshrink = _with("Hardshrink", "hardshrink", ("threshold", 0.5))
Softshrink = _with("Softshrink", "softshrink", ("threshold", 0.5))
Softplus = _with("Softplus", "softplus", ("beta", 1.0), ("threshold", 20.0))
Maxout = _with("Maxout", "maxout", ("groups", None), ("axis", 1))
Softmax = _with("Softmax", "softmax", ("axis", -1))
LogSoftmax = _with("LogSoftmax", "log_softmax", ("axis", -1))
ThresholdedReLU = _with("ThresholdedReLU", "thresholded_relu",
                        ("threshold", 1.0))


class PReLU(Layer):
    """``max(x, 0) + weight · min(x, 0)``: ``weight`` ``[num_parameters]``
    from ``Constant(init)`` (or ``weight_attr``), one slope or one a
    channel."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._data_format = data_format
        with building(self, device, generator):
            self.weight = self.create_parameter(
                [num_parameters], attr=weight_attr,
                default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


class RReLU(Layer):
    """Leaky ReLU with a slope drawn uniformly from ``[lower, upper]`` a
    element while training (from ``generator``, else the process-wide
    dropout generator of the default device, ``layers.held_generator``),
    ``(lower + upper) / 2`` otherwise."""

    def __init__(self, lower=1.0 / 8.0, upper=1.0 / 3.0, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._lower, self._upper = lower, upper
        self.generator = held_generator(generator, True)

    def forward(self, x):
        return F.rrelu(x, self._lower, self._upper, self.training,
                       generator=self.generator)
