"""Activation layers (port of ``paddle_tpu/nn/layer/activation.py``): the
``_simple`` factory, ``ReLU``, ``ReLU6``, ``Sigmoid`` and ``Silu`` (also
named ``SiLU``), and ``Softplus``. The other classes are not ported yet
(ROADMAP.md, queue 1)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["ReLU", "ReLU6", "SiLU", "Sigmoid", "Silu", "Softplus"]


def _simple(name, fn_name=None, **defaults):
    """A parameterless layer class named ``name`` whose forward is the
    functional ``fn_name`` (default ``name.lower()``) with ``defaults``
    and the constructor's keywords."""
    fn = getattr(F, fn_name or name.lower())

    class _Act(nn.Module):
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
Silu = _simple("Silu", "silu")
SiLU = Silu


class Softplus(nn.Module):
    def __init__(self, beta=1.0, threshold=20.0, name=None):
        super().__init__()
        self._beta, self._threshold = beta, threshold

    def forward(self, x):
        return F.softplus(x, self._beta, self._threshold)
