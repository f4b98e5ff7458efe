"""Convolution layers (port of ``paddle_tpu/nn/layer/conv.py``): ``Conv1D``,
``Conv2D`` and ``Conv3D``.

Parameters as the JAX layers make them: ``weight`` ``[out, in / groups,
*k]`` from ``KaimingUniform(fan_in)`` (uniform within ``±sqrt(6 /
fan_in)``), ``bias`` ``[out]`` uniform within ``±1/sqrt(fan_in)``, or no
bias with ``bias_attr=False``; ``fan_in = in / groups · prod(k)``. The
values are drawn from ``generator`` when the layer is built alone, else
from its model's (``nn.layer.layers.building``). ``padding_mode`` is kept
and read nowhere, as in the JAX package. A ``ParamAttr`` is not ported:
``weight_attr`` must be None and ``bias_attr`` None or False. The
transposed layers are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ...device import DEFAULT_DEVICE
from .. import functional as F
from .layers import building

__all__ = ["Conv1D", "Conv2D", "Conv3D"]


def check_attrs(weight_attr, bias_attr) -> None:
    """The ``ParamAttr`` values the port takes: none but ``bias_attr=False``."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError(
            "ParamAttr is not ported yet (ROADMAP.md, queue 1): pass "
            "weight_attr=None and bias_attr=None or False")


class _ConvNd(nn.Module):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        check_attrs(weight_attr, bias_attr)
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * n
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ks
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode, self._data_format = padding_mode, data_format
        self._fan_in = in_channels // groups * math.prod(ks)
        with building(self, device, generator):
            self.weight = nn.Parameter(
                torch.empty([out_channels, in_channels // groups] + ks))
            self.bias = (nn.Parameter(torch.empty(out_channels))
                         if bias_attr is not False else None)

    def _init_parameters(self, gen: torch.Generator) -> None:
        limit = math.sqrt(2.0) * math.sqrt(3.0 / self._fan_in)
        self.weight.uniform_(-limit, limit, generator=gen)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(self._fan_in)
            self.bias.uniform_(-bound, bound, generator=gen)

    def forward(self, x):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._dilation, self._groups,
                              self._data_format)

    def extra_repr(self) -> str:
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}, padding="
                f"{self._padding}")


class Conv1D(_ConvNd):
    _fn = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device,
                         generator=generator)


class Conv2D(_ConvNd):
    _fn = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device,
                         generator=generator)


class Conv3D(_ConvNd):
    _fn = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode, weight_attr,
                         bias_attr, data_format, device=device,
                         generator=generator)
