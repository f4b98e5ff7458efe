"""Convolution layers (port of ``paddle_tpu/nn/layer/conv.py``): ``Conv1D``,
``Conv2D``, ``Conv3D`` and their transposes.

Parameters as the JAX layers make them: ``weight`` ``[out, in / groups,
*k]`` from ``KaimingUniform(fan_in)`` (uniform within ``±sqrt(6 /
fan_in)``), ``bias`` ``[out]`` uniform within ``±1/sqrt(fan_in)``, or no
bias with ``bias_attr=False``; ``fan_in = in / groups · prod(k)``. These
are the defaults of ``create_parameter``; ``weight_attr``/``bias_attr``
(a ``ParamAttr``, an initializer or a name) replace them as in the JAX
layers. The values are drawn from ``generator`` when the layer is built
alone, else from its model's (``nn.layer.layers.building``).
``padding_mode`` is kept and read nowhere, as in the JAX package. A
transposed layer's weight is ``[in, out / groups, *k]``, with the same
``fan_in``; its ``forward`` takes an ``output_size`` that the functions
ignore, as the JAX ones do.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..initializer import KaimingUniform, Uniform
from .layers import Layer, building

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]


class _ConvNd(Layer):
    _fn = None

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 transpose=False, output_padding=0, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        ks = list(kernel_size) if isinstance(kernel_size, (list, tuple)) \
            else [kernel_size] * n
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = ks
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._padding_mode, self._data_format = padding_mode, data_format
        self._output_padding = output_padding
        self._fan_in = in_channels // groups * math.prod(ks)
        shape = ([in_channels, out_channels // groups] if transpose
                 else [out_channels, in_channels // groups]) + ks
        bound = 1.0 / math.sqrt(self._fan_in)
        with building(self, device, generator):
            self.weight = self.create_parameter(
                shape, attr=weight_attr,
                default_initializer=KaimingUniform(fan_in=self._fan_in))
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=Uniform(-bound, bound))

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


class _ConvTransposeNd(_ConvNd):
    _n = 0

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, self._n,
                         stride, padding, dilation, groups, "zeros",
                         weight_attr, bias_attr, data_format, transpose=True,
                         output_padding=output_padding, device=device,
                         generator=generator)

    def forward(self, x, output_size=None):
        return type(self)._fn(x, self.weight, self.bias, self._stride,
                              self._padding, self._output_padding,
                              self._groups, self._dilation, output_size,
                              self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _n = 1
    _fn = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv2DTranspose(_ConvTransposeNd):
    _n = 2
    _fn = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)


class Conv3DTranspose(_ConvTransposeNd):
    _n = 3
    _fn = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW", *,
                 device=DEFAULT_DEVICE, generator=None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding, output_padding, groups, dilation,
                         weight_attr, bias_attr, data_format, device=device,
                         generator=generator)
