"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``):
``MaxPool2D``, ``AvgPool2D`` and ``AdaptiveAvgPool2D``, over the
functionals of ``nn/functional/pooling.py``. The other pools are not
ported yet (ROADMAP.md, queue 1)."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["AdaptiveAvgPool2D", "AvgPool2D", "MaxPool2D"]


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0,
                 return_mask=False, ceil_mode=False, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = dict(return_mask=return_mask, ceil_mode=ceil_mode,
                       data_format=data_format)

    def forward(self, x):
        return F.max_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = dict(ceil_mode=ceil_mode, exclusive=exclusive,
                       divisor_override=divisor_override,
                       data_format=data_format)

    def forward(self, x):
        return F.avg_pool2d(x, self.kernel_size, self.stride, self.padding,
                            **self.kw)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size, self._data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)
