"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``):
``MaxPool2D``, ``AvgPool2D``, ``AdaptiveAvgPool1D/2D/3D`` and
``AdaptiveMaxPool1D/2D/3D``, over the functionals of
``nn/functional/pooling.py``. The other pools are not ported yet
(ROADMAP.md, queue 1)."""
from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool2D", "MaxPool2D"]


class MaxPool2D(Layer):
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


class AvgPool2D(Layer):
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


class AdaptiveAvgPool1D(Layer):
    def __init__(self, output_size, name=None):
        super().__init__()
        self._output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self._output_size)


class AdaptiveAvgPool2D(Layer):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self._output_size, self._data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self._output_size, self._data_format)


class AdaptiveAvgPool3D(Layer):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        self._output_size, self._data_format = output_size, data_format

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self._output_size, self._data_format)


def _adaptive_max(name, fn_name):
    """An ``AdaptiveMaxPool*`` class over ``F.<fn_name>``; with
    ``return_mask`` its forward returns ``(out, None)``, as in JAX."""
    fn = getattr(F, fn_name)

    class _Pool(Layer):
        def __init__(self, output_size, return_mask=False, name=None):
            super().__init__()
            self._output_size, self._return_mask = output_size, return_mask

        def forward(self, x):
            return fn(x, self._output_size, self._return_mask)

    _Pool.__name__ = _Pool.__qualname__ = name
    return _Pool


AdaptiveMaxPool1D = _adaptive_max("AdaptiveMaxPool1D", "adaptive_max_pool1d")
AdaptiveMaxPool2D = _adaptive_max("AdaptiveMaxPool2D", "adaptive_max_pool2d")
AdaptiveMaxPool3D = _adaptive_max("AdaptiveMaxPool3D", "adaptive_max_pool3d")
