"""Pooling layers (port of ``paddle_tpu/nn/layer/pooling.py``):
``MaxPool1D/2D/3D``, ``AvgPool1D/2D/3D``, ``AdaptiveAvgPool1D/2D/3D`` and
``AdaptiveMaxPool1D/2D/3D``, over the functionals of
``nn/functional/pooling.py``."""
from __future__ import annotations


from .. import functional as F
from .layers import Layer

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "MaxPool1D", "MaxPool2D",
           "MaxPool3D"]


class _Pool(Layer):
    """A pool over ``F.<_fn>``: the window, its stride and padding, then
    the pool's keywords."""
    _fn = None

    def __init__(self, kernel_size, stride=None, padding=0, **kw):
        super().__init__()
        self.kernel_size, self.stride, self.padding = (kernel_size, stride,
                                                       padding)
        self.kw = kw

    def forward(self, x):
        return getattr(F, self._fn)(x, self.kernel_size, self.stride,
                                    self.padding, **self.kw)


def _max_pool(cls_name, fn, data_format):
    class _MaxPool(_Pool):
        _fn = fn

        def __init__(self, kernel_size, stride=None, padding=0,
                     return_mask=False, ceil_mode=False,
                     data_format=data_format, name=None):
            super().__init__(kernel_size, stride, padding,
                             return_mask=return_mask, ceil_mode=ceil_mode,
                             data_format=data_format)

    _MaxPool.__name__ = _MaxPool.__qualname__ = cls_name
    return _MaxPool


MaxPool1D = _max_pool("MaxPool1D", "max_pool1d", "NCL")
MaxPool2D = _max_pool("MaxPool2D", "max_pool2d", "NCHW")
MaxPool3D = _max_pool("MaxPool3D", "max_pool3d", "NCDHW")


class AvgPool1D(_Pool):
    _fn = "avg_pool1d"

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, data_format="NCL", name=None):
        super().__init__(kernel_size, stride, padding, exclusive=exclusive,
                         ceil_mode=ceil_mode, data_format=data_format)


def _avg_pool(cls_name, fn, data_format):
    class _AvgPool(_Pool):
        _fn = fn

        def __init__(self, kernel_size, stride=None, padding=0,
                     ceil_mode=False, exclusive=True, divisor_override=None,
                     data_format=data_format, name=None):
            super().__init__(kernel_size, stride, padding,
                             ceil_mode=ceil_mode, exclusive=exclusive,
                             divisor_override=divisor_override,
                             data_format=data_format)

    _AvgPool.__name__ = _AvgPool.__qualname__ = cls_name
    return _AvgPool


AvgPool2D = _avg_pool("AvgPool2D", "avg_pool2d", "NCHW")
AvgPool3D = _avg_pool("AvgPool3D", "avg_pool3d", "NCDHW")


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
