"""BatchNorm layers (port of ``paddle_tpu/nn/layer/norm.py:12-86``):
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D``.

As the JAX layers: ``weight`` 1 and ``bias`` 0 (each dropped with
``*_attr=False``, each replaced by a ``ParamAttr``'s initializer), and two buffers named ``_mean`` (0) and ``_variance``
(1), so the state dicts line up key for key; ``momentum`` 0.9 is the
share of the running stats kept at each update (``F.batch_norm``).
``decorate`` at O2 casts the buffers to bf16 with the rest of the model;
the first training step writes them back as f32, as the JAX step does.
``SyncBatchNorm`` raises: cross-device statistics come with the
distributed layouts (ROADMAP.md, queue 7).
"""
from __future__ import annotations

from typing import Optional

import torch
from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..initializer import Constant
from .layers import Layer, building

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm"]


class _BatchNormBase(Layer):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        with building(self, device, generator):
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
            self.register_buffer("_mean", torch.empty(num_features))
            self.register_buffer("_variance", torch.empty(num_features))

    def _init_parameters(self, gen: torch.Generator) -> None:
        super()._init_parameters(gen)
        self._mean.zero_()
        self._variance.fill_(1.0)

    def forward(self, x):
        return F.batch_norm(x, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)

    def extra_repr(self) -> str:
        return (f"num_features={self._num_features}, momentum="
                f"{self._momentum}, epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Cross-device BatchNorm: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SyncBatchNorm needs the distributed layouts, which are not "
            "ported yet (ROADMAP.md, queue 7)")

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        raise NotImplementedError(
            "SyncBatchNorm needs the distributed layouts, which are not "
            "ported yet (ROADMAP.md, queue 7)")
