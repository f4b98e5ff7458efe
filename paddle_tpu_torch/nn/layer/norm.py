"""Normalization layers (port of ``paddle_tpu/nn/layer/norm.py``):
``BatchNorm``, ``BatchNorm1D``, ``BatchNorm2D`` and ``BatchNorm3D``,
``GroupNorm``, ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and
``SpectralNorm``.

As the JAX layers: ``weight`` 1 and ``bias`` 0 (each dropped with
``*_attr=False``, each replaced by a ``ParamAttr``'s initializer), and two buffers named ``_mean`` (0) and ``_variance``
(1), so the state dicts line up key for key; ``momentum`` 0.9 is the
share of the running stats kept at each update (``F.batch_norm``).
``decorate`` at O2 casts the buffers to bf16 with the rest of the model;
the first training step writes them back as f32, as the JAX step does.
``SyncBatchNorm`` takes its training statistics over every rank of the
``dp`` group.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..functional.norm import sync_batch_norm
from ..initializer import Constant, Normal
from .layers import Layer, building

__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "GroupNorm", "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D",
           "LocalResponseNorm", "SpectralNorm", "SyncBatchNorm"]


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
    """Cross-rank BatchNorm: in training, the statistics span the rows of
    every rank of the ``dp`` group (``F.sync_batch_norm``), so the output,
    the running stats and the gradients are those of ``BatchNorm`` over
    the global batch, as the JAX layer (GSPMD over the global batch) gives
    them. With one rank, and with the running stats, it is ``BatchNorm``."""

    def forward(self, x):
        from ...distributed import env as dist_env

        use_stats = (not self.training) if self._use_global_stats is None \
            else self._use_global_stats
        env = dist_env.instance()
        if use_stats or not env.initialized or \
                env.axis_degrees.get("dp", 1) == 1:
            return super().forward(x)
        return sync_batch_norm(x, self._mean, self._variance, self.weight,
                                 self.bias, momentum=self._momentum,
                                 epsilon=self._epsilon,
                                 data_format=self._data_format)

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """``layer`` with every BatchNorm below it replaced by a
        ``SyncBatchNorm`` holding the same parameters and running stats
        (the tensors themselves); ``layer`` itself when it is one."""
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, cls):
            new = cls(layer._num_features, layer._momentum, layer._epsilon,
                      weight_attr=False, bias_attr=False,
                      data_format=layer._data_format,
                      use_global_stats=layer._use_global_stats,
                      device=layer._mean.device)
            new.weight, new.bias = layer.weight, layer.bias
            new._mean, new._variance = layer._mean, layer._variance
            new.train(layer.training)
            return new
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return layer


def _affine_params(layer, n, weight_attr, bias_attr):
    layer.weight = layer.create_parameter(
        [n], attr=weight_attr, default_initializer=Constant(1.0))
    layer.bias = layer.create_parameter([n], attr=bias_attr, is_bias=True)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        with building(self, device, generator):
            _affine_params(self, num_channels, weight_attr, bias_attr)

    def forward(self, x):
        return F.group_norm(x, self._num_groups, self._epsilon, self.weight,
                            self.bias, self._data_format)


class InstanceNorm1D(Layer):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._epsilon, self._data_format = epsilon, data_format
        with building(self, device, generator):
            _affine_params(self, num_features, weight_attr, bias_attr)

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, **kw)


class InstanceNorm3D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 name=None, **kw):
        super().__init__(num_features, epsilon, momentum, weight_attr,
                         bias_attr, data_format, name, **kw)


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.args = (size, alpha, beta, k, data_format)

    def forward(self, x):
        return F.local_response_norm(x, *self.args)


class SpectralNorm(Layer):
    """``weight`` divided by its largest singular value, estimated by
    ``power_iters`` steps of power iteration from the layer's ``weight_u``
    and ``weight_v`` (which the forward does not update), as the JAX layer
    computes it."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 dtype="float32", *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self._dim, self._power_iters, self._epsilon = dim, power_iters, \
            epsilon
        h = int(weight_shape[dim])
        w = math.prod(int(s) for s in weight_shape) // h
        with building(self, device, generator):
            self.weight_u = self.create_parameter(
                [h], default_initializer=Normal(0.0, 1.0))
            self.weight_v = self.create_parameter(
                [w], default_initializer=Normal(0.0, 1.0))
        self.weight_u.stop_gradient = True
        self.weight_v.stop_gradient = True

    def forward(self, weight):
        dim, eps = self._dim, self._epsilon
        wm = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
        u, v = self.weight_u.detach(), self.weight_v.detach()
        for _ in range(self._power_iters):
            v = wm.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wm @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        return weight / (u @ wm @ v)
