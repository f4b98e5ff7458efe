"""``Linear``, ``Embedding``, ``LayerNorm``, ``Dropout``, ``RMSNorm``,
``Flatten`` and ``Identity`` (port of ``paddle_tpu/nn/layer/common.py``
and ``norm.py``). ``Linear``, ``Embedding`` and ``LayerNorm`` are torch's
modules and ``Layer`` s at once (same parameters, names and ``[out, in]``
weight layout as torch's) whose forward runs the port's functionals, so
they follow the AMP state and the JAX rules as the JAX layers do. Their
parameters come from ``create_parameter`` with the JAX layers' defaults
and ``weight_attr``/``bias_attr`` (a ``ParamAttr``, an initializer, a
name, or False for none); a ``Linear`` weight is marked ``transposed``,
so an initializer computes on the JAX ``[in, out]`` shape. Built alone, a
layer lands on ``device`` (default: ``set_device``'s, else CUDA) with
values from ``generator`` (default: the build generator); inside a model's
build, the model does that."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...device import DEFAULT_DEVICE
from .. import functional as F
from ..initializer import Constant, Normal, XavierNormal
from .layers import Layer, building, held_generator

__all__ = ["Dropout", "Embedding", "Flatten", "Identity", "Linear",
           "LayerNorm", "RMSNorm"]


class Linear(nn.Linear, Layer):
    """``y = x @ weight.T + bias``: ``weight`` ``[out, in]`` (the JAX
    layer's ``[in, out]`` transposed) from ``XavierNormal`` (std ``sqrt(2
    / (in + out))``), ``bias`` 0, or none with ``bias_attr=False``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        with building(self, device, generator):
            super().__init__(in_features, out_features,
                             bias=bias_attr is not False)
            self.weight = self.create_parameter(
                [out_features, in_features], attr=weight_attr,
                default_initializer=XavierNormal(), transposed=True)
            if bias_attr is not False:
                self.bias = self.create_parameter([out_features],
                                                  attr=bias_attr,
                                                  is_bias=True)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class Embedding(nn.Embedding, Layer):
    """torch's module with the JAX layer's parameter (``Normal(0, 1)``, or
    ``weight_attr``'s initializer; the ``padding_idx`` row then zeroed, a
    negative index counted from the end) and forward: the output is 0 at
    padding positions whatever the row holds (``F.embedding``)."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        with building(self, device, generator):
            super().__init__(num_embeddings, embedding_dim,
                             padding_idx=padding_idx)
            self.weight = self.create_parameter(
                [num_embeddings, embedding_dim], attr=weight_attr,
                default_initializer=Normal(0.0, 1.0))

    @torch.no_grad()
    def _init_parameters(self, gen: torch.Generator) -> None:
        super()._init_parameters(gen)
        if self.padding_idx is not None:
            self.weight[self.padding_idx].zero_()

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(Layer):
    """Upscale-in-train dropout of probability ``p`` while training, its
    keep masks drawn from ``generator`` (a ``torch.Generator`` on the
    input's device), never from torch's global one. Without one, the
    layer holds from its construction the process-wide dropout generator
    of the default device (``layers.held_generator``, seeded by
    ``paddle.seed``). ``axis`` and the ``downscale_in_infer`` mode are not
    ported yet (ROADMAP.md, queue 1 item 6)."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        if axis is not None or mode != "upscale_in_train":
            raise NotImplementedError(
                "Dropout takes axis=None and mode='upscale_in_train' only "
                "(ROADMAP.md, queue 1 item 6)")
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = held_generator(generator, p > 0.0)

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class LayerNorm(nn.LayerNorm, Layer):
    """LayerNorm over the trailing ``normalized_shape``: ``weight`` 1 and
    ``bias`` 0 (each dropped with ``*_attr=False``), ``epsilon`` (torch's
    ``eps=`` taken too)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None, *, eps=None,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        eps = epsilon if eps is None else eps
        with building(self, device, generator):
            super().__init__(normalized_shape, eps=eps)
            shape = list(self.normalized_shape)
            self.weight = self.create_parameter(
                shape, attr=weight_attr, default_initializer=Constant(1.0))
            self.bias = self.create_parameter(shape, attr=bias_attr,
                                              is_bias=True)

    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class Identity(Layer):
    """``x`` itself; the arguments are taken and ignored."""

    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, x):
        return x


class RMSNorm(Layer):
    """RMSNorm over the last axis (``paddle_tpu/nn/layer/norm.py``
    ``RMSNorm``): one parameter, ``weight``, initialized to 1.0; the
    forward is ``F.rms_norm`` with the weight, so K4 on the GPU."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6,
                 weight_attr=None, name=None, *, device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        if len(normalized_shape) != 1:
            raise NotImplementedError(
                "RMSNorm normalizes the last axis only: pass one size")
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        with building(self, device, generator):
            self.weight = self.create_parameter(
                list(self.normalized_shape), attr=weight_attr,
                default_initializer=Constant(1.0))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class Flatten(Layer):
    """``x`` with its axes ``start_axis`` to ``stop_axis`` merged into one
    (``paddle_tpu/nn/layer/common.py:102``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
