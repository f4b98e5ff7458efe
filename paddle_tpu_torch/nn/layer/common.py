"""``Linear``, ``Embedding``, ``LayerNorm``, ``RMSNorm``, the dropouts
(``Dropout``, ``Dropout2D/3D``, ``AlphaDropout``), the pads, the
upsamplers, the shuffles, ``Bilinear``, ``CosineSimilarity``,
``Fold``/``Unfold``, ``Flatten`` and ``Identity`` (port of
``paddle_tpu/nn/layer/common.py`` and ``norm.py``). ``Linear``, ``Embedding`` and ``LayerNorm`` are torch's
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

__all__ = ["AlphaDropout", "Bilinear", "ChannelShuffle", "CosineSimilarity",
           "Dropout", "Dropout2D", "Dropout3D", "Embedding", "Flatten",
           "Fold", "Identity", "LayerNorm", "Linear", "Pad1D", "Pad2D",
           "Pad3D", "PixelShuffle", "PixelUnshuffle", "RMSNorm", "Unfold",
           "Upsample", "UpsamplingBilinear2D", "UpsamplingNearest2D",
           "ZeroPad2D"]


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
    """Dropout of probability ``p`` while training (``F.dropout``: ``axis``
    and both modes), its keep masks drawn from ``generator`` (a
    ``torch.Generator`` on the input's device), never from torch's global
    one. Without one, the layer holds from its construction the
    process-wide dropout generator of the default device
    (``layers.held_generator``, seeded by ``paddle.seed``)."""

    def __init__(self, p: float = 0.5, axis=None, mode="upscale_in_train",
                 name=None, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode
        self.generator = held_generator(generator, p > 0.0)

    def forward(self, x):
        return F.dropout(x, self.p, self.axis, self.training, self.mode,
                         generator=self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class Dropout2D(Dropout):
    """Whole channels dropped (``F.dropout2d``)."""

    def __init__(self, p=0.5, data_format="NCHW", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(p, generator=generator)
        self.data_format = data_format

    def forward(self, x):
        return F.dropout2d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class Dropout3D(Dropout):
    def __init__(self, p=0.5, data_format="NCDHW", name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(p, generator=generator)
        self.data_format = data_format

    def forward(self, x):
        return F.dropout3d(x, self.p, self.training, self.data_format,
                           generator=self.generator)


class AlphaDropout(Dropout):
    def __init__(self, p=0.5, name=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(p, generator=generator)

    def forward(self, x):
        return F.alpha_dropout(x, self.p, self.training,
                               generator=self.generator)


class _Pad(Layer):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.padding, self.mode, self.value, self.data_format = (
            padding, mode, value, data_format)

    def forward(self, x):
        return F.pad(x, self.padding, mode=self.mode, value=self.value,
                     data_format=self.data_format)


class Pad1D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_Pad):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class Upsample(Layer):
    """``F.interpolate`` (the JAX resize) as a layer."""

    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0,
                         data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0,
                         data_format)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = (downscale_factor,
                                                   data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Bilinear(Layer):
    """``x1 · weight[o] · x2 + bias``: ``weight`` ``[out, in1, in2]`` from
    ``XavierNormal`` (the JAX layer's default), ``bias`` 0 (none with
    ``bias_attr=False``)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None, *,
                 device=DEFAULT_DEVICE,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        with building(self, device, generator):
            self.weight = self.create_parameter(
                [out_features, in1_features, in2_features], attr=weight_attr)
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


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
