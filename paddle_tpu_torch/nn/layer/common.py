"""``Linear``, ``Embedding``, ``LayerNorm``, ``Dropout``, ``RMSNorm`` and
``Flatten``. ``Linear``, ``Embedding`` and ``LayerNorm`` are torch's
modules (same parameters, names and ``[out, in]`` weight layout) whose
forward runs the port's functionals, so they follow the AMP state and the
JAX rules as the JAX layers do; ``Dropout``, ``RMSNorm`` and ``Flatten``
are the JAX layers' counterparts."""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from .. import functional as F

__all__ = ["Dropout", "Embedding", "Flatten", "Linear", "LayerNorm",
           "RMSNorm"]


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)

    def _init_parameters(self, gen: torch.Generator) -> None:
        """The JAX ``Linear``'s defaults (``nn.layer.layers.
        init_parameters``): ``XavierNormal`` weight, std ``sqrt(2 / (in +
        out))``, and a zero bias."""
        std = math.sqrt(2.0 / (self.in_features + self.out_features))
        self.weight.normal_(0.0, std, generator=gen)
        if self.bias is not None:
            self.bias.zero_()


class Embedding(nn.Embedding):
    """torch's module (its ``padding_idx`` row is zero at construction, as
    the JAX layer's is) with the JAX forward: the output is 0 at padding
    positions whatever the row holds (``F.embedding``)."""

    def forward(self, x):
        return F.embedding(x, self.weight, self.padding_idx)


class Dropout(nn.Module):
    """Upscale-in-train dropout of probability ``p`` while training, its
    keep masks drawn from ``generator`` (a ``torch.Generator`` on the
    input's device; required when the layer drops), never from torch's
    global one."""

    def __init__(self, p: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.p = p
        self.generator = generator

    def forward(self, x):
        return F.dropout(x, self.p, self.training, self.generator)

    def extra_repr(self) -> str:
        return f"p={self.p}"


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)


class RMSNorm(nn.Module):
    """RMSNorm over the last axis (``paddle_tpu/nn/layer/norm.py``
    ``RMSNorm``): one parameter, ``weight``, initialized to 1.0; the
    forward is ``F.rms_norm`` with the weight, so K4 on the GPU."""

    def __init__(self, normalized_shape, epsilon: float = 1e-6):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        if len(normalized_shape) != 1:
            raise NotImplementedError(
                "RMSNorm normalizes the last axis only: pass one size")
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = epsilon
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))

    def forward(self, x):
        return F.rms_norm(x, self.weight, self.epsilon)

    def extra_repr(self) -> str:
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"


class Flatten(nn.Module):
    """``x`` with its axes ``start_axis`` to ``stop_axis`` merged into one
    (``paddle_tpu/nn/layer/common.py:102``)."""

    def __init__(self, start_axis: int = 1, stop_axis: int = -1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, x):
        return torch.flatten(x, self.start_axis, self.stop_axis)
