"""``Linear``, ``LayerNorm`` and ``RMSNorm``. The first two are torch's
modules (same parameters, names and ``[out, in]`` weight layout) whose
forward runs the port's functionals, so they follow the AMP state as the
JAX layers do; ``RMSNorm`` is the JAX layer's counterpart."""
from __future__ import annotations

import torch
from torch import nn

from .. import functional as F

__all__ = ["Linear", "LayerNorm", "RMSNorm"]


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


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
