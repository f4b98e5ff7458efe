"""``Linear`` and ``LayerNorm``: torch's modules (same parameters, names and
``[out, in]`` weight layout) whose forward runs the port's functionals, so
they follow the AMP state as the JAX layers do."""
from __future__ import annotations

from torch import nn

from .. import functional as F

__all__ = ["Linear", "LayerNorm"]


class Linear(nn.Linear):
    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                            self.eps)
