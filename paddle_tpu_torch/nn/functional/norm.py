"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``,
``layer_norm``)."""
from __future__ import annotations

import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["layer_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape``; under AMP O2 it
    computes in f32 and returns f32 (op ``layer_norm``, black list)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    return TF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)
