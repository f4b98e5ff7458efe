"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``,
``layer_norm`` and ``rms_norm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs
from ...ops.cuda.rms_norm import rms_norm_value

__all__ = ["layer_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape``; under AMP O2 it
    computes in f32 and returns f32 (op ``layer_norm``, black list)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    return TF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """RMSNorm over the last axis. With a weight it takes the route the JAX
    package takes on the TPU: the fused kernel (for CUDA tensors K4 and
    the backward kernel, for CPU tensors their plain versions) under op
    ``pallas_rms_norm``, white-listed, so under AMP O2 x and w enter in
    bf16 and the result is bf16. Without a weight it is the JAX fallback
    in plain torch under op ``rms_norm``, black-listed: f32 under O2."""
    if weight is None:
        (x,) = cast_inputs("rms_norm", x)
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + epsilon)
    x, weight = cast_inputs("pallas_rms_norm", x, weight)
    return rms_norm_value(x, weight, epsilon, device=x.device)
