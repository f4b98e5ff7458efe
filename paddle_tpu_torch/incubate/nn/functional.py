"""``paddle.incubate.nn.functional`` for the port (port of
``paddle_tpu/incubate/nn/functional.py``, the ported subset): the Llama
fusions ``fused_rms_norm`` and ``swiglu``, and the re-exports of
``flashmask_attention``, ``fused_softmax_mask`` and
``fused_softmax_mask_upper_triangle``."""
from __future__ import annotations

from ...device import DEFAULT_DEVICE, resolve_device
from ...nn import functional as F
from ...nn.functional.flash_attention import (
    flashmask_attention, fused_softmax_mask, fused_softmax_mask_upper_triangle)
from ...ops.activation import swiglu

__all__ = ["flashmask_attention", "fused_rms_norm", "fused_softmax_mask",
           "fused_softmax_mask_upper_triangle", "swiglu"]


def fused_rms_norm(x, norm_weight, norm_bias=None, epsilon: float = 1e-6,
                   begin_norm_axis: int = -1, bias=None, residual=None, *,
                   device=DEFAULT_DEVICE):
    """``(out, residual_out)``: ``residual_out = x (+ bias) (+ residual)``,
    the pre-norm sum that feeds the next skip connection, and ``out =
    rms_norm(residual_out) * norm_weight (+ norm_bias)`` through
    ``F.rms_norm`` (K4 on the GPU). Normalizes the last axis only.
    ``device`` is where the caller means to run (default CUDA); the
    tensors must lie there."""
    ndim = x.dim()
    if begin_norm_axis not in (-1, ndim - 1):
        raise NotImplementedError(
            f"fused_rms_norm: only last-axis normalization is implemented "
            f"(begin_norm_axis={begin_norm_axis}, ndim={ndim}); flatten the "
            "trailing dims first")
    dev = resolve_device(device)
    for t in (x, norm_weight, norm_bias, bias, residual):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"a tensor lies on {t.device}, the call asked "
                             f"for {dev}")
    v = x
    if bias is not None:
        v = v + bias
    if residual is not None:
        v = v + residual
    out = F.rms_norm(v, norm_weight, epsilon=epsilon)
    if norm_bias is not None:
        out = out + norm_bias
    return out, v
