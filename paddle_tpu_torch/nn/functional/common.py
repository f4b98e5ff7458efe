"""Common functionals (port of ``paddle_tpu/nn/functional/common.py``, the
subset the GPT and BERT paths reach): ``linear`` under AMP, ``embedding``
with the JAX ``padding_idx`` rule and ``dropout`` from an explicit
generator."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["linear", "embedding", "dropout"]


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with torch's ``[out, in]`` weight; under
    AMP O2 it computes in the AMP dtype (op ``linear``)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return TF.linear(x, weight, bias)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` gathered at the integer ids ``x``; op
    ``embedding`` (gray under AMP). With ``padding_idx`` the output is 0
    wherever ``x`` equals it, whatever that row holds, as the JAX function
    selects it away (torch's ``padding_idx`` returns the row and zeroes only
    its gradient). The gradient reaches the weight alone. ``sparse`` is
    accepted and ignored, as in the JAX package."""
    (weight,) = cast_inputs("embedding", weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def dropout(x, p: float = 0.5, training: bool = True,
            generator: Optional[torch.Generator] = None):
    """Upscale-in-train dropout: ``x / (1 - p)`` where kept, 0 where
    dropped, the keep mask drawn from ``generator`` (a ``torch.Generator``
    on ``x``'s device). Randomness is explicit: the global generator is
    never drawn from, so ``generator`` is required when the call drops."""
    if not training or p == 0.0:
        return x
    if not 0.0 < p < 1.0:
        raise ValueError(f"dropout probability must be in [0, 1), got {p}")
    if generator is None:
        raise ValueError("dropout draws from an explicit torch.Generator: "
                         "pass generator=")
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= p
    return torch.where(keep, x / (1.0 - p), 0.0)
