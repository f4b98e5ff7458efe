"""Miscellaneous ops (port of ``paddle_tpu/ops/misc_ops.py``; so far
``spectral_norm``, which ``static.nn.spectral_norm`` builds on). The rest
of the JAX module is queue 1 item 10 of ``ROADMAP.md``."""
from __future__ import annotations

import torch

from ..core.tensor import paddle_out

__all__ = ["spectral_norm"]


@paddle_out
def spectral_norm(weight, u, v, dim=0, power_iters=1, eps=1e-12, name=None):
    """``weight`` divided by its largest singular value, estimated by
    ``power_iters`` steps of power iteration from ``u`` ``[h]`` and ``v``
    ``[w]`` (each normalized by ``max(norm, eps)``), as the JAX op computes
    it (reference op: spectral_norm)."""
    wm = weight.movedim(dim, 0).reshape(weight.shape[dim], -1)
    uu, vv = u, v
    for _ in range(max(int(power_iters), 0)):
        vv = wm.T @ uu
        vv = vv / torch.clamp_min(torch.linalg.vector_norm(vv), eps)
        uu = wm @ vv
        uu = uu / torch.clamp_min(torch.linalg.vector_norm(uu), eps)
    sigma = uu @ wm @ vv
    return weight / torch.clamp_min(sigma, eps)
