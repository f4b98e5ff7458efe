"""Gradient clipping (port of ``paddle_tpu/nn/clip.py``), given to an
optimizer as ``grad_clip`` and applied to its ``(parameter, gradient)``
pairs before the update. A parameter whose ``need_clip`` attribute is
False passes unclipped.

No clip reads a value back to the host: the norms and scales are device
scalars, so a clipped step runs in one CUDA graph. Each result keeps the
dtype of the jnp expression it ports:

- ``ClipGradByValue``: ``clip(g, min, max)`` in g's dtype;
- ``ClipGradByNorm``: each g's own norm ``sqrt(sum(g²))`` and scale
  ``min(clip_norm / max(norm, 1e-12), 1)`` in g's dtype (python scalars
  keep it, as jnp's weak types do), then ``g · scale``;
- ``ClipGradByGlobalNorm``: one f32 norm over every clipped g (each
  ``sum(g²)`` in f32, added in the pairs' order), the f32 scale cast to
  each g's dtype before ``g · scale``.
"""
from __future__ import annotations

import torch

__all__ = ["ClipGradBase", "ClipGradByGlobalNorm", "ClipGradByNorm",
           "ClipGradByValue", "GradientClipBase", "GradientClipByGlobalNorm",
           "GradientClipByNorm", "GradientClipByValue"]


def _skips(p, g) -> bool:
    return g is None or not getattr(p, "need_clip", True)


class ClipGradBase:
    def __call__(self, params_grads):
        raise NotImplementedError


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, params_grads):
        return [(p, g if _skips(p, g) else torch.clamp(g, self.min, self.max))
                for p, g in params_grads]


class ClipGradByNorm(ClipGradBase):
    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _skips(p, g):
                out.append((p, g))
                continue
            norm = torch.sqrt(torch.sum(torch.square(g)))
            scale = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            out.append((p, g * scale))
        return out


class ClipGradByGlobalNorm(ClipGradBase):
    """Global-norm clip: every clipped gradient scaled by
    ``min(clip_norm / max(‖g‖, 1e-12), 1)``, ``‖g‖`` the f32 norm over all
    of them."""

    def __init__(self, clip_norm, group_name="default_group",
                 auto_skip_clip=False):
        self.clip_norm = float(clip_norm)
        #: the norm of the last call, a device scalar (inside a CUDA graph:
        #: the replays' cell), for a caller to read after a step
        self.last_norm = None

    def _global_norm_sq(self, params_grads):
        total = None
        for p, g in params_grads:
            if _skips(p, g):
                continue
            s = torch.sum(torch.square(g.float()))
            total = s if total is None else total + s
        return total

    def __call__(self, params_grads):
        total = self._global_norm_sq(params_grads)
        if total is None:
            return params_grads
        gnorm = self.last_norm = torch.sqrt(total)
        scale = torch.clamp_max(
            self.clip_norm / torch.clamp_min(gnorm, 1e-12), 1.0)
        return [(p, g if _skips(p, g) else g * scale.to(g.dtype))
                for p, g in params_grads]


GradientClipBase = ClipGradBase
GradientClipByValue = ClipGradByValue
GradientClipByNorm = ClipGradByNorm
GradientClipByGlobalNorm = ClipGradByGlobalNorm
