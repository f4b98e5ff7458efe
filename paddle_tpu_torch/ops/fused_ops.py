"""Fused-op tier (port of ``paddle_tpu/ops/fused_ops.py``, the subset the
Llama path reaches): rotary position embeddings.

The JAX package writes RoPE as one jnp composite for XLA to fuse; it has
no Pallas kernel, so here it is plain torch.
"""
from __future__ import annotations

import functools

import torch

from ..amp.auto_cast import cast_inputs

__all__ = ["fused_rotary_position_embedding"]


@functools.lru_cache(maxsize=32)
def _rope_table(s: int, d: int, base: float, neox: bool,
                device: torch.device):
    """``(sin, cos)``, each ``[1, S, 1, D]`` f32 on ``device``. Built on the
    host by the JAX formula (``base ** (-arange(0, D, 2) / D)``, then
    ``pos ⊗ freqs``) and only then moved, so the card's table is bit for
    bit the CPU's. Not a module buffer: ``amp.decorate`` would cast it."""
    # normal tensors even when first made under inference_mode, so a later
    # training step may save them for backward
    with torch.inference_mode(False):
        pos = torch.arange(s, dtype=torch.float32)
        freqs = base ** (-torch.arange(0, d, 2, dtype=torch.float32) / d)
        ang = pos[:, None] * freqs[None, :]
        emb = (torch.cat([ang, ang], -1) if neox
               else torch.repeat_interleave(ang, 2, -1))
        return tuple(f(emb)[None, :, None, :].to(device)
                     for f in (torch.sin, torch.cos))


def _rotate(t, sin, cos, neox):
    if neox:
        t1, t2 = t.chunk(2, dim=-1)
        rot = torch.cat([-t2, t1], dim=-1)
    else:
        rot = torch.stack([-t[..., 1::2], t[..., 0::2]], -1).reshape(t.shape)
    return t * cos + rot * sin


def fused_rotary_position_embedding(q, k=None, v=None, sin=None, cos=None,
                                    position_ids=None,
                                    use_neox_rotary_style=True,
                                    time_major=False,
                                    rotary_emb_base=10000.0):
    """RoPE applied to each of q, k, v that is given (``[B, S, H, D]``),
    returning the three (None where not given). ``sin``/``cos`` (``[S, D]``
    or ``[1, S, 1, D]``) are built from ``rotary_emb_base`` when not given;
    ``position_ids`` (``[B, S]``) pick their rows. Neox style rotates the
    halves, the interleaved style the even/odd pairs. Op ``fused_rope``:
    gray, so bf16 under AMP O2. ``time_major`` (``[S, B, H, D]``) is not
    ported; the JAX function accepts the flag and ignores it."""
    if time_major:
        raise NotImplementedError(
            "time_major RoPE is not ported (ROADMAP.md, queue 1)")
    s, d = q.shape[1], q.shape[3]
    if sin is None or cos is None:
        sin_v, cos_v = _rope_table(s, d, float(rotary_emb_base),
                                   bool(use_neox_rotary_style), q.device)
    else:
        sin_v, cos_v = sin, cos
        if sin_v.dim() == 2:
            sin_v, cos_v = sin_v[None, :, None, :], cos_v[None, :, None, :]
    if position_ids is not None:
        n = max(s, sin_v.shape[1])
        sin_v = sin_v.expand(1, n, 1, d)[0, :, 0][position_ids][:, :, None, :]
        cos_v = cos_v.expand(1, n, 1, d)[0, :, 0][position_ids][:, :, None, :]
    outs = []
    for t in (q, k, v):
        if t is None:
            outs.append(None)
            continue
        (t,) = cast_inputs("fused_rope", t)
        # cast right before the multiply, where the JAX package rounds
        # (fused_ops.py:108)
        outs.append(_rotate(t, sin_v.to(t.dtype), cos_v.to(t.dtype),
                            use_neox_rotary_style))
    return tuple(outs)
