"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

Layout follows paddle: ``[batch, seqlen, num_heads, head_dim]``. Both
functionals run through ``flash_attention_value`` (``ops/cuda/
flash_attention.py``), which is differentiable: K1 forward and K2/K3
backward for CUDA tensors, their plain versions for CPU tensors. Dropout
applies when ``training`` and the probability is positive; its seed, a
``(1,)`` int32 tensor, is drawn from the caller's ``torch.Generator`` on
the tensors' device (the JAX ``_seed_from_key`` draws it from a key), so
the global generator is never touched. ``attn_mask`` and
``return_softmax`` raise ``NotImplementedError`` naming where they are
queued.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...amp.auto_cast import cast_inputs
from ...ops.cuda.flash_attention import flash_attention_value

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A ``(1,)`` int32 dropout seed in [0, 2**31 - 1), drawn on ``device``
    from ``generator``; no host round trip."""
    if generator is None:
        raise ValueError("attention dropout draws its seed from an explicit "
                         "torch.Generator: pass generator=")
    return torch.randint(0, 2**31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)


def _attend(op, query, key, value, causal, dropout, generator):
    query, key, value = cast_inputs(op, query, key, value)
    seed = _draw_seed(generator, query.device) if dropout > 0.0 else None
    return flash_attention_value(query, key, value, causal,
                                 1.0 / math.sqrt(query.shape[-1]), dropout,
                                 seed, device=query.device)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, generator=None):
    """``paddle.nn.functional.flash_attention.flash_attention`` parity:
    returns ``(out, None)``."""
    if return_softmax:
        raise NotImplementedError(
            "return_softmax materializes the probabilities; not ported yet "
            "(ROADMAP.md, queue 1)")
    out = _attend("flash_attention", query, key, value, causal,
                  dropout if training else 0.0, generator)
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` parity for
    the unmasked case (q/k/v: ``[B, S, H, D]``)."""
    if attn_mask is not None:
        raise NotImplementedError(
            "attn_mask is not ported yet (ROADMAP.md, queue 1)")
    return _attend("sdpa_flash", query, key, value, is_causal,
                   dropout_p if training else 0.0, generator)
