"""Attention functionals (port of ``paddle_tpu/nn/functional/attention.py``).

Layout follows paddle: ``[batch, seqlen, num_heads, head_dim]``. Without
a mask both functionals run through ``flash_attention_value`` (``ops/cuda/
flash_attention.py``), which is differentiable: K1 forward and K2/K3
backward for CUDA tensors, their plain versions for CPU tensors. Dropout
applies when ``training`` and the probability is positive; its seed, a
``(1,)`` int32 tensor, is drawn from the caller's ``torch.Generator`` on
the tensors' device, or from the process-wide dropout generator there
(``base.global_state.dropout_generator``, seeded by ``paddle.seed``)
when the caller gives none (the JAX ``_seed_from_key`` draws it from a
key); torch's global generator is never touched.

With ``attn_mask`` (BERT's padding bias), and for ``return_softmax``, the
JAX package takes its XLA composition ``_xla_attention``, which has no
Pallas kernel; the port computes the same composition with torch ops
(:func:`_xla_attention`), in the same dtypes step for step, and autograd
differentiates it. Dropout there draws its keep mask from the caller's
generator: the JAX ``jax.random.bernoulli`` stream cannot be matched.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...amp.auto_cast import cast_inputs
from ...base import draws
from ...ops.cuda.flash_attention import NEG_INF, flash_attention_value
from .common import dropout as _dropout

__all__ = ["flash_attention", "scaled_dot_product_attention"]


def _draw_seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A ``(1,)`` int32 dropout seed in [0, 2**31 - 1), drawn on ``device``
    from ``generator`` (the process-wide dropout generator on ``device``
    when it is None), or from the pushed draw source (``base.draws``); no
    host round trip."""
    return draws.seed(generator, device)


def _xla_attention(q, k, v, causal: bool, scale: float, bias=None,
                   dropout: float = 0.0,
                   generator: Optional[torch.Generator] = None):
    """The JAX ``_xla_attention`` with torch ops; returns ``(out, probs)``,
    ``probs`` before dropout. The logits are the einsum in the input dtype
    times ``scale``; an f32 ``bias`` promotes them to f32, as jnp does; a
    causal mask is top-left aligned as JAX's ``tril(·, t − s)``; the
    softmax runs in f32 and is cast back to q's dtype before P·V."""
    logits = torch.einsum("bshd,bthd->bhst", q, k) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        s, t = logits.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=q.device).tril(t - s)
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    p = _dropout(probs, dropout, training=True, generator=generator)
    return torch.einsum("bhst,bthd->bshd", p, v), probs


def _attend(op, query, key, value, causal, dropout, generator):
    query, key, value = cast_inputs(op, query, key, value)
    seed = _draw_seed(generator, query.device) if dropout > 0.0 else None
    return flash_attention_value(query, key, value, causal,
                                 1.0 / math.sqrt(query.shape[-1]), dropout,
                                 seed, device=query.device)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, training=True, generator=None):
    """``paddle.nn.functional.flash_attention.flash_attention`` parity:
    returns ``(out, None)``, or with ``return_softmax`` ``(out, probs
    [B, H, Sq, Sk])`` through the composition that materializes them (op
    ``flash_attention_xla``)."""
    if return_softmax:
        q, k, v = cast_inputs("flash_attention_xla", query, key, value)
        return _xla_attention(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]),
                              dropout=dropout if training else 0.0,
                              generator=generator)
    out = _attend("flash_attention", query, key, value, causal,
                  dropout if training else 0.0, generator)
    return out, None


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, generator=None):
    """``paddle.nn.functional.scaled_dot_product_attention`` parity (q/k/v:
    ``[B, S, H, D]``). ``attn_mask`` broadcasts to ``[B, H, Sq, Sk]``: a
    float mask is added to the logits, a bool one keeps where True (its
    bias ``where(m, 0, -1e30)`` in f32); a masked call computes the
    composition (op ``sdpa_xla``), an unmasked one runs K1–K3."""
    if attn_mask is not None:
        bias = (torch.where(attn_mask, 0.0, NEG_INF)
                if attn_mask.dtype == torch.bool else attn_mask)
        q, k, v, bias = cast_inputs("sdpa_xla", query, key, value, bias)
        return _xla_attention(q, k, v, is_causal,
                              1.0 / math.sqrt(q.shape[-1]), bias,
                              dropout_p if training else 0.0, generator)[0]
    return _attend("sdpa_flash", query, key, value, is_causal,
                   dropout_p if training else 0.0, generator)
