"""Sampled next-token choice, drawn exactly as the JAX package draws it.

The JAX decode programs (``paddle_tpu/serving/decode.py``
``PagedDecodePrograms._choose_tokens``) filter each lane's logits by
temperature, top-k and top-p, then call ``jax.random.categorical`` with
the lane's raw ``uint32[2]`` key ``[seed, token_index]``. That draw is a
pure function of the key, so this module computes it in torch, bit for
bit:

- ``threefry2x32`` — JAX's counter-based generator (20 rounds, rotations
  13/15/26/6 and 17/29/16/24, key injection every 4 rounds), over int64
  tensors that hold 32-bit values;
- ``random_bits`` — the bits of a ``[V]`` draw under JAX's partitionable
  threefry: counters ``(0, i)`` for index ``i``, the bits ``b1 ^ b2``;
- ``gumbel`` — the uniform ``((bits >> 9) | 0x3F800000)`` as f32, minus
  1, lifted to ``[tiny, 1)``, then ``-log(-log(u))``;
- ``categorical`` — the first index of the max of ``logits + gumbel``.

No ``torch.Generator`` is drawn from: a lane's stream depends only on its
key, never on its batch, and a CUDA graph can capture the draw.
"""
from __future__ import annotations

import math

import torch

__all__ = ["threefry2x32", "random_bits", "gumbel", "categorical",
           "filtered_logits", "choose_tokens"]

_MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counters ``(x1, x2)`` under the key ``(k1,
    k2)``; every argument an int64 tensor of 32-bit values (broadcast).
    Returns the two output words, int64 holding 32 bits."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _MASK32
    x2 = (x2 + ks[1]) & _MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK32
            x2 = _rotl32(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK32
    return x1, x2


def random_bits(keys, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for each raw key row of
    ``keys`` (``[B, 2]`` int64 of 32-bit values) → ``[B, n]`` int64."""
    keys = keys.long()
    col = torch.arange(n, device=keys.device, dtype=torch.int64)[None]
    b1, b2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(col),
                          col)
    return b1 ^ b2


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` per key row → ``[B, n]``
    f32: the uniform in ``[tiny, 1)`` from the mantissa bits, then
    ``-log(-log(u))``."""
    bits = random_bits(keys, n)
    floats = (((bits >> 9) | 0x3F800000).to(torch.int32)
              .view(torch.float32) - 1.0)
    u = torch.clamp_min(floats + _TINY, _TINY)
    return -torch.log(-torch.log(u))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` per row: the first index of
    the max of ``logits + gumbel``; ``logits`` ``[B, V]`` f32."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, dim=-1)


def filtered_logits(head, temps, top_ks, top_ps):
    """Each lane's logits ``[B, V]`` divided by its temperature, with what
    the top-k and top-p filters drop set to ``-inf``. The kept set is the
    prefix of the descending sort that both filters keep (rank below
    ``top_k`` when ``top_k > 0``; cumulative probability before the value
    below ``top_p`` when ``0 < top_p < 1``), its cutoff the smallest kept
    value, as JAX's ``lane`` computes it. f32."""
    V = head.shape[-1]
    scaled = head.float() / torch.where(temps > 0, temps, 1.0)[:, None]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    rank = torch.arange(V, device=head.device)
    k_eff = torch.clamp(torch.where(top_ks > 0, top_ks, V), 1, V)
    e = torch.exp(srt - srt[:, :1])
    probs = e / e.sum(dim=-1, keepdim=True)
    p_eff = torch.where((top_ps > 0.0) & (top_ps < 1.0), top_ps, 1.0)
    keep = ((rank[None] < k_eff[:, None])
            & (torch.cumsum(probs, dim=-1) - probs < p_eff[:, None]))
    cutoff = torch.where(keep, srt, math.inf).amin(dim=-1, keepdim=True)
    return torch.where(scaled >= cutoff, scaled, -math.inf)


def choose_tokens(head, temps, top_ks, top_ps, rkeys):
    """Per-lane next token from head logits ``[B, V]``: a lane with
    ``temps == 0`` takes the plain argmax, so greedy decoding stays
    bit-exact; the others draw :func:`categorical` from
    :func:`filtered_logits` under their key ``rkeys[b]``. Both branches
    are computed for every lane and chosen by ``temps``, as the JAX
    program does."""
    greedy = torch.argmax(head, dim=-1)
    sampled = categorical(rkeys, filtered_logits(head, temps, top_ks,
                                                 top_ps))
    return torch.where(temps > 0, sampled, greedy)
