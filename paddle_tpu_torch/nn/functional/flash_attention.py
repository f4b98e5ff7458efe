"""Flash-attention API family (port of
``paddle_tpu/nn/functional/flash_attention.py``).

- ``flashmask_attention``: attention under the column-compressed
  ``startend_row_indices`` mask, through ``flashmask_value``
  (``ops/cuda/flashmask.py``): K5 forward and K6/K7 backward for CUDA
  tensors, their plain versions for CPU tensors. Without indices it is
  ``flash_attention`` (K1–K3).
- ``flash_attn_qkvpacked``: the packed ``[B, S, 3, H, D]`` tensor sliced
  (views, no copy) into ``flash_attention``.
- ``flash_attn_unpadded``, ``flash_attn_varlen_qkvpacked``,
  ``calc_reduced_attn_scores``, ``fused_softmax_mask`` and
  ``fused_softmax_mask_upper_triangle``: plain torch, as the JAX package
  computes them in XLA outside any Pallas kernel.

``sparse_attention`` is not ported yet (ROADMAP.md, queue 1). Each
function casts its floating inputs under AMP by its JAX op name; the
indices and sequence offsets are never cast.
"""
from __future__ import annotations

import math

import torch

from ...amp.auto_cast import cast_inputs
from ...ops.cuda.flashmask import flashmask_value
from .attention import flash_attention

__all__ = ["calc_reduced_attn_scores", "flash_attn_qkvpacked",
           "flash_attn_unpadded", "flash_attn_varlen_qkvpacked",
           "flashmask_attention", "fused_softmax_mask",
           "fused_softmax_mask_upper_triangle"]

NEG_INF = -1e30


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         training=True, generator=None):
    """Packed ``[B, S, 3, H, D]`` QKV flash attention: ``(out, None)``.
    q, k and v are strided views of the pack, so gradients flow back into
    it."""
    return flash_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                           dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training,
                           generator=generator)


def _segments(cu_seqlens, total: int) -> torch.Tensor:
    """The sequence id of each of ``total`` packed tokens from cumulative
    offsets; offsets at or past ``total`` start no sequence, as the JAX
    scatter drops them."""
    starts = torch.bincount(cu_seqlens[1:-1], minlength=total)[:total]
    return starts.cumsum(0)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False, training=True):
    """Varlen attention over packed ``(total_tokens, H, D)`` tensors with
    cumulative sequence offsets: one dense masked attention over all
    tokens, a token seeing only its own sequence (and, when causal, its
    own and earlier positions in it). Returns ``(out, probs [H, Tq, Tk])``
    with ``return_softmax``, else ``(out, None)``. The JAX function takes
    ``dropout`` and ignores it; the port raises on ``dropout > 0`` in
    training instead."""
    if dropout > 0.0 and training:
        raise NotImplementedError(
            "flash_attn_unpadded with dropout is not ported (ROADMAP.md, "
            "queue 1); the JAX function ignores dropout")
    q, k, v = cast_inputs("flash_attn_unpadded", query, key, value)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    cq = torch.as_tensor(cu_seqlens_q, device=q.device).long()
    ck = torch.as_tensor(cu_seqlens_k, device=q.device).long()
    tq, tk = q.shape[0], k.shape[0]
    seg_q = _segments(cq, tq)
    seg_k = _segments(ck, tk)
    same = seg_q[:, None] == seg_k[None, :]
    if causal:
        pos_q = torch.arange(tq, device=q.device) - cq[seg_q]
        pos_k = torch.arange(tk, device=q.device) - ck[seg_k]
        same = same & (pos_q[:, None] >= pos_k[None, :])
    logits = torch.einsum("qhd,khd->hqk", q, k) * sc
    probs = torch.softmax(torch.where(same, logits, NEG_INF), dim=-1)
    out = torch.einsum("hqk,khd->qhd", probs, v)
    return out, (probs if return_softmax else None)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
                                max_seqlen_k, scale=None, dropout=0.0,
                                causal=False, return_softmax=False,
                                training=True):
    """:func:`flash_attn_unpadded` on a packed ``(total_tokens, 3, H, D)``
    tensor."""
    return flash_attn_unpadded(qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens_q,
                               cu_seqlens_k, max_seqlen_q, max_seqlen_k,
                               scale=scale, dropout=dropout, causal=causal,
                               return_softmax=return_softmax,
                               training=training)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=True, window_size=None, *,
                        generator=None):
    """Attention under a column-compressed mask (reference:
    ``paddle.nn.functional.flashmask_attention``).

    ``startend_row_indices`` ``[B, 1 or H, Sk, ncol]`` gives, per key
    column, the query rows it hides: causal takes ``[LTS]`` (rows >= LTS)
    or ``[LTS, LTE]`` (rows in [LTS, LTE)), non-causal ``[LTS, LTE, UTS,
    UTE]`` (rows in either interval); other layouts raise. A fully masked
    row gives 0, as the JAX package's Pallas kernel does. Without indices
    this is ``flash_attention(...)[0]``, with its dropout (from
    ``generator``). ``window_size`` with indices raises, as in the JAX
    package, and so does ``dropout > 0`` with indices: the JAX package
    takes its XLA route there, with a ``jax.random`` stream no port can
    match."""
    if startend_row_indices is None:
        return flash_attention(query, key, value, dropout=dropout,
                               causal=causal, generator=generator)[0]
    if window_size is not None:
        raise NotImplementedError("window_size with startend_row_indices")
    if dropout > 0.0:
        raise NotImplementedError(
            "flashmask_attention with dropout > 0 and startend_row_indices "
            "is not ported yet (ROADMAP.md, queue 1)")
    scale = 1.0 / math.sqrt(query.shape[-1])
    query, key, value = cast_inputs("flashmask_attention", query, key, value)
    return flashmask_value(query, key, value, startend_row_indices, causal,
                           scale, device=query.device)


def calc_reduced_attn_scores(query, key, softmax_lse=None):
    """Attention probabilities averaged over the queries, ``[B, H, Sk]``
    (q, k: ``[B, S, H, D]``). ``softmax_lse`` is accepted and unused, as
    in the JAX function."""
    q, k = cast_inputs("calc_reduced_attn_scores", query, key)
    logits = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(q.shape[-1])
    return torch.softmax(logits, dim=-1).mean(dim=2)


def fused_softmax_mask(x, mask):
    """``softmax(x + mask)`` over the last axis."""
    x, mask = cast_inputs("fused_softmax_mask", x, mask)
    return torch.softmax(x + mask, dim=-1)


def fused_softmax_mask_upper_triangle(x):
    """Softmax over the last axis with the upper triangle (key > query)
    masked."""
    (x,) = cast_inputs("fused_softmax_mask_upper_triangle", x)
    s, t = x.shape[-2], x.shape[-1]
    keep = torch.ones(s, t, dtype=torch.bool, device=x.device).tril()
    return torch.softmax(torch.where(keep, x, NEG_INF), dim=-1)
