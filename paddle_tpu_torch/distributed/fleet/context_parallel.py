"""Context parallelism: ring attention and Ulysses attention over the
``sep`` axis (port of ``paddle_tpu/distributed/fleet/context_parallel.py``).

Layout ``[batch, seq, heads, head_dim]``; each ``sep`` rank holds its
contiguous part of the sequence (rank ``r`` the positions ``r·S/n`` to
``(r+1)·S/n − 1``), and the result is cut the same way.

- :func:`ring_attention`. The JAX package writes an online-softmax
  blockwise attention in jnp, K/V moving with ``ppermute``
  (``context_parallel.py:38-80``). The port computes the same function
  with the attention kernels. At step ``t`` each rank runs K1
  (``flash_attention_fwd``, which returns ``(o, lse)``) on its q against
  the K/V block the ring holds, block ``(r − t) mod n``: the diagonal block
  causal (top-left, which matches because the parts are aligned), the
  earlier blocks whole; a block of later positions is fully masked and
  launches nothing (JAX computes it and masks it to zero: the same
  output). The blocks merge by their lse in f32 (``o = Σ exp(lse_j −
  lse)·o_j``), and the result is cast once to q's dtype, as JAX's f32
  accumulator is. K/V move with a point-to-point ring shift. The backward
  rotates K/V again (as JAX's checkpointed step recomputes) and runs K2/K3
  (``flash_attention_bwd``) on each live block with the merged ``o`` and
  ``lse`` (Δ = rowsum(dO∘O) needs the merged O): dQ accumulates in f32 on
  its rank, and the f32 dK/dV partials travel the ring with their block,
  one more shift bringing them home. Under a causal mask rank ``r`` runs
  ``r + 1`` blocks: the last rank does ``n``.
- :func:`ulysses_attention`: two all-to-alls (sequence ↔ heads) around
  ``FlashAttentionFunction`` (K1–K3), which needs ``num_heads`` divisible
  by the ``sep`` degree, as JAX does. Its dropout (divergence) uses K1's
  hash with a seed drawn from the RNG tracker's ``model_parallel_rng``
  and folded with the ``sep`` rank, so each head group draws its own
  masks; JAX's ``_xla_attention`` draws from ``jax.random``, which the port
  cannot match.

On the CPU both run the kernels' plain versions. Over one rank each is
plain attention through the same kernels.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from ...amp.auto_cast import cast_inputs
from ...core.tensor import plain, wrap
from ...ops.cuda import flash_attention as fa
from .. import communication as comm
from . import mpu

__all__ = ["ring_attention", "ulysses_attention", "ring_blocks"]

SEP_AXIS = "sep"


def ring_blocks(rank: int, n: int, causal: bool) -> list:
    """The K/V blocks rank ``rank`` of ``n`` attends to, in ring order
    (step ``t`` holds block ``(rank − t) mod n``), each as ``(step, block,
    causal)``; under a causal mask the later blocks are left out."""
    out = []
    for t in range(n):
        j = (rank - t) % n
        if causal and j > rank:
            continue
        out.append((t, j, causal and j == rank))
    return out


def _shift(x: torch.Tensor, c) -> torch.Tensor:
    """``x`` to the next rank of the ring, the previous rank's in."""
    return comm._exchange(x, (c.me + 1) % c.n, (c.me - 1) % c.n, c)


def _merge(o_acc, lse_acc, o, lse):
    """Two partial attentions over disjoint keys merged by their lse, in
    f32: ``o`` ``[B, S, H, D]``, ``lse`` ``[B, H, 1, S]``."""
    o = o.float()
    if o_acc is None:
        return o, lse
    new = torch.logaddexp(lse_acc, lse)

    def weight(part):
        return torch.exp(part - new)[:, :, 0].transpose(1, 2)[..., None]

    return o_acc * weight(lse_acc) + o * weight(lse), new


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, c):
        dev = q.device
        o_acc = lse = None
        k_t, v_t = k, v
        live = {t: blk for t, *blk in ring_blocks(c.me, c.n, causal)}
        for t in range(c.n):
            if t in live:
                o_j, lse_j = fa.flash_attention_fwd(
                    q, k_t, v_t, live[t][1], scale, device=dev)
                o_acc, lse = _merge(o_acc, lse, o_j, lse_j)
            if t + 1 < c.n:
                k_t, v_t = _shift(k_t, c), _shift(v_t, c)
        o = o_acc.to(q.dtype)
        lse = lse.contiguous()
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, scale, c)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, scale, c = ctx.args
        do = do.contiguous()
        live = {t: blk for t, *blk in ring_blocks(c.me, c.n, causal)}
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_t, v_t = k, v
        for t in range(c.n):
            if t in live:
                dq_j, dk_j, dv_j = fa.flash_attention_bwd(
                    q, k_t, v_t, o, lse, do, None, live[t][1], scale,
                    device=q.device)
                dq += dq_j.float()
                dk += dk_j.float()
                dv += dv_j.float()
            if t + 1 < c.n:
                k_t, v_t = _shift(k_t, c), _shift(v_t, c)
                dk, dv = _shift(dk, c), _shift(dv, c)
        if c.n > 1:
            # rank r ends holding block (r + 1)'s sums: one more step home
            dk, dv = _shift(dk, c), _shift(dv, c)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def _check_seq(q, k, v):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [batch, seq, heads, head_dim] "
                         f"of one shape, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def ring_attention(q, k, v, causal=True, axis=SEP_AXIS):
    """Ring attention over the ``axis`` group: ``q``, ``k``, ``v`` are
    this rank's ``[B, S/n, H, D]`` parts of the sequence; returns this
    rank's part of the exact attention output. Under AMP it computes in
    the AMP dtype (op ``flash_attention``)."""
    c = mpu.group_comm(axis)
    q, k, v = cast_inputs("flash_attention", plain(q), plain(k), plain(v))
    _check_seq(q, k, v)
    scale = 1.0 / math.sqrt(q.shape[-1])
    if c.n == 1:
        return wrap(fa.flash_attention_value(q, k, v, causal, scale,
                                             device=q.device))
    return wrap(_RingAttention.apply(q, k, v, bool(causal), scale, c))


def _seq_to_heads(x: torch.Tensor, c) -> torch.Tensor:
    """``[B, S/n, H, D]`` → ``[B, S, H/n, D]``: head group ``j`` to rank
    ``j``, the sequence parts from every rank concatenated."""
    b, s, h, d = x.shape
    parts = x.reshape(b, s, c.n, h // c.n, d).permute(2, 0, 1, 3, 4)
    got = comm._AllToAll.apply(parts.contiguous(), c)
    return got.permute(1, 0, 2, 3, 4).reshape(b, c.n * s, h // c.n, d)


def _heads_to_seq(x: torch.Tensor, c) -> torch.Tensor:
    """The inverse of :func:`_seq_to_heads`."""
    b, s_all, hl, d = x.shape
    s = s_all // c.n
    parts = x.reshape(b, c.n, s, hl, d).permute(1, 0, 2, 3, 4)
    got = comm._AllToAll.apply(parts.contiguous(), c)
    return got.permute(1, 2, 0, 3, 4).reshape(b, s, c.n * hl, d)


def ulysses_attention(q, k, v, causal=True, axis=SEP_AXIS, dropout=0.0, *,
                      generator: Optional[torch.Generator] = None):
    """Ulysses attention over the ``axis`` group: all-to-all from sequence
    parts to head groups, attention over the whole sequence on the local
    heads (K1–K3), all-to-all back. ``num_heads`` must be divisible by the
    group's size. ``dropout`` draws its seed from ``generator``, by
    default the tracker's ``model_parallel_rng`` on the tensors' device,
    and folds this rank's ``axis`` coordinate into it."""
    c = mpu.group_comm(axis)
    q, k, v = cast_inputs("flash_attention", plain(q), plain(k), plain(v))
    _check_seq(q, k, v)
    if c.n > 1 and q.shape[2] % c.n:
        raise ValueError(f"num_heads {q.shape[2]} not divisible by "
                         f"{axis}={c.n}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    seed = None
    if dropout > 0.0:
        gen = generator if generator is not None else \
            mpu.get_rng_state_tracker().generator(device=q.device)
        # the tracker is seeded per mp rank, so the sep ranks draw alike:
        # each folds its coordinate in, or K1's hash, which sees the local
        # head index, would give head h on every rank the same mask
        seed = torch.randint(0, (2**31 - 1) // c.n, (1,), generator=gen,
                             device=q.device, dtype=torch.int32)
        if c.n > 1:
            seed = seed * c.n + c.me
    if c.n == 1:
        return wrap(fa.flash_attention_value(q, k, v, causal, scale,
                                             dropout, seed, device=q.device))
    qh, kh, vh = (_seq_to_heads(t, c) for t in (q, k, v))
    out = fa.flash_attention_value(qh, kh, vh, causal, scale, dropout, seed,
                                   device=q.device)
    return wrap(_heads_to_seq(out, c))
