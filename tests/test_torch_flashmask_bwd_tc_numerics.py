"""The numerics of the tensor-core K6 and K7 (FlashMask backward, bfloat16),
emulated on the CPU.

``csrc/flashmask_dq_sm90.cu`` (K6) and ``csrc/flashmask_dkv_sm90.cu``
(K7) take bf16 operands into wgmma with f32 sums, recompute
P = 2^(S·scale·log2 e − lse·log2 e) per tile, select it to 0 where the
column-interval mask hides the pair (a row that sees no key has
lse ≈ −1e30, where P would be inf), and form dS = P∘(dP − Δ). Where the
Pallas kernels and the plain version keep P and dS in f32, K6 gives dS to
dS·K, and K7 gives Pᵀ to Pᵀ·dO and dSᵀ to dSᵀ·Q, as two bf16 parts each,
hi + lo, one product per part. This file emulates exactly that in plain
torch and holds it, in f32 before the outputs' own rounding, against the
Pallas backward in interpret mode (``_fm_bwd(..., interpret=True)``, fed
the Pallas forward's o rounded to bf16 and its lse) and the port's plain
version over the documented index layouts of
``tests/test_torch_flashmask_tc_numerics.py``: dq, dk and dv at least 4x
inside ``chip_smoke.py``'s bf16 gate (2e-2 plus 1e-2 of the value), dQ
exactly 0 on fully masked rows, every output finite. It also shows why
the parts are two: rounded once to bf16, as K2 rounds dS, each of dq, dk
and dv leaves the 4x margin on some of these layouts. The Pallas backward
takes any Sq and Sk (``_fm_blocks`` halves its 256/512 blocks until they
divide them), so the layouts' lengths (96 to 200) need no rounding up.
Last, K7's list of live q tiles, restated over its 128-key blocks and
64-row q tiles, drops no allowed pair.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flashmask import _fm_bwd, _fm_fwd
from paddle_tpu_torch.ops.cuda import flashmask as fm
from tests.test_torch_flashmask_tc_numerics import (_first_allowed,
                                                    _intervals, _layouts)

# chip_smoke.py's bf16 gate on K6 and K7, and the margin this design must
# keep
BWD_ATOL, BWD_RTOL = 2e-2, 1e-2
MARGIN = 4.0
BLOCK_K = 128  # keys per K7 block
TILE_Q = 64    # q rows per K7 Q/dO tile
LOG2E = 1.4426950408889634


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _hi_lo(x):
    """x as the sum of two bf16 values: x rounded, plus what it left out,
    rounded."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def _inputs(b, sq, sk, h, d, seed):
    """q, k, v, dO as f32 tensors of bf16-representable values."""
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
            .to(torch.bfloat16).float() for n in (sq, sk, sk, sq)]


def emulate_fm_bwd(q, k, v, o, lse, do, idx, causal, scale, split=True):
    """K6 and K7 on the tensor cores: P from exp2, selected to 0 where
    hidden; dS = P∘(dP − Δ); dS (K6), Pᵀ and dSᵀ (K7) in two bf16 parts
    (``split``; else rounded once) before their products, f32 sums.
    Returns f32 ``(dq, dk, dv)``."""
    parts = _hi_lo if split else _bf16
    hide = fm.disallowed(idx, q.shape[1], k.shape[1], causal)
    s = torch.einsum("bshd,bthd->bhst", q, k) * (scale * LOG2E)
    p = torch.where(hide, 0.0,
                    torch.exp2(s - lse.transpose(-1, -2) * LOG2E))
    dp = torch.einsum("bshd,bthd->bhst", do, v)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = parts(p * (dp - delta))
    dq = torch.einsum("bhst,bthd->bshd", ds, k) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q) * scale
    dv = torch.einsum("bhst,bshd->bthd", parts(p), do)
    return dq, dk, dv


@functools.lru_cache(maxsize=None)
def _case(i):
    """Layout i's inputs, the Pallas forward's (o in bf16, lse), the
    Pallas backward in interpret mode and the plain version's gradients."""
    name, b, sq, sk, h, d, causal, idx = _layouts()[i]
    q, k, v, do = _inputs(b, sq, sk, h, d, 40 + i)
    scale = 1.0 / math.sqrt(d)
    jidx = jnp.asarray(idx)
    o_pl, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           jidx, causal, scale, interpret=True)
    o = _bf16(torch.from_numpy(np.array(o_pl)))
    lse = torch.from_numpy(np.array(lse_pl))
    pallas = _fm_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jidx,
                     jnp.asarray(o.numpy()), jnp.asarray(lse.numpy()),
                     jnp.asarray(do.numpy()), causal, scale, interpret=True)
    tidx = torch.from_numpy(idx)
    plain = fm.flashmask_bwd(q, k, v, o, lse, do, tidx, causal, scale,
                             device="cpu")
    return (name, causal, scale, tidx, (q, k, v, o, lse, do),
            [np.array(g) for g in pallas], [g.numpy() for g in plain])


def _share(got, want):
    """The worst error as a share of the bf16 gate."""
    return float((np.abs(got - want) / (BWD_ATOL + BWD_RTOL * np.abs(want)))
                 .max())


def _worst_single_rounding(which):
    """The worst share of the gate that one bf16 rounding leaves in output
    ``which`` (0 dq, 1 dk, 2 dv) against the plain version, over the
    layouts and eight input seeds each."""
    worst = 0.0
    for seed in range(8):
        for i, (_, b, sq, sk, h, d, causal, idx) in enumerate(_layouts()):
            q, k, v, do = _inputs(b, sq, sk, h, d, 100 * seed + i)
            scale = 1.0 / math.sqrt(d)
            tidx = torch.from_numpy(idx)
            o, lse = fm.flashmask_fwd(q, k, v, tidx, causal, scale,
                                      device="cpu")
            o = _bf16(o)
            want = fm.flashmask_bwd(q, k, v, o, lse, do, tidx, causal, scale,
                                    device="cpu")[which]
            got = emulate_fm_bwd(q, k, v, o, lse, do, tidx, causal, scale,
                                 split=False)[which]
            worst = max(worst, _share(got.numpy(), want.numpy()))
    return worst


def _check_outputs(which):
    for i in range(len(_layouts())):
        name, causal, scale, tidx, data, pallas, plain = _case(i)
        got = emulate_fm_bwd(*data, tidx, causal, scale)
        for out in which:
            g = got[out].numpy()
            assert np.isfinite(g).all(), (name, out)
            for label, want in (("pallas", pallas[out]), ("plain",
                                                          plain[out])):
                share = _share(g, want)
                assert share <= 1.0 / MARGIN, (name, out, label, share)
            # the rounding is there to be seen: not the f32 result bit for
            # bit
            assert float(np.abs(plain[out]).max()) > 0, (name, out)
            assert not np.array_equal(g, plain[out]), (name, out)


def test_dq_rounding_sits_4x_inside_the_gate():
    _check_outputs((0,))
    # why K6 splits dS: rounded once, dq leaves the 4x margin
    assert _worst_single_rounding(0) > 1.0 / MARGIN


def test_dkv_rounding_sits_4x_inside_the_gate():
    _check_outputs((1, 2))
    # why K7 splits Pᵀ and dSᵀ: rounded once, dk and dv leave the 4x margin
    assert _worst_single_rounding(1) > 1.0 / MARGIN
    assert _worst_single_rounding(2) > 1.0 / MARGIN


def test_fully_masked_rows_give_exactly_zero_dq():
    """Rows no key is allowed for have lse ≈ −1e30, where 2^(s − lse) is
    inf: P is selected to 0 there, so dQ is exactly 0, as the Pallas
    kernel gives, and no output holds a NaN or an inf."""
    i = 2  # "fully masked rows, Hm=H": rows 70..79 see no key
    name, causal, scale, tidx, data, pallas, _ = _case(i)
    q, k = data[0], data[1]
    dead = fm.disallowed(tidx, q.shape[1], k.shape[1], causal).all(-1) \
        .transpose(1, 2)
    assert bool(dead[0, 70:80].all()) and int(dead.sum()) >= 20, name
    assert bool((data[4].squeeze(2).transpose(1, 2)[dead] <= -1e29).all())
    dq, dk, dv = emulate_fm_bwd(*data, tidx, causal, scale)
    assert torch.equal(dq[dead], torch.zeros_like(dq[dead]))
    assert np.array_equal(pallas[0][dead.numpy()],
                          np.zeros_like(pallas[0][dead.numpy()]))
    assert all(bool(torch.isfinite(g).all()) for g in (dq, dk, dv))


def test_the_q_tile_list_drops_no_allowed_pair():
    """Over each 128-key block, a 64-row q tile from the causal first one
    that K7 leaves off its list (no column of the block lets a tile row
    through) holds no allowed pair, and a listed tile it marks whole (no
    column's intervals meet the tile rows) hides nothing but the causal
    diagonal. Packed documents let the list save tiles."""
    for name, b, sq, sk, h, d, causal, idx in _layouts():
        hide = fm.disallowed(torch.from_numpy(idx), sq, sk, causal).numpy()
        diag = (np.arange(sq)[:, None] < np.arange(sk)[None, :]) & causal
        skipped = 0
        n_qt = -(-sq // TILE_Q)
        for bi in range(b):
            for hi in range(idx.shape[1]):
                for k0 in range(0, sk, BLOCK_K):
                    cols = range(k0, min(k0 + BLOCK_K, sk))
                    ivs = [_intervals(idx[bi, hi, c], idx.shape[-1])
                           for c in cols]
                    qt0 = min(k0 // TILE_Q, n_qt) if causal else 0
                    for t in range(qt0, n_qt):
                        q0 = t * TILE_Q
                        q_last = min(q0 + TILE_Q, sq) - 1
                        live = any(_first_allowed(iv, c, q0, causal) <= q_last
                                   for iv, c in zip(ivs, cols))
                        meets = any(s0 < e0 and s0 <= q_last and e0 > q0
                                    for iv in ivs
                                    for s0, e0 in (iv[:2], iv[2:]))
                        block = hide[bi, hi, q0:q_last + 1,
                                     k0:k0 + BLOCK_K]
                        if not live:
                            skipped += 1
                            assert block.all(), (name, bi, hi, k0, t)
                        if not meets:
                            assert np.array_equal(
                                block, diag[q0:q_last + 1, k0:k0 + BLOCK_K]), (
                                name, bi, hi, k0, t)
                    # causal: the q tiles before the first hold no allowed
                    # pair with the block's keys
                    assert hide[bi, hi, :qt0 * TILE_Q, k0:k0 + BLOCK_K].all()
        if name.startswith("documents"):
            assert skipped > 0, name
