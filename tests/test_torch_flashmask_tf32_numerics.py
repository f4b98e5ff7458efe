"""The numerics of the float32 K7 (FlashMask dK/dV) on the tensor cores
(3xTF32), emulated on the CPU.

``csrc/flashmask_dkv_tf32.cu`` runs every product a·b of float32 operands
as three TF32 products, a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, summed in f32
(``tests/test_torch_flash_tf32_numerics.py`` pins the TF32 rounding):
Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, then Pᵀ·dO and dSᵀ·Q per q tile (32 rows, 16 at
D = 128), each tile's sum added to dV and dK in f32, with Qᵀ and dOᵀ in
the kernel's q order. P = 2^(S·scale·log2 e − lse·log2 e) is selected to
0 where the column-interval mask hides the pair: a row that sees no key
has lse ≈ −1e30, where 2^(s − lse) is inf. This file emulates exactly that
in plain torch and holds dk and dv against the Pallas backward in
interpret mode (``_fm_bwd(..., interpret=True)``, fed the Pallas forward's
o and lse) and the port's plain version over the documented index layouts
of ``tests/test_torch_flashmask_tc_numerics.py``: at least 4x inside
``chip_smoke.py``'s f32 gate (1e-4), with the single-TF32 emulation's
error printed beside. It holds the kernel's list of live q tiles,
restated over its blocks (128 keys and 32-row q tiles at D <= 64, 64 keys
and 16-row tiles at D = 128), to dropping no allowed pair, and hidden
pairs and keys that no query sees to exactly 0.
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flashmask import _fm_bwd, _fm_fwd
from paddle_tpu_torch.ops.cuda import flashmask as fm
from tests.test_torch_flash_tf32_numerics import LOG2E, _q_order, product
from tests.test_torch_flashmask_tc_numerics import (_first_allowed,
                                                    _intervals, _layouts)

# chip_smoke.py's f32 gate on K7 (absolute), and the margin this design
# must keep
GATE = 1e-4
MARGIN = 4.0
# (keys per block, q rows per tile) of the kernel at D <= 64 and D = 128
GEOMETRIES = {64: (128, 32), 128: (64, 16)}


def _geometry(d):
    return GEOMETRIES[64 if d <= 64 else 128]


def _p_ds(q, k, v, o, lse, do, idx, causal, scale, single=False):
    """Pᵀ and dSᵀ as K7 forms them, ``[B, H, Sq, Sk]``: S and dP in 3xTF32
    (or ``single``), P from exp2 selected to 0 where hidden,
    dS = P∘(dP − Δ)."""
    hide = fm.disallowed(idx, q.shape[1], k.shape[1], causal)
    s = product("bshd,bthd->bhst", q, k, single) * (scale * LOG2E)
    p = torch.where(hide, 0.0,
                    torch.exp2(s - lse.transpose(-1, -2) * LOG2E))
    dp = product("bshd,bthd->bhst", do, v, single)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    return p, p * (dp - delta)


def emulate_fm_dkv(q, k, v, o, lse, do, idx, causal, scale, single=False):
    """f32 K7: per q tile, Pᵀ and dSᵀ against dO and Q in 3xTF32 over the
    tile's rows in the kernel's q order, each tile's sum added in f32.
    Returns f32 ``(dk, dv)``."""
    b, sq, h, d = q.shape
    p, ds = _p_ds(q, k, v, o, lse, do, idx, causal, scale, single)
    tile = _geometry(d)[1]
    dk = torch.zeros_like(k)
    dv = torch.zeros_like(v)
    for q0 in range(0, sq, tile):
        rows = q0 + _q_order(min(tile, sq - q0))
        dv += product("bhst,bshd->bthd", p[:, :, rows], do[:, rows], single)
        dk += product("bhst,bshd->bthd", ds[:, :, rows], q[:, rows], single)
    return dk * scale, dv


@functools.lru_cache(maxsize=None)
def _case(i):
    """Layout i's f32 inputs, the Pallas forward's (o, lse), and dk, dv
    from the Pallas backward in interpret mode and the plain version."""
    name, b, sq, sk, h, d, causal, idx = _layouts()[i]
    rs = np.random.RandomState(60 + i)
    q, k, v, do = (torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
                   for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    jidx = jnp.asarray(idx)
    o_pl, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           jidx, causal, scale, interpret=True)
    o = torch.from_numpy(np.array(o_pl))
    lse = torch.from_numpy(np.array(lse_pl))
    pallas = _fm_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jidx,
                     o_pl, lse_pl, jnp.asarray(do.numpy()), causal, scale,
                     interpret=True)
    tidx = torch.from_numpy(idx)
    plain = fm.flashmask_bwd(q, k, v, o, lse, do, tidx, causal, scale,
                             device="cpu")
    return (name, (q, k, v, o, lse, do, tidx, causal, scale),
            [np.array(g) for g in pallas[1:]], [g.numpy() for g in plain[1:]])


def test_dkv_3xtf32_sits_4x_inside_the_gate():
    worst, worst_single = 0.0, 0.0
    for i in range(len(_layouts())):
        name, args, pallas, plain = _case(i)
        got = emulate_fm_dkv(*args)
        got1 = emulate_fm_dkv(*args, single=True)
        for out, g, g1, want_pl, want in zip(("dk", "dv"), got, got1, pallas,
                                             plain):
            g, g1 = g.numpy(), g1.numpy()
            assert np.isfinite(g).all(), (name, out)
            for label, ref in (("pallas", want_pl), ("plain", want)):
                share = float(np.abs(g - ref).max()) / GATE
                assert share <= 1.0 / MARGIN, (name, out, label, share)
                worst = max(worst, share)
                worst_single = max(worst_single,
                                   float(np.abs(g1 - ref).max()) / GATE)
            # the rounding is there to be seen: not the f32 result bit for
            # bit
            assert float(np.abs(want).max()) > 0, (name, out)
            assert not np.array_equal(g, want), (name, out)
    print(f"K7 dk and dv, worst share of the 1e-4 gate: 3xTF32 "
          f"{worst:.3f}, one TF32 product {worst_single:.3f}")
    # why three products: one would leave the f32 gate itself
    assert worst_single > 1.0, worst_single


def test_the_f32_q_tile_list_drops_no_allowed_pair():
    """At both of the kernel's geometries, over each block of keys, a q
    tile from the causal first one that the list leaves out (no column of
    the block lets a tile row through) holds no allowed pair, and a listed
    tile it marks whole (no column's intervals meet the tile rows) hides
    nothing but the causal diagonal. Packed documents let the list save
    tiles."""
    for block_k, tile_q in GEOMETRIES.values():
        for name, b, sq, sk, h, d, causal, idx in _layouts():
            hide = fm.disallowed(torch.from_numpy(idx), sq, sk,
                                 causal).numpy()
            diag = (np.arange(sq)[:, None] < np.arange(sk)[None, :]) & causal
            skipped = 0
            n_qt = -(-sq // tile_q)
            for bi in range(b):
                for hi in range(idx.shape[1]):
                    for k0 in range(0, sk, block_k):
                        cols = range(k0, min(k0 + block_k, sk))
                        ivs = [_intervals(idx[bi, hi, c], idx.shape[-1])
                               for c in cols]
                        qt0 = min(k0 // tile_q, n_qt) if causal else 0
                        for t in range(qt0, n_qt):
                            q0 = t * tile_q
                            q_last = min(q0 + tile_q, sq) - 1
                            live = any(
                                _first_allowed(iv, c, q0, causal) <= q_last
                                for iv, c in zip(ivs, cols))
                            meets = any(s0 < e0 and s0 <= q_last and e0 > q0
                                        for iv in ivs
                                        for s0, e0 in (iv[:2], iv[2:]))
                            block = hide[bi, hi, q0:q_last + 1,
                                         k0:k0 + block_k]
                            if not live:
                                skipped += 1
                                assert block.all(), (name, bi, hi, k0, t)
                            if not meets:
                                assert np.array_equal(
                                    block,
                                    diag[q0:q_last + 1, k0:k0 + block_k]), (
                                    name, bi, hi, k0, t)
                        # causal: the q tiles before the first hold no
                        # allowed pair with the block's keys
                        assert hide[bi, hi, :qt0 * tile_q,
                                    k0:k0 + block_k].all()
            if name.startswith("documents"):
                assert skipped > 0, (name, block_k, tile_q)


def test_hidden_pairs_and_unseen_keys_give_exactly_zero():
    """Pᵀ and dSᵀ are exactly 0 at every hidden pair, also on rows that see
    no key (lse ≈ −1e30, where 2^(s − lse) is inf), and every value is
    finite; keys no query sees get dK = dV = 0 exactly, as the Pallas
    backward gives."""
    name, args, _, _ = _case(2)  # "fully masked rows, Hm=H": rows 70..79
    q, k, v, o, lse, do, tidx, causal, scale = args
    hide = fm.disallowed(tidx, q.shape[1], k.shape[1], causal).expand(
        -1, q.shape[2], -1, -1)
    dead = hide.all(-1)
    assert bool(dead[0, :, 70:80].all()), name
    assert bool((lse.squeeze(2)[dead] <= -1e29).all()), name
    p, ds = _p_ds(*args)
    for t in (p, ds):
        assert bool(torch.isfinite(t).all()), name
        assert torch.equal(t[hide], torch.zeros_like(t[hide])), name
    assert all(bool(torch.isfinite(g).all()) for g in emulate_fm_dkv(*args))
    # bidirectional documents, Sq != Sk, with the last ten keys hidden from
    # every row
    sq, sk, h, d = 96, 160, 2, 64
    idx = np.empty((1, 1, sk, 4), np.int32)
    for (k0, k1), (q0, q1) in zip(((0, 70), (70, sk)), ((0, 40), (40, sq))):
        idx[:, :, k0:k1] = (q1, sq, 0, q0)
    idx[:, :, 150:] = (0, sq, 0, 0)
    rs = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rs.randn(1, n, h, d).astype(np.float32))
                   for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    o_pl, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           jnp.asarray(idx), False, scale, interpret=True)
    o = torch.from_numpy(np.array(o_pl))
    lse = torch.from_numpy(np.array(lse_pl))
    dk, dv = emulate_fm_dkv(q, k, v, o, lse, do, torch.from_numpy(idx),
                            False, scale)
    _, dk_pl, dv_pl = _fm_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                              jnp.asarray(idx), o_pl, lse_pl,
                              jnp.asarray(do.numpy()), False, scale,
                              interpret=True)
    for got in (dk, dv, torch.from_numpy(np.array(dk_pl)),
                torch.from_numpy(np.array(dv_pl))):
        assert torch.equal(got[:, 150:], torch.zeros_like(got[:, 150:]))
        assert float(got[:, :150].abs().max()) > 0
