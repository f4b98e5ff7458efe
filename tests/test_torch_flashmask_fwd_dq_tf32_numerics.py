"""The numerics of the float32 K5 (FlashMask forward) and K6 (FlashMask dQ)
on the tensor cores (3xTF32), emulated on the CPU.

``csrc/flashmask_fwd_tf32.cu`` and ``csrc/flashmask_dq_tf32.cu`` run every
product a·b of float32 operands as three TF32 products, a_lo·b_hi +
a_hi·b_lo + a_hi·b_hi, summed in f32 (``tests/test_torch_flash_tf32_
numerics.py`` pins the TF32 rounding). K5 computes S = Q·Kᵀ, selects the
scores the column-interval mask hides to -inf before the row max, runs the
online softmax in exp2 over its key tiles (64 keys at D <= 64, 32 at
D = 128; a tile that raises no row max leaves the row as it was), splits P
into hi and lo for P·V, sums each tile's P·V from 0 and adds it to O in
f32 (O = O·alpha + the tile's sum). K6 computes S and dP = dO·Vᵀ,
P = 2^(S·scale·log2 e − lse·log2 e) selected to 0 where hidden (a row
that sees no key has lse ≈ −1e30, where 2^(s − lse) is inf),
dS = P∘(dP − Δ), and sums each 32-key tile's dS·K from 0 before adding it
to dQ in f32. This file emulates exactly that in plain torch and holds O,
lse and dq against the Pallas kernels in interpret mode
(``_fm_fwd(..., interpret=True)``, ``_fm_bwd(..., interpret=True)`` fed
the Pallas forward's o and lse) and the port's plain versions over the
documented index layouts of ``tests/test_torch_flashmask_tc_numerics.py``:
at least 4x inside ``chip_smoke.py``'s f32 gate (1e-4), with the
single-TF32 emulation's error printed beside. It holds the kernels' lists
of live k tiles, restated over their blocks (K5: 128 rows by 64 or 32
keys; K6: 128 or 64 rows by 32 keys), to dropping no allowed pair, and
fully masked rows to O = dQ = 0 exactly.
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

# chip_smoke.py's f32 gates on K5 (O, lse) and K6 (dq), absolute, and the
# margin this design must keep
GATE = 1e-4
MARGIN = 4.0
# (q rows per block, keys per k tile) of each kernel: K5 at D <= 64 and at
# D = 128, K6 at D <= 64 and at D = 128
GEOMETRIES = {"K5": {64: (128, 64), 128: (128, 32)},
              "K6": {64: (128, 32), 128: (64, 32)}}


def _geometry(kernel, d):
    return GEOMETRIES[kernel][64 if d <= 64 else 128]


def emulate_fm_fwd(q, k, v, idx, causal, scale, single=False):
    """f32 K5: S in 3xTF32 (or ``single``), hidden scores selected to -inf,
    the online softmax in exp2 over the kernel's key tiles, each tile's P·V
    in 3xTF32 summed from 0, then O = O·alpha + the tile's sum. Returns
    ``o [B, Sq, H, D]`` and ``lse [B, H, 1, Sq]``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tile = _geometry("K5", d)[1]
    hide = fm.disallowed(idx, sq, sk, causal)
    s = torch.where(hide, -math.inf, product("bshd,bthd->bhst", q, k, single))
    sl = scale * LOG2E
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    vt = v.transpose(1, 2)
    for k0 in range(0, sk, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.where(m_new == m, 1.0, torch.exp2((m - m_new) * sl))
        p = torch.exp2(st * sl - torch.where(m_new == -math.inf, 0.0,
                                             m_new * sl))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + product("bhst,bhtd->bhsd", p,
                                    vt[:, :, k0:k0 + tile], single)
        m = m_new
    den = l.clamp_min(1e-30)
    lse = torch.where(m == -math.inf, -1e30, m * scale) + torch.log(den)
    return (acc / den).transpose(1, 2), lse.transpose(-1, -2)


def emulate_fm_dq(q, k, v, o, lse, do, idx, causal, scale, single=False):
    """f32 K6: S and dP in 3xTF32 (or ``single``), P from exp2 selected to
    0 where hidden, dS = P∘(dP − Δ); per 32-key tile dS·K in 3xTF32 over
    the tile's keys in the order of the kernel's Kᵀ, the tile's sum added
    in f32. Returns f32 ``dq``."""
    sk = k.shape[1]
    hide = fm.disallowed(idx, q.shape[1], sk, causal)
    s = product("bshd,bthd->bhst", q, k, single) * (scale * LOG2E)
    p = torch.where(hide, 0.0,
                    torch.exp2(s - lse.transpose(-1, -2) * LOG2E))
    dp = product("bshd,bthd->bhst", do, v, single)
    ds = p * (dp - (do * o).sum(-1).transpose(1, 2)[..., None])
    tile = _geometry("K6", q.shape[-1])[1]
    dq = torch.zeros_like(q)
    for k0 in range(0, sk, tile):
        keys = k0 + _q_order(min(tile, sk - k0))
        dq += product("bhst,bthd->bshd", ds[..., keys], k[:, keys], single)
    return dq * scale


@functools.lru_cache(maxsize=None)
def _case(i):
    """Layout i's f32 inputs; O, lse and dq from the Pallas kernels in
    interpret mode (the backward from the Pallas forward's o and lse) and
    from the plain versions."""
    name, b, sq, sk, h, d, causal, idx = _layouts()[i]
    rs = np.random.RandomState(80 + i)
    q, k, v, do = (torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
                   for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    jidx = jnp.asarray(idx)
    o_pl, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                           jidx, causal, scale, interpret=True)
    o = torch.from_numpy(np.array(o_pl))
    lse = torch.from_numpy(np.array(lse_pl))
    dq_pl = _fm_bwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)), jidx,
                    o_pl, lse_pl, jnp.asarray(do.numpy()), causal, scale,
                    interpret=True)[0]
    tidx = torch.from_numpy(idx)
    o_ref, lse_ref = fm.flashmask_fwd(q, k, v, tidx, causal, scale,
                                      device="cpu")
    dq_ref = fm.flashmask_bwd(q, k, v, o, lse, do, tidx, causal, scale,
                              device="cpu")[0]
    return (name, (q, k, v, o, lse, do, tidx, causal, scale),
            {"o": o.numpy(), "lse": lse.numpy(), "dq": np.array(dq_pl)},
            {"o": o_ref.numpy(), "lse": lse_ref.numpy(), "dq": dq_ref.numpy()})


def _emulate(args, single=False):
    q, k, v, o, lse, do, tidx, causal, scale = args
    o_k, lse_k = emulate_fm_fwd(q, k, v, tidx, causal, scale, single)
    return {"o": o_k, "lse": lse_k,
            "dq": emulate_fm_dq(q, k, v, o, lse, do, tidx, causal, scale,
                                single)}


def test_fwd_and_dq_3xtf32_sit_4x_inside_the_gate():
    worst, worst_single = {}, {}
    for i in range(len(_layouts())):
        name, args, pallas, plain = _case(i)
        got, got1 = _emulate(args), _emulate(args, single=True)
        for out in ("o", "lse", "dq"):
            g, g1 = got[out].numpy(), got1[out].numpy()
            assert np.isfinite(g).all(), (name, out)
            for label, want in (("pallas", pallas[out]),
                                ("plain", plain[out])):
                share = float(np.abs(g - want).max()) / GATE
                assert share <= 1.0 / MARGIN, (name, out, label, share)
                worst[out] = max(worst.get(out, 0.0), share)
                worst_single[out] = max(worst_single.get(out, 0.0),
                                        float(np.abs(g1 - want).max()) / GATE)
            # the rounding is there to be seen: not the f32 result bit for
            # bit
            assert not np.array_equal(g, plain[out]), (name, out)
    print("f32 K5/K6, worst share of the 1e-4 gate, 3xTF32 (one TF32 "
          "product): " + ", ".join(f"{n} {worst[n]:.3f} ({worst_single[n]:.3f})"
                                   for n in worst))
    # why three products: one would leave the f32 gate itself
    assert worst_single["o"] > 1.0 and worst_single["dq"] > 1.0, worst_single


def test_the_live_k_tile_lists_drop_no_allowed_pair():
    """At each of the two kernels' geometries, over each block of q rows, a
    k tile within the causal bound that the list leaves out (no column lets
    a block row through) holds no allowed pair, a listed tile it marks
    whole (no column's intervals meet the block rows) hides nothing but
    the causal diagonal, and the tiles past the causal bound hold no
    allowed pair. Packed documents let the lists save tiles."""
    geometries = {g for kernel in GEOMETRIES.values() for g in kernel.values()}
    for block_q, tile_k in sorted(geometries):
        for name, b, sq, sk, h, d, causal, idx in _layouts():
            hide = fm.disallowed(torch.from_numpy(idx), sq, sk,
                                 causal).numpy()
            diag = (np.arange(sq)[:, None] < np.arange(sk)[None, :]) & causal
            skipped = 0
            for bi in range(b):
                for hi in range(idx.shape[1]):
                    for q0 in range(0, sq, block_q):
                        q_last = min(q0 + block_q, sq) - 1
                        n_kt = -(-sk // tile_k)
                        if causal:
                            n_kt = min(n_kt, (q0 + block_q - 1) // tile_k + 1)
                        for t in range(n_kt):
                            cols = range(t * tile_k, min((t + 1) * tile_k, sk))
                            ivs = [_intervals(idx[bi, hi, c], idx.shape[-1])
                                   for c in cols]
                            live = any(
                                _first_allowed(iv, c, q0, causal) <= q_last
                                for iv, c in zip(ivs, cols))
                            meets = any(s0 < e0 and s0 <= q_last and e0 > q0
                                        for iv in ivs
                                        for s0, e0 in (iv[:2], iv[2:]))
                            block = hide[bi, hi, q0:q_last + 1,
                                         t * tile_k:(t + 1) * tile_k]
                            if not live:
                                skipped += 1
                                assert block.all(), (name, block_q, tile_k,
                                                     bi, hi, q0, t)
                            if not meets:
                                assert np.array_equal(
                                    block, diag[q0:q_last + 1,
                                                t * tile_k:(t + 1) * tile_k]
                                ), (name, block_q, tile_k, bi, hi, q0, t)
                        assert hide[bi, hi, q0:q_last + 1,
                                    n_kt * tile_k:].all()
            if name.startswith("documents"):
                assert skipped > 0, (name, block_q, tile_k)


def test_fully_masked_rows_give_exactly_zero():
    """Rows no key is allowed for keep m = -inf through every K5 tile and
    get P = 0 at every K6 pair, though 2^(s − lse) is inf there: O and dQ
    are 0 exactly, lse is the Pallas kernel's -1e30 + log(1e-30), and no
    value is NaN."""
    name, args, pallas, _ = _case(2)  # "fully masked rows, Hm=H"
    q, k, v, o, lse, do, tidx, causal, scale = args
    sq, sk = q.shape[1], k.shape[1]
    dead = fm.disallowed(tidx, sq, sk, causal).all(-1).transpose(1, 2)
    assert bool(dead[0, 70:80].all()) and int(dead.sum()) >= 20, name
    got = _emulate(args)
    for out in ("o", "dq"):
        assert torch.equal(got[out][dead], torch.zeros_like(got[out][dead]))
        assert bool(torch.isfinite(got[out]).all()), out
        assert float(got[out][~dead].abs().max()) > 0, out
    rows = got["lse"].squeeze(2).transpose(1, 2)[dead]
    want = torch.from_numpy(pallas["lse"]).squeeze(2).transpose(1, 2)[dead]
    assert torch.equal(rows, want) and bool((rows <= -1e29).all())
