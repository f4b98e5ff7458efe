"""The numerics of the tensor-core K5 (FlashMask forward, bfloat16),
emulated on the CPU.

``csrc/flashmask_fwd_sm90.cu`` runs the tensor-core K1 block under
FlashMask's mask: bf16 operands into wgmma with f32 sums, the online
softmax over 64-key tiles in exp2, and P rounded once to bf16 before P·V,
where the Pallas kernel and the plain version keep P in f32. Hidden scores
are selected to -inf before the row max, so a row that sees no key keeps
m = -inf and gives O = 0 exactly. This file emulates exactly that in plain
torch and holds it, in f32 before the output's own rounding, against the
Pallas kernel in interpret mode (``_fm_fwd(..., interpret=True)``) and the
port's plain version over the documented index layouts: O at least 4x
inside ``chip_smoke.py``'s bf16 gate (2e-2 plus one bf16 step, 2^-7 of the
value), lse 4x inside 1e-3, fully masked rows exactly 0. It also holds the
kernel's tile skip, restated here over its 128-row blocks and 64-key
tiles, to dropping no allowed pair.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flashmask import _fm_fwd
from paddle_tpu_torch.ops.cuda import flashmask as fm

# chip_smoke.py's bf16 gates on K5, and the margin this design must keep
TOL_O, TOL_O_REL, TOL_LSE = 2e-2, 2.0 ** -7, 1e-3
MARGIN = 4.0
TILE_K = 64   # keys per K/V tile of the tensor-core kernel
BLOCK_Q = 128  # q rows per block
LOG2E = 1.4426950408889634
OPEN = 0x7FFFFFFF  # the kernel's end of an interval open to the last row


def _documents(rs, b, s, n):
    """Causal [b, 1, s, 1]: n documents; a key hides the rows from its
    document's end on."""
    idx = np.empty((b, 1, s, 1), np.int32)
    for i in range(b):
        cuts = np.sort(rs.choice(np.arange(1, s), n - 1, replace=False))
        for start, end in zip(np.r_[0, cuts], np.r_[cuts, s]):
            idx[i, 0, start:end, 0] = end
    return idx


def _layouts():
    """(name, B, Sq, Sk, H, D, causal, indices) over the documented layouts:
    causal ncol 1 and 2, non-causal ncol 4, Hm = 1 and Hm = H, Sq != Sk,
    ragged S, a head dim padded to 64 and one of two 64-column boxes."""
    rs = np.random.RandomState(3)
    out = [("documents, ragged S", 2, 200, 200, 2, 64, True,
            _documents(rs, 2, 200, 4))]
    s = 192  # share-question [LTS, LTE]: a question, three answers, padding
    idx = np.full((1, 1, s, 2), s - 24, np.int32)
    for start, end in ((48, 96), (96, 140), (140, s - 24)):
        idx[:, :, start:end, 0] = end
    out.append(("share question", 1, s, s, 2, 128, True, idx))
    s, j = 160, np.arange(160)  # [LTS, LTE] per head, rows 70..79 see no key
    lts = np.minimum(j + rs.randint(1, 30, (1, 2, s)), s)
    lte = np.minimum(lts + rs.randint(0, 40, (1, 2, s)), s)
    lts = np.where(j <= 79, np.minimum(lts, np.maximum(70, j)), lts)
    lte = np.where(j <= 79, np.maximum(lte, 80), lte)
    out.append(("fully masked rows, Hm=H", 1, s, s, 2, 16, True,
                np.stack([lts, lte], -1).astype(np.int32)))
    s, j = 192, np.arange(192)  # a sliding window, a width per head
    idx = np.stack([np.stack([np.minimum(j + w, s), np.full(s, s),
                              np.zeros(s, np.int64), np.maximum(j - w + 1, 0)],
                             -1) for w in (7, 40)])[None].astype(np.int32)
    out.append(("sliding window, Hm=H", 1, s, s, 2, 64, False, idx))
    sq, sk = 96, 160  # bidirectional documents, query i sees key document i
    idx = np.empty((1, 1, sk, 4), np.int32)
    for (k0, k1), (q0, q1) in zip(((0, 70), (70, sk)), ((0, 40), (40, sq))):
        idx[:, :, k0:k1] = (q1, sq, 0, q0)
    out.append(("bidirectional documents, Sq != Sk", 1, sq, sk, 2, 64, False,
                idx))
    return out


def _inputs(b, sq, sk, h, d, seed):
    """q, k, v as f32 tensors of bf16-representable values."""
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
            .to(torch.bfloat16).float() for n in (sq, sk, sk)]


def emulate_fm_fwd(q, k, v, idx, causal, scale):
    """K5 on the tensor cores: hidden scores selected to -inf, the online
    softmax over 64-key tiles in exp2 (a tile that raises no row max leaves
    the row as it was), P rounded to bf16 before P·V, f32 sums. Returns f32
    ``o [B, Sq, H, D]`` and ``lse [B, H, 1, Sq]``."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    hide = fm.disallowed(idx, sq, sk, causal)
    s = torch.einsum("bshd,bthd->bhst", q, k)
    s = torch.where(hide, -math.inf, s)
    sl = scale * LOG2E
    m = torch.full((b, h, sq, 1), -math.inf)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, q.shape[-1])
    vt = v.transpose(1, 2)
    for k0 in range(0, sk, TILE_K):
        st = s[..., k0:k0 + TILE_K]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.where(m_new == m, 1.0, torch.exp2((m - m_new) * sl))
        p = torch.exp2(st * sl - torch.where(m_new == -math.inf, 0.0,
                                             m_new * sl))
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt[:, :,
                                                               k0:k0 + TILE_K]
        m = m_new
    den = l.clamp_min(1e-30)
    lse = torch.where(m == -math.inf, -1e30, m * scale) + torch.log(den)
    return (acc / den).transpose(1, 2), lse.transpose(-1, -2)


def test_forward_rounding_sits_4x_inside_the_gate():
    for i, (name, b, sq, sk, h, d, causal, idx) in enumerate(_layouts()):
        q, k, v = _inputs(b, sq, sk, h, d, i)
        scale = 1.0 / math.sqrt(d)
        tidx = torch.from_numpy(idx)
        o, lse = emulate_fm_fwd(q, k, v, tidx, causal, scale)
        o_pl, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                               jnp.asarray(idx), causal, scale,
                               interpret=True)
        o_ref, lse_ref = fm.flashmask_fwd(q, k, v, tidx, causal, scale,
                                          device="cpu")
        for label, want_o, want_lse in (
                ("pallas", np.asarray(o_pl), np.asarray(lse_pl)),
                ("plain", o_ref.numpy(), lse_ref.numpy())):
            err_o = np.abs(o.numpy() - want_o)
            limit = (TOL_O + TOL_O_REL * np.abs(want_o)) / MARGIN
            assert (err_o <= limit).all(), (name, label, float(err_o.max()))
            err_l = float(np.abs(lse.numpy() - want_lse).max())
            assert err_l <= TOL_LSE / MARGIN, (name, label, err_l)
        # the rounding is there to be seen: not the f32 result bit for bit
        assert not torch.equal(o, o_ref), name


def test_fully_masked_rows_give_exactly_zero():
    """Rows no key is allowed for keep m = -inf through every tile: O is 0
    exactly and lse is the Pallas kernel's -1e30 + log(1e-30), with no NaN
    anywhere."""
    name, b, sq, sk, h, d, causal, idx = _layouts()[2]
    q, k, v = _inputs(b, sq, sk, h, d, 7)
    scale = 1.0 / math.sqrt(d)
    tidx = torch.from_numpy(idx)
    o, lse = emulate_fm_fwd(q, k, v, tidx, causal, scale)
    _, lse_pl = _fm_fwd(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                        jnp.asarray(idx), causal, scale, interpret=True)
    dead = fm.disallowed(tidx, sq, sk, causal).all(-1).transpose(1, 2)
    assert bool(dead[0, 70:80].all()) and int(dead.sum()) >= 20, name
    assert torch.equal(o[dead], torch.zeros_like(o[dead]))
    rows = lse.squeeze(2).transpose(1, 2)[dead]
    want = torch.from_numpy(np.array(lse_pl)).squeeze(2).transpose(1, 2)
    assert torch.equal(rows, want[dead]) and bool((rows <= -1e29).all())
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())


def _first_allowed(iv, kp, q0, causal):
    """The kernel's ``first_allowed``: the first row at or after q0 that key
    column kp lets through, past the causal bound and both intervals."""
    r = q0
    for _ in range(3):
        if causal and r < kp:
            r = kp
        if iv[0] <= r < iv[1]:
            r = iv[1]
        if iv[2] <= r < iv[3]:
            r = iv[3]
    return r


def _intervals(col, ncol):
    """A key column's indices as the kernel's two [start, end) intervals."""
    if ncol == 1:
        return int(col[0]), OPEN, 0, 0
    if ncol == 2:
        return int(col[0]), int(col[1]), 0, 0
    return tuple(int(x) for x in col)


def test_the_tile_skip_drops_no_allowed_pair():
    """Over each 128-row block, a 64-key tile the kernel skips (no column
    lets a block row through) holds no allowed pair, and a tile it marks
    whole (no column's intervals meet the block rows) hides nothing but the
    causal diagonal. Packed documents let the skip save tiles."""
    for name, b, sq, sk, h, d, causal, idx in _layouts():
        hide = fm.disallowed(torch.from_numpy(idx), sq, sk, causal).numpy()
        diag = (np.arange(sq)[:, None] < np.arange(sk)[None, :]) & causal
        skipped = 0
        for bi in range(b):
            for hi in range(idx.shape[1]):
                for q0 in range(0, sq, BLOCK_Q):
                    q_last = min(q0 + BLOCK_Q, sq) - 1
                    n_kt = -(-sk // TILE_K)
                    if causal:
                        n_kt = min(n_kt, (q0 + BLOCK_Q - 1) // TILE_K + 1)
                    for t in range(n_kt):
                        cols = range(t * TILE_K, min((t + 1) * TILE_K, sk))
                        ivs = [_intervals(idx[bi, hi, c], idx.shape[-1])
                               for c in cols]
                        live = any(_first_allowed(iv, c, q0, causal) <= q_last
                                   for iv, c in zip(ivs, cols))
                        meets = any(s0 < e0 and s0 <= q_last and e0 > q0
                                    for iv in ivs
                                    for s0, e0 in (iv[:2], iv[2:]))
                        block = hide[bi, hi, q0:q_last + 1,
                                     t * TILE_K:(t + 1) * TILE_K]
                        if not live:
                            skipped += 1
                            assert block.all(), (name, bi, hi, q0, t)
                        if not meets:
                            assert np.array_equal(
                                block, diag[q0:q_last + 1,
                                            t * TILE_K:(t + 1) * TILE_K]), (
                                name, bi, hi, q0, t)
        if name.startswith("documents"):
            assert skipped > 0, name
