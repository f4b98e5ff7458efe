"""The numerics of the float32 K1 and K2 on the tensor cores (3xTF32),
emulated on the CPU.

``csrc/flash_attention_fwd_tf32.cu`` (K1) and ``csrc/flash_attention_dq_tf32.cu``
(K2) run every product a·b of float32 operands as three TF32 products,
a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, summed in f32, where hi = tf32(x)
rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``) and
lo = tf32(x − hi): S = Q·Kᵀ and P·V in K1 (P split after dropout's
rescale), S, dP = dO·Vᵀ and dS·K in K2. K1 runs its online softmax in
exp2 over 64-key tiles (32-key tiles at D = 128); K2 recomputes
P = 2^(S·scale·log2 e − lse·log2 e). This file emulates exactly that in
plain torch, TF32 rounding by int32 bit operations, and holds O, lse and
dq against the Pallas kernels in interpret mode and against the port's
plain versions (the on-card gate): at least 4x inside ``chip_smoke.py``'s
f32 gates (``TOL`` and ``BWD_TOL``: 1e-4). It prints the single-TF32
emulation's error (one product a_hi·b_hi) beside the 3xTF32 one and shows
that one product would leave the gate itself. It also pins the TF32
rounding on known bit patterns.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    _flash_fwd, flash_attention_grad_interpret_test)
from paddle_tpu_torch.ops.cuda import flash_attention as fa

# chip_smoke.py's f32 gates (O, lse, dq: absolute) and the margin this
# design must keep
GATE = 1e-4
MARGIN = 4.0
LOG2E = 1.4426950408889634

CASES = [
    # B, Sq, Sk, H, D, causal, dropout
    (1, 100, 100, 2, 64, True, 0.0),    # ragged S
    (1, 77, 130, 2, 16, False, 0.1),    # Sq != Sk, D padded to 64
    (1, 130, 130, 2, 128, True, 0.1),   # 32-key tiles
    (2, 33, 33, 1, 64, False, 0.0),
    (1, 96, 160, 1, 128, False, 0.0),   # Sq != Sk at D = 128
]


def tf32(x):
    """``x`` (float32) rounded to TF32, to nearest with ties away from
    zero, as ``cvt.rna.tf32.f32``: add half of the 13 dropped bits to the
    magnitude bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def product(eq, a, b, single=False):
    """``einsum(eq, a, b)`` as the kernels compute it: three TF32 products
    a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in f32, or one, a_hi·b_hi."""
    a_hi, a_lo = _split(a)
    b_hi, b_lo = _split(b)
    out = torch.einsum(eq, a_hi, b_hi)
    if single:
        return out
    return (torch.einsum(eq, a_lo, b_hi) + torch.einsum(eq, a_hi, b_lo)
            + out)


def _keep(seed, b, h, sq, sk, dropout):
    bq, bk = fa.blocks(sq, sk)
    return fa.dropout_keep(seed, torch.arange(b).view(b, 1, 1, 1),
                           torch.arange(h).view(1, h, 1, 1), sq, sk, bq, bk,
                           dropout)


def _mask(sq, sk, causal):
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    return torch.ones(sq, sk, dtype=torch.bool).tril()


def emulate_fwd(q, k, v, causal, scale, dropout, seed, single=False):
    """f32 K1: S in 3xTF32 (or ``single``), online softmax in exp2 over the
    kernel's key tiles, P (times keep / (1 - p)) and V in 3xTF32, f32 sums.
    Returns ``o [B, Sq, H, D]`` and ``lse [B, H, 1, Sq]``."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    tile = 64 if d <= 64 else 32
    s = product("bshd,bthd->bhst", q, k, single) * (scale * LOG2E)
    s = torch.where(_mask(sq, sk, causal), s, -1e30)
    keep = _keep(seed, b, h, sq, sk, dropout) if dropout > 0 else None
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, d)
    vt = v.transpose(1, 2)
    for k0 in range(0, sk, tile):
        st = s[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(st > -1e30, torch.exp2(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + tile], p / (1.0 - dropout), 0.0)
        acc = acc * alpha + product("bhst,bhtd->bhsd", p,
                                    vt[:, :, k0:k0 + tile], single)
        m = m_new
    den = l.clamp_min(1e-30)
    o = (acc / den).transpose(1, 2)
    lse = (m * math.log(2.0) + torch.log(den)).transpose(-1, -2)
    return o, lse


def emulate_dq(q, k, v, o, lse, do, causal, scale, dropout, seed,
               single=False):
    """f32 K2: S and dP = dO·Vᵀ in 3xTF32 (or ``single``),
    P = exp2(S·scale·log2 e − lse·log2 e), dS = P∘(dP′ − Δ) and K in
    3xTF32 for dS·K, f32 sums; dq in f32."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = product("bshd,bthd->bhst", q, k, single) * (scale * LOG2E)
    p = torch.exp2(s - lse.transpose(-1, -2) * LOG2E)
    p = torch.where(_mask(sq, sk, causal), p, 0.0)
    dp = product("bshd,bthd->bhst", do, v, single)
    if dropout > 0:
        keep = _keep(seed, b, h, sq, sk, dropout)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (dp - delta)
    return product("bhst,bthd->bshd", ds, k, single) * scale


def _case_data(case, seed):
    b, sq, sk, h, d, _, _ = case
    rs = np.random.RandomState(seed)
    q, k, v = (rs.randn(b, n, h, d).astype(np.float32)
               for n in (sq, sk, sk))
    do = rs.randn(b, sq, h, d).astype(np.float32)
    tseed = torch.tensor([31 + seed], dtype=torch.int32)
    return q, k, v, do, tseed, 1.0 / math.sqrt(d)


def test_tf32_rounding_on_known_bit_patterns():
    cases = {
        0x3F800000: 0x3F800000,  # 1.0 is a TF32 value
        0x3F800FFF: 0x3F800000,  # below half an ulp: down
        0x3F801000: 0x3F802000,  # a tie: away from zero
        0xBF801000: 0xBF802000,  # a negative tie: away from zero
        0x3F801001: 0x3F802000,  # above half an ulp: up
        0x3F802FFF: 0x3F802000,
        0x3FFFF000: 0x40000000,  # the carry reaches the exponent
        0x80000000: 0x80000000,  # -0.0 stays
        0x00001000: 0x00002000,  # a subnormal tie
        0x7F7FEFFF: 0x7F7FE000,  # the largest TF32 value
    }
    x = torch.tensor([v - (1 << 32) if v >= 1 << 31 else v for v in cases],
                     dtype=torch.int32).view(torch.float32)
    got = tf32(x).view(torch.int32).tolist()
    want = [v - (1 << 32) if v >= 1 << 31 else v for v in cases.values()]
    assert got == want, [hex(g & 0xFFFFFFFF) for g in got]
    # hi + lo carries x to about 2^-22 of its size; one TF32 part to 2^-11
    y = torch.from_numpy(np.random.RandomState(0).randn(4096)
                         .astype(np.float32))
    hi, lo = _split(y)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert (lo.view(torch.int32) & 0x1FFF).eq(0).all()
    assert float(((hi + lo - y).abs() / y.abs()).max()) <= 2.0 ** -21
    assert float(((hi - y).abs() / y.abs()).max()) > 2.0 ** -13


def _share(err, ref):
    return float(np.abs(err - ref).max()) / GATE


def test_forward_3xtf32_sits_4x_inside_the_gate():
    worst, worst_single = 0.0, 0.0
    for i, case in enumerate(CASES):
        _, _, _, _, _, causal, dropout = case
        q, k, v, _, tseed, scale = _case_data(case, i)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        o, lse = emulate_fwd(tq, tk, tv, causal, scale, dropout, tseed)
        o1, lse1 = emulate_fwd(tq, tk, tv, causal, scale, dropout, tseed,
                               single=True)
        o_pl, lse_pl = _flash_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  jnp.asarray(tseed.numpy()), causal, scale,
                                  dropout, interpret=True)
        o_ref, lse_ref = fa.flash_attention_fwd(tq, tk, tv, causal, scale,
                                                dropout, tseed, device="cpu")
        for name, want_o, want_lse in (("pallas", np.asarray(o_pl),
                                        np.asarray(lse_pl)),
                                       ("plain", o_ref.numpy(),
                                        lse_ref.numpy())):
            share = max(_share(o.numpy(), want_o),
                        _share(lse.numpy(), want_lse))
            assert share <= 1.0 / MARGIN, (case, name, share)
            worst = max(worst, share)
            worst_single = max(worst_single, _share(o1.numpy(), want_o),
                               _share(lse1.numpy(), want_lse))
        # the emulation is not the f32 result bit for bit
        assert not torch.equal(o, o_ref), case
    print(f"K1 O and lse, worst share of the 1e-4 gate: 3xTF32 {worst:.3f}, "
          f"one TF32 product {worst_single:.3f}")
    # why three products: one would leave the f32 gate itself
    assert worst_single > 1.0, worst_single


def test_dq_3xtf32_sits_4x_inside_the_gate():
    worst, worst_single = 0.0, 0.0
    for i, case in enumerate(CASES):
        _, _, _, _, _, causal, dropout = case
        q, k, v, do, tseed, scale = _case_data(case, 10 + i)
        jseed = jnp.asarray(tseed.numpy())
        # the Pallas forward and backward in interpret mode, at the scale
        # 1/sqrt(D) of _case_data
        _, (dq_pl, _, _) = flash_attention_grad_interpret_test(
            *(jnp.asarray(a) for a in (q, k, v, do)), causal, dropout, jseed)
        tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
        o, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, dropout,
                                        tseed, device="cpu")
        dq = emulate_dq(tq, tk, tv, o, lse, tdo, causal, scale, dropout,
                        tseed)
        dq1 = emulate_dq(tq, tk, tv, o, lse, tdo, causal, scale, dropout,
                         tseed, single=True)
        dq_ref, _, _ = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed,
                                              causal, scale, dropout,
                                              device="cpu")
        for name, want in (("pallas", np.asarray(dq_pl)),
                           ("plain", dq_ref.numpy())):
            share = _share(dq.numpy(), want)
            assert share <= 1.0 / MARGIN, (case, name, share)
            worst = max(worst, share)
            worst_single = max(worst_single, _share(dq1.numpy(), want))
        assert float(dq_ref.abs().max()) > 0 and not torch.equal(dq, dq_ref)
    print(f"K2 dq, worst share of the 1e-4 gate: 3xTF32 {worst:.3f}, one "
          f"TF32 product {worst_single:.3f}")
    assert worst_single > 1.0, worst_single
