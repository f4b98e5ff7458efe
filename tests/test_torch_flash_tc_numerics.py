"""The numerics of the tensor-core K1, K2 and K3 (bfloat16), emulated on
the CPU.

``csrc/flash_attention_fwd_sm90.cu``, ``csrc/flash_attention_dq_sm90.cu``
and ``csrc/flash_attention_dkv_sm90.cu`` take bf16 operands into wgmma with
f32 sums, as the plain versions sum the same bf16 values in f32, but they
round what the plain versions keep in f32: P (after dropout's rescale)
before P·V, and dS before dS·K, once to bf16; Pᵀ before Pᵀ·dO and dSᵀ
before dSᵀ·Q to two bf16 parts, hi + lo, each part a product of its own
(a single rounding there would leave dK and dV less than 4x inside the
gate, which this file also shows). The forward also runs its online
softmax over 64-key tiles in exp2. This file emulates exactly
that in plain torch and holds the result, in f32 before the outputs' own
rounding, against the Pallas kernels in interpret mode and against the
port's plain versions (the on-card gate): the errors must sit at least 4x
inside ``chip_smoke.py``'s bf16 tolerances, ``TOL`` on O and lse and
``BWD_TOL`` on dq, dk and dv. It also pins the wrappers' routing by dtype
(flash attention and FlashMask) and the rule for which operands TMA reads
in place (bfloat16 and float32), both pure functions of shape, strides,
offset and dtype.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    _flash_fwd, flash_attention_grad_interpret_test)
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flashmask as fm

# chip_smoke.py's bf16 gates, and the margin this design must keep: O within
# 2e-2 plus one bf16 step (2^-7 of the value), lse within 1e-3
TOL_O, TOL_O_REL, TOL_LSE = 2e-2, 2.0 ** -7, 1e-3
BWD_ATOL, BWD_RTOL = 2e-2, 1e-2
MARGIN = 4.0
TILE_K = 64  # keys per K/V tile of the tensor-core kernels
LOG2E = 1.4426950408889634

CASES = [
    # B, Sq, Sk, H, D, causal, dropout
    (1, 100, 100, 2, 64, True, 0.0),    # ragged S
    (1, 77, 130, 2, 16, False, 0.1),    # Sq != Sk, D padded to 64
    (1, 130, 130, 2, 128, True, 0.1),   # two 64-column boxes
    (2, 33, 33, 1, 64, False, 0.0),
]


def _bf16_inputs(b, sq, sk, h, d, seed):
    """q, k, v, dO as f32 arrays of bf16-representable values."""
    rs = np.random.RandomState(seed)

    def one(n):
        x = torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    return one(sq), one(sk), one(sk), one(sq)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _keep(seed, b, h, sq, sk, dropout):
    bq, bk = fa.blocks(sq, sk)
    return fa.dropout_keep(seed, torch.arange(b).view(b, 1, 1, 1),
                           torch.arange(h).view(1, h, 1, 1), sq, sk, bq, bk,
                           dropout)


def _mask(sq, sk, causal):
    if not causal:
        return torch.ones(sq, sk, dtype=torch.bool)
    return torch.ones(sq, sk, dtype=torch.bool).tril()


def emulate_fwd(q, k, v, causal, scale, dropout, seed):
    """K1 on the tensor cores: online softmax over 64-key tiles in exp2, P
    (times keep / (1 - p)) rounded to bf16 before P·V, f32 sums. Returns
    f32 ``o [B, Sq, H, D]`` and ``lse [B, H, 1, Sq]``."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q, k) * (scale * LOG2E)
    s = torch.where(_mask(sq, sk, causal), s, -1e30)
    keep = _keep(seed, b, h, sq, sk, dropout) if dropout > 0 else None
    m = torch.full((b, h, sq, 1), -1e30)
    l = torch.zeros(b, h, sq, 1)
    acc = torch.zeros(b, h, sq, q.shape[-1])
    vt = v.transpose(1, 2)
    for k0 in range(0, sk, TILE_K):
        st = s[..., k0:k0 + TILE_K]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.where(st > -1e30, torch.exp2(st - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[..., k0:k0 + TILE_K], p / (1.0 - dropout), 0.0)
        acc = acc * alpha + _bf16(p) @ vt[:, :, k0:k0 + TILE_K]
        m = m_new
    den = l.clamp_min(1e-30)
    o = (acc / den).transpose(1, 2)
    lse = (m * math.log(2.0) + torch.log(den)).transpose(-1, -2)
    return o, lse


def emulate_dq(q, k, v, o, lse, do, causal, scale, dropout, seed):
    """K2 on the tensor cores: P = exp2(S·scale·log2 e − lse·log2 e),
    dS = P∘(dP′ − Δ) rounded to bf16 before dS·K, f32 sums; f32 dq."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q, k) * (scale * LOG2E)
    p = torch.exp2(s - lse.transpose(-1, -2) * LOG2E)
    p = torch.where(_mask(sq, sk, causal), p, 0.0)
    dp = torch.einsum("bshd,bthd->bhst", do, v)
    if dropout > 0:
        keep = _keep(seed, b, h, sq, sk, dropout)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = _bf16(p * (dp - delta))
    return torch.einsum("bhst,bthd->bshd", ds, k) * scale


def _bf16_hi_lo(x):
    """x as the sum of two bf16 values: x rounded, plus what it left out,
    rounded."""
    hi = _bf16(x)
    return hi + _bf16(x - hi)


def emulate_dkv(q, k, v, o, lse, do, causal, scale, dropout, seed,
                split=True):
    """K3 on the tensor cores: Pᵀ = exp2(Sᵀ·scale·log2 e − lse·log2 e),
    Pᵀ (after dropout's rescale) and dSᵀ = Pᵀ∘(dP′ᵀ − Δ) in two bf16 parts
    (``split``; else rounded once) before Pᵀ·dO and dSᵀ·Q, f32 sums; f32 dk
    and dv."""
    parts = _bf16_hi_lo if split else _bf16
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    s = torch.einsum("bshd,bthd->bhst", q, k) * (scale * LOG2E)
    p = torch.exp2(s - lse.transpose(-1, -2) * LOG2E)
    p = torch.where(_mask(sq, sk, causal), p, 0.0)
    dp = torch.einsum("bshd,bthd->bhst", do, v)
    p_av = p
    if dropout > 0:
        keep = _keep(seed, b, h, sq, sk, dropout)
        p_av = torch.where(keep, p / (1.0 - dropout), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout), 0.0)
    delta = (do * o).sum(-1).transpose(1, 2)[..., None]
    ds = parts(p * (dp - delta))
    dk = torch.einsum("bhst,bshd->bthd", ds, q) * scale
    dv = torch.einsum("bhst,bshd->bthd", parts(p_av), do)
    return dk, dv


def _case_data(case, seed):
    b, sq, sk, h, d, causal, dropout = case
    q, k, v, do = _bf16_inputs(b, sq, sk, h, d, seed)
    tseed = torch.tensor([17 + seed], dtype=torch.int32)
    return q, k, v, do, tseed, 1.0 / math.sqrt(d)


def test_forward_rounding_sits_4x_inside_the_gate():
    for i, case in enumerate(CASES):
        _, _, _, _, _, causal, dropout = case
        q, k, v, _, tseed, scale = _case_data(case, i)
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        o, lse = emulate_fwd(tq, tk, tv, causal, scale, dropout, tseed)
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
            err_o = np.abs(o.numpy() - want_o)
            err_l = float(np.abs(lse.numpy() - want_lse).max())
            if dropout > 0:  # chip_smoke judges O with dropout by BWD_TOL
                limit = (BWD_ATOL + BWD_RTOL * np.abs(want_o)) / MARGIN
            else:
                limit = (TOL_O + TOL_O_REL * np.abs(want_o)) / MARGIN
            assert (err_o <= limit).all(), (case, name, float(err_o.max()))
            assert err_l <= TOL_LSE / MARGIN, (case, name, err_l)
        # the rounding is there to be seen: not the f32 result bit for bit
        assert not torch.equal(o, o_ref), case


def test_dq_rounding_sits_4x_inside_the_gate():
    for i, case in enumerate(CASES):
        _, _, _, _, _, causal, dropout = case
        q, k, v, do, tseed, scale = _case_data(case, i)
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
        dq_ref, _, _ = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed,
                                              causal, scale, dropout,
                                              device="cpu")
        for name, want in (("pallas", np.asarray(dq_pl)),
                           ("plain", dq_ref.numpy())):
            err = np.abs(dq.numpy() - want)
            limit = (BWD_ATOL + BWD_RTOL * np.abs(want)) / MARGIN
            assert (err <= limit).all(), (case, name, float(err.max()))
        assert float(dq_ref.abs().max()) > 0 and not torch.equal(dq, dq_ref)


def test_dkv_rounding_sits_4x_inside_the_gate():
    worst_single = 0.0  # of one bf16 rounding, as a share of the gate
    for i, case in enumerate(CASES):
        _, _, _, _, _, causal, dropout = case
        q, k, v, do, tseed, scale = _case_data(case, 20 + i)
        jseed = jnp.asarray(tseed.numpy())
        _, (_, dk_pl, dv_pl) = flash_attention_grad_interpret_test(
            *(jnp.asarray(a) for a in (q, k, v, do)), causal, dropout, jseed)
        tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
        o, lse = fa.flash_attention_fwd(tq, tk, tv, causal, scale, dropout,
                                        tseed, device="cpu")
        dk, dv = emulate_dkv(tq, tk, tv, o, lse, tdo, causal, scale, dropout,
                             tseed)
        _, dk_ref, dv_ref = fa.flash_attention_bwd(
            tq, tk, tv, o, lse, tdo, tseed, causal, scale, dropout,
            device="cpu")
        for name, got, want in (("dk pallas", dk, np.asarray(dk_pl)),
                                ("dv pallas", dv, np.asarray(dv_pl)),
                                ("dk plain", dk, dk_ref.numpy()),
                                ("dv plain", dv, dv_ref.numpy())):
            err = np.abs(got.numpy() - want)
            limit = (BWD_ATOL + BWD_RTOL * np.abs(want)) / MARGIN
            assert (err <= limit).all(), (case, name, float(err.max()))
        for got, ref in ((dk, dk_ref), (dv, dv_ref)):
            assert float(ref.abs().max()) > 0 and not torch.equal(got, ref)
        for got, ref in zip(emulate_dkv(tq, tk, tv, o, lse, tdo, causal,
                                        scale, dropout, tseed, split=False),
                            (dk_ref, dv_ref)):
            share = (got - ref).abs() / (BWD_ATOL + BWD_RTOL * ref.abs())
            worst_single = max(worst_single, float(share.max()))
    # why K3 splits: rounded once, Pᵀ or dSᵀ would leave dK or dV less than
    # 4x inside the gate here
    assert worst_single > 1.0 / MARGIN, worst_single


def test_routing_and_the_tma_alignment_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fa.kernel_for(name, bf16) == name + "_sm90"
        # float16: the same tensor-core kernels, instantiated for __half
        assert fa.kernel_for(name, torch.float16) == name + "_sm90"
    # float32: K1, K2 and K3 on the tensor cores in 3xTF32
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fa.kernel_for(name, f32) == name + "_tf32"
    assert fa.SOURCES["bwd_dkv_tf32"][0] == "flash_attention_dkv_tf32"
    # every kernel reads q, k, v (and dO) through TMA
    assert fa.TMA_KERNELS == {fa.kernel_for(name, dt)
                              for name in ("fwd", "bwd_dq", "bwd_dkv")
                              for dt in (bf16, f32)} == set(fa.SOURCES)
    # float16 waits for K5-K7 (FlashMask); float64 has no kernel
    for mod, bad in ((fa, torch.float64), (fm, torch.float64),
                     (fm, torch.float16)):
        try:
            mod.kernel_for("fwd", bad)
        except TypeError:
            pass
        else:
            raise AssertionError(f"{bad} was routed")
    sources = {src for src, _, _ in fa.SOURCES.values()}
    assert sources == {"flash_attention_fwd_sm90", "flash_attention_dq_sm90",
                       "flash_attention_dkv_sm90", "flash_attention_fwd_tf32",
                       "flash_attention_dq_tf32", "flash_attention_dkv_tf32"}
    assert set(fa.SOURCES) == {"fwd_sm90", "fwd_tf32", "bwd_dq_sm90",
                               "bwd_dq_tf32", "bwd_dkv_sm90", "bwd_dkv_tf32"}
    # FlashMask: K5, K6 and K7 on the tensor cores for bf16, and for f32 in
    # 3xTF32 (flashmask_fwd_tf32.cu, flashmask_dq_tf32.cu,
    # flashmask_dkv_tf32.cu)
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fm.kernel_for(name, bf16) == name + "_sm90"
        assert fm.kernel_for(name, f32) == name + "_tf32"
    assert fm.SOURCES["fwd_tf32"][:2] == ("flashmask_fwd_tf32",
                                          "paddle_flashmask_fwd_tf32")
    assert fm.SOURCES["bwd_dq_tf32"][:2] == ("flashmask_dq_tf32",
                                             "paddle_flashmask_bwd_dq_tf32")
    assert fm.SOURCES["bwd_dkv_tf32"][0] == "flashmask_dkv_tf32"
    assert {src for src, _, _ in fm.SOURCES.values()} == {
        "flashmask_fwd_sm90", "flashmask_dq_sm90", "flashmask_dkv_sm90",
        "flashmask_fwd_tf32", "flashmask_dq_tf32", "flashmask_dkv_tf32"}
    assert set(fm.SOURCES) == {"fwd_sm90", "fwd_tf32", "bwd_dq_sm90",
                               "bwd_dq_tf32", "bwd_dkv_sm90", "bwd_dkv_tf32"}
    # every kernel reads through TMA and counts its tiles
    assert {name for name, (_, _, tc) in fm.SOURCES.items() if tc} == {
        fm.kernel_for(name, dt) for name in ("fwd", "bwd_dq", "bwd_dkv")
        for dt in (bf16, f32)} == set(fm.SOURCES)

    def aligned(t):
        return fa.tma_aligned(t.shape, t.stride(),
                              t.storage_offset() * t.element_size(), t.dtype)

    for d in fa.HEAD_DIMS:
        # GPT's packed qkv slices and Llama's repeat_interleaved k, v
        qkv = torch.zeros(2, 100, 3, 3, d, dtype=bf16)
        assert all(aligned(qkv[..., i, :]) for i in range(3)), d
        kv = torch.zeros(2, 100, 1, d, dtype=bf16).repeat_interleave(3, 2)
        assert aligned(kv) and aligned(torch.zeros(1, 7, 5, d, dtype=bf16))
        # an offset of one element, or of 4 bytes from a packed slice
        flat = torch.zeros(2 * 100 * 3 * d + 8, dtype=bf16)
        assert not aligned(flat[1:1 + 2 * 100 * 3 * d].view(2, 100, 3, d))
        assert not aligned(flat[2:2 + 2 * 100 * 3 * d].view(2, 100, 3, d))
        assert aligned(flat[8:8 + 2 * 100 * 3 * d].view(2, 100, 3, d))
        # float32: the serve path's packed qkv slices (offsets of 0, D and
        # 2D floats, a head stride of 3D floats) are read in place; an
        # offset of one float is not 16-byte aligned, one of 4 floats is
        fqkv = torch.zeros(1, 100, 12, 3, d)
        assert all(aligned(fqkv[..., i, :]) for i in range(3)), d
        fflat = torch.zeros(2 * 100 * 3 * d + 4)
        assert not aligned(fflat[1:1 + 2 * 100 * 3 * d].view(2, 100, 3, d))
        assert aligned(fflat[4:4 + 2 * 100 * 3 * d].view(2, 100, 3, d))
        # float16 is read as bfloat16 is; other dtypes never go to TMA;
        # the last dim must be contiguous
        assert aligned(torch.zeros(2, 100, 3, 3, d,
                                   dtype=torch.float16)[..., 1, :])
        assert not aligned(torch.zeros(1, 4, 2, d, dtype=torch.float64))
        assert not aligned(torch.zeros(1, 4, d, 2, dtype=bf16).transpose(2, 3))
        assert not aligned(torch.zeros(1, 4, d, 2).transpose(2, 3))
    # a head stride of 68 elements (136 bytes) is not a multiple of 16 bytes;
    # in float32 a stride of 66 floats (264 bytes) is not either
    rows = torch.zeros(2, 50, 4, 68, dtype=bf16)[..., :64]
    assert not aligned(rows)
    assert aligned(torch.zeros(2, 50, 4, 68)[..., :64])
    assert not aligned(torch.zeros(2, 50, 4, 66)[..., :64])
    # a dim of length 1 is never stepped: its stride does not matter, and
    # the wrapper hands the kernels the contiguous one
    one = torch.zeros(1, 8, 2, 64, dtype=bf16).as_strided((1, 8, 2, 64),
                                                          (3, 128, 64, 1))
    assert aligned(one)
    assert fa._strides(one)[:3] == [8 * 2 * 64, 128, 64]


def test_cpu_tensors_take_the_plain_version_in_every_dtype():
    """The routing applies to CUDA tensors only: on the CPU both dtypes run
    the plain version, nothing is copied for TMA and nothing is counted."""
    case = (1, 70, 70, 2, 64, True, 0.1)
    q, k, v, do, tseed, scale = _case_data(case, 9)
    before = (fa.launches, fa.dq_launches, fa.dkv_launches, fa.tma_copies)
    for dtype in (torch.bfloat16, torch.float32):
        tq, tk, tv, tdo = (torch.from_numpy(a).to(dtype) for a in
                           (q, k, v, do))
        o, lse = fa.flash_attention_fwd(tq, tk, tv, True, scale, 0.1, tseed,
                                        device="cpu")
        want = fa.flash_attention_fwd_reference(tq, tk, tv, True, scale, 0.1,
                                                tseed)
        assert torch.equal(o, want[0]) and torch.equal(lse, want[1])
        grads = fa.flash_attention_bwd(tq, tk, tv, o, lse, tdo, tseed, True,
                                       scale, 0.1, device="cpu")
        assert all(g.dtype == dtype for g in grads)
    assert (fa.launches, fa.dq_launches, fa.dkv_launches,
            fa.tma_copies) == before
