"""The numerics of the tensor-core K1 and K2 (bfloat16), emulated on the CPU.

``csrc/flash_attention_fwd_sm90.cu`` and ``csrc/flash_attention_dq_sm90.cu``
take bf16 operands into wgmma with f32 sums, as the plain versions sum the
same bf16 values in f32, but they round two things the plain versions keep
in f32: P (after dropout's rescale) before P·V, and dS before dS·K. The
forward also runs its online softmax over 64-key tiles in exp2. This file
emulates exactly that in plain torch and holds the result, in f32 before
the outputs' own rounding, against the Pallas kernels in interpret mode and
against the port's plain versions (the on-card gate): the errors must sit
at least 4x inside ``chip_smoke.py``'s bf16 tolerances, ``TOL`` on O and lse
and ``BWD_TOL`` on dq. It also pins the wrapper's routing by dtype and the
rule for which operands TMA reads in place, both pure functions of shape,
strides, offset and dtype.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.ops.pallas.flash_attention import (
    _flash_fwd, flash_attention_grad_interpret_test)
from paddle_tpu_torch.ops.cuda import flash_attention as fa

# chip_smoke.py's bf16 gates, and the margin this design must keep
TOL_O, TOL_LSE = 2e-2, 1e-3
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
                limit = TOL_O / MARGIN
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


def test_routing_and_the_tma_alignment_rule():
    bf16, f32 = torch.bfloat16, torch.float32
    assert fa.kernel_for("fwd", bf16) == "fwd_sm90"
    assert fa.kernel_for("bwd_dq", bf16) == "bwd_dq_sm90"
    assert fa.kernel_for("bwd_dkv", bf16) == "bwd_dkv"
    for name in ("fwd", "bwd_dq", "bwd_dkv"):
        assert fa.kernel_for(name, f32) == name
    for bad in (torch.float16, torch.float64):
        try:
            fa.kernel_for("fwd", bad)
        except TypeError:
            pass
        else:
            raise AssertionError(f"{bad} was routed")
    sources = {src for src, _ in fa.SOURCES.values()}
    assert sources == {"flash_attention_fwd", "flash_attention_bwd",
                       "flash_attention_fwd_sm90", "flash_attention_dq_sm90"}

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
        # float32 never goes to TMA; the last dim must be contiguous
        assert not aligned(torch.zeros(1, 4, 2, d))
        assert not aligned(torch.zeros(1, 4, d, 2, dtype=bf16).transpose(2, 3))
    # a head stride of 68 elements (136 bytes) is not a multiple of 16 bytes
    rows = torch.zeros(2, 50, 4, 68, dtype=bf16)[..., :64]
    assert not aligned(rows)
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
