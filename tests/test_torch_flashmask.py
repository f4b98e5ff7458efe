"""The port's FlashMask plain versions (K5–K7) against the Pallas kernels.

The plain PyTorch versions, which the wrappers run for CPU tensors, are
held against ``_fm_fwd``/``_fm_bwd`` in interpret mode on the same numpy
inputs, at the tolerances of ``tests/test_pallas_backward.py``: 2e-4 on O
and lse, 2e-3 on the gradients, all in f32. The layouts are the documented
ones (causal ncol 1 and 2, non-causal ncol 4), with Hm = 1 and Hm = H,
Sq != Sk and a ragged S. A fully masked row must give exactly 0 in O and dQ,
with no NaN anywhere. In float16 both sides compute in f32 and round
once, and agree within one fp16 step plus those tolerances. The CUDA kernels are held against the plain versions
on the card (``tests/test_torch_cuda_flashmask.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas.flashmask import _fm_bwd, _fm_fwd, _tile_mask
from paddle_tpu_torch.ops.cuda import flashmask as fm

TOL_O, TOL_GRAD = 2e-4, 2e-3


def doc_mask(rs, b, s):
    """Causal document mask [b, 1, s, 1]: each key column hides the rows
    from its document's end on."""
    idx = np.empty((b, 1, s, 1), np.int32)
    for i in range(b):
        cuts = np.sort(rs.choice(np.arange(1, s), 3, replace=False))
        for start, end in zip(np.r_[0, cuts], np.r_[cuts, s]):
            idx[i, 0, start:end, 0] = end
    return idx


def share_question_mask(b, s):
    """Causal [b, 1, s, 2]: a question and three answers, then padding; an
    answer's columns hide the rows of the later answers of its question."""
    group = s - s // 8
    bounds = [0, s // 4, s // 2, 3 * s // 4 - 5, group]
    idx = np.empty((b, 1, s, 2), np.int32)
    idx[..., 0] = idx[..., 1] = group  # question and padding: nothing hidden
    for start, end in zip(bounds[1:-1], bounds[2:]):
        idx[:, :, start:end, 0] = end
    return idx


def masked_rows_mask(rs, b, h, s, rows=(40, 47)):
    """Causal [b, h, s, 2] with random intervals per head, and rows
    ``rows[0]..rows[1]`` hidden from every key column at or below them."""
    j = np.arange(s)
    lts = np.minimum(j + rs.randint(1, 30, (b, h, s)), s)
    lte = np.minimum(lts + rs.randint(0, 40, (b, h, s)), s)
    r0, r1 = rows
    cols = j <= r1
    lts = np.where(cols, np.minimum(lts, np.maximum(r0, j)), lts)
    lte = np.where(cols, np.maximum(lte, r1 + 1), lte)
    return np.stack([lts, lte], -1).astype(np.int32)


def window_mask(b, h, s):
    """Non-causal [b, h, s, 4] sliding window, a width per head: key column
    j hides rows >= j + w and rows < j - w + 1."""
    j = np.arange(s)
    idx = np.empty((b, h, s, 4), np.int32)
    for head in range(h):
        w = 3 + 5 * head
        idx[:, head, :, 0] = np.minimum(j + w, s)
        idx[:, head, :, 1] = s
        idx[:, head, :, 2] = 0
        idx[:, head, :, 3] = np.maximum(j - w + 1, 0)
    return idx


def bidirectional_doc_mask(b, sq, sk, cuts_q, cuts_k):
    """Non-causal [b, 1, sk, 4]: query document i sees key document i only
    (documents end at ``cuts_q`` rows and ``cuts_k`` columns)."""
    idx = np.empty((b, 1, sk, 4), np.int32)
    k_bounds = np.r_[0, cuts_k, sk]
    q_bounds = np.r_[0, cuts_q, sq]
    for i in range(len(k_bounds) - 1):
        cols = slice(k_bounds[i], k_bounds[i + 1])
        idx[:, :, cols] = (q_bounds[i + 1], sq, 0, q_bounds[i])
    return idx


def _case(name):
    rs = np.random.RandomState(CASES.index(name))
    if name == "doc_ncol1":
        return 2, 128, 128, 2, True, doc_mask(rs, 2, 128)
    if name == "share_question_ncol2":
        return 2, 128, 128, 2, True, share_question_mask(2, 128)
    if name == "masked_rows_ncol2_hm_h":
        return 1, 96, 96, 2, True, masked_rows_mask(rs, 1, 2, 96)
    if name == "window_ncol4_hm_h":
        return 1, 64, 64, 3, False, window_mask(1, 3, 64)
    if name == "bidirectional_doc_sq_ne_sk":
        return 1, 48, 80, 2, False, bidirectional_doc_mask(1, 48, 80, [20],
                                                           [30])
    if name == "ragged_doc_ncol1":
        return 1, 100, 100, 2, True, doc_mask(rs, 1, 100)
    raise KeyError(name)


CASES = ["doc_ncol1", "share_question_ncol2", "masked_rows_ncol2_hm_h",
         "window_ncol4_hm_h", "bidirectional_doc_sq_ne_sk",
         "ragged_doc_ncol1"]


@pytest.mark.parametrize("name", CASES)
def test_plain_kernels_match_pallas_interpret(name):
    b, sq, sk, h, causal, idx = _case(name)
    d = 16
    rs = np.random.RandomState(0)
    q, do = (rs.randn(b, sq, h, d).astype(np.float32) for _ in range(2))
    k, v = (rs.randn(b, sk, h, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / math.sqrt(d)

    jq, jk, jv, jdo, jidx = (jnp.asarray(a) for a in (q, k, v, do, idx))
    o_ref, lse_ref = _fm_fwd(jq, jk, jv, jidx, causal, scale, interpret=True)
    grads_ref = _fm_bwd(jq, jk, jv, jidx, o_ref, lse_ref, jdo, causal, scale,
                        interpret=True)

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tidx = torch.from_numpy(idx)
    o, lse = fm.flashmask_fwd(tq, tk, tv, tidx, causal, scale, device="cpu")
    grads = fm.flashmask_bwd(tq, tk, tv, o, lse, tdo, tidx, causal, scale,
                             device="cpu")
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), rtol=TOL_O,
                               atol=TOL_O)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL_O,
                               atol=TOL_O)
    for label, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        assert got.shape == want.shape and got.dtype == torch.float32, label
        assert bool(torch.isfinite(got).all()), label
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_GRAD, atol=TOL_GRAD,
                                   err_msg=label)

    # rows no key column is allowed for: O and dQ exactly 0, lse -1e30
    hide = fm.disallowed(tidx, sq, sk, causal).expand(b, h, sq, sk)
    dead = hide.all(-1).transpose(1, 2)  # [B, Sq, H]
    if name == "masked_rows_ncol2_hm_h":
        assert bool(dead[0, 40:48].all()) and int(dead.sum()) >= 16
    assert torch.equal(o[dead], torch.zeros_like(o[dead]))
    assert torch.equal(grads[0][dead], torch.zeros_like(grads[0][dead]))
    assert bool((lse.squeeze(2).transpose(1, 2)[dead] <= -1e29).all())
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("name", CASES)
def test_float16_plain_kernels_match_pallas_interpret(name):
    """float16 (what AMP O1 casts attention to): the Pallas kernels compute
    in f32 and write O, dq, dk, dv in the input's dtype, as the plain
    versions do, so both round one f32 result to fp16. Held within one
    fp16 step (2⁻¹⁰ of the value) plus the f32 tolerances above; lse is
    f32 in both."""
    b, sq, sk, h, causal, idx = _case(name)
    d = 16
    rs = np.random.RandomState(1)
    q, do = (rs.randn(b, sq, h, d).astype(np.float16) for _ in range(2))
    k, v = (rs.randn(b, sk, h, d).astype(np.float16) for _ in range(2))
    scale = 1.0 / math.sqrt(d)

    jq, jk, jv, jdo, jidx = (jnp.asarray(a) for a in (q, k, v, do, idx))
    o_ref, lse_ref = _fm_fwd(jq, jk, jv, jidx, causal, scale, interpret=True)
    grads_ref = _fm_bwd(jq, jk, jv, jidx, o_ref, lse_ref, jdo, causal, scale,
                        interpret=True)
    assert o_ref.dtype == jnp.float16

    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tidx = torch.from_numpy(idx)
    o, lse = fm.flashmask_fwd(tq, tk, tv, tidx, causal, scale, device="cpu")
    grads = fm.flashmask_bwd(tq, tk, tv, o, lse, tdo, tidx, causal, scale,
                             device="cpu")

    def close(got, want, tol, label):
        assert got.dtype == torch.float16 and got.shape == want.shape, label
        got = got.float().numpy()
        want = np.asarray(want, np.float32)
        assert np.isfinite(got).all(), label
        err = np.abs(got - want)
        bad = err > 2.0 ** -10 * np.abs(want) + tol
        assert not bad.any(), (label, float(err.max()))

    close(o, o_ref, TOL_O, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), rtol=TOL_O,
                               atol=TOL_O)
    for label, got, want in zip(("dq", "dk", "dv"), grads, grads_ref):
        close(got, want, TOL_GRAD, label)


def test_disallowed_matches_pallas_tile_mask():
    """The dense mask of the plain versions equals the Pallas
    ``_tile_mask`` (plus the causal diagonal) over the whole matrix, for
    every layout."""
    for name in CASES:
        b, sq, sk, h, causal, idx = _case(name)
        got = fm.disallowed(torch.from_numpy(idx), sq, sk, causal).numpy()
        rows = jnp.arange(sq)[:, None] + jnp.zeros((1, sk), jnp.int32)
        for bi in range(b):
            for hi in range(idx.shape[1]):
                want = np.asarray(_tile_mask(jnp.asarray(idx[bi, hi]), rows,
                                             causal, idx.shape[-1]))
                if causal:
                    want = want | (np.arange(sq)[:, None]
                                   < np.arange(sk)[None, :])
                np.testing.assert_array_equal(got[bi, hi], want,
                                              err_msg=name)
