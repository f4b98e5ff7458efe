"""On-card tests of the port's FlashMask kernels K5–K7 (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_flashmask.py

K5, K6 and K7 are held against their plain PyTorch versions on the same
card, from the same (o, lse) for the backward, the bf16 kernels (on the
tensor cores) also over every layout and head dim, at the tolerances of
the K1–K3 card tests (the bf16 K5's O within one bf16 step plus 2e-2):
f32 1e-4 absolute (lse 1e-3); bf16 2e-2 absolute plus 1e-2 of the value
(the outputs round once to bf16). The f32 kernels (3xTF32 on the tensor
cores) are also held within 1e-4 of the plain versions computed in
float64, the fp16 kernels (the bf16 sources instantiated for __half) at the
bf16 gates divided by 8 over every layout and head dim, over every layout and at a long sequence whose blocks list their
tiles in rounds. Fully masked rows give exactly 0 in O and dQ. ``flashmask_attention`` differentiates through them with exactly
one launch of each and none of K1–K3, and copies no ``[B, S, H, D]``
operand for TMA; an operand TMA cannot read in place is copied and
counted, not refused.
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.nn.functional import flashmask_attention
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import flashmask as fm

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    err = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        return float(err.max()) <= 1e-4
    return bool((err <= 2e-2 + 1e-2 * want.float().abs()).all())


def _indices(rs, kind, b, hm, sq, sk):
    j = np.arange(sk)
    if kind == "doc":  # causal [LTS]: documents of 37 tokens
        ends = np.minimum(j // 37 * 37 + 37, sk)
        return np.broadcast_to(ends[:, None], (b, hm, sk, 1)).copy()
    if kind == "masked_rows":  # causal [LTS, LTE], rows 70..79 fully hidden
        lts = np.minimum(j + rs.randint(1, 40, (b, hm, sk)), sq)
        lte = np.minimum(lts + rs.randint(0, 50, (b, hm, sk)), sq)
        cols = j <= 79
        lts = np.where(cols, np.minimum(lts, np.maximum(70, j)), lts)
        lte = np.where(cols, np.maximum(lte, 80), lte)
        return np.stack([lts, lte], -1)
    # non-causal [LTS, LTE, UTS, UTE]: a sliding window of half-width 20
    rows = np.round(j * sq / sk).astype(np.int64)
    one = np.stack([np.minimum(rows + 20, sq), np.full(sk, sq),
                    np.zeros(sk, np.int64), np.maximum(rows - 19, 0)], -1)
    return np.broadcast_to(one, (b, hm, sk, 4)).copy()


CASES = [
    # B, Sq, Sk, H, Hm, D, dtype, kind
    (2, 200, 200, 3, 1, 64, torch.float32, "doc"),          # ragged S
    (1, 256, 256, 2, 2, 128, torch.bfloat16, "doc"),
    (1, 192, 192, 2, 2, 64, torch.float32, "masked_rows"),
    (1, 128, 128, 2, 1, 128, torch.bfloat16, "masked_rows"),
    (2, 130, 260, 2, 1, 64, torch.float32, "window"),      # Sq != Sk
    (1, 256, 256, 4, 4, 128, torch.bfloat16, "window"),
]


def test_kernels_match_plain(card):
    rs = np.random.RandomState(0)
    for case in CASES:
        b, sq, sk, h, hm, d, dtype, kind = case
        causal = kind != "window"
        idx = torch.from_numpy(_indices(rs, kind, b, hm, sq, sk)).to(card)
        q, do = (torch.from_numpy(rs.randn(b, sq, h, d).astype(
            np.float32)).to(card, dtype) for _ in range(2))
        k, v = (torch.from_numpy(rs.randn(b, sk, h, d).astype(
            np.float32)).to(card, dtype) for _ in range(2))
        scale = 1.0 / math.sqrt(d)
        counts = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches)
        o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
        grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, causal, scale)
        torch.cuda.synchronize()
        assert (fm.fwd_launches, fm.dq_launches, fm.dkv_launches) == tuple(
            c + 1 for c in counts), case
        tidx = fm.prepare_indices(idx, q, k, causal)
        ro, rlse = fm.flashmask_fwd_reference(q, k, v, tidx, causal, scale)
        assert _close(o, ro, dtype), case
        assert float((lse - rlse).abs().max()) <= 1e-3, case
        want = fm.flashmask_bwd_reference(q, k, v, o, lse, do, tidx, causal,
                                          scale)
        for name, got, ref, like in zip(("dq", "dk", "dv"), grads, want,
                                        (q, k, v)):
            assert got.dtype == dtype and got.shape == like.shape, (case,
                                                                    name)
            assert bool(torch.isfinite(got.float()).all()), (case, name)
            assert _close(got, ref, dtype), (case, name)
        dead = fm.disallowed(tidx, sq, sk, causal).expand(
            b, h, sq, sk).all(-1).transpose(1, 2)
        assert (kind == "masked_rows") == bool(dead.any()), case
        assert float(o[dead].float().abs().sum()) == 0.0, case
        assert float(grads[0][dead].float().abs().sum()) == 0.0, case


def test_tensor_core_forward_over_layouts(card):
    """bf16 K5 runs on the tensor cores (wgmma fed by TMA) over every
    documented layout, Hm = 1 and Hm = H, at every head dim: O within
    2e-2 plus one bf16 step (2^-7 of the value) of the plain version, lse
    within 1e-3, O exactly 0 on fully masked rows, one launch and no TMA
    copy each; its blocks skip k tiles of packed documents and compute no
    more than the causal bound's."""
    rs = np.random.RandomState(2)
    for kind, causal in (("doc", True), ("share_question", True),
                         ("masked_rows", True), ("window", False)):
        for hm in (1, 2):
            for d in fa.HEAD_DIMS:
                b, s, h = 1, 192, 2
                if kind == "share_question":  # [LTS, LTE]: three answers
                    idx = np.full((b, hm, s, 2), s - 24, np.int32)
                    for start, end in ((48, 96), (96, 140), (140, s - 24)):
                        idx[:, :, start:end, 0] = end
                else:
                    idx = _indices(rs, kind, b, hm, s, s)
                idx = torch.from_numpy(idx).to(card)
                q, k, v = (torch.from_numpy(rs.randn(b, s, h, d).astype(
                    np.float32)).to(card, torch.bfloat16) for _ in range(3))
                scale = 1.0 / math.sqrt(d)
                counts = (fm.fwd_launches, fa.tma_copies)
                o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
                torch.cuda.synchronize()
                case = (kind, hm, d)
                assert (fm.fwd_launches, fa.tma_copies) == (counts[0] + 1,
                                                            counts[1]), case
                tidx = fm.prepare_indices(idx, q, k, causal)
                ro, rlse = fm.flashmask_fwd_reference(q, k, v, tidx, causal,
                                                      scale)
                err = (o.float() - ro.float()).abs()
                assert bool((err <= 2e-2 + 2.0 ** -7 * ro.float().abs())
                            .all()), case
                assert float((lse - rlse).abs().max()) <= 1e-3, case
                dead = fm.disallowed(tidx, s, s, causal).expand(
                    b, h, s, s).all(-1).transpose(1, 2)
                assert (kind == "masked_rows") == bool(dead.any()), case
                assert float(o[dead].float().abs().sum()) == 0.0, case
                live, bound = fm.fwd_tiles(q, k, v, idx, causal, scale)
                assert 0 < live <= bound, case
                if kind == "doc":
                    assert live < bound, case


def test_flashmask_attention_differentiates_through_k5_k7(card):
    """Autograd through the entry point: one launch each of K5, K6 and K7,
    none of K1–K3, gradients equal to the plain path's on the CPU."""
    rs = np.random.RandomState(1)
    b, s, h, d = 1, 300, 4, 64
    arrays = [rs.randn(b, s, h, d).astype(np.float32) for _ in range(4)]
    idx = _indices(rs, "doc", b, 1, s, s)
    grads = {}
    for dev in ("cpu", card):
        q, k, v = (torch.from_numpy(a).to(dev).requires_grad_(True)
                   for a in arrays[:3])
        before = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                  fa.launches, fa.dq_launches, fa.dkv_launches)
        out = flashmask_attention(q, k, v, torch.from_numpy(idx))
        out.backward(torch.from_numpy(arrays[3]).to(dev))
        after = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                 fa.launches, fa.dq_launches, fa.dkv_launches)
        want = (1, 1, 1, 0, 0, 0) if dev is card else (0,) * 6
        assert tuple(x - y for x, y in zip(after, before)) == want, dev
        grads[str(dev)] = [out.detach().cpu()] + [t.grad.cpu()
                                                  for t in (q, k, v)]
    for got, ref in zip(grads[str(card)], grads["cpu"]):
        assert float((got - ref).abs().max()) <= 1e-4


def _share_question(b, hm, s):
    """Causal [LTS, LTE]: a question, three answers, padding."""
    idx = np.full((b, hm, s, 2), s - 24, np.int32)
    for start, end in ((48, 96), (96, 140), (140, s - 24)):
        idx[:, :, start:end, 0] = end
    return idx


def test_tensor_core_backward_over_layouts(card):
    """bf16 K6 and K7 run on the tensor cores (wgmma fed by TMA, a list of
    live tiles) over every documented layout, Hm = 1 and Hm = H, at every
    head dim: dq, dk and dv within 2e-2 plus 1e-2 of the value of the plain
    version, finite, dQ exactly 0 on fully masked rows, one launch each and
    no TMA copy; their blocks skip tiles of packed documents and compute no
    more than their causal bounds'."""
    rs = np.random.RandomState(3)
    for kind, causal in (("doc", True), ("share_question", True),
                         ("masked_rows", True), ("window", False)):
        for hm in (1, 2):
            for d in fa.HEAD_DIMS:
                b, s, h = 1, 320, 2
                idx = (_share_question(b, hm, s) if kind == "share_question"
                       else _indices(rs, kind, b, hm, s, s))
                idx = torch.from_numpy(idx).to(card)
                q, k, v, do = (torch.from_numpy(rs.randn(b, s, h, d).astype(
                    np.float32)).to(card, torch.bfloat16) for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
                counts = (fm.dq_launches, fm.dkv_launches, fa.tma_copies)
                grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, causal,
                                         scale)
                torch.cuda.synchronize()
                case = (kind, hm, d)
                assert (fm.dq_launches, fm.dkv_launches, fa.tma_copies) == (
                    counts[0] + 1, counts[1] + 1, counts[2]), case
                tidx = fm.prepare_indices(idx, q, k, causal)
                want = fm.flashmask_bwd_reference(q, k, v, o, lse, do, tidx,
                                                  causal, scale)
                for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
                    assert bool(torch.isfinite(got.float()).all()), (case,
                                                                     name)
                    assert _close(got, ref, torch.bfloat16), (case, name)
                dead = fm.disallowed(tidx, s, s, causal).expand(
                    b, h, s, s).all(-1).transpose(1, 2)
                assert (kind == "masked_rows") == bool(dead.any()), case
                assert float(grads[0][dead].float().abs().sum()) == 0.0, case
                for live, bound in fm.bwd_tiles(q, k, v, o, lse, do, idx,
                                                causal, scale):
                    assert 0 < live <= bound, case
                    if kind == "doc":
                        assert live < bound, case


def test_tensor_core_backward_reads_bshd_in_place(card):
    """Through ``flashmask_attention`` in bf16 the backward launches K6
    and K7 once each, K1–K3 never, and copies nothing for TMA; an operand
    whose head stride is not a multiple of 16 bytes is copied and counted,
    and its gradients still match the plain version's."""
    rs = np.random.RandomState(4)
    b, s, h, d = 1, 384, 4, 128
    idx = torch.from_numpy(_indices(rs, "doc", b, 1, s, s)).to(card)
    q, k, v, do = (torch.from_numpy(rs.randn(b, s, h, d).astype(np.float32))
                   .to(card, torch.bfloat16) for _ in range(4))
    for t in (q, k, v):
        t.requires_grad_(True)
    before = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches, fa.launches,
              fa.dq_launches, fa.dkv_launches, fa.tma_copies)
    flashmask_attention(q, k, v, idx).backward(do)
    torch.cuda.synchronize()
    after = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches, fa.launches,
             fa.dq_launches, fa.dkv_launches, fa.tma_copies)
    assert tuple(x - y for x, y in zip(after, before)) == (1, 1, 1, 0, 0, 0,
                                                           0)
    # a head stride of 132 elements (264 bytes) is not a multiple of 16
    # bytes: TMA cannot read q in place
    wide = torch.zeros(b, s, h, d + 4, dtype=torch.bfloat16, device=card)
    wide[..., :d] = q.detach()
    qs = wide[..., :d]
    assert not fa.tma_aligned(qs.shape, qs.stride(), qs.data_ptr(), qs.dtype)
    scale = 1.0 / math.sqrt(d)
    kd, vd = k.detach(), v.detach()
    o, lse = fm.flashmask_fwd(q.detach(), kd, vd, idx, True, scale)
    copies = fa.tma_copies
    grads = fm.flashmask_bwd(qs, kd, vd, o, lse, do, idx, True, scale)
    torch.cuda.synchronize()
    assert fa.tma_copies == copies + 1
    tidx = fm.prepare_indices(idx, q, k, True)
    want = fm.flashmask_bwd_reference(q.detach(), kd, vd, o, lse, do, tidx,
                                      True, scale)
    for got, ref in zip(grads, want):
        assert _close(got, ref, torch.bfloat16)


def test_f32_dkv_lists_a_long_sequence_in_rounds(card):
    """f32 K7 (3xTF32) lists at most as many q tiles at once as its shared
    memory holds (4534 16-row tiles at D = 128), so a block with more walks
    them in rounds. At S = 80000 in documents of 1000 tokens the first
    key blocks take two rounds: each document's dk and dv (and dq) match
    the plain backward run on that document alone, within 1e-4."""
    rs = np.random.RandomState(5)
    s, n, d = 80000, 1000, 128
    idx = torch.from_numpy(_indices_docs(s, n)).to(card)
    q, k, v, do = (torch.from_numpy(rs.randn(1, s, 1, d).astype(np.float32))
                   .to(card) for _ in range(4))
    scale = 1.0 / math.sqrt(d)
    o, lse = fm.flashmask_fwd(q, k, v, idx, True, scale)
    counts = fm.dkv_launches
    grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, True, scale)
    torch.cuda.synchronize()
    assert fm.dkv_launches == counts + 1
    assert fm.kernel_for("bwd_dkv", torch.float32) == "bwd_dkv_tf32"
    one = torch.from_numpy(_indices_docs(n, n)).to(card)
    for doc in (0, 3, s // n - 1):
        rows = slice(doc * n, (doc + 1) * n)
        want = fm.flashmask_bwd_reference(
            q[:, rows], k[:, rows], v[:, rows], o[:, rows],
            lse[..., rows].contiguous(), do[:, rows], one, True, scale)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
            assert bool(torch.isfinite(got[:, rows]).all()), (doc, name)
            assert _close(got[:, rows], ref, torch.float32), (doc, name)
    _, (live, bound) = fm.bwd_tiles(q, k, v, o, lse, do, idx, True, scale)
    assert 0 < live < bound


def _indices_docs(s, n):
    """Causal [1, 1, s, 1]: documents of n tokens."""
    ends = np.minimum(np.arange(s) // n * n + n, s)
    return ends.reshape(1, 1, s, 1).astype(np.int32)


def _float64_forward_backward(q, k, v, o, lse, do, tidx, causal, scale):
    """The plain forward and backward computed in float64: ``(o, lse, dq,
    dk, dv)``, the backward from the kernel's own (o, lse)."""
    f64 = [t.double() for t in (q, k, v, o, lse, do)]
    ro, rlse = fm.flashmask_fwd_reference(*f64[:3], tidx, causal, scale)
    return (ro, rlse, *fm.flashmask_bwd_reference(*f64, tidx, causal, scale))


def test_f32_tensor_core_kernels_over_layouts(card):
    """f32 K5 and K6 run on the tensor cores in 3xTF32 (wgmma fed by TMA, a
    list of live k tiles) over every documented layout, Hm = 1 and Hm = H,
    at every head dim: O, lse and dq within 1e-4 of the plain versions
    computed in float64 (and dk, dv of f32 K7), finite, O and dQ exactly 0
    on fully masked rows, one launch each and no TMA copy; their blocks
    skip k tiles of packed documents and compute no more than their causal
    bounds'."""
    rs = np.random.RandomState(6)
    for kind, causal in (("doc", True), ("share_question", True),
                         ("masked_rows", True), ("window", False)):
        for hm in (1, 2):
            for d in fa.HEAD_DIMS:
                b, s, h = 1, 320, 2
                idx = (_share_question(b, hm, s) if kind == "share_question"
                       else _indices(rs, kind, b, hm, s, s))
                idx = torch.from_numpy(idx).to(card)
                q, k, v, do = (torch.from_numpy(rs.randn(b, s, h, d).astype(
                    np.float32)).to(card) for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                counts = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                          fa.tma_copies)
                o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
                grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, causal,
                                         scale)
                torch.cuda.synchronize()
                case = (kind, hm, d)
                assert (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                        fa.tma_copies) == (counts[0] + 1, counts[1] + 1,
                                           counts[2] + 1, counts[3]), case
                tidx = fm.prepare_indices(idx, q, k, causal)
                want = _float64_forward_backward(q, k, v, o, lse, do, tidx,
                                                 causal, scale)
                for name, got, ref in zip(("o", "lse", "dq", "dk", "dv"),
                                          (o, lse, *grads), want):
                    assert got.dtype == torch.float32, (case, name)
                    assert bool(torch.isfinite(got).all()), (case, name)
                    if name == "lse":
                        # a fully masked row's -1e30 + log(1e-30), which
                        # float64 holds apart from float32's nearest value
                        seen = ref > -1e29
                        assert bool((got[~seen] <= -1e29).all()), case
                        got, ref = got[seen], ref[seen]
                    err = float((got.double() - ref).abs().max())
                    assert err <= 1e-4, (case, name, err)
                dead = fm.disallowed(tidx, s, s, causal).expand(
                    b, h, s, s).all(-1).transpose(1, 2)
                assert (kind == "masked_rows") == bool(dead.any()), case
                assert float(o[dead].abs().sum()) == 0.0, case
                assert float(grads[0][dead].abs().sum()) == 0.0, case
                counted = [fm.fwd_tiles(q, k, v, idx, causal, scale),
                           *fm.bwd_tiles(q, k, v, o, lse, do, idx, causal,
                                         scale)]
                for live, bound in counted:
                    assert 0 < live <= bound, case
                    if kind == "doc":
                        assert live < bound, case


def test_f32_fwd_and_dq_list_a_long_sequence_in_rounds(card):
    """f32 K5 and K6 list at most as many k tiles at once as their shared
    memory holds (about 500: 32000 keys for K5 at D = 64, 16000 for K6 and
    for K5 at D = 128), so a block with more votes, lists and walks them in
    rounds, the TMA ring going on across rounds. At S = 40000 in two
    documents of 20000 tokens, the second document's last blocks take
    rounds with no live tile and rounds with many: each document's O, lse
    and dq match the float64 plain versions run on that document alone,
    within 1e-4."""
    rs = np.random.RandomState(7)
    s, n = 40000, 20000
    idx = torch.from_numpy(_indices_docs(s, n)).to(card)
    one = torch.from_numpy(_indices_docs(n, n)).to(card)
    for d in (64, 128):
        q, k, v, do = (torch.from_numpy(rs.randn(1, s, 1, d).astype(
            np.float32)).to(card) for _ in range(4))
        scale = 1.0 / math.sqrt(d)
        counts = (fm.fwd_launches, fm.dq_launches)
        o, lse = fm.flashmask_fwd(q, k, v, idx, True, scale)
        dq = fm.flashmask_bwd(q, k, v, o, lse, do, idx, True, scale)[0]
        torch.cuda.synchronize()
        assert (fm.fwd_launches, fm.dq_launches) == (counts[0] + 1,
                                                     counts[1] + 1)
        for doc in range(s // n):
            rows = slice(doc * n, (doc + 1) * n)
            part = [t[:, rows] for t in (q, k, v, o)]
            want = _float64_forward_backward(
                *part, lse[..., rows].contiguous(), do[:, rows], one, True,
                scale)
            for name, got, ref in zip(("o", "lse", "dq"),
                                      (o[:, rows], lse[..., rows],
                                       dq[:, rows]), want):
                assert bool(torch.isfinite(got).all()), (d, doc, name)
                err = float((got.double() - ref).abs().max())
                assert err <= 1e-4, (d, doc, name, err)
            del want
            torch.cuda.empty_cache()
        live, bound = fm.fwd_tiles(q, k, v, idx, True, scale)
        assert 0 < live < bound, d
        (live, bound), _ = fm.bwd_tiles(q, k, v, o, lse, do, idx, True,
                                        scale)
        assert 0 < live < bound, d


def _close_fp16(got, want, atol, rtol):
    err = (got.float() - want.float()).abs()
    return bool((err <= atol + rtol * want.float().abs()).all())


def test_float16_kernels_over_layouts(card):
    """float16 K5, K6 and K7 (the bf16 tensor-core sources instantiated for
    __half) take fp16 q, k, v and dO and write O, dq, dk and dv in fp16,
    over every documented layout, Hm = 1 and Hm = H, at every head dim,
    against their plain versions at the bf16 gates divided by 8 (fp16's
    step is 2^-10 of the value, bf16's 2^-7): O within 2.5e-3 plus 2^-10 of
    the value, lse within 1.25e-4, the gradients within 2.5e-3 plus
    1.25e-3 of the value; finite, exactly 0 on fully masked rows (O and
    dQ), one launch each and no TMA copy. Before the fp16 instantiations
    the wrappers raised ``TypeError`` here."""
    rs = np.random.RandomState(4)
    for kind, causal in (("doc", True), ("share_question", True),
                         ("masked_rows", True), ("window", False)):
        for hm in (1, 2):
            for d in fa.HEAD_DIMS:
                b, s, h = 1, 320, 2
                idx = (_share_question(b, hm, s) if kind == "share_question"
                       else _indices(rs, kind, b, hm, s, s))
                idx = torch.from_numpy(idx).to(card)
                q, k, v, do = (torch.from_numpy(rs.randn(b, s, h, d).astype(
                    np.float32)).to(card, torch.float16) for _ in range(4))
                scale = 1.0 / math.sqrt(d)
                counts = (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                          fa.tma_copies)
                o, lse = fm.flashmask_fwd(q, k, v, idx, causal, scale)
                grads = fm.flashmask_bwd(q, k, v, o, lse, do, idx, causal,
                                         scale)
                torch.cuda.synchronize()
                case = (kind, hm, d)
                assert (fm.fwd_launches, fm.dq_launches, fm.dkv_launches,
                        fa.tma_copies) == (counts[0] + 1, counts[1] + 1,
                                           counts[2] + 1, counts[3]), case
                assert o.dtype == torch.float16 and lse.dtype == torch.float32
                tidx = fm.prepare_indices(idx, q, k, causal)
                ro, rlse = fm.flashmask_fwd_reference(q, k, v, tidx, causal,
                                                      scale)
                assert _close_fp16(o, ro, 2.5e-3, 2.0 ** -10), case
                assert float((lse - rlse).abs().max()) <= 1.25e-4, case
                want = fm.flashmask_bwd_reference(q, k, v, o, lse, do, tidx,
                                                  causal, scale)
                for name, got, ref in zip(("dq", "dk", "dv"), grads, want):
                    assert got.dtype == torch.float16, (case, name)
                    assert bool(torch.isfinite(got.float()).all()), (case,
                                                                     name)
                    assert _close_fp16(got, ref, 2.5e-3, 1.25e-3), (case,
                                                                    name)
                dead = fm.disallowed(tidx, s, s, causal).expand(
                    b, h, s, s).all(-1).transpose(1, 2)
                assert float(o[dead].float().abs().sum()) == 0.0, case
                assert float(grads[0][dead].float().abs().sum()) == 0.0, case
