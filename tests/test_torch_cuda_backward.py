"""On-card tests of the port's flash-attention backward (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_backward.py

K1 with dropout, K2 and K3 are held against their plain PyTorch versions on
the same card, on q, k and v sliced from a packed ``[B, S, H, 3, D]``
tensor as the GPT attention hands them over; bf16 K1, K2 and K3 (the
tensor-core kernels) also over every head dim, and on operands TMA cannot
read in place, which the wrapper copies. Tolerances: f32 1e-4
absolute; bf16 2e-2 absolute plus 1e-2 of the value (the outputs round
once to bf16, whose step is at most 2⁻⁷ of the value).
"""
import math

import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.gpt import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt_tiny)
from paddle_tpu_torch.ops.cuda import flash_attention as fa

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


CASES = [
    # B, Sq, Sk, H, D, dtype, causal, dropout
    (2, 100, 100, 3, 64, torch.float32, True, 0.0),    # ragged S
    (1, 77, 130, 2, 32, torch.float32, False, 0.1),    # Sq != Sk
    (1, 64, 128, 2, 16, torch.float32, True, 0.0),     # keys no query sees
    (1, 130, 64, 2, 64, torch.float32, True, 0.2),     # Sq > Sk
    (2, 200, 200, 2, 128, torch.bfloat16, True, 0.1),
    (1, 33, 33, 4, 64, torch.bfloat16, False, 0.0),
]


def test_kernels_match_plain_on_packed_qkv(card):
    rs = np.random.RandomState(0)
    seed = torch.tensor([1234], dtype=torch.int32, device=card)
    for case in CASES:
        b, sq, sk, h, d, dtype, causal, dropout = case
        qp = torch.from_numpy(rs.randn(b, sq, h, 3, d).astype(np.float32))
        kp = torch.from_numpy(rs.randn(b, sk, h, 3, d).astype(np.float32))
        qp, kp = qp.to(card, dtype), kp.to(card, dtype)
        q, k, v = qp[..., 0, :], kp[..., 1, :], kp[..., 2, :]
        do = torch.from_numpy(rs.randn(b, sq, h, d).astype(np.float32)).to(
            card, dtype)
        scale = 1.0 / math.sqrt(d)
        counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
        dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, causal,
                                            scale, dropout)
        torch.cuda.synchronize()
        assert (fa.launches, fa.dq_launches, fa.dkv_launches) == tuple(
            c + 1 for c in counts), case
        ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                    dropout, seed)
        assert _close(o, ro, dtype), case
        assert float((lse - rlse).abs().max()) <= 1e-3, case
        # the backward from the same (o, lse), so K2/K3 alone are compared
        want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                                causal, scale, dropout)
        for name, got, ref, like in zip(("dq", "dk", "dv"), (dq, dk, dv),
                                        want, (q, k, v)):
            assert got.dtype == dtype and got.shape == like.shape, (case,
                                                                    name)
            assert _close(got, ref, dtype), (case, name)
        if causal and sk > sq:
            assert float(dk[:, sq:].abs().max()) == 0.0
            assert float(dv[:, sq:].abs().max()) == 0.0


def _bf16_case(b, sq, sk, h, d, causal, dropout, rs, card, seed):
    """K1 and K2 (bf16, the tensor-core kernels) against their plain
    versions on one case; returns the outputs."""
    q, k, v, do = (torch.from_numpy(rs.randn(b, n, h, d).astype(np.float32))
                   .to(card, torch.bfloat16) for n in (sq, sk, sk, sq))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
    dq, _, _ = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, causal,
                                      scale, dropout)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, causal, scale,
                                                dropout, seed)
    rdq, _, _ = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed,
                                                 causal, scale, dropout)
    case = (b, sq, sk, h, d, causal, dropout)
    assert _close(o, ro, torch.bfloat16), case
    assert float((lse - rlse).abs().max()) <= 1e-3, case
    assert _close(dq, rdq, torch.bfloat16), case
    assert float(rdq.float().abs().max()) > 0, case
    return q, k, v, do, o, lse, dq


def test_tensor_core_kernels_match_plain_over_head_dims(card):
    """bf16 K1 and K2 run on the tensor cores (wgmma fed by TMA) at every
    head dim, with ragged S, Sq != Sk and dropout 0.1, within the bf16
    tolerance of the plain versions, one launch each."""
    rs = np.random.RandomState(5)
    seed = torch.tensor([99], dtype=torch.int32, device=card)
    for d in fa.HEAD_DIMS:
        for b, sq, sk, causal, dropout in ((2, 200, 200, True, 0.1),
                                           (1, 77, 130, False, 0.1),
                                           (1, 130, 64, True, 0.0),
                                           (1, 300, 300, False, 0.0)):
            counts = (fa.launches, fa.dq_launches, fa.tma_copies)
            _bf16_case(b, sq, sk, 2, d, causal, dropout, rs, card, seed)
            assert (fa.launches, fa.dq_launches, fa.tma_copies) == (
                counts[0] + 1, counts[1] + 1, counts[2])


def test_misaligned_operands_are_copied_for_tma_not_routed_away(card):
    """A bf16 view TMA cannot read in place (base 2 bytes off 16) is copied
    contiguous and counted in ``tma_copies``; the tensor-core kernels still
    run (one launch each) and agree with the plain versions."""
    b, s, h, d = 1, 150, 2, 64
    n = b * s * h * d
    rs = np.random.RandomState(6)
    seed = torch.tensor([7], dtype=torch.int32, device=card)
    flats = [torch.from_numpy(rs.randn(n + 1).astype(np.float32)).to(
        card, torch.bfloat16) for _ in range(4)]
    q, k, v, do = (f[1:].view(b, s, h, d) for f in flats)
    assert not fa.tma_aligned(q.shape, q.stride(), q.data_ptr(), q.dtype)
    counts = (fa.launches, fa.dq_launches, fa.tma_copies)
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_attention_fwd(q, k, v, True, scale)
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, True,
                                        scale)
    torch.cuda.synchronize()
    # q, k, v for K1; q, k, v, dO for K2
    assert (fa.launches, fa.dq_launches, fa.tma_copies) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 7)
    ro, rlse = fa.flash_attention_fwd_reference(q, k, v, True, scale)
    assert _close(o, ro, torch.bfloat16)
    assert float((lse - rlse).abs().max()) <= 1e-3
    want = fa.flash_attention_bwd_reference(q, k, v, o, lse, do, seed, True,
                                            scale)
    for got, ref in zip((dq, dk, dv), want):
        assert _close(got, ref, torch.bfloat16)


def test_tensor_core_dkv_matches_plain_over_head_dims(card):
    """bf16 K3 runs on the tensor cores (wgmma fed by TMA) at every head
    dim, with ragged S, Sq != Sk, keys no query sees (dK = dV = 0, written)
    and dropout 0.1, within the bf16 tolerance of the plain version, one
    launch each; GPT's packed-qkv slices are read in place."""
    rs = np.random.RandomState(8)
    seed = torch.tensor([41], dtype=torch.int32, device=card)
    for d in fa.HEAD_DIMS:
        for b, sq, sk, causal, dropout in ((2, 200, 200, True, 0.1),
                                           (1, 77, 130, False, 0.1),
                                           (1, 64, 200, True, 0.0),
                                           (1, 130, 64, True, 0.0),
                                           (1, 300, 300, False, 0.0)):
            qp = torch.from_numpy(rs.randn(b, sq, 2, 3, d).astype(
                np.float32)).to(card, torch.bfloat16)
            kp = torch.from_numpy(rs.randn(b, sk, 2, 3, d).astype(
                np.float32)).to(card, torch.bfloat16)
            q, k, v = qp[..., 0, :], kp[..., 1, :], kp[..., 2, :]
            do = torch.from_numpy(rs.randn(b, sq, 2, d).astype(
                np.float32)).to(card, torch.bfloat16)
            scale = 1.0 / math.sqrt(d)
            o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout,
                                            seed)
            counts = (fa.dkv_launches, fa.tma_copies)
            _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, seed,
                                               causal, scale, dropout)
            torch.cuda.synchronize()
            case = (d, b, sq, sk, causal, dropout)
            assert (fa.dkv_launches, fa.tma_copies) == (counts[0] + 1,
                                                        counts[1]), case
            _, rdk, rdv = fa.flash_attention_bwd_reference(
                q, k, v, o, lse, do, seed, causal, scale, dropout)
            for got, ref in ((dk, rdk), (dv, rdv)):
                assert got.dtype == torch.bfloat16 and got.shape == ref.shape
                assert bool(torch.isfinite(got.float()).all()), case
                assert _close(got, ref, torch.bfloat16), case
            if causal and sk > sq:
                assert float(dk[:, sq:].float().abs().max()) == 0.0, case
                assert float(dv[:, sq:].float().abs().max()) == 0.0, case


def test_f32_dkv_matches_float64_over_head_dims(card):
    """f32 K3 runs on the tensor cores in 3xTF32 (wgmma fed by TMA) at every
    head dim, with ragged S, Sq != Sk, keys no query sees (dK = dV = 0,
    written) and dropout 0.1, one launch each, reading GPT's packed-qkv
    slices in place: dk and dv within 1e-4 of the plain version and of the
    plain version computed in float64. A view TMA cannot read in place
    (base 4 bytes off 16) is copied once for K2 and K3 and counted."""
    rs = np.random.RandomState(9)
    seed = torch.tensor([43], dtype=torch.int32, device=card)

    def check(q, k, v, do, causal, dropout, copies, case):
        scale = 1.0 / math.sqrt(q.shape[-1])
        o, lse = fa.flash_attention_fwd(q, k, v, causal, scale, dropout, seed)
        counts = (fa.dkv_launches, fa.tma_copies)
        _, dk, dv = fa.flash_attention_bwd(q, k, v, o, lse, do, seed, causal,
                                           scale, dropout)
        torch.cuda.synchronize()
        assert (fa.dkv_launches, fa.tma_copies) == (counts[0] + 1,
                                                    counts[1] + copies), case
        _, rdk, rdv = fa.flash_attention_bwd_reference(
            q, k, v, o, lse, do, seed, causal, scale, dropout)
        _, xdk, xdv = fa.flash_attention_bwd_reference(
            *(t.double() for t in (q, k, v, o, lse, do)), seed, causal, scale,
            dropout)
        for got, ref, exact in ((dk, rdk, xdk), (dv, rdv, xdv)):
            assert got.dtype == torch.float32 and got.shape == ref.shape
            assert bool(torch.isfinite(got).all()), case
            assert _close(got, ref, torch.float32), case
            assert float((got.double() - exact).abs().max()) <= 1e-4, case
        sq, sk = q.shape[1], k.shape[1]
        if causal and sk > sq:
            assert float(dk[:, sq:].abs().max()) == 0.0, case
            assert float(dv[:, sq:].abs().max()) == 0.0, case

    for d in fa.HEAD_DIMS:
        for b, sq, sk, causal, dropout in ((2, 200, 200, True, 0.1),
                                           (1, 77, 130, False, 0.1),
                                           (1, 64, 200, True, 0.0),
                                           (1, 130, 64, True, 0.0),
                                           (1, 300, 300, False, 0.0)):
            qp = torch.from_numpy(rs.randn(b, sq, 2, 3, d).astype(
                np.float32)).to(card)
            kp = torch.from_numpy(rs.randn(b, sk, 2, 3, d).astype(
                np.float32)).to(card)
            do = torch.from_numpy(rs.randn(b, sq, 2, d).astype(
                np.float32)).to(card)
            check(qp[..., 0, :], kp[..., 1, :], kp[..., 2, :], do, causal,
                  dropout, 0, (d, b, sq, sk, causal, dropout))
    b, s, h, d = 1, 150, 2, 64
    flats = [torch.from_numpy(rs.randn(b * s * h * d + 1).astype(
        np.float32)).to(card) for _ in range(4)]
    q, k, v, do = (f[1:].view(b, s, h, d) for f in flats)
    assert not fa.tma_aligned(q.shape, q.stride(), q.data_ptr(), q.dtype)
    check(q, k, v, do, True, 0.0, 4, "misaligned")


def _grads(model, ids):
    loss = GPTPretrainingCriterion(model.config)(model(ids), ids)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def test_gpt_tiny_gradients_reach_qkv_proj_on_the_card(card):
    """Training-mode GPT on the card differentiates through K1–K3: the
    qkv projection's gradient matches the CPU plain path within 1e-4."""
    cfg = gpt_tiny()
    gpu = GPTForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    cpu = GPTForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(3))
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 100))
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches)
    loss_gpu, g_gpu = _grads(gpu.train(), torch.from_numpy(ids).to(card))
    torch.cuda.synchronize()
    assert (fa.launches - counts[0], fa.dq_launches - counts[1],
            fa.dkv_launches - counts[2]) == (2, 2, 2)
    loss_cpu, g_cpu = _grads(cpu.train(), torch.from_numpy(ids))
    assert abs(loss_gpu.item() - loss_cpu.item()) <= 1e-4
    for name, want in g_cpu.items():
        got = g_gpu[name].cpu()
        assert float((got - want).abs().max()) <= 1e-4, name
    qkv = g_gpu["gpt.h.0.attn.qkv_proj.weight"]
    assert float(qkv.abs().max()) > 0


def test_dropout_training_is_reproducible_from_the_seed(card):
    """Two models from the same dropout seed give bitwise-equal losses;
    another seed gives other ones."""
    cfg = gpt_tiny(hidden_dropout_prob=0.1, attention_dropout_prob=0.1)
    ids = torch.from_numpy(
        np.random.RandomState(2).randint(0, cfg.vocab_size, (2, 64))).to(card)
    losses = []
    for dropout_seed in (5, 5, 6):
        model = GPTForCausalLM(cfg, dropout_seed=dropout_seed,
                               generator=torch.Generator().manual_seed(0))
        loss, _ = _grads(model.train(), ids)
        losses.append(loss.item())
    assert losses[0] == losses[1]
    assert losses[0] != losses[2]
