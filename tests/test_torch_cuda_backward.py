"""On-card tests of the port's flash-attention backward (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_backward.py

K1 with dropout, K2 and K3 are held against their plain PyTorch versions on
the same card, on q, k and v sliced from a packed ``[B, S, H, 3, D]``
tensor as the GPT attention hands them over. Tolerances: f32 1e-4
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
