"""On-card tests of the port's RMSNorm kernel and Llama (marker ``cuda``).

They need an NVIDIA Hopper GPU and ``nvcc``, and skip on hosts without a
GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_llama.py

K4 is held against its plain PyTorch version on the same card: f32 within
1e-5 of each row's largest output; bf16 within one bf16 step (2⁻⁷ of the
value) plus 1e-3. ``llama_tiny``'s gradients on the card (K1–K4) are held
against the CPU plain path within 1e-4, in f32 with TF32 off.
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                           LlamaPretrainingCriterion,
                                           llama_tiny)
from paddle_tpu_torch.ops.cuda import flash_attention as fa
from paddle_tpu_torch.ops.cuda import rms_norm as rms

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        top = want.abs().amax(dim=-1, keepdim=True)
        return bool((err <= 1e-5 * top).all())
    return bool((err <= 2.0 ** -7 * want.abs() + 1e-3).all())


CASES = [
    # shape, x dtype, w dtype, strided rows
    ((4, 2048, 768), torch.bfloat16, torch.bfloat16, False),
    ((1000, 768), torch.float32, torch.float32, False),   # ragged rows
    ((256, 4096), torch.bfloat16, torch.bfloat16, False),  # block per row
    ((8, 100), torch.float32, torch.float32, False),       # odd d
    ((9, 100), torch.bfloat16, torch.float32, False),      # mixed types
    ((5, 3000), torch.float32, torch.bfloat16, True),      # strided rows
]


def test_kernel_matches_plain(card):
    rs = np.random.RandomState(0)
    for shape, xt, wt, strided in CASES:
        d = shape[-1]
        x = torch.from_numpy(rs.randn(*shape).astype(np.float32) * 3)
        if strided:  # rows 2d apart: a view, no copy
            x = torch.cat([x, x], dim=-1)[..., :d]
        x = x.to(card, xt)
        w = torch.from_numpy(rs.uniform(0.5, 1.5, d).astype(np.float32)).to(
            card, wt)
        before = rms.launches
        got = rms.rms_norm_fwd(x, w, 1e-5)
        torch.cuda.synchronize()
        assert rms.launches == before + 1
        want = rms.rms_norm_reference(x, w, 1e-5)
        assert got.dtype == xt and got.shape == x.shape
        assert bool(torch.isfinite(got.float()).all())
        assert _close(got, want, xt), (shape, xt, wt)


def _grads(model, ids):
    loss = LlamaPretrainingCriterion(model.config)(model(ids), ids)
    loss.backward()
    return loss, {n: p.grad for n, p in model.named_parameters()}


def test_llama_tiny_gradients_match_cpu(card):
    """Training-mode Llama on the card differentiates through K1–K4; every
    gradient matches the CPU plain path within 1e-4."""
    cfg = llama_tiny(num_attention_heads=4, num_key_value_heads=2)
    gpu = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(3))
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    ids = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 100))
    counts = (fa.launches, fa.dq_launches, fa.dkv_launches, rms.launches)
    loss_gpu, g_gpu = _grads(gpu.train(), torch.from_numpy(ids).to(card))
    torch.cuda.synchronize()
    layers = cfg.num_hidden_layers
    assert (fa.launches - counts[0], fa.dq_launches - counts[1],
            fa.dkv_launches - counts[2], rms.launches - counts[3]) == (
                layers, layers, layers, 2 * layers + 1)
    loss_cpu, g_cpu = _grads(cpu.train(), torch.from_numpy(ids))
    assert abs(loss_gpu.item() - loss_cpu.item()) <= 1e-4
    for name, want in g_cpu.items():
        got = g_gpu[name].cpu()
        assert float((got - want).abs().max()) <= 1e-4, name
