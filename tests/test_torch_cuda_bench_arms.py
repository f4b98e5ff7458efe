"""``bench.py``'s GPT arm on the card (marker ``cuda``), read as text with
only its imports renamed, as ``chip_smoke.py`` phase 21 reads it, at its
CPU size (``on_tpu=False``: gpt_tiny, 4 × 128, f32) after
``paddle.set_device("gpu")``: every step after the first a replay, K1–K3
launched, the loss stream bit for bit the hand-built ``TrainStep``'s on the
card. Skips on hosts without a GPU. This file imports no JAX:

    python -m pytest -p no:cacheprovider --noconftest -m cuda tests/test_torch_cuda_bench_arms.py
"""
import importlib.util
from pathlib import Path

import pytest
import torch

import paddle_tpu_torch as paddle
from paddle_tpu_torch import device as device_mod
from paddle_tpu_torch.jit import TrainStep
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.optimizer import AdamW

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _gen():
    return torch.Generator().manual_seed(0)


def test_gpt_arm_at_cpu_size_on_the_card(monkeypatch):
    """The GPT arm at its CPU size (gpt_tiny, 4 × 128, f32) on the GPU:
    every step after the first a replay, the losses bit for bit the
    hand-built step's on the card, K1–K3 launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from paddle_tpu_torch.ops.cuda import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.setattr(device_mod, "_chosen", None)
    paddle.set_device("gpu")
    fa.launches = 0
    local, losses = _chip_smoke().run_bench_arm("bench_gpt", on_tpu=False)
    assert fa.launches > 0
    assert local["step"].stats == {"compiled_steps": 5, "eager_steps": 1}
    cfg = gpt.gpt_tiny()
    model = gpt.GPTForCausalLM(cfg, generator=_gen())
    crit = gpt.GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters())
    step = TrainStep(model=model, optimizer=opt,
                     loss_fn=lambda ids: crit(model(ids), ids))
    ids = local["ids"].as_subclass(torch.Tensor)
    want = [step(ids) for _ in range(6)]
    for got, exp in zip(losses, want):
        assert torch.equal(got.as_subclass(torch.Tensor),
                           exp.as_subclass(torch.Tensor))
