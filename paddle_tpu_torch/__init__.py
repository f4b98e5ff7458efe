"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA Hopper.

A package of its own beside the JAX one: it imports ``torch`` and never
``jax`` or ``paddle_tpu``. Module paths mirror ``paddle_tpu``'s so each
piece's counterpart is easy to find. Every entry point runs on the GPU
(``device="cuda"``) unless the caller asks for ``device="cpu"``, and
every TPU kernel on the ported path is a hand-written Hopper kernel under
``ops/cuda/csrc`` with a plain PyTorch version beside it.

Ported so far: GPT paged decode serving (``serving.DecodeEngine`` over
``models.gpt.GPTForCausalLM``) with the flash-attention forward kernel;
the GPT and Llama training steps (``jit.TrainStep``, ``optimizer.AdamW``,
``amp`` O2) with the flash-attention backward kernels and the RMSNorm
kernel; the batch serving tier: ``jit.save``/``jit.load`` over
``torch.export``, ``inference.Predictor`` with one CUDA graph a
(batch, seq) rung, and ``serving.ServingEngine``; the training-step API:
``optimizer.lr`` schedulers, parameter groups, ``nn.ClipGradBy*``, the ten
optimizers, ``amp`` O1/O2 in bf16 or fp16 with ``amp.GradScaler``, and
``nn.CrossEntropyLoss``.
"""
from . import framework, inference, jit, serving, static
from .device import DEFAULT_DEVICE, resolve_device

__all__ = ["DEFAULT_DEVICE", "framework", "inference", "jit",
           "resolve_device", "serving", "static"]
