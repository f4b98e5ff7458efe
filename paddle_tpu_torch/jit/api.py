"""``TrainStep``, eager (port of ``paddle_tpu/jit/api.py``).

The JAX ``TrainStep`` compiles forward, backward and the optimizer update
into one XLA program. Here a call runs them eagerly, in the same order:
``loss = loss_fn(*batch)``, ``loss.backward()``, ``optimizer.step()``,
``optimizer.clear_grad()``, and returns the loss. The learning rate rides
in the optimizer's device scalar, rewritten only when ``get_lr()``
changes, as the JAX step's LR cell is. A CUDA graph or ``torch.compile``
of the step is later work (ROADMAP.md, queue 1).

Not ported, each raising ``NotImplementedError``: gradient accumulation
(``grad_accum_steps != 1``), shape bucketing (``bucket_axes``) and
``sharding``.
"""
from __future__ import annotations

from typing import Callable, Optional

from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["TrainStep"]


class TrainStep:
    """One training step per call: ``loss_fn(*batch)`` builds the loss from
    the model; ``device`` (default CUDA) is where the step runs and where
    the model's parameters must lie."""

    def __init__(self, model=None, optimizer=None,
                 loss_fn: Optional[Callable] = None,
                 grad_accum_steps: int = 1, bucket_axes=None, sharding=None,
                 *, device=DEFAULT_DEVICE):
        if grad_accum_steps != 1:
            raise NotImplementedError(
                "gradient accumulation is not ported yet (ROADMAP.md, "
                "queue 1)")
        if bucket_axes:
            raise NotImplementedError(
                "TrainStep shape bucketing is not ported yet (ROADMAP.md, "
                "queue 1)")
        if sharding is not None:
            raise NotImplementedError(
                "TrainStep sharding is not ported yet (ROADMAP.md, queue 1)")
        if optimizer is None or loss_fn is None:
            raise ValueError("TrainStep needs an optimizer and a loss_fn")
        dev = resolve_device(device)
        if model is not None:
            for p in model.parameters():
                if p.device.type != dev.type:
                    raise ValueError(f"the model lies on {p.device}, the "
                                     f"step was asked for {dev}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn

    def __call__(self, *batch):
        loss = self.loss_fn(*batch)
        loss.backward()
        self.optimizer.step()
        self.optimizer.clear_grad()
        return loss.detach()
