"""``TrainStep`` (port of ``paddle_tpu/jit/api.py``).

The JAX ``TrainStep`` compiles forward, backward and the optimizer update
into one donated XLA program. Here the step function runs them in the
same order: ``loss = loss_fn(*batch)``, ``loss.backward()``,
``optimizer.step()``, ``optimizer.clear_grad()``, and returns the loss;
a :class:`~.functionalize.CompiledFunction` runs it. On CUDA the first
call of each signature runs eagerly, the second captures the whole step as
one CUDA graph, and every call from then on is one replay of it, the
optimizer's update inside it one multi-tensor AdamW kernel. There is no
knob: the device decides, as the JAX package always compiles. On the CPU
every call runs eagerly.

The learning rate rides in the optimizer's device scalar, rewritten
outside the graph before a call, only when ``get_lr()`` changes, as the
JAX step's LR cell is: a scheduler stepped between calls moves it, and
the graph replays with the new value. The step count is a device scalar
that the graph advances. Gradient clipping, parameter groups and every
optimizer but ``LBFGS`` (which needs a closure, in both packages) run
inside the graph: none reads a value to the host. ``clear_grad`` sets every ``.grad`` to None, so the captured
backward allocates the gradients from the graph's pool, at the same
addresses on every replay. The model's CUDA generators (dropout) are
registered with the graph, so a replay draws what an eager step would.

``grad_accum_steps`` is accepted and read nowhere, as in the JAX
package. Not ported, each raising ``NotImplementedError``: shape
bucketing (``bucket_axes``) and ``sharding`` (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..optimizer import LBFGS
from .functionalize import CompiledFunction

__all__ = ["TrainStep"]


class TrainStep:
    """One training step per call: ``loss_fn(*batch)`` builds the loss from
    the model; ``device`` (default CUDA) is where the step runs and where
    the model's parameters must lie."""

    def __init__(self, model=None, optimizer=None,
                 loss_fn: Optional[Callable] = None,
                 grad_accum_steps: int = 1, bucket_axes=None, sharding=None,
                 *, device=DEFAULT_DEVICE):
        if bucket_axes:
            raise NotImplementedError(
                "TrainStep shape bucketing is not ported yet (ROADMAP.md, "
                "queue 1)")
        if sharding is not None:
            raise NotImplementedError(
                "TrainStep sharding is not ported yet (ROADMAP.md, queue 1)")
        if optimizer is None or loss_fn is None:
            raise ValueError("TrainStep needs an optimizer and a loss_fn")
        if isinstance(optimizer, LBFGS):
            raise TypeError("LBFGS steps through a closure: call "
                            "optimizer.step(closure) eagerly")
        dev = resolve_device(device)
        if model is not None:
            for p in model.parameters():
                if p.device.type != dev.type:
                    raise ValueError(f"the model lies on {p.device}, the "
                                     f"step was asked for {dev}")
        self.model = model
        self.optimizer = optimizer
        self.loss_fn = loss_fn
        base_key = ((lambda: "train" if model.training else "eval")
                    if model is not None else (lambda: "fn"))

        # a closure over the arguments, not over self: the cache holds the
        # function, and a cycle back to the step would keep the graphs'
        # memory alive until the garbage collector ran
        def step_fn(*batch):
            loss = loss_fn(*batch)
            loss.backward()
            optimizer.step()
            optimizer.clear_grad()
            return loss.detach()

        self._compiled = CompiledFunction(
            step_fn, static_key_fn=base_key, name="train_step", device=dev,
            generators=_cuda_generators(model))

    def __call__(self, *batch):
        # refresh the LR cell before the graph, only when it changed: a
        # refresh captured into the graph would replay a stale LR
        self.optimizer._device_lr()
        return self._compiled(*batch)

    @property
    def stats(self) -> dict:
        """Steps run as graph replays and steps run eagerly."""
        return self._compiled.stats

    def audit_report(self) -> dict:
        """Captures and replays per cache key, and the run accounting."""
        return self._compiled.audit_report()


def _cuda_generators(model) -> List[torch.Generator]:
    """The distinct CUDA generators the model's modules hold (dropout)."""
    if model is None:
        return []
    found = {}
    for mod in model.modules():
        for value in vars(mod).values():
            if isinstance(value, torch.Generator) \
                    and value.device.type == "cuda":
                found[id(value)] = value
    return list(found.values())
