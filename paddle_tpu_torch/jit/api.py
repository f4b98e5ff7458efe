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

``bucket_axes`` (``{arg_index: axis}``) pads each batch's variable dims
up to a rung of the log₂ ladder over ``bucket_range`` (default ``(16,
4096)``) with ``bucket_pad_values`` per arg, before the call and outside
the graph, through a :class:`~.bucketing.BucketedFunction`: each rung is
one signature, so one CUDA graph, captured at the rung's second call and
replayed after it.

Telemetry, as in the JAX step: with ``FLAGS_telemetry_trace`` a call is a
``train.step`` span; with ``FLAGS_telemetry_anomaly`` its host wall (the
queueing of a replay) feeds the flight recorder's step-time detector;
with ``FLAGS_numerics_witness`` the returned loss is watched
(``"train.loss"``). All three dark, a call reads three attributes and
nothing else: no clock, no host read, no launch.

A call takes ``paddle.Tensor`` s as readily as plain tensors: it hands
the step their plain form (``as_subclass``: no copy), so the graph's
static input buffers and the model see plain tensors and the copy in is
the one launch it always was. The loss comes back as a ``paddle.Tensor``
the same way, so ``loss.numpy()`` works on the card; a replay launches
nothing more for it.

A ``DataParallel`` model all-reduces its gradients at the end of the
backward, before the update: on NCCL inside the step's one CUDA graph (a
replay issues the all-reduces with no host work), on gloo eagerly (gloo
stages CUDA tensors through the host, which no graph can hold: every call
of such a step runs eagerly, and a gloo collective raises under capture).

``grad_accum_steps`` is accepted and read nowhere, as in the JAX
package. Not ported: ``sharding`` raises ``NotImplementedError``
(ROADMAP.md, queue 7).
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import torch

from ..core.tensor import plain, wrap
from ..device import DEFAULT_DEVICE, resolve_device
from ..observability import numerics
from ..observability.anomaly import monitor
from ..observability.tracing import tracer
from ..optimizer import LBFGS
from .bucketing import BucketedFunction
from .functionalize import CompiledFunction

__all__ = ["TrainStep", "model_generators"]


class TrainStep:
    """One training step per call: ``loss_fn(*batch)`` builds the loss from
    the model; ``device`` (default CUDA) is where the step runs and where
    the model's parameters must lie."""

    def __init__(self, model=None, optimizer=None,
                 loss_fn: Optional[Callable] = None,
                 grad_accum_steps: int = 1, bucket_axes=None,
                 bucket_range=None, bucket_pad_values=None, sharding=None,
                 *, device=DEFAULT_DEVICE):
        if sharding is not None:
            raise NotImplementedError(
                "TrainStep sharding is not ported yet (ROADMAP.md, queue 7)")
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

        compiled_kw = dict(static_key_fn=base_key, name="train_step",
                           device=dev, generators=_cuda_generators(model),
                           capture=_capturable(model))
        if bucket_axes:
            lo, hi = bucket_range or (16, 4096)
            self._compiled = BucketedFunction(
                step_fn, bucket_axes=bucket_axes, min_len=lo, max_len=hi,
                pad_values=bucket_pad_values, **compiled_kw)
        else:
            self._compiled = CompiledFunction(step_fn, **compiled_kw)

    def __call__(self, *batch):
        batch = tuple(plain(x) for x in batch)
        # refresh the LR cell before the graph, only when it changed: a
        # refresh captured into the graph would replay a stale LR
        self.optimizer._device_lr()
        if not (tracer.enabled or monitor.enabled or numerics._enabled):
            return wrap(self._compiled(*batch))
        # read once: a flag flipped mid-step must not leave t0 unset
        timed = monitor.enabled
        t0 = time.perf_counter() if timed else 0.0
        if tracer.enabled:
            with tracer.span("train.step", track="train_loop"):
                out = self._compiled(*batch)
        else:
            out = self._compiled(*batch)
        if timed:
            monitor.on_step(time.perf_counter() - t0)
        numerics.watch("train.loss", out)
        return wrap(out)

    @property
    def stats(self) -> dict:
        """Steps run as graph replays and steps run eagerly."""
        return self._compiled.stats

    def audit_report(self) -> dict:
        """Captures and replays per cache key, and the run accounting (and
        the ladder, ``"buckets"``, when bucketed)."""
        return self._compiled.audit_report()


def model_generators(model) -> List[torch.Generator]:
    """The distinct generators the model's modules hold (dropout), in the
    order ``model.modules()`` meets them: what a train-state snapshot
    saves beside torch's default generators."""
    if model is None:
        return []
    found = {}
    for mod in model.modules():
        for value in vars(mod).values():
            if isinstance(value, torch.Generator):
                found.setdefault(id(value), value)
    return list(found.values())


def _capturable(model) -> bool:
    """False in a gloo world of several ranks, whose collectives (a
    ``DataParallel`` model's, a tensor-, sequence- or context-parallel
    model's) stage CUDA tensors through the host, which a CUDA graph
    cannot hold: such steps run eagerly. On NCCL one graph a step holds
    the collectives, a ring's point-to-point exchanges too."""
    from ..distributed import env as dist_env
    from ..distributed.parallel import DataParallel

    if isinstance(model, DataParallel) and model.backend == "gloo":
        return False
    env = dist_env.instance()
    return not (env.initialized and env.backend == "gloo"
                and env.world_size > 1)


def _cuda_generators(model) -> List[torch.Generator]:
    """The model's CUDA generators, which a captured step registers."""
    return [g for g in model_generators(model) if g.device.type == "cuda"]
