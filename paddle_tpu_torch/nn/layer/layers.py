"""How the port's layers and models come to hold their parameters (the part
of ``paddle_tpu/nn/layer/layers.py`` ``Layer.create_parameter`` the port
needs; the layers themselves are ``torch.nn.Module`` s).

A public constructor with parameters builds inside :func:`building`: its
submodules are made without storage (on the ``meta`` device), so torch's
own initializers neither run nor draw from the global generator. The
outermost module under construction then takes CPU storage, draws every
initial value from one explicit ``torch.Generator`` (default: the
process-wide build generator that ``paddle.seed`` seeds, which starts at
0), so one seed gives the same weights on every device, moves to the
device the caller asked for (default: ``set_device``'s, else CUDA; raises
when CUDA is absent and the caller did not ask for the CPU) and names its
parameters. A module
built inside another's build leaves all of that to the outer one.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Optional

import torch
from torch import nn

from ...base.global_state import build_generator
from ...device import resolve_device

__all__ = ["building", "init_parameters", "name_parameters"]


def name_parameters(model: nn.Module) -> None:
    """Give each parameter a ``param_name``, its qualified state-dict key,
    which AdamW passes to ``apply_decay_param_fun`` where the JAX package
    passes ``p.name`` (a process-wide counter there, which cannot be
    matched; torch reserves ``Tensor.name``)."""
    for name, p in model.named_parameters():
        p.param_name = name


@torch.no_grad()
def init_parameters(model: nn.Module, gen: torch.Generator) -> None:
    """Each module's JAX default initializers, in ``model.modules()``
    order: every module that defines ``_init_parameters(gen)`` (the port's
    ``Linear``, convolutions and BatchNorms) fills its own parameters and
    buffers."""
    for mod in model.modules():
        init = getattr(mod, "_init_parameters", None)
        if init is not None:
            init(gen)


@contextlib.contextmanager
def building(model: nn.Module, device, generator: Optional[torch.Generator],
             init: Callable[[nn.Module, torch.Generator], None]
             = init_parameters):
    """Build ``model``'s parameters and submodules inside this block
    without storage; on leaving, the outermost model under construction
    takes CPU storage, runs ``init(model, generator)``, moves to
    ``device`` and names its parameters. Inside another build it does
    nothing, and ``device`` is not resolved."""
    if torch.empty(0).device.type == "meta":
        yield
        return
    dev = resolve_device(device)
    with torch.device("meta"):
        yield
    model.to_empty(device="cpu")
    init(model, generator if generator is not None else build_generator())
    model.to(dev)
    name_parameters(model)
