"""The port's kernels as operators of torch's dispatcher.

Each kernel wrapper is an operator of the ``paddle_tpu_torch`` namespace
(``paddle_tpu_torch::rms_norm_fwd``, ...) with a CUDA kernel (the
hand-written kernel's launch), a CPU kernel (its plain version) and a fake
(the shapes), so that the op-interception tier (``core/hooks.py``) sees
each call as one op, a static program records it and ``torch.export``
keeps it as one node. :func:`define` puts them on a
``torch.library.Library`` directly rather than through
``torch.library.custom_op``, whose Python layer (an autograd wrapper and
an aliasing check on every call) adds host time to every eager call; the
kernels' gradients are their wrappers' own ``autograd.Function``\\ s.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NAMESPACE", "define"]

NAMESPACE = "paddle_tpu_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")


def define(schema: str, *, cuda: Callable, cpu: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define ``paddle_tpu_torch::<schema>`` with its CUDA and CPU kernels
    and its fake; returns the operator's default overload, which callers
    call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    _LIB.impl(name, cuda, "CUDA")
    _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
