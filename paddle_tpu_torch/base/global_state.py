"""Process-wide framework state: grad mode, the default dtype and the seed
(port of ``paddle_tpu/base/global_state.py``).

The grad mode is torch's own. :func:`seed` seeds torch's generators (the
CPU one and every CUDA one: what dropout and the random ops draw from
when no generator is given) and the build generator: one process-wide
CPU ``torch.Generator`` from which every model or layer built without
``generator=`` draws its initial values. It starts at 0 in a fresh
process, so ``seed(0)`` then a build gives the weights of a build with
``generator=torch.Generator().manual_seed(0)``, and a second build in the
same process draws further and differs, as the JAX package's splitting
key does. Its stream is torch's, not JAX's threefry: the same seed gives
other values in the two packages.
"""
from __future__ import annotations

import torch

from . import dtype as dtype_mod

__all__ = ["build_generator", "enable_grad", "get_default_dtype",
           "is_grad_enabled", "no_grad", "seed", "set_default_dtype",
           "set_grad_enabled"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
# on or off at once when called, and back at the end of a ``with`` block
set_grad_enabled = torch.set_grad_enabled


_build_generator = torch.Generator().manual_seed(0)
_default_dtype = torch.float32


def build_generator() -> torch.Generator:
    """The process-wide generator that builds without ``generator=``
    draw their initial values from."""
    return _build_generator


def seed(s: int) -> torch.Generator:
    """Seed torch's CPU and CUDA generators and the build generator with
    ``s`` (``paddle.seed``); returns the build generator. Initializes no
    CUDA: torch applies the seed to the CUDA generators when CUDA starts."""
    s = int(s)
    torch.manual_seed(s)
    return _build_generator.manual_seed(s)


def get_default_dtype() -> str:
    """The dtype a float tensor gets when none is given, by name."""
    return dtype_mod.dtype_name(_default_dtype)


def set_default_dtype(d) -> None:
    """Set the dtype a float tensor gets when none is given; torch's own
    default is left alone."""
    global _default_dtype
    d = dtype_mod.convert_dtype(d)
    if not d.is_floating_point:
        raise TypeError(f"the default dtype must be a float dtype, not {d}")
    _default_dtype = d


def default_dtype() -> torch.dtype:
    return _default_dtype
