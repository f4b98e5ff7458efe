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

The Paddle-style layers built without a generator (``nn.Dropout``,
``nn.RReLU``, ``nn.MultiHeadAttention``) draw from one process-wide
generator a device (:func:`dropout_generator`), made at first use and
seeded by :func:`seed` (0 until then), where the JAX package draws from its
global key. Each such layer holds it from its construction, so a captured
training step registers it with its graph and a train-state snapshot saves
it, as they do a model's own generators.

The random vision transforms built without a generator draw from one
process-wide ``random.Random`` (:func:`host_random`), seeded by
:func:`seed`, where the JAX package draws from Python's global ``random``.
A ``DataLoader`` worker process reseeds its own copy at each epoch's start
(``io/dataloader.py``).
"""
from __future__ import annotations

import random

import torch

from . import dtype as dtype_mod

__all__ = ["build_generator", "dropout_generator", "enable_grad",
           "get_default_dtype", "host_random", "is_dropout_generator",
           "is_grad_enabled",
           "no_grad", "seed", "set_default_dtype", "set_grad_enabled",
           "swap_dropout_generator"]

no_grad = torch.no_grad
enable_grad = torch.enable_grad
is_grad_enabled = torch.is_grad_enabled
# on or off at once when called, and back at the end of a ``with`` block
set_grad_enabled = torch.set_grad_enabled


_build_generator = torch.Generator().manual_seed(0)
_default_dtype = torch.float32
_seed = 0
_dropout_generators = {}  # torch.device -> torch.Generator
_host_random = random.Random(0)


def build_generator() -> torch.Generator:
    """The process-wide generator that builds without ``generator=``
    draw their initial values from."""
    return _build_generator


def host_random() -> random.Random:
    """The process-wide host generator that the random transforms built
    without ``generator=`` draw from."""
    return _host_random


def seed(s: int) -> torch.Generator:
    """Seed torch's CPU and CUDA generators, the build generator and the
    host generator with ``s`` (``paddle.seed``); returns the build
    generator. Initializes no CUDA: torch applies the seed to the CUDA
    generators when CUDA starts."""
    global _seed
    s = _seed = int(s)
    torch.manual_seed(s)
    _host_random.seed(s)
    for gen in _dropout_generators.values():
        gen.manual_seed(s)
    return _build_generator.manual_seed(s)


def dropout_generator(device) -> torch.Generator:
    """The process-wide dropout generator on ``device``, made at first use
    and seeded with the last :func:`seed` (0 before any)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    gen = _dropout_generators.get(dev)
    if gen is None:
        gen = _dropout_generators[dev] = torch.Generator(
            device=dev).manual_seed(_seed)
    return gen


def swap_dropout_generator(device, gen: torch.Generator) -> torch.Generator:
    """Make ``gen`` the process-wide dropout generator on ``device`` and
    return the one it replaces (``RNGStatesTracker.rng_state``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    prev = dropout_generator(dev)
    _dropout_generators[dev] = gen
    return prev


def is_dropout_generator(gen) -> bool:
    """Whether ``gen`` is one of the process-wide dropout generators."""
    return any(gen is g for g in _dropout_generators.values())


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
