"""Where dropout's random draws come from.

Every draw of the port's dropout goes through here: a keep mask
(``nn.functional.dropout`` and its variants, :func:`keep_mask`) and the
``(1,)`` int32 seed of the flash-attention kernels' dropout hash
(:func:`seed`). By default each is drawn from the caller's
``torch.Generator`` (the process-wide dropout generator of the device when
there is none). A source pushed for a block of code takes its place:

- :class:`DrawTape` (``fleet.recompute``): while it records, each draw is
  made as it would be without it and kept; while it replays, the kept
  draws come back in the same order. A recomputed forward so sees the
  masks and the seeds of the first one bit for bit, and no generator's
  state is read or written: under a CUDA graph capture a generator's
  state cannot be read (each replay advances it on the device), so the
  draws themselves are what is carried. A tape keeps one bool a masked
  element and one int32 a seed until the replay.
- :class:`SeededStream` (a pipeline unit, ``fleet.pipeline_schedules``):
  every draw is a hash of a ``(1,)`` int64 seed on the device, the draw's
  index in the unit and the element's index, so running the unit again
  (a recompute) gives its masks again, and a captured step, whose seed is
  drawn anew from the model's generator at each replay, gives new masks
  at each replay. The hash mixes in the caller's generator's initial seed,
  so draws from streams seeded apart (a tensor-parallel rank's own
  ``model_parallel_rng`` and the model's generator) stay apart.

Sources nest: a tape pushed inside a stream records the stream's draws.
The stack is per thread.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional

import torch

from . import global_state

__all__ = ["DrawTape", "SeededStream", "keep_mask", "mix", "pushed", "seed"]

_M = 0xFFFFFFFF
_local = threading.local()


def _stack() -> List[object]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _generator(generator: Optional[torch.Generator], device):
    return (generator if generator is not None
            else global_state.dropout_generator(device))


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's finalizer on uint32 values held in int64 (the products
    wrap in 64 bits; their low 32 bits are the uint32 products)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M
    return h ^ (h >> 16)


def mix(key: torch.Tensor, *values) -> torch.Tensor:
    """``key`` (an int64 tensor of uint32 values) hashed with the integers
    ``values`` in turn; on ``key``'s device, no host round trip."""
    h = key & _M
    for v in values:
        h = _fmix32((h + (int(v) * 0x9E3779B9 & _M) + 0x7F4A7C15) & _M)
    return h


class _Base:
    below = None  # the source under this one when it was pushed

    def _below_keep_mask(self, shape, p, generator, device):
        if self.below is not None:
            return self.below.keep_mask(shape, p, generator, device)
        return _draw_keep_mask(shape, p, generator, device)

    def _below_seed(self, generator, device):
        if self.below is not None:
            return self.below.seed(generator, device)
        return _draw_seed(generator, device)


class DrawTape(_Base):
    """The draws of one recorded run, replayed in order (module notes):
    push it with :meth:`recording`, then with :meth:`replaying`."""

    def __init__(self):
        self.draws: List[torch.Tensor] = []
        self._replaying = False
        self._at = 0

    def _take(self, what: str) -> torch.Tensor:
        if self._at >= len(self.draws):
            raise RuntimeError(
                f"recompute: the replay drew a {what} the first run did not "
                f"(the block must draw the same masks in the same order)")
        value = self.draws[self._at]
        self._at += 1
        return value

    def keep_mask(self, shape, p, generator, device):
        if self._replaying:
            return self._take("keep mask")
        mask = self._below_keep_mask(shape, p, generator, device)
        self.draws.append(mask)
        return mask

    def seed(self, generator, device):
        if self._replaying:
            return self._take("dropout seed")
        s = self._below_seed(generator, device)
        self.draws.append(s)
        return s

    @contextlib.contextmanager
    def recording(self):
        self._replaying = False
        with pushed(self):
            yield self

    @contextlib.contextmanager
    def replaying(self):
        self._replaying, self._at = True, 0
        with pushed(self):
            yield self


class SeededStream(_Base):
    """Draws hashed from ``key``, a ``(1,)`` int64 tensor on the device
    (module notes); the ``k``-th draw of a run takes index ``k``."""

    def __init__(self, key: torch.Tensor):
        self.key = key
        self.count = 0

    def _next(self, generator) -> torch.Tensor:
        salt = generator.initial_seed() & _M if generator is not None else 0
        k = self.count
        self.count += 1
        return mix(self.key, k, salt)

    def keep_mask(self, shape, p, generator, device):
        s = self._next(generator)
        idx = torch.arange(math.prod(shape), device=device,
                           dtype=torch.int64)
        h = _fmix32(((idx * 0x27D4EB2F) & _M) ^ s)
        h = _fmix32(h ^ (s >> 7))
        u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return (u >= p).reshape(tuple(shape))

    def seed(self, generator, device):
        s = self._next(generator)
        return (s % (2**31 - 1)).to(torch.int32)


@contextlib.contextmanager
def pushed(source):
    """``source`` answers the draws of this thread inside the block."""
    stack = _stack()
    source.below = stack[-1] if stack else None
    stack.append(source)
    try:
        yield source
    finally:
        stack.pop()
        source.below = None


def _draw_keep_mask(shape, p, generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=_generator(generator, device),
                      device=device) >= p


def _draw_seed(generator, device) -> torch.Tensor:
    return torch.randint(0, 2**31 - 1, (1,),
                         generator=_generator(generator, device),
                         device=device, dtype=torch.int32)


def keep_mask(shape, p: float, generator: Optional[torch.Generator],
              device) -> torch.Tensor:
    """Dropout's bool keep mask of ``shape`` (kept with probability
    ``1 - p``) on ``device``, from the innermost source pushed, else from
    ``generator`` (the process-wide dropout generator of ``device`` when
    None)."""
    stack = _stack()
    if stack:
        return stack[-1].keep_mask(shape, p, generator, device)
    return _draw_keep_mask(shape, p, generator, device)


def seed(generator: Optional[torch.Generator], device) -> torch.Tensor:
    """A ``(1,)`` int32 dropout-hash seed in [0, 2**31 - 1) on ``device``,
    from the innermost source pushed, else from ``generator``."""
    stack = _stack()
    if stack:
        return stack[-1].seed(generator, device)
    return _draw_seed(generator, device)
