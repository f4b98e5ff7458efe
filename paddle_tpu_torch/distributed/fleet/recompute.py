"""Activation recompute (port of ``paddle_tpu/distributed/fleet/
recompute.py``).

Reference: distributed/fleet/recompute/recompute.py — a PyLayer that
drops the block's activations in the forward and runs the block again in
the backward, with the RNG state restored so dropout draws the same masks.

The JAX package gets this from ``jax.checkpoint``, its random key an input
of the block. Here the block runs under torch's non-reentrant checkpoint
(``torch.utils.checkpoint``: the saved activations are dropped and made
again when the backward unpacks them), and the replay sees the dropout
draws of the first run: each keep mask and each flash-attention seed the
block draws (from the process-wide dropout generator, a layer's or the
model's own, the tensor-parallel tracker's) is kept on a ``base.draws``
tape and given back in the replay. torch's own ``preserve_rng_state``
restores only torch's default generators, which the port's dropout never
draws from, and it reads their state, which a CUDA graph capture cannot;
the tape reads and writes no generator, so a captured ``TrainStep`` holds
a recomputed block, each replay drawing new masks and recomputing with
them. ``preserve_rng_state=False`` keeps no tape: the replay draws anew.
The replay runs under the AMP state of the first run (``amp.auto_cast``
has ended when the backward runs), as torch's checkpoint restores
``torch.autocast``'s.
``use_reentrant`` is accepted and read nowhere: the reentrant form of
torch's checkpoint takes no context for the replay, and both give the same
gradients.
"""
from __future__ import annotations

import contextlib
from typing import Callable

from torch.utils import checkpoint as _checkpoint

from ...amp.auto_cast import current_state, state_guard
from ...base import draws

__all__ = ["no_recompute", "recompute", "recompute_sequential"]


@contextlib.contextmanager
def _replay(tape, amp):
    with state_guard(amp), (
            tape.replaying() if tape is not None
            else contextlib.nullcontext()):
        yield


def _contexts(preserve_rng_state: bool):
    """The first run's context and the replay's (called at the first
    run)."""
    amp = current_state()
    if not preserve_rng_state:
        return contextlib.nullcontext(), _replay(None, amp)
    tape = draws.DrawTape()
    return tape.recording(), _replay(tape, amp)


def recompute(function: Callable, *args, use_reentrant=True,
              preserve_rng_state=True, **kwargs):
    """``function(*args, **kwargs)``, its activations recomputed in the
    backward instead of kept (module notes); a tensor or a tuple, as the
    function returns (a list comes back a tuple). ``args`` may be
    ``paddle.Tensor`` s or plain tensors."""
    out = _checkpoint.checkpoint(
        function, *args, use_reentrant=False, preserve_rng_state=False,
        context_fn=lambda: _contexts(preserve_rng_state), **kwargs)
    return tuple(out) if isinstance(out, list) else out


def recompute_sequential(ctx, functions, *args, **kwargs):
    """reference recompute_sequential: each of ``functions`` recomputed in
    turn, the output of one the input of the next."""
    out = args
    for fn in functions:
        out = (recompute(fn, *out, **kwargs),)
    return out[0]


def no_recompute(function, *args, **kwargs):
    """reference no_recompute: ``function`` called as it is (the escape
    hatch inside a recomputed region)."""
    return function(*args, **kwargs)
