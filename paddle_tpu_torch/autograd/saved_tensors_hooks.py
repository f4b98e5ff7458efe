"""``saved_tensors_hooks`` (port of ``paddle_tpu/autograd/
saved_tensors_hooks.py``): a ``(pack_hook, unpack_hook)`` pair for the
tensors a ``PyLayer`` saves through ``PyLayerContext.save_for_backward``,
and for no others (the residuals of built-in ops are torch's own, as they
are XLA's in the JAX package; torch's global
``torch.autograd.graph.saved_tensors_hooks`` is not installed). A pack
runs at the save, an unpack at each ``saved_tensor()`` read. The pair is
thread-local; a ``PyLayer`` keeps the pair active at its forward."""
from __future__ import annotations

import contextlib
import threading

__all__ = ["current_hooks", "saved_tensors_hooks"]

_tls = threading.local()


def current_hooks():
    """The active ``(pack_hook, unpack_hook)``, or None."""
    return getattr(_tls, "hooks", None)


@contextlib.contextmanager
def saved_tensors_hooks(pack_hook, unpack_hook):
    prev = getattr(_tls, "hooks", None)
    _tls.hooks = (pack_hook, unpack_hook)
    try:
        yield
    finally:
        _tls.hooks = prev
