"""``paddle.grad`` and ``paddle.autograd.backward`` (port of
``paddle_tpu/core/autograd.py`` ``grad`` and ``backward``) over
``torch.autograd``."""
from __future__ import annotations

import torch

from .tensor import plain, wrap

__all__ = ["backward", "grad"]


def _as_list(x):
    return [x] if isinstance(x, torch.Tensor) else list(x)


def grad(outputs, inputs, grad_outputs=None, retain_graph=None,
         create_graph=False, only_inputs=True, allow_unused=False,
         no_grad_vars=None):
    """The gradients of ``outputs`` (weighted by ``grad_outputs``, default
    ones) with respect to each of ``inputs``, as a list of ``Tensor`` s.
    ``retain_graph`` defaults to ``create_graph``; an input that the
    outputs do not reach gives None with ``allow_unused``, else
    ``ValueError``."""
    outs, ins = _as_list(outputs), _as_list(inputs)
    if grad_outputs is not None:
        grad_outputs = _as_list(grad_outputs)
    if retain_graph is None:
        retain_graph = create_graph
    grads = torch.autograd.grad(outs, ins, grad_outputs=grad_outputs,
                                retain_graph=retain_graph,
                                create_graph=create_graph, allow_unused=True)
    if not allow_unused and any(g is None for g in grads):
        raise ValueError("an input is unreachable from the outputs (set "
                         "allow_unused=True to get None for it)")
    return [None if g is None else wrap(g) for g in grads]


def backward(tensors, grad_tensors=None, retain_graph=False):
    """Accumulate into every leaf's ``.grad`` the gradients of ``tensors``
    (a tensor or a list), each weighted by its ``grad_tensors`` entry
    (default: ones, for a root of any shape, as the JAX engine seeds it)."""
    roots = [plain(t) for t in _as_list(tensors)]
    if grad_tensors is None:
        grad_tensors = [None] * len(roots)
    else:
        grad_tensors = _as_list(grad_tensors)
    seeds = [torch.ones_like(t) if g is None else plain(g)
             for t, g in zip(roots, grad_tensors)]
    torch.autograd.backward(roots, seeds, retain_graph=retain_graph)
