"""Custom user ops (port of ``paddle_tpu/core/custom_op.py``; reference
``paddle/fluid/framework/custom_operator.cc`` and
``python/paddle/utils/cpp_extension``).

A custom op is a forward written in torch ops (or one that launches the
user's own kernel) and an optional backward. :func:`register_op` makes it
a ``torch.library`` operator, ``paddle_tpu_torch_custom::<name>``, so that
the op-interception tier (``core/hooks.py``) sees each call as one op: a
static program records it, the tensor checker and the operator stats read
it, a recording profiler times it, and ``torch.export`` keeps it as one
node. This is what routing through ``dispatch.primitive`` gives a JAX
custom op.

    @register_op("my_gelu", backward=my_gelu_grad)     # backward optional
    def my_gelu(x):
        return 0.5 * x * (1 + torch.tanh(0.79788456 * (x + 0.044715 * x**3)))

    out = paddle.run_custom_op("my_gelu", tensor)       # or the returned fn

``backward(res, g)`` gets ``res = (inputs, outputs)`` (the outputs one
tensor or a tuple, as the forward returned them) and ``g``, the output
gradient (a tuple for several outputs), and returns the inputs' gradients.
Without a backward the gradient is the forward's own, recomputed under
autograd in the backward pass (the JAX package differentiates the forward
by ``jax.vjp``). Keyword attributes travel as JSON, so they are numbers,
strings, booleans and lists of them. Registering a name again replaces its
forward and backward; the operator stays.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, Optional

import torch

from .tensor import as_tensor, plain, wrap

__all__ = ["CUSTOM_OPS", "NAMESPACE", "get_custom_op", "register_op",
           "run_custom_op"]

NAMESPACE = "paddle_tpu_torch_custom"
CUSTOM_OPS: Dict[str, dict] = {}
_SCHEMA = "(Tensor[] xs, str attrs) -> Tensor[]"


def _as_list(out) -> list:
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _fresh(outs, xs) -> list:
    """Outputs as plain tensors that alias no input (an operator's contract:
    an output that shares an input's storage is copied)."""
    bases = {x.untyped_storage().data_ptr() for x in xs}
    return [o.clone() if o.untyped_storage().data_ptr() in bases
            else plain(o) for o in outs]


def _define(name: str):
    """The operator of ``name``: it calls the forward and backward
    registered under that name at the time of the call."""

    def impl(xs, attrs):
        out = CUSTOM_OPS[name]["forward"](*xs, **json.loads(attrs))
        return _fresh(_as_list(out), xs)

    op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl,
                                 mutates_args=(), schema=_SCHEMA)

    @op.register_fake
    def _fake(xs, attrs):
        out = CUSTOM_OPS[name]["forward"](*xs, **json.loads(attrs))
        return [o.new_empty(o.shape) for o in _as_list(out)]

    def setup(ctx, inputs, output):
        xs, attrs = inputs
        ctx.attrs = attrs
        ctx.n_inputs = len(xs)
        ctx.save_for_backward(*xs, *output)

    def backward(ctx, grads):
        saved = ctx.saved_tensors
        xs, outs = saved[:ctx.n_inputs], saved[ctx.n_inputs:]
        grads = [torch.zeros_like(o) if g is None else g
                 for g, o in zip(grads, outs)]
        entry = CUSTOM_OPS[name]
        if entry["backward"] is not None:
            single = len(outs) == 1 and entry["n_outputs"] in (None, 1)
            res = (tuple(xs), outs[0] if single else tuple(outs))
            got = entry["backward"](res, grads[0] if single else tuple(grads))
            return [None if g is None else plain(g)
                    for g in _as_list(got)], None
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(x.is_floating_point())
                      for x in xs]
            out = _as_list(entry["forward"](*leaves,
                                            **json.loads(ctx.attrs)))
            diff = [x for x in leaves if x.requires_grad]
            got = iter(torch.autograd.grad(out, diff, grads,
                                           allow_unused=True))
        return [next(got) if x.requires_grad else None for x in leaves], None

    op.register_autograd(backward, setup_context=setup)
    return op


def register_op(name: str, forward: Optional[Callable] = None,
                backward: Optional[Callable] = None,
                n_outputs: Optional[int] = None):
    """Register a custom op; usable as a decorator or a direct call.
    Returns the op's Python entry point, ``api(*tensors, **attrs)``."""

    def _register(fwd: Callable):
        entry = CUSTOM_OPS.get(name)
        op = entry["op"] if entry is not None else _define(name)

        def api(*tensors, **attrs):
            dev = next((t.device for t in tensors
                        if isinstance(t, torch.Tensor)), None)
            xs = [plain(t) if isinstance(t, torch.Tensor)
                  else as_tensor(t, place=dev) for t in tensors]
            outs = op(xs, json.dumps(attrs, sort_keys=True))
            if len(outs) == 1 and n_outputs in (None, 1):
                return wrap(outs[0])
            return wrap(tuple(outs))

        api.__name__ = name
        CUSTOM_OPS[name] = {"forward": fwd, "backward": backward,
                            "n_outputs": n_outputs, "api": api, "op": op}
        return api

    if forward is not None:
        return _register(forward)
    return _register


def run_custom_op(name: str, *tensors, **attrs):
    """Call a registered custom op by name (reference ``_run_custom_op``)."""
    if name not in CUSTOM_OPS:
        raise KeyError(f"custom op '{name}' is not registered")
    return CUSTOM_OPS[name]["api"](*tensors, **attrs)


def get_custom_op(name: str) -> Optional[dict]:
    return CUSTOM_OPS.get(name)
