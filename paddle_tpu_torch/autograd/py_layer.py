"""``PyLayer``: a user-written autograd function (port of
``paddle_tpu/autograd/py_layer.py``) over ``torch.autograd.Function``.

``forward(ctx, *args, **kwargs)`` and ``backward(ctx, *grads)`` are the
user's static methods; ``backward`` returns one gradient a tensor input
(a single one need not be a tuple). ``apply`` returns a single tensor or a
tuple, as the JAX ``apply`` does. The context keeps Paddle's API:
``save_for_backward``/``saved_tensor`` (through the active
``saved_tensors_hooks`` pair, if any), ``mark_non_differentiable``,
``set_materialize_grads``; other attributes may be set on it freely.
"""
from __future__ import annotations

import torch

from ..core.tensor import wrap
from .saved_tensors_hooks import current_hooks

__all__ = ["PyLayer", "PyLayerContext", "once_differentiable"]

once_differentiable = torch.autograd.function.once_differentiable


class PyLayerContext:
    """What ``forward`` and ``backward`` share."""

    def __init__(self, ctx=None):
        self._ctx = ctx
        self._saved = None
        self._unpack = None
        self.non_differentiable = []

    def save_for_backward(self, *tensors):
        hooks = current_hooks()
        if hooks is None:
            self._ctx.save_for_backward(*tensors)
            self._unpack = None
            return
        pack, self._unpack = hooks
        self._saved = [pack(t) for t in tensors]

    def saved_tensor(self):
        if self._unpack is not None:
            return [self._unpack(p) for p in self._saved]
        return list(self._ctx.saved_tensors)

    def mark_non_differentiable(self, *tensors):
        self.non_differentiable.extend(tensors)
        self._ctx.mark_non_differentiable(*tensors)

    def set_materialize_grads(self, value: bool):
        self._ctx.set_materialize_grads(bool(value))


class PyLayer:
    """Subclass with ``forward(ctx, ...)`` and ``backward(ctx, ...)`` static
    methods; call ``apply``."""

    @staticmethod
    def forward(ctx, *args, **kwargs):
        raise NotImplementedError

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError

    @classmethod
    def _function(cls):
        fn = cls.__dict__.get("_torch_function")
        if fn is None:
            layer = cls

            class _Function(torch.autograd.Function):
                @staticmethod
                def forward(ctx, kwargs, *args):
                    pctx = ctx.paddle_ctx = PyLayerContext(ctx)
                    ctx.tensor_inputs = [isinstance(a, torch.Tensor)
                                         for a in args]
                    outs = layer.forward(pctx, *args, **kwargs)
                    if isinstance(outs, list):
                        outs = tuple(outs)
                    return outs

                @staticmethod
                def backward(ctx, *grads):
                    res = layer.backward(ctx.paddle_ctx,
                                         *(wrap(g) for g in grads))
                    if not isinstance(res, (tuple, list)):
                        res = (res,)
                    res = iter(res)
                    return (None,) + tuple(next(res, None) if is_t else None
                                           for is_t in ctx.tensor_inputs)

            _Function.__name__ = _Function.__qualname__ = cls.__name__
            fn = _Function
            cls._torch_function = fn
        return fn

    @classmethod
    def apply(cls, *args, **kwargs):
        return wrap(cls._function().apply(kwargs, *args))
