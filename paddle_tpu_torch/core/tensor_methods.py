"""``Tensor``'s method surface (port of ``paddle_tpu/core/tensor_methods.py``).

Every public op of ``ops.creation``, ``manipulation``, ``math``, ``logic``,
``search``, ``stat``, ``linalg``, ``activation``, ``einsum_ops`` and
``random`` whose first parameter takes a tensor
becomes a ``Tensor`` method, by the JAX package's rules (``_patchable``,
``_SKIP``): ``x.sum(axis=1)`` is ``paddle.sum(x, axis=1)``, and returns a
``Tensor``. Where torch has a method of the same name (``size``,
``transpose``, ``split``, ``max``, ``sort``, ...), the ``Tensor`` takes
Paddle's. They are installed on ``paddle.Tensor`` only, never on
``torch.Tensor``; a method the class defines itself (``astype``,
``numpy``, ...) is left alone.
"""
from __future__ import annotations

import inspect

from .. import tensor as paddle_tensor
from ..ops import (activation, creation, einsum_ops, linalg, logic,
                   manipulation, math, search, stat)
from ..ops import random as random_ops
from .tensor import Tensor, paddle_out

# names that must not become methods: constructors and shape helpers
_SKIP = {
    "to_tensor", "arange", "linspace", "logspace", "eye", "meshgrid", "rand",
    "randn", "randint", "randperm", "uniform", "normal", "standard_normal",
    "empty", "full", "ones", "zeros", "tril_indices", "triu_indices",
    "assign", "broadcast_shape",
}

_FIRST_PARAM_OK = {"x", "input", "tensor", "a", "t"}


def _patchable(name, fn) -> bool:
    if name.startswith("_") or name in _SKIP:
        return False
    if not callable(fn) or inspect.isclass(fn):
        return False
    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return False
    return bool(params) and params[0] in _FIRST_PARAM_OK


def _install(module) -> None:
    for name in module.__all__:
        fn = getattr(module, name)
        if _patchable(name, fn) and name not in Tensor.__dict__:
            # the op as ``paddle.tensor`` exports it: returning Tensors
            setattr(Tensor, name, getattr(paddle_tensor, name, None)
                    or paddle_out(fn))


for _module in (math, manipulation, logic, search, stat, linalg, activation,
                einsum_ops, creation, random_ops):
    _install(_module)
