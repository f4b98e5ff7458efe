"""The ``paddle.tensor`` namespace (port of ``paddle_tpu/tensor.py``): the
functional tensor ops grouped like the reference's submodules (and the
top level's linear algebra and ``einsum``), each returning ``Tensor`` s. The plain-tensor forms the port's own modules call
are in ``ops``."""
from __future__ import annotations

from .core.tensor import paddle_out
from .ops import (creation, einsum_ops, linalg, logic, manipulation, math,
                  random, search, stat)

__all__ = ["creation", "logic", "manipulation", "math", "random", "search",
           "stat"]

# the linear algebra of the JAX top level (the rest is ``paddle.linalg``'s)
_TOP_LINALG = {
    "cdist", "cholesky", "cholesky_solve", "corrcoef", "cov", "det", "dist",
    "eig", "eigh", "eigvals", "eigvalsh", "householder_product", "inv",
    "lstsq", "lu", "matrix_power", "matrix_rank", "multi_dot", "norm",
    "pinv", "qr", "slogdet", "solve", "svd", "t", "triangular_solve"}

for _module in (creation, logic, manipulation, math, random, search, stat,
                linalg, einsum_ops):
    for _name in _module.__all__:
        if _module is linalg and _name not in _TOP_LINALG:
            continue
        globals()[_name] = paddle_out(getattr(_module, _name))
        # paddle.tensor stays this namespace at the top level
        if _name not in __all__ and _name != "tensor":
            __all__.append(_name)
del _module, _name
