"""The ``paddle.tensor`` namespace (port of ``paddle_tpu/tensor.py``): the
functional tensor ops grouped like the reference's submodules, each
returning ``Tensor`` s. The plain-tensor forms the port's own modules call
are in ``ops``."""
from __future__ import annotations

from .core.tensor import paddle_out
from .ops import creation, logic, manipulation, math, random, search, stat

__all__ = ["creation", "logic", "manipulation", "math", "random", "search",
           "stat"]

for _module in (creation, logic, manipulation, math, random, search, stat):
    for _name in _module.__all__:
        globals()[_name] = paddle_out(getattr(_module, _name))
        # paddle.tensor stays this namespace at the top level
        if _name not in __all__ and _name != "tensor":
            __all__.append(_name)
del _module, _name
