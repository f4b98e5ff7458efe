"""``paddle.static.InputSpec`` for the port (a copy of
``paddle_tpu/static/__init__.py``'s ``InputSpec``; the rest of the JAX
module, its Program/Executor surface, is not ported).

An ``InputSpec`` declares an exported input's shape and dtype for
``jit.save``: ``None`` or ``-1`` marks a dynamic dim, which the export
keeps symbolic so that one saved program serves every size on that axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["InputSpec", "torch_dtype"]


def torch_dtype(dtype) -> torch.dtype:
    """``dtype`` (a ``torch.dtype``, a numpy dtype or a name such as
    ``"int64"`` or ``"bfloat16"``) as a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name.replace("torch.", ""), None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"not a dtype: {dtype!r}")
    return out


class InputSpec:
    """Shape, dtype and name of one exported input (reference
    ``static/input.py::InputSpec``). ``None`` or ``-1`` dims are dynamic;
    ``dtype`` is a ``torch.dtype`` or its name."""

    def __init__(self, shape: Sequence[Optional[int]], dtype="float32",
                 name=None, stop_gradient=True):
        self.shape = [None if (s is None or s == -1) else int(s)
                      for s in shape]
        self.dtype = torch_dtype(dtype)
        self.name = name
        self.stop_gradient = stop_gradient

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)

    def __repr__(self):
        return (f"InputSpec(shape={self.shape}, dtype={self.dtype}, "
                f"name={self.name})")

    def __eq__(self, other):
        return (isinstance(other, InputSpec) and self.shape == other.shape
                and self.dtype == other.dtype and self.name == other.name)

    def __hash__(self):
        return hash((tuple(self.shape), str(self.dtype), self.name))
