"""Element-wise arithmetic (port of ``paddle_tpu/ops/math.py``, the subset
the model paths reach): ``add``, a gray op under AMP, as the JAX ``add``
is. O2 computes it in the AMP dtype, so an f32 normalization output meets
a bf16 branch in bf16, where torch alone would promote the sum to f32."""
from __future__ import annotations

from ..amp.auto_cast import cast_inputs

__all__ = ["add"]


def add(x, y):
    """``x + y`` (op ``add``)."""
    x, y = cast_inputs("add", x, y)
    return x + y
