"""Comparison, logical and bitwise ops (port of ``paddle_tpu/ops/
logic.py``). They read their inputs as they are (no AMP cast) and return
bool tensors, but the bitwise ops, which keep the integer dtype."""
from __future__ import annotations

import torch

from . import _common as c

__all__ = ["allclose", "bitwise_and", "bitwise_left_shift", "bitwise_not",
           "bitwise_or", "bitwise_right_shift", "bitwise_xor",
           "check_numerics", "equal", "equal_all", "greater_equal",
           "greater_than", "in1d", "is_empty", "is_tensor", "isclose",
           "isin", "less_equal", "less_than", "logical_and", "logical_not",
           "logical_or", "logical_xor", "not_equal"]


def _cmp(op_name, fn, doc):
    def op(x, y, name=None):
        x, y = c.operands(x, y)
        if not isinstance(x, torch.Tensor):
            x = torch.as_tensor(x, device=y.device)
        return fn(x, y)

    op.__name__ = op.__qualname__ = op_name
    op.__doc__ = f"{doc}, element-wise."
    return op


equal = _cmp("equal", torch.eq, "``x == y``")
not_equal = _cmp("not_equal", torch.ne, "``x != y``")
greater_than = _cmp("greater_than", torch.gt, "``x > y``")
greater_equal = _cmp("greater_equal", torch.ge, "``x >= y``")
less_than = _cmp("less_than", torch.lt, "``x < y``")
less_equal = _cmp("less_equal", torch.le, "``x <= y``")
logical_and = _cmp("logical_and", torch.logical_and, "``x and y``")
logical_or = _cmp("logical_or", torch.logical_or, "``x or y``")
logical_xor = _cmp("logical_xor", torch.logical_xor, "``x xor y``")
bitwise_and = _cmp("bitwise_and", torch.bitwise_and, "``x & y``")
bitwise_or = _cmp("bitwise_or", torch.bitwise_or, "``x | y``")
bitwise_xor = _cmp("bitwise_xor", torch.bitwise_xor, "``x ^ y``")
bitwise_left_shift = _cmp("bitwise_left_shift", torch.bitwise_left_shift,
                          "``x << y``")
bitwise_right_shift = _cmp("bitwise_right_shift",
                           torch.bitwise_right_shift, "``x >> y``")


def logical_not(x, name=None):
    return torch.logical_not(c.tensor(x))


def bitwise_not(x, name=None):
    return torch.bitwise_not(c.tensor(x))


def equal_all(x, y, name=None):
    """Whether ``x`` and ``y`` have one shape and equal elements, as a 0-d
    bool tensor."""
    x, y = c.tensor(x), c.tensor(y)
    return torch.tensor(x.shape == y.shape and bool(torch.equal(x, y)),
                        device=x.device)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """Whether every ``|x - y| <= atol + rtol * |y|``, as a 0-d bool
    tensor."""
    x, y = c.tensor(x), c.tensor(y)
    return torch.isclose(x, y, rtol, atol, equal_nan).all()


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    x, y = c.tensor(x), c.tensor(y)
    return torch.isclose(x, y, rtol, atol, equal_nan)


def is_empty(x, name=None):
    """Whether ``x`` has no elements, as a 0-d bool tensor."""
    x = c.tensor(x)
    return torch.tensor(x.numel() == 0, device=x.device)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def in1d(x, test_x, assume_unique=False, invert=False, name=None):
    """Whether each element of ``x`` is in ``test_x``."""
    x = c.tensor(x)
    return torch.isin(x, c.tensor(test_x, x), invert=invert)


isin = in1d


def check_numerics(x, op_type="", var_name="", message="",
                   stack_height_limit=-1, check_nan_inf_level=0, name=None):
    """``x``; raises ``ValueError`` if it holds a NaN or an infinity (a
    host read)."""
    if not bool(torch.isfinite(c.tensor(x)).all()):
        raise ValueError(f"check_numerics failed for {var_name or 'tensor'} "
                         f"{message}: NaN/Inf found")
    return x
