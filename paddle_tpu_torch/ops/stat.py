"""Statistics (port of ``paddle_tpu/ops/stat.py``): black under AMP where
the JAX package's are (``std``, ``var``: f32)."""
from __future__ import annotations

import torch

from ..amp.auto_cast import cast_inputs
from . import _common as c

__all__ = ["mean", "median", "nanmedian", "nanquantile", "quantile", "std",
           "var"]


def _one(op, x):
    (x,) = cast_inputs(op, c.tensor(x))
    return x


def mean(x, axis=None, keepdim=False, name=None):
    from .math import mean as _mean

    return _mean(x, axis, keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_one("std", x), dim=c.axes(axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_one("var", x), dim=c.axes(axis),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def _quantile(fn, x, q, axis, keepdim, interpolation):
    """``fn`` (``torch.quantile`` or ``nanquantile``) over one axis, a list
    of axes (moved last and merged) or all (None)."""
    qv = q if isinstance(q, torch.Tensor) else torch.as_tensor(
        q, dtype=x.dtype)
    qv = c.tensor(qv, x).to(device=x.device, dtype=x.dtype)
    ax = c.axes(axis)
    if isinstance(ax, tuple):
        nd = x.ndim
        dims = [a % nd for a in ax]
        rest = [d for d in range(nd) if d not in dims]
        moved = x.permute(rest + dims).reshape(
            [x.shape[d] for d in rest] + [-1])
        out = fn(moved, qv, dim=-1, interpolation=interpolation)
        if keepdim:
            shape = list(out.shape[:out.ndim - len(rest)]) + [
                1 if d in dims else x.shape[d] for d in range(nd)]
            out = out.reshape(shape)
        return out
    return fn(x, qv, dim=ax, keepdim=keepdim, interpolation=interpolation)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    """The median over ``axis``: with ``mode="avg"`` the mean of the two
    middle values of an even count, with ``"min"`` the lower one (op
    ``median``)."""
    x = _one("median", x)
    if mode == "avg":
        return _quantile(torch.quantile, x, 0.5, axis, keepdim, "linear")
    ax = c.axes(axis)
    v = x.reshape(-1) if ax is None else x
    d = 0 if ax is None else ax
    out = torch.sort(v, dim=d).values.select(d, (v.shape[d] - 1) // 2)
    return out.unsqueeze(d) if keepdim and ax is not None else out


def nanmedian(x, axis=None, keepdim=False, mode="avg", name=None):
    return _quantile(torch.nanquantile, _one("nanmedian", x), 0.5, axis,
                     keepdim, "linear")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, _one("quantile", x), q, axis, keepdim,
                     interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, _one("nanquantile", x), q, axis,
                     keepdim, interpolation)
