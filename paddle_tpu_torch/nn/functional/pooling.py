"""Pooling (port of ``paddle_tpu/nn/functional/pooling.py``): ``max_pool2d``,
``avg_pool2d`` and ``adaptive_avg_pool2d``.

The JAX functions are ``lax.reduce_window`` over windows padded as
:func:`_pads` says (``"SAME"``/``"VALID"``, ints, ``[before, after]``
pairs, and ``ceil_mode`` as extra padding after). The port computes the
same windows with torch's pooling:

- ``max_pool2d`` pads with −inf. Where the pads are symmetric and at most
  half the window, torch pads itself; otherwise ``TF.pad`` pads first. Its
  gradient goes to the first maximum of a window in row-major order, as
  XLA's ``select_and_scatter`` (``ge``) sends it.
- ``avg_pool2d`` divides the window sum by ``divisor_override``, by the
  count of real elements (``exclusive`` with padding), or by the window's
  size, as the JAX function does.
- ``adaptive_avg_pool2d`` takes the JAX route, one spatial axis at a time:
  where the size divides, the axis is cut into ``k``-element windows,
  summed and divided by ``k``; else each output bin averages its slice
  ``[floor(j·n/o), ceil((j+1)·n/o))``. Each axis rounds to the input's
  dtype, so in bf16 the result rounds twice, as in JAX. Its gradient is a
  broadcast, with no scattered adds.

All three are gray ops under AMP: O2 computes them in the AMP dtype. The
other pools are not ported yet (ROADMAP.md, queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["adaptive_avg_pool2d", "avg_pool2d", "max_pool2d"]

_CHANNEL_LAST = ("NHWC", "NLC", "NWC", "NDHWC")


def _tup(v, n):
    if isinstance(v, (list, tuple)):
        return (tuple(int(x) for x in v[:n]) if len(v) >= n
                else tuple(int(v[0]) for _ in range(n)))
    return tuple(int(v) for _ in range(n))


def _pads(padding, n, ceil_mode, in_spatial, ksize, stride):
    """``[(before, after)] * n``, as the JAX function pads."""
    if isinstance(padding, str):
        if padding.upper() == "VALID":
            return [(0, 0)] * n
        base = []
        for i in range(n):  # SAME
            out = -(-in_spatial[i] // stride[i])
            total = max(0, (out - 1) * stride[i] + ksize[i] - in_spatial[i])
            base.append((total // 2, total - total // 2))
        return base
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        base = [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    else:
        base = [(p, p) for p in _tup(padding, n)]
    if ceil_mode:
        out = []
        for i in range(n):
            lo, hi = base[i]
            rem = (in_spatial[i] + lo + hi - ksize[i]) % stride[i]
            out.append((lo, hi + (stride[i] - rem) % stride[i] if rem
                        else hi))
        base = out
    return base


def _flat(pads):
    """``pads`` as ``TF.pad`` lists them: the last axis first."""
    return [p for pair in reversed(pads) for p in pair]


def _windows(x, kernel_size, stride, padding, ceil_mode, data_format):
    """``x`` channel-first, the window, its stride and the JAX pads."""
    if data_format in _CHANNEL_LAST:
        x = x.movedim(-1, 1)
    ksize = _tup(kernel_size, 2)
    stride = ksize if stride is None else _tup(stride, 2)
    pads = _pads(padding, 2, ceil_mode, x.shape[2:], ksize, stride)
    return x, ksize, stride, pads


def _restore(out, data_format):
    return out.movedim(1, -1) if data_format in _CHANNEL_LAST else out


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW"):
    """Max over each window, padded with −inf (op ``max_pool2d``)."""
    if return_mask:
        raise NotImplementedError(
            "max_pool2d(return_mask=True) is not ported yet: the JAX "
            "function returns placeholder indices (ROADMAP.md, queue 1)")
    (x,) = cast_inputs("max_pool2d", x)
    x, ksize, stride, pads = _windows(x, kernel_size, stride, padding,
                                      ceil_mode, data_format)
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        torch_pad = tuple(lo for lo, _ in pads)
    else:
        x = TF.pad(x, _flat(pads), value=-math.inf)
        torch_pad = 0
    return _restore(TF.max_pool2d(x, ksize, stride, torch_pad), data_format)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW"):
    """Mean over each window, zero-padded (op ``avg_pool2d``): the window
    sum over ``divisor_override``, over the count of real elements when
    ``exclusive`` and padded, else over the window's size."""
    (x,) = cast_inputs("avg_pool2d", x)
    x, ksize, stride, pads = _windows(x, kernel_size, stride, padding,
                                      ceil_mode, data_format)
    padded = any(p != (0, 0) for p in pads)

    def window_sum(t):
        if padded:
            t = TF.pad(t, _flat(pads))
        return TF.avg_pool2d(t, ksize, stride, divisor_override=1)

    s = window_sum(x)
    if divisor_override:
        out = s / divisor_override
    elif exclusive and padded:
        out = s / window_sum(torch.ones((1, 1) + tuple(x.shape[2:]),
                                        dtype=x.dtype, device=x.device))
    else:
        out = s / float(ksize[0] * ksize[1])
    return _restore(out, data_format)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Mean over ``output_size`` bins, one spatial axis at a time, as the
    JAX ``_adaptive`` computes it (op ``adaptive_avg_pool2d``)."""
    (x,) = cast_inputs("adaptive_avg_pool2d", x)
    first = 1 if data_format in _CHANNEL_LAST else 2
    out = x
    for i, osz in enumerate(_tup(output_size, 2)):
        ax = first + i
        isz = out.shape[ax]
        if isz % osz == 0:
            k = isz // osz
            out = out.unflatten(ax, (osz, k)).sum(ax + 1) / k
        else:
            out = torch.cat(
                [out.narrow(ax, (j * isz) // osz,
                            -(-((j + 1) * isz) // osz) - (j * isz) // osz)
                 .mean(ax, keepdim=True) for j in range(osz)], dim=ax)
    return out
