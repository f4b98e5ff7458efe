"""Pooling (port of ``paddle_tpu/nn/functional/pooling.py``):
``max_pool1d/2d/3d``, ``avg_pool1d/2d/3d`` and the adaptive pools
``adaptive_avg_pool1d/2d/3d`` and ``adaptive_max_pool1d/2d/3d``.

The JAX functions are ``lax.reduce_window`` over windows padded as
:func:`_pads` says (``"SAME"``/``"VALID"``, ints, ``[before, after]``
pairs, and ``ceil_mode`` as extra padding after). The port computes the
same windows with torch's pooling:

- ``max_pool*`` pad with −inf. Where the pads are symmetric and at most
  half the window, torch pads itself; otherwise ``TF.pad`` pads first. The
  gradient goes to the first maximum of a window in row-major order, as
  XLA's ``select_and_scatter`` (``ge``) sends it. ``return_mask=True``
  returns the flat spatial index of that maximum in the unpadded input,
  upstream Paddle's mask; the JAX functions return placeholder zeros
  (ROADMAP.md, divergences inside the reference).
- ``avg_pool*`` divide the window sum by ``divisor_override``, by the
  count of real elements (``exclusive`` with padding), or by the window's
  size, as the JAX function does.
- The adaptive pools take the JAX route (``_adaptive``), one spatial axis
  at a time: where the size divides, the axis is cut into ``k``-element
  windows, and each window is summed and divided by ``k`` (mean) or
  reduced by a 1-D max pool whose gradient goes to the window's first
  maximum, as ``reduce_window``'s does; else each output bin reduces its
  slice ``[floor(j·n/o), ceil((j+1)·n/o))`` by ``mean`` or ``amax`` (a tie
  shares the gradient equally, as ``jnp.max``'s). Each axis rounds to the
  input's dtype, so in bf16 the result rounds once an axis, as in JAX. The
  mean's gradient is a broadcast, with no scattered adds.
  ``adaptive_max_pool*(return_mask=True)`` returns ``(out, None)``, as the
  JAX functions do.

All are gray ops under AMP: O2 computes them in the AMP dtype.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "adaptive_max_pool3d",
           "avg_pool1d", "avg_pool2d", "avg_pool3d", "max_pool1d",
           "max_pool2d", "max_pool3d"]

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


def _windows(x, kernel_size, stride, padding, ceil_mode, data_format, n):
    """``x`` channel-first, the window, its stride and the JAX pads over
    its ``n`` spatial axes."""
    if data_format in _CHANNEL_LAST:
        x = x.movedim(-1, 1)
    ksize = _tup(kernel_size, n)
    stride = ksize if stride is None else _tup(stride, n)
    pads = _pads(padding, n, ceil_mode, x.shape[2:], ksize, stride)
    return x, ksize, stride, pads


def _restore(out, data_format):
    return out.movedim(1, -1) if data_format in _CHANNEL_LAST else out


_MAX_POOL = {1: TF.max_pool1d, 2: TF.max_pool2d, 3: TF.max_pool3d}


def _unpad_index(idx, padded, pads):
    """Flat indices into the padded spatial shape ``padded`` as flat
    indices into the unpadded one."""
    coords, rest = [], idx
    for size in reversed(padded):
        coords.append(rest % size)
        rest = rest // size
    out = None
    for c, size, (lo, hi) in zip(reversed(coords), padded, pads):
        c = c - lo
        out = c if out is None else out * (size - lo - hi) + c
    return out


def _max_pool(name, x, kernel_size, stride, padding, return_mask, ceil_mode,
              data_format, n):
    """Max over each window, padded with −inf (op ``name``); with
    ``return_mask`` also the flat spatial index of each window's first
    maximum in the unpadded input (int64, upstream Paddle's mask)."""
    (x,) = cast_inputs(name, x)
    x, ksize, stride, pads = _windows(x, kernel_size, stride, padding,
                                      ceil_mode, data_format, n)
    pool = _MAX_POOL[n]
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, ksize)):
        out = pool(x, ksize, stride, tuple(lo for lo, _ in pads),
                   return_indices=return_mask)
    else:
        padded = TF.pad(x, _flat(pads), value=-math.inf)
        out = pool(padded, ksize, stride, 0, return_indices=return_mask)
        if return_mask:
            out = (out[0], _unpad_index(out[1], padded.shape[2:], pads))
    if return_mask:
        return _restore(out[0], data_format), _restore(out[1], data_format)
    return _restore(out, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool("max_pool1d", x, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    """Max over each window, padded with −inf (op ``max_pool2d``); with
    ``return_mask``, ``(out, indices)``: the flat spatial index of each
    maximum, where the JAX function returns placeholder zeros."""
    return _max_pool("max_pool2d", x, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool("max_pool3d", x, kernel_size, stride, padding,
                     return_mask, ceil_mode, data_format, 3)


def _window_sum(t, ksize, stride, pads):
    """The sum of each (zero-padded) window."""
    if any(p != (0, 0) for p in pads):
        t = TF.pad(t, _flat(pads))
    if len(ksize) == 1:  # avg_pool1d has no divisor_override
        return TF.avg_pool2d(t[..., None, :], (1,) + ksize, (1,) + stride,
                             divisor_override=1)[..., 0, :]
    pool = TF.avg_pool2d if len(ksize) == 2 else TF.avg_pool3d
    return pool(t, ksize, stride, divisor_override=1)


def _avg_pool(name, x, kernel_size, stride, padding, ceil_mode, exclusive,
              divisor_override, data_format, n):
    """Mean over each window, zero-padded (op ``name``): the window sum
    over ``divisor_override``, over the count of real elements when
    ``exclusive`` and padded, else over the window's size."""
    (x,) = cast_inputs(name, x)
    x, ksize, stride, pads = _windows(x, kernel_size, stride, padding,
                                      ceil_mode, data_format, n)
    s = _window_sum(x, ksize, stride, pads)
    if divisor_override:
        out = s / divisor_override
    elif exclusive and any(p != (0, 0) for p in pads):
        out = s / _window_sum(torch.ones((1, 1) + tuple(x.shape[2:]),
                                         dtype=x.dtype, device=x.device),
                              ksize, stride, pads)
    else:
        out = s / float(math.prod(ksize))
    return _restore(out, data_format)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool("avg_pool1d", x, kernel_size, stride, padding,
                     ceil_mode, exclusive, None, data_format, 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool("avg_pool2d", x, kernel_size, stride, padding,
                     ceil_mode, exclusive, divisor_override, data_format, 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool("avg_pool3d", x, kernel_size, stride, padding,
                     ceil_mode, exclusive, divisor_override, data_format, 3)


def _window_max(x, ax, k):
    """The max of each ``k``-element window along ``ax``, its gradient to
    the window's first maximum (a 1-D max pool over that axis alone)."""
    moved = x.movedim(ax, -1)
    shape = moved.shape
    out = TF.max_pool1d(moved.reshape(-1, 1, shape[-1]), k, k)
    return out.reshape(shape[:-1] + (shape[-1] // k,)).movedim(-1, ax)


def _adaptive(name, x, output_size, n, data_format, mode):
    """``output_size`` bins over the ``n`` spatial axes, one axis at a
    time, as the JAX ``_adaptive`` reduces them."""
    (x,) = cast_inputs(name, x)
    first = 1 if data_format in _CHANNEL_LAST else 2
    out = x
    for i, osz in enumerate(_tup(output_size, n)):
        ax = first + i
        isz = out.shape[ax]
        if isz % osz == 0:
            k = isz // osz
            out = (_window_max(out, ax, k) if mode == "max"
                   else out.unflatten(ax, (osz, k)).sum(ax + 1) / k)
        else:
            reduce = ((lambda t: t.amax(ax, keepdim=True)) if mode == "max"
                      else (lambda t: t.mean(ax, keepdim=True)))
            out = torch.cat(
                [reduce(out.narrow(ax, (j * isz) // osz,
                                   -(-((j + 1) * isz) // osz)
                                   - (j * isz) // osz))
                 for j in range(osz)], dim=ax)
    return out


def adaptive_avg_pool1d(x, output_size, name=None):
    """Mean over ``output_size`` bins of the last axis (op
    ``adaptive_avg_pool1d``)."""
    return _adaptive("adaptive_avg_pool1d", x, output_size, 1, "NCL", "avg")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Mean over ``output_size`` bins, one spatial axis at a time, as the
    JAX ``_adaptive`` computes it (op ``adaptive_avg_pool2d``)."""
    return _adaptive("adaptive_avg_pool2d", x, output_size, 2, data_format,
                     "avg")


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive("adaptive_avg_pool3d", x, output_size, 3, data_format,
                     "avg")


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    """Max over ``output_size`` bins; with ``return_mask``, ``(out,
    None)`` as in JAX (op ``adaptive_max_pool1d``)."""
    out = _adaptive("adaptive_max_pool1d", x, output_size, 1, "NCL", "max")
    return (out, None) if return_mask else out


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    out = _adaptive("adaptive_max_pool2d", x, output_size, 2, "NCHW", "max")
    return (out, None) if return_mask else out


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    out = _adaptive("adaptive_max_pool3d", x, output_size, 3, "NCDHW", "max")
    return (out, None) if return_mask else out
