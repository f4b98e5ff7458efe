"""Common functionals (port of ``paddle_tpu/nn/functional/common.py``, the
functions): ``linear`` under AMP, ``embedding`` with the JAX
``padding_idx`` rule, ``dropout`` (with ``axis`` and both modes),
``dropout2d``/``3d`` and ``alpha_dropout`` from the caller's generator or
the process-wide one,
``normalize``, ``cosine_similarity``, ``bilinear``, the pixel and channel
shuffles, ``unfold``/``fold`` (torch's im2col after the JAX pads), ``pad``
and ``interpolate``/``upsample``.

``interpolate`` computes what the JAX function computes, not what
``torch.nn.functional.interpolate`` does:

- ``linear``/``bilinear``/``trilinear``, ``bicubic`` and ``area`` (linear,
  as in JAX) with ``align_corners=False`` go through ``jax.image.resize``
  there, which antialiases when it shrinks and uses the Keys cubic kernel
  with a = −0.5 (torch's bicubic uses −0.75, and its bilinear does not
  antialias). The port builds ``jax.image``'s per-axis weight matrix
  ``[in, out]`` (:func:`resize_weights`: the triangle or cubic kernel,
  widened by ``in / out`` when shrinking, each column normalised, columns
  whose sample falls outside the input zeroed) in f32, casts it to the
  input's dtype as JAX does, and contracts the axes one at a time with
  ``torch.matmul``, in the order JAX's einsum path takes (the cheapest;
  ties in axis order). An axis whose size does not change is skipped, as
  in JAX. The backward is a matrix product too, so two runs give the same
  bits (torch's ``upsample_bilinear2d`` backward adds with atomics on the
  GPU). The weights are built once per (in, out, kernel, dtype, device)
  and kept for the life of the process, so a captured CUDA graph may read
  them: the first call of a shape must come before a capture, as
  ``CompiledFunction``'s eager first call does.
- ``nearest`` gathers index ``floor(i · in / out)`` (f32) on every axis.
- ``align_corners=True`` blends the rows at ``floor(p)`` and ``floor(p) +
  1`` of ``p = linspace(0, in - 1, out)`` (JAX's f32 ``linspace``), with
  the blend weight in the input's dtype.

The gathers' backward (``nearest``, ``align_corners=True``) adds with
``index_add`` (atomics on the GPU). ``interpolate`` is a gray op under
AMP: O2 computes it in the AMP dtype.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs
from ...base import draws
from ...ops.manipulation import pad  # noqa: F401  (F.pad, as in JAX)

__all__ = ["alpha_dropout", "bilinear", "channel_shuffle",
           "cosine_similarity", "dropout", "dropout2d", "dropout3d",
           "embedding", "fold", "interpolate", "label_smooth", "linear",
           "normalize", "one_hot", "pad", "pixel_shuffle", "pixel_unshuffle",
           "resize_weights", "unfold", "upsample"]


def linear(x, weight, bias=None):
    """``x @ weight.T + bias`` with torch's ``[out, in]`` weight; under
    AMP O2 it computes in the AMP dtype (op ``linear``)."""
    x, weight, bias = cast_inputs("linear", x, weight, bias)
    return TF.linear(x, weight, bias)


def embedding(x, weight, padding_idx=None, sparse=False):
    """Rows of ``weight`` gathered at the integer ids ``x``; op
    ``embedding`` (gray under AMP). With ``padding_idx`` the output is 0
    wherever ``x`` equals it, whatever that row holds, as the JAX function
    selects it away (torch's ``padding_idx`` returns the row and zeroes only
    its gradient). The gradient reaches the weight alone. ``sparse`` is
    accepted and ignored, as in the JAX package."""
    (weight,) = cast_inputs("embedding", weight)
    out = TF.embedding(x, weight)
    if padding_idx is not None:
        out = torch.where((x == padding_idx)[..., None], 0.0, out)
    return out


def _check_p(p):
    if not 0.0 <= p <= 1.0:
        raise ValueError(f"dropout probability must be in [0, 1], got {p}")


def _keep_mask(x, p, shape, generator):
    """The keep mask of shape ``shape``, drawn from ``generator`` or, when
    it is None, from the process-wide dropout generator on ``x``'s device
    (``base.global_state.dropout_generator``, seeded by ``paddle.seed``),
    as the layers draw; a pushed draw source (``base.draws``: a recompute's
    tape, a pipeline unit's stream) answers in their place."""
    return draws.keep_mask(shape, p, generator, x.device)


def dropout(x, p: float = 0.5, axis=None, training: bool = True,
            mode: str = "upscale_in_train", name=None, *,
            generator: Optional[torch.Generator] = None):
    """Dropout of probability ``p`` while ``training``, the keep mask drawn
    from ``generator`` (a ``torch.Generator`` on ``x``'s device), or from
    the process-wide dropout generator on that device when it is None;
    torch's global generator is never drawn from. ``p = 1`` gives zeros,
    as the JAX function does.
    ``axis`` (an axis or a list) draws one mask entry per index of those
    axes, shared along the others. ``upscale_in_train`` gives ``x / (1 -
    p)`` where kept, ``downscale_in_infer`` ``x`` itself; 0 where dropped.
    Outside training (or at ``p = 0``) ``x`` is returned as it is, in both
    modes, as the JAX function returns it."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode {mode!r}: upscale_in_train or "
                         f"downscale_in_infer")
    _check_p(p)
    if not training or p == 0.0:
        return x
    if p == 1.0:
        # every element dropped; x / (1 - p) would give a NaN gradient
        return torch.where(torch.zeros((), dtype=torch.bool,
                                       device=x.device), x, 0.0)
    shape = list(x.shape)
    if axis is not None:
        axes = [a % x.dim() for a in (axis if isinstance(axis, (list, tuple))
                                      else [axis])]
        shape = [s if i in axes else 1 for i, s in enumerate(shape)]
    keep = _keep_mask(x, p, shape, generator)
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0)
    return torch.where(keep, x, 0.0)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    """Whole channels dropped: one mask entry per (sample, channel)."""
    spatial = [2, 3] if data_format == "NCHW" else [1, 2]
    return dropout(x, p, [i for i in range(4) if i not in spatial], training,
                   generator=generator)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None, *,
              generator: Optional[torch.Generator] = None):
    spatial = [2, 3, 4] if data_format == "NCDHW" else [1, 2, 3]
    return dropout(x, p, [i for i in range(5) if i not in spatial], training,
                   generator=generator)


_SELU_ALPHA = 1.6732632423543772
_SELU_SCALE = 1.0507009873554805


def alpha_dropout(x, p=0.5, training=True, name=None, *,
                  generator: Optional[torch.Generator] = None):
    """SELU-preserving dropout: dropped elements take ``-alpha·scale``,
    then ``a·x + b`` restores the mean and variance, as the JAX function
    computes it."""
    if not training or p == 0.0:
        return x
    keep = _keep_mask(x, p, x.shape, generator)
    alpha_p = -_SELU_ALPHA * _SELU_SCALE
    a = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b = -a * alpha_p * p
    return a * torch.where(keep, x, alpha_p) + b


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """``x`` over its ``p``-norm along ``axis`` (at least ``epsilon``)."""
    norm = torch.sum(torch.abs(x) ** p, dim=axis, keepdim=True) ** (1.0 / p)
    return x / torch.clamp_min(norm, epsilon)


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    num = torch.sum(x1 * x2, dim=axis)
    den = (torch.sqrt(torch.sum(x1 * x1, dim=axis))
           * torch.sqrt(torch.sum(x2 * x2, dim=axis)))
    return num / torch.clamp_min(den, eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] · weight[o] · x2[b]`` (+ ``bias``), ``weight``
    ``[out, in1, in2]``."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        x = x.reshape(b, c // (r * r), r, r, h, w).permute(0, 1, 4, 2, 5, 3)
        return x.reshape(b, c // (r * r), h * r, w * r)
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, r, r, c // (r * r)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h * r, w * r, c // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        b, c, h, w = x.shape
        x = x.reshape(b, c, h // r, r, w // r, r).permute(0, 1, 3, 5, 2, 4)
        return x.reshape(b, c * r * r, h // r, w // r)
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // r, w // r, c * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        b, c, h, w = x.shape
        return x.reshape(b, groups, c // groups, h, w).transpose(1, 2) \
            .reshape(b, c, h, w)
    b, h, w, c = x.shape
    return x.reshape(b, h, w, groups, c // groups).transpose(3, 4) \
        .reshape(b, h, w, c)


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def _im2col_args(kernel_sizes, strides, paddings, dilations):
    """Kernel, stride, dilation pairs and the pads as ``TF.pad`` lists
    them (``[left, right, top, bottom]``) from the JAX ``[top, left,
    bottom, right]`` (or ``[h, w]``, or one int)."""
    pd = _pair(paddings)
    if len(pd) == 2:
        pd = [pd[0], pd[1], pd[0], pd[1]]
    return (_pair(kernel_sizes), _pair(strides), _pair(dilations),
            [pd[1], pd[3], pd[0], pd[2]])


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: ``[N, C·kh·kw, L]``, channel-major, as the JAX function
    stacks its patches."""
    ks, st, dl, pads = _im2col_args(kernel_sizes, strides, paddings,
                                    dilations)
    return TF.unfold(TF.pad(x, pads), ks, dilation=dl, stride=st)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, the sum of the overlapping patches, the pads cut away."""
    ks, st, dl, pads = _im2col_args(kernel_sizes, strides, paddings,
                                    dilations)
    os_ = _pair(output_sizes)
    full = (os_[0] + pads[2] + pads[3], os_[1] + pads[0] + pads[1])
    out = TF.fold(x, full, ks, dilation=dl, stride=st)
    return out[:, :, pads[2]:full[0] - pads[3], pads[0]:full[1] - pads[1]]


def one_hot(x, num_classes, name=None):
    """``x``'s integer classes as one-hot rows in the default float dtype
    (``ops.creation.one_hot``)."""
    from ...ops.creation import one_hot as _one_hot

    return _one_hot(x, num_classes)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    """``(1 - epsilon) · label + epsilon · prior``: the prior is uniform
    (``1 / classes`` of the last axis) unless ``prior_dist`` gives one. Op
    ``label_smooth``, gray under AMP."""
    from ...ops._common import tensor

    label = tensor(label)
    (label,) = cast_inputs("label_smooth", label)
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * tensor(prior_dist, label)
    return (1 - epsilon) * label + epsilon / label.shape[-1]


_CHANNEL_LAST = ("NHWC", "NWC", "NDHWC")
_METHODS = {"nearest": "nearest", "bilinear": "linear", "linear": "linear",
            "trilinear": "linear", "bicubic": "cubic", "area": "linear"}
_WEIGHTS = {}  # (in, out, method, dtype, device) -> [in, out] weights


def _triangle(x):
    return torch.clamp_min(1.0 - x.abs(), 0.0)


def _keys_cubic(x):
    """The Keys cubic kernel with a = -0.5, as ``jax.image`` writes it."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def resize_weights(isz: int, osz: int, method: str) -> torch.Tensor:
    """``jax.image``'s ``compute_weight_mat`` for a resize of one axis from
    ``isz`` to ``osz`` (scale ``osz / isz``, no translation, antialiased),
    in f32 on the CPU: ``[isz, osz]``, column ``j`` the weights of output
    ``j``."""
    f32 = torch.float32
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    inv_scale = 1.0 / torch.tensor(osz / isz, dtype=f32)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample = (torch.arange(osz, dtype=f32) + 0.5) * inv_scale - 0.5
    dist = (sample[None, :] - torch.arange(isz, dtype=f32)[:, None]).abs()
    w = kernel(dist / kernel_scale)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= isz - 0.5)
    return torch.where(inside[None, :], w, 0.0)


def _weights(isz, osz, method, dtype, device):
    key = (isz, osz, method, dtype, device)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = resize_weights(isz, osz, method).to(device=device,
                                                            dtype=dtype)
    return _WEIGHTS[key]


def _contract(v, ax, w):
    """``v`` with axis ``ax`` contracted against ``w`` ``[in, out]``."""
    if ax == v.dim() - 1:
        return torch.matmul(v, w)
    shape = v.shape
    pre = math.prod(shape[:ax])
    out = torch.matmul(w.t(), v.reshape(pre, shape[ax], -1))
    return out.reshape(shape[:ax] + (w.shape[1],) + shape[ax + 1:])


def _contraction_order(shape, axes, sizes):
    """The order in which JAX's einsum path contracts the axes: the least
    total of each step's index space (the operand's size times the new
    axis's), ties to the earlier order."""
    best, best_cost = None, None
    for order in itertools.permutations(range(len(axes))):
        cur, cost = list(shape), 0
        for i in order:
            cost += math.prod(cur) * sizes[i]
            cur[axes[i]] = sizes[i]
        if best_cost is None or cost < best_cost:
            best, best_cost = order, cost
    return best


def _resize(v, axes, sizes, method):
    """The ``jax.image.resize`` route: per-axis weight matrices in ``v``'s
    dtype, contracted one axis at a time."""
    todo = [(ax, osz) for ax, osz in zip(axes, sizes) if v.shape[ax] != osz]
    if not todo:
        return v
    order = _contraction_order(v.shape, [ax for ax, _ in todo],
                               [osz for _, osz in todo])
    for i in order:
        ax, osz = todo[i]
        v = _contract(v, ax, _weights(v.shape[ax], osz, method, v.dtype,
                                      v.device))
    return v


def _nearest(v, axes, sizes):
    for ax, osz in zip(axes, sizes):
        pos = torch.arange(osz, dtype=torch.float32, device=v.device) * (
            v.shape[ax] / osz)  # an f32 product, as JAX's
        v = v.index_select(ax, torch.floor(pos).long())
    return v


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, num)`` in f32, as JAX computes it."""
    last = torch.full((1,), stop, dtype=torch.float32, device=device)
    if num == 1:
        return last * 0
    step = torch.arange(num - 1, dtype=torch.float32, device=device) / float(
        num - 1)
    return torch.cat([stop * step, last])


def _align_corners(v, axes, sizes):
    for ax, osz in zip(axes, sizes):
        isz = v.shape[ax]
        pos = _linspace(isz - 1.0, osz, v.device)
        lo = torch.floor(pos)
        hi = torch.clamp_max(lo + 1, isz - 1)
        shape = [1] * v.dim()
        shape[ax] = osz
        w = (pos - lo).to(v.dtype).reshape(shape)
        v = (v.index_select(ax, lo.long()) * (1 - w)
             + v.index_select(ax, hi.long()) * w)
    return v


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """``x`` resized over its spatial axes to ``size`` (or the floor of
    each size times ``scale_factor``) as the JAX function computes it (see
    the module's docstring; op ``interpolate``). ``align_mode`` is accepted
    and read nowhere, as in JAX."""
    if mode not in _METHODS:
        raise ValueError(f"interpolate mode {mode!r}: one of "
                         f"{sorted(_METHODS)}")
    (x,) = cast_inputs("interpolate", x)
    n = x.dim() - 2
    first = 1 if data_format in _CHANNEL_LAST else 2
    axes = list(range(first, first + n))
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.tolist()
        sizes = ([int(s) for s in size] if isinstance(size, (list, tuple))
                 else [int(size)] * n)
    else:
        factors = (scale_factor if isinstance(scale_factor, (list, tuple))
                   else [scale_factor] * n)
        sizes = [int(np.floor(x.shape[ax] * f))
                 for ax, f in zip(axes, factors)]
    method = _METHODS[mode]
    if method == "nearest":
        return _nearest(x, axes, sizes)
    if align_corners:
        return _align_corners(x, axes, sizes)
    return _resize(x, axes, sizes, method)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)
