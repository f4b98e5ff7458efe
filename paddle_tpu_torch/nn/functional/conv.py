"""Convolutions (port of ``paddle_tpu/nn/functional/conv.py``):
``conv1d``, ``conv2d``, ``conv3d`` and their transposes.

The JAX functions call ``lax.conv_general_dilated``, a ``lax`` op and not
a Pallas kernel, so the port hands the product to torch's convolution
(cuDNN on the GPU). The weight layout is Paddle's and torch's alike,
``[out, in / groups, *k]``. Padding follows the JAX rules
(:func:`_resolve_padding`): ``"SAME"``, ``"VALID"``, one int or one per
axis, or the flattened ``[before, after]`` pairs; an asymmetric pad is
applied with ``TF.pad`` before a convolution without padding. Channel-last
layouts (``NLC``, ``NHWC``, ``NDHWC``) are moved to channel-first around
the convolution. The bias is added after the product, as the JAX function
adds it, so under AMP the product rounds before the sum. All three are
white ops: under AMP O2 (and O1) they compute in the AMP dtype.

The transposes take Paddle's weight layout ``[in, out / groups, *k]``
(torch's too) and the JAX functions' padding: the pads resolve as the
forward convolution's would (``"SAME"`` from the input's size), and each
axis's output runs from ``lo`` to ``(in − 1)·stride + dilation·(k − 1) + 1
− hi + output_padding`` of the full transposed product, zeros past its
end, as JAX's dilated convolution gives it. ``output_size`` is accepted
and ignored, as in the JAX functions.
"""
from __future__ import annotations

import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs

__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose"]

_CHANNEL_LAST = ("NHWC", "NLC", "NWC", "NDHWC")
_TORCH_CONV = {1: TF.conv1d, 2: TF.conv2d, 3: TF.conv3d}
_TORCH_CONV_T = {1: TF.conv_transpose1d, 2: TF.conv_transpose2d,
                 3: TF.conv_transpose3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 2 * n:  # paddle allows [before, after] pairs flattened
            return tuple(v)
        return tuple(int(v[0]) for _ in range(n))
    return tuple(int(v) for _ in range(n))


def _resolve_padding(padding, n, stride, dilation, ksize, in_spatial):
    """``[(before, after)] * n``, as the JAX function resolves it."""
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p == "SAME":
            pads = []
            for i in range(n):
                out = -(-in_spatial[i] // stride[i])
                eff_k = (ksize[i] - 1) * dilation[i] + 1
                total = max(0, (out - 1) * stride[i] + eff_k - in_spatial[i])
                pads.append((total // 2, total - total // 2))
            return pads
        raise ValueError(f"bad padding {padding}")
    if isinstance(padding, (list, tuple)) and len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    pads = _tuplize(padding, n)
    return [(p, p) for p in pads]


def _conv(name, x, weight, bias, stride, padding, dilation, groups, n,
          data_format):
    x, weight, bias = cast_inputs(name, x, weight, bias)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    pads = _resolve_padding(padding, n, stride, dilation, weight.shape[2:],
                            x.shape[2:])
    if all(lo == hi for lo, hi in pads):
        torch_pad = tuple(lo for lo, _ in pads)
    else:
        # TF.pad lists the last axis first
        x = TF.pad(x, [p for pair in reversed(pads) for p in pair])
        torch_pad = 0
    out = _TORCH_CONV[n](x, weight, None, stride, torch_pad, dilation, groups)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channel_last else out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    return _conv("conv1d", x, weight, bias, stride, padding, dilation,
                 groups, 1, data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    return _conv("conv2d", x, weight, bias, stride, padding, dilation,
                 groups, 2, data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    return _conv("conv3d", x, weight, bias, stride, padding, dilation,
                 groups, 3, data_format)


def _conv_transpose(name, x, weight, bias, stride, padding, output_padding,
                    dilation, groups, n, data_format):
    x, weight, bias = cast_inputs(name, x, weight, bias)
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    channel_last = data_format in _CHANNEL_LAST
    if channel_last:
        x = x.movedim(-1, 1)
    ksize = weight.shape[2:]
    pads = _resolve_padding(padding, n, stride, dilation, ksize, x.shape[2:])
    out = _TORCH_CONV_T[n](x, weight, None, stride, 0, 0, groups, dilation)
    for i, (lo, hi) in enumerate(pads):
        full = out.shape[2 + i]
        end = full - hi + opad[i]
        if end > full:  # past the product's end: zeros
            widths = [0, 0] * (n - 1 - i) + [0, end - full]
            out = TF.pad(out, widths)
        out = out.narrow(2 + i, lo, end - lo)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return out.movedim(1, -1) if channel_last else out


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose("conv1d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 1,
                           data_format)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose("conv2d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 2,
                           data_format)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose("conv3d_transpose", x, weight, bias, stride,
                           padding, output_padding, dilation, groups, 3,
                           data_format)
