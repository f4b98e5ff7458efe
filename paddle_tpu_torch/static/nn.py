"""``paddle.static.nn`` layer builders (port of ``paddle_tpu/static/nn.py``;
reference ``python/paddle/static/nn/``).

Each builder makes its parameters eagerly, with the interception
suspended (so they are constants of the program, read by reference and
kept across ``Executor.run`` calls), on the input's device, from the build
generator; then applies the compute ops, which record into the active
``Program``. The parameters' values are the port's own draws: they match
the JAX builders' laws, not their bits.
"""
from __future__ import annotations

import math

import torch

from ..base.global_state import build_generator
from ..core import hooks
from ..core.tensor import Parameter
from ..nn import functional as F
from ..ops import activation as act_mod
from ..ops import manipulation, misc_ops
from ..ops import math as om

__all__ = ["batch_norm", "case", "cond", "conv2d", "conv2d_transpose",
           "conv3d", "conv3d_transpose", "embedding", "fc", "group_norm",
           "instance_norm", "layer_norm", "prelu", "spectral_norm",
           "switch_case", "while_loop"]


def _param(like, shape, dtype=None, scale=None, fill=None) -> Parameter:
    """A parameter of ``shape`` on ``like``'s device in ``dtype`` (default
    ``like``'s): normal with std ``scale`` (default ``sqrt(2 /
    shape[0])``), or ``fill`` everywhere."""
    shape = tuple(int(s) for s in shape)
    dtype = dtype or like.dtype
    with hooks.suspended():
        if fill is not None:
            data = torch.full(shape, float(fill), dtype=dtype)
        else:
            if scale is None:
                scale = math.sqrt(2.0 / max(shape[0], 1))
            data = (torch.randn(shape, generator=build_generator())
                    * scale).to(dtype)
        return Parameter(data.to(like.device))


def fc(x, size, num_flatten_dims=1, activation=None, name=None,
       weight_attr=None, bias_attr=None):
    """Fully-connected layer (reference ``static/nn/common.py::fc``)."""
    in_dim = math.prod(int(s) for s in x.shape[num_flatten_dims:])
    w = _param(x, (in_dim, size))
    b = _param(x, (size,), fill=0.0)
    flat = x
    if x.ndim > num_flatten_dims + 1:
        flat = manipulation.reshape(
            x, [int(s) for s in x.shape[:num_flatten_dims]] + [in_dim])
    return _maybe_act(om.add(om.matmul(flat, w), b), activation)


def embedding(input, size, is_sparse=False, padding_idx=None,
              dtype="float32", name=None, param_attr=None):
    """reference ``static/nn/common.py::embedding``."""
    from ..base import dtype as dtype_mod

    table = _param(input, size, dtype_mod.convert_dtype(dtype), scale=0.02)
    return F.embedding(input, table)


def batch_norm(input, act=None, momentum=0.9, epsilon=1e-5, name=None,
               **kwargs):
    """Inference-style batch norm over the stored statistics (reference
    ``static/nn/common.py::batch_norm``, the is_test path)."""
    c = int(input.shape[1])
    gamma, beta = _param(input, (c,), fill=1.0), _param(input, (c,), fill=0.0)
    mean, var = _param(input, (c,), fill=0.0), _param(input, (c,), fill=1.0)
    out = F.batch_norm(input, mean, var, weight=gamma, bias=beta,
                       training=False, momentum=momentum, epsilon=epsilon)
    return _maybe_act(out, act)


def _ks(filter_size, n) -> tuple:
    return (tuple(filter_size) if isinstance(filter_size, (list, tuple))
            else (filter_size,) * n)


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, act=None, name=None, **kwargs):
    """reference ``static/nn/common.py::conv2d``."""
    c_in = int(input.shape[1])
    w = _param(input, (num_filters, c_in // groups) + _ks(filter_size, 2))
    out = F.conv2d(input, w, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    return _maybe_act(out, act)


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=1, act=None, name=None, **kwargs):
    """reference ``static/nn/common.py::conv3d``."""
    c_in = int(input.shape[1])
    w = _param(input, (num_filters, c_in // groups) + _ks(filter_size, 3))
    out = F.conv3d(input, w, stride=stride, padding=padding,
                   dilation=dilation, groups=groups)
    return _maybe_act(out, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, act=None, name=None, **kwargs):
    """reference ``static/nn/common.py::layer_norm``: normalizes over the
    dims from ``begin_norm_axis`` on."""
    shape = [int(s) for s in input.shape[begin_norm_axis:]]
    g = _param(input, shape, fill=1.0) if scale else None
    b = _param(input, shape, fill=0.0) if shift else None
    out = F.layer_norm(input, shape, weight=g, bias=b, epsilon=epsilon)
    return _maybe_act(out, act)


def group_norm(input, groups, epsilon=1e-5, act=None, name=None, **kwargs):
    """reference ``static/nn/common.py::group_norm``."""
    c = int(input.shape[1])
    g, b = _param(input, (c,), fill=1.0), _param(input, (c,), fill=0.0)
    out = F.group_norm(input, groups, epsilon=epsilon, weight=g, bias=b)
    return _maybe_act(out, act)


def instance_norm(input, epsilon=1e-5, name=None, **kwargs):
    """reference ``static/nn/common.py::instance_norm``."""
    c = int(input.shape[1])
    g, b = _param(input, (c,), fill=1.0), _param(input, (c,), fill=0.0)
    return F.instance_norm(input, weight=g, bias=b, eps=epsilon)


def _transpose_ks(v_shape, filter_size, output_size, stride, padding, nd,
                  dilation=1):
    """``filter_size``, or derived from ``output_size`` (reference
    conv*d_transpose: out = (in-1)*stride - 2*pad + dilation*(ks-1) + 1 per
    spatial dim)."""
    if filter_size is not None:
        return _ks(filter_size, nd)
    if output_size is None:
        raise ValueError("one of filter_size / output_size is required")

    def tup(x):
        return tuple(x) if isinstance(x, (list, tuple)) else (x,) * nd

    outs, strides, pads, dils = (tup(output_size), tup(stride), tup(padding),
                                 tup(dilation))
    ins = tuple(v_shape[2:2 + nd])
    ks = []
    for o, i, s, p, d in zip(outs, ins, strides, pads, dils):
        span = int(o) - (int(i) - 1) * int(s) + 2 * int(p) - 1
        if span < 0 or span % int(d):
            raise ValueError(
                f"output_size {outs} unreachable from input {ins} with "
                f"stride {strides} / padding {pads} / dilation {dils}")
        ks.append(span // int(d) + 1)
    return tuple(ks)


def _conv_transpose(fn, nd, input, num_filters, filter_size, output_size,
                    stride, padding, dilation, groups, act):
    c_in = int(input.shape[1])
    ks = _transpose_ks(input.shape, filter_size, output_size, stride,
                       padding, nd, dilation)
    w = _param(input, (c_in, num_filters // groups) + ks)
    out = fn(input, w, stride=stride, padding=padding, dilation=dilation,
             groups=groups, output_size=output_size)
    return _maybe_act(out, act)


def conv2d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1, act=None,
                     name=None, **kwargs):
    """reference ``static/nn/common.py::conv2d_transpose``."""
    return _conv_transpose(F.conv2d_transpose, 2, input, num_filters,
                           filter_size, output_size, stride, padding,
                           dilation, groups, act)


def conv3d_transpose(input, num_filters, filter_size=None, output_size=None,
                     stride=1, padding=0, dilation=1, groups=1, act=None,
                     name=None, **kwargs):
    """reference ``static/nn/common.py::conv3d_transpose``."""
    return _conv_transpose(F.conv3d_transpose, 3, input, num_filters,
                           filter_size, output_size, stride, padding,
                           dilation, groups, act)


def prelu(x, mode="all", param_attr=None, data_format="NCHW", name=None):
    """reference ``static/nn/common.py::prelu``; ``mode`` in {'all',
    'channel', 'element'} sizes the slope parameter (0.25)."""
    if mode == "all":
        shape = (1,)
    elif mode == "channel":
        shape = (int(x.shape[1]),)
    elif mode == "element":
        shape = tuple(int(s) for s in x.shape[1:])
    else:
        raise ValueError(f"prelu mode {mode!r}")
    return act_mod.prelu(x, _param(x, shape, fill=0.25),
                         data_format=data_format)


def spectral_norm(weight, dim=0, power_iters=1, eps=1e-12, name=None):
    """reference ``static/nn/common.py::spectral_norm``: ``weight`` over its
    largest singular value (power iteration from persistent ``u``/``v``)."""
    h = int(weight.shape[dim])
    w = math.prod(int(s) for i, s in enumerate(weight.shape) if i != dim)
    u, v = _param(weight, (h,), scale=1.0), _param(weight, (w,), scale=1.0)
    return misc_ops.spectral_norm(weight, u, v, dim=dim,
                                  power_iters=power_iters, eps=eps)


def _maybe_act(out, act):
    return getattr(act_mod, act)(out) if act else out


# static-mode structured control flow (reference static/nn/control_flow.py)
from .control_flow import case, cond, switch_case, while_loop  # noqa: E402
