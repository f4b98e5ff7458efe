"""Normalization functionals (port of ``paddle_tpu/nn/functional/norm.py``,
``layer_norm``, ``rms_norm``, ``batch_norm``, ``group_norm``,
``instance_norm`` and ``local_response_norm``)."""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ...amp.auto_cast import cast_inputs
from ...ops.cuda.rms_norm import rms_norm_value

__all__ = ["batch_norm", "group_norm", "instance_norm", "layer_norm",
           "local_response_norm", "rms_norm"]


def layer_norm(x, normalized_shape, weight=None, bias=None,
               epsilon: float = 1e-5):
    """LayerNorm over the trailing ``normalized_shape``; under AMP O2 it
    computes in f32 and returns f32 (op ``layer_norm``, black list)."""
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    x, weight, bias = cast_inputs("layer_norm", x, weight, bias)
    return TF.layer_norm(x, tuple(normalized_shape), weight, bias, epsilon)


def rms_norm(x, weight=None, epsilon: float = 1e-6):
    """RMSNorm over the last axis. With a weight it takes the route the JAX
    package takes on the TPU: the fused kernel (for CUDA tensors K4 and
    the backward kernel, for CPU tensors their plain versions) under op
    ``pallas_rms_norm``, white-listed, so under AMP O2 x and w enter in
    bf16 and the result is bf16. Without a weight it is the JAX fallback
    in plain torch under op ``rms_norm``, black-listed: f32 under O2."""
    if weight is None:
        (x,) = cast_inputs("rms_norm", x)
        ms = torch.mean(torch.square(x), dim=-1, keepdim=True)
        return x * torch.rsqrt(ms + epsilon)
    x, weight = cast_inputs("pallas_rms_norm", x, weight)
    return rms_norm_value(x, weight, epsilon, device=x.device)


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training: bool = False, momentum: float = 0.9,
               epsilon: float = 1e-5, data_format: str = "NCHW",
               use_global_stats=None):
    """BatchNorm over every axis but the channel's (axis 1 for an ``NC*``
    layout, else the last).

    - With batch statistics (``training``, unless ``use_global_stats``
      says otherwise): ``(x − mean)·rsqrt(var + eps)·w + b`` with the
      batch's biased variance (op ``batch_norm``), and the running stats
      move as the JAX function moves them, ``m·running + (1 − m)·batch``
      with the unbiased variance ``var·n/(n − 1)`` (``m`` is the kept
      share: torch's ``momentum`` is ``1 − m``).
    - With the running stats: the same formula over them (op
      ``batch_norm_infer``), and nothing moves.

    Both ops are black under AMP: f32 in, f32 out. The running stats are
    written in place (``copy_``), so a CUDA graph that captured them keeps
    accumulating into the same storage. One exception, as in the JAX
    package: when the update's dtype differs from the buffer's (``decorate``
    cast the buffers to bf16 at O2 and the batch stats are f32), the buffer
    takes the f32 value once (``.data``, the same tensor object); that
    raises while a CUDA stream is capturing, where the graph would hold a
    tensor the module never sees."""
    ch_axis = 1 if data_format.startswith("NC") and x.ndim > 1 else x.ndim - 1
    use_stats = (not training) if use_global_stats is None \
        else use_global_stats
    if use_stats:
        x, running_mean, running_var, weight, bias = cast_inputs(
            "batch_norm_infer", x, running_mean, running_var, weight, bias)
    else:
        x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    if ch_axis != 1:
        x = x.movedim(ch_axis, 1)
    out = torch.native_batch_norm(
        x, weight, bias, running_mean if use_stats else None,
        running_var if use_stats else None, not use_stats, 0.0, epsilon)[0]
    if not use_stats and running_mean is not None:
        axes = [i for i in range(x.ndim) if i != 1]
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=axes, correction=0)
            n = x.numel() // x.shape[1]
            unbiased = var * (n / max(n - 1, 1))
            _store_stat(running_mean, momentum * running_mean
                        + (1 - momentum) * mean)
            _store_stat(running_var, momentum * running_var
                        + (1 - momentum) * unbiased)
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def sync_batch_norm(x, running_mean, running_var, weight=None, bias=None,
                    momentum: float = 0.9, epsilon: float = 1e-5,
                    data_format: str = "NCHW", group=None):
    """Training-mode BatchNorm whose statistics span every rank of
    ``group`` (a ``distributed.Group``; default the ``dp`` axis): the
    per-channel sum and row count, then the sum of squared deviations
    from the global mean, each all-reduced (two passes, as ``jnp.var``
    takes them), so the output and the running stats are those of
    BatchNorm over all the ranks' rows. The all-reduces carry JAX's
    ``psum`` gradient (the cotangents summed over the ranks), so after
    ``DataParallel`` averages the parameters' gradients they are those of
    the global batch's mean loss. Black under AMP, as ``batch_norm``; the
    running stats follow ``batch_norm``'s storage rule."""
    from ...distributed import communication as comm
    from ...distributed.parallel import _dp_group

    c = comm._comm(group if group is not None else _dp_group())
    ch_axis = 1 if data_format.startswith("NC") and x.ndim > 1 else x.ndim - 1
    x, weight, bias = cast_inputs("batch_norm", x, weight, bias)
    if ch_axis != 1:
        x = x.movedim(ch_axis, 1)
    axes = [i for i in range(x.ndim) if i != 1]
    channels = x.shape[1]
    shape = [1, channels] + [1] * (x.ndim - 2)
    local = torch.cat([x.sum(axes), x.new_full((1,), x.numel() // channels)])
    total = comm._AllReduce.apply(local, comm.ReduceOp.SUM, c)
    n = total[channels]
    mean = total[:channels] / n
    centered = x - mean.reshape(shape)
    var = comm._AllReduce.apply((centered * centered).sum(axes),
                                comm.ReduceOp.SUM, c) / n
    out = centered * torch.rsqrt(var + epsilon).reshape(shape)
    out = _affine(out, weight, bias, shape)
    if running_mean is not None:
        with torch.no_grad():
            unbiased = var * (n / torch.clamp(n - 1, min=1))
            _store_stat(running_mean, momentum * running_mean
                        + (1 - momentum) * mean.detach())
            _store_stat(running_var, momentum * running_var
                        + (1 - momentum) * unbiased)
    return out.movedim(1, ch_axis) if ch_axis != 1 else out


def _store_stat(buffer: torch.Tensor, value: torch.Tensor) -> None:
    """``buffer ← value``: in place when the dtypes agree, else (the first
    O2 step's bf16 → f32) by taking the value's storage, which must not
    happen under CUDA graph capture."""
    if buffer.dtype == value.dtype:
        buffer.copy_(value)
        return
    if buffer.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"batch_norm would rebind a {buffer.dtype} running stat to "
            f"{value.dtype} inside a CUDA graph capture; the graph would "
            f"write a tensor the module never reads. Run one eager step "
            f"first (TrainStep's first call is eager)")
    buffer.data = value


def _affine(out, weight, bias, shape):
    if weight is not None:
        out = out * weight.reshape(shape)
    if bias is not None:
        out = out + bias.reshape(shape)
    return out


def instance_norm(x, running_mean=None, running_var=None, weight=None,
                  bias=None, use_input_stats=True, momentum=0.9, eps=1e-5,
                  data_format="NCHW", name=None):
    """Each sample's channel normalized over its spatial axes with its own
    mean and biased variance, then the per-channel affine, as the JAX
    function computes it (the running stats are accepted and unused, as
    there). Op ``instance_norm``, black under AMP."""
    x, weight, bias = cast_inputs("instance_norm", x, weight, bias)
    ch_axis = 1 if data_format.startswith("NC") else x.ndim - 1
    spatial = (tuple(range(2, x.ndim)) if ch_axis == 1
               else tuple(range(1, x.ndim - 1)))
    var, mean = torch.var_mean(x, dim=spatial, correction=0, keepdim=True)
    out = (x - mean) * torch.rsqrt(var + eps)
    shape = [1] * x.ndim
    shape[ch_axis] = x.shape[ch_axis]
    return _affine(out, weight, bias, shape)


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """The channels split into ``num_groups`` groups, each sample's group
    normalized with its mean and biased variance, then the per-channel
    affine, as the JAX function computes it. Op ``group_norm``, black
    under AMP."""
    x, weight, bias = cast_inputs("group_norm", x, weight, bias)
    channel_last = not data_format.startswith("NC")
    v = x.movedim(-1, 1) if channel_last else x
    b, c = v.shape[0], v.shape[1]
    g = v.reshape((b, num_groups, c // num_groups) + tuple(v.shape[2:]))
    var, mean = torch.var_mean(g, dim=tuple(range(2, g.ndim)), correction=0,
                               keepdim=True)
    out = ((g - mean) * torch.rsqrt(var + epsilon)).reshape(v.shape)
    shape = [1] * out.ndim
    shape[1] = c
    out = _affine(out, weight, bias, shape)
    return out.movedim(1, -1) if channel_last else out


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """``x / (k + alpha · Σ x²)^beta``, the sum over ``size`` neighbouring
    channels (``size // 2`` before, the rest after, zero-padded), added
    one window offset at a time as the JAX function adds them."""
    ch = 1 if data_format.startswith("NC") else x.dim() - 1
    c = x.shape[ch]
    half = size // 2
    pads = [0, 0] * (x.dim() - 1 - ch) + [half, size - half - 1]
    padded = TF.pad(torch.square(x), pads)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + padded.narrow(ch, i, c)
    return x / (k + alpha * acc) ** beta
