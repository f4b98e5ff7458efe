"""``paddle.flops``: per-layer FLOP and parameter accounting (port of
``paddle_tpu/hapi/dynamic_flops.py``; reference:
python/paddle/hapi/dynamic_flops.py). Forward hooks record each leaf
module's multiply-accumulate count from its real input and output shapes,
summed over one dry forward.

The per-layer formulas are the port's own copy of the JAX package's
(``paddle_tpu/analysis/cost_model.py``: ``linear_flops``, ``conv_flops``,
``norm_flops``, ``activation_flops``, ``pool_flops``), so both count the
same layers alike. Layers are matched by class name; ``custom_ops`` maps
layer classes to ``fn(layer, x, y) -> flops`` counters, as the reference
does."""
from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

__all__ = ["flops"]


def _numel(shape):
    n = 1
    for s in shape:
        n *= int(s)
    return n


def linear_flops(out_numel: int, in_features: int, has_bias: bool) -> int:
    """Dense layer: one MAC per (output element, input feature)."""
    return out_numel * in_features + (out_numel if has_bias else 0)


def conv_flops(out_numel: int, cin_per_group: int, kernel_numel: int,
               has_bias: bool) -> int:
    """Convolution: one MAC per (output element, in-channel, kernel tap)."""
    return out_numel * cin_per_group * kernel_numel + (
        out_numel if has_bias else 0)


def norm_flops(in_numel: int) -> int:
    """Normalization layers: about two passes (statistics and affine)."""
    return 2 * in_numel


def activation_flops(out_numel: int) -> int:
    return out_numel


def pool_flops(out_numel: int, kernel_numel: int) -> int:
    return out_numel * kernel_numel


def _count_conv(layer, x, y):
    # torch's and Paddle's weight: [out, in / groups, *kernel]
    return conv_flops(_numel(y.shape), int(layer.weight.shape[1]),
                      _numel(layer.weight.shape[2:]),
                      getattr(layer, "bias", None) is not None)


def _count_linear(layer, x, y):
    # torch's weight is [out, in] (the JAX layer's is [in, out])
    return linear_flops(_numel(y.shape), int(layer.weight.shape[1]),
                        getattr(layer, "bias", None) is not None)


def _count_norm(layer, x, y):
    return norm_flops(_numel(x.shape))


def _count_act(layer, x, y):
    return activation_flops(_numel(y.shape))


def _count_pool(layer, x, y):
    ks = getattr(layer, "kernel_size", 2)
    k = _numel(ks) if isinstance(ks, (list, tuple)) else int(ks) ** 2
    return pool_flops(_numel(y.shape), k)


_COUNTERS = {
    "Conv1D": _count_conv, "Conv2D": _count_conv, "Conv3D": _count_conv,
    "Conv1DTranspose": _count_conv, "Conv2DTranspose": _count_conv,
    "Conv3DTranspose": _count_conv,
    "Linear": _count_linear,
    "BatchNorm": _count_norm, "BatchNorm1D": _count_norm,
    "BatchNorm2D": _count_norm, "BatchNorm3D": _count_norm,
    "LayerNorm": _count_norm, "GroupNorm": _count_norm,
    "InstanceNorm2D": _count_norm,
    "ReLU": _count_act, "ReLU6": _count_act, "GELU": _count_act,
    "Sigmoid": _count_act, "Tanh": _count_act, "Silu": _count_act,
    "SiLU": _count_act, "Softmax": _count_act, "LeakyReLU": _count_act,
    "MaxPool1D": _count_pool, "MaxPool2D": _count_pool,
    "MaxPool3D": _count_pool, "AvgPool1D": _count_pool,
    "AvgPool2D": _count_pool, "AvgPool3D": _count_pool,
}


@torch.no_grad()
def flops(net, input_size, custom_ops: Optional[dict] = None,
          print_detail: bool = False) -> int:
    """Total forward FLOPs of ``net`` on an ``input_size`` batch of f32
    zeros on the network's device (reference ``paddle.flops``)."""
    custom = {cls.__name__: fn for cls, fn in (custom_ops or {}).items()}
    rows = []
    handles = []

    def attach(layer):
        name = type(layer).__name__
        counter = custom.get(name) or _COUNTERS.get(name)
        if counter is None or list(layer.children()):
            return

        def hook(lay, inputs, output, _counter=counter):
            x = inputs[0] if isinstance(inputs, (list, tuple)) else inputs
            y = output[0] if isinstance(output, (list, tuple)) else output
            n_params = int(sum(p.numel()
                               for p in lay.parameters(recurse=False)))
            rows.append((type(lay).__name__, list(np.shape(y)),
                         n_params, int(_counter(lay, x, y))))

        handles.append(layer.register_forward_hook(hook))

    for sub in net.modules():
        attach(sub)
    dev = next((p.device for p in net.parameters()), torch.device("cpu"))
    was_training = net.training
    net.eval()
    try:
        net(torch.zeros(tuple(input_size), dtype=torch.float32, device=dev))
    finally:
        if was_training:
            net.train()
        for h in handles:
            h.remove()
    total = sum(r[3] for r in rows)
    if print_detail:
        log = logging.getLogger("paddle_tpu_torch")
        log.info("%-18s %-20s %12s %14s", "Layer", "Output shape",
                 "Params", "FLOPs")
        for name, shape, n_params, f in rows:
            log.info("%-18s %-20s %12d %14d", name, shape, n_params, f)
        log.info("Total FLOPs: %d  (~%.3f GFLOPs)", total, total / 1e9)
    return total
