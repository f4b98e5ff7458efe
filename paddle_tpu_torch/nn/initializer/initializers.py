"""Parameter initializers (port of ``paddle_tpu/nn/initializer/
initializers.py``).

An initializer fills a parameter in place: ``init(param)``. It computes
on the parameter's shape in the JAX package, which for a ``Linear`` weight
is ``[in, out]`` where the port keeps torch's ``[out, in]``: a parameter
whose ``transposed`` attribute is set (``Linear`` sets it on its weight)
is filled with the transpose of what the initializer computes on the
reversed shape, so the fans, the bounds and ``Assign``'s layout are the
JAX package's. The random ones draw on the CPU, in float32, from an
explicit ``torch.Generator`` (``generator=``; default: the process-wide
build generator that ``paddle.seed`` seeds, ``base.global_state``), then
cast and copy into the parameter: one seed gives the same values on every
device. Their stream is torch's, not JAX's threefry, so the two packages
draw other values from one seed, of the same law.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ...base.global_state import build_generator

__all__ = ["Assign", "Bilinear", "Constant", "Dirac", "Initializer",
           "KaimingNormal", "KaimingUniform", "Normal", "Orthogonal",
           "TruncatedNormal", "Uniform", "XavierNormal", "XavierUniform",
           "calculate_gain", "global_initializer", "set_global_initializer"]

_global_weight_init = None
_global_bias_init = None


def set_global_initializer(weight_init, bias_init=None) -> None:
    """The initializers ``create_parameter`` falls back on when neither the
    ``ParamAttr`` nor the layer names one."""
    global _global_weight_init, _global_bias_init
    _global_weight_init, _global_bias_init = weight_init, bias_init


def global_initializer(is_bias: bool):
    return _global_bias_init if is_bias else _global_weight_init


def calculate_gain(nonlinearity, param=None) -> float:
    gains = {
        "sigmoid": 1.0, "linear": 1.0, "conv1d": 1.0, "conv2d": 1.0,
        "conv3d": 1.0, "tanh": 5.0 / 3.0, "relu": math.sqrt(2.0),
        "leaky_relu": math.sqrt(
            2.0 / (1 + (param if param is not None else 0.01) ** 2)),
        "selu": 3.0 / 4.0,
    }
    return gains[nonlinearity]


def _fan_in_out(shape) -> tuple:
    """Fans as the JAX package reckons them on its own shape: ``[in,
    out]`` for a 2-D weight, ``[out, in / groups, *k]`` for a kernel."""
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def jax_shape(param) -> tuple:
    """The parameter's shape in the JAX package (reversed for a
    ``transposed`` one)."""
    shape = tuple(param.shape)
    return shape[::-1] if getattr(param, "transposed", False) else shape


class Initializer:
    """``init(param, generator=None)`` fills ``param`` in place and
    returns it. A subclass computes the values, a CPU tensor, in
    ``_values(shape, gen)`` on the JAX shape, which the fans are reckoned
    on; a ``transposed`` parameter takes their transpose."""

    def __call__(self, param, block=None, generator=None):
        gen = generator if generator is not None else build_generator()
        value = torch.as_tensor(self._values(jax_shape(param), gen))
        if getattr(param, "transposed", False):
            value = value.t()
        with torch.no_grad():
            param.copy_(value)
        return param

    def _values(self, shape, gen):
        raise NotImplementedError


def _empty(shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32)


class Constant(Initializer):
    def __init__(self, value=0.0):
        self.value = value

    def _values(self, shape, gen):
        return torch.full(shape, float(self.value))


class Normal(Initializer):
    def __init__(self, mean=0.0, std=1.0):
        self.mean, self.std = mean, std

    def _values(self, shape, gen):
        return _empty(shape).normal_(self.mean, self.std, generator=gen)


class TruncatedNormal(Initializer):
    """Normal of ``mean`` and ``std`` cut to ``[a, b]`` (absolute bounds,
    as JAX's ``(a - mean) / std``), by the inverse CDF of a uniform draw
    between the bounds' CDF values."""

    def __init__(self, mean=0.0, std=1.0, a=-2.0, b=2.0):
        self.mean, self.std, self.a, self.b = mean, std, a, b

    def _values(self, shape, gen):
        def cdf(v):
            return 0.5 * (1.0 + math.erf(v / math.sqrt(2.0)))

        lo = cdf((self.a - self.mean) / self.std)
        hi = cdf((self.b - self.mean) / self.std)
        u = _empty(shape).uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
        z = torch.erfinv(u) * math.sqrt(2.0)
        z = z.clamp((self.a - self.mean) / self.std,
                    (self.b - self.mean) / self.std)
        return self.mean + self.std * z


class Uniform(Initializer):
    def __init__(self, low=-1.0, high=1.0):
        self.low, self.high = low, high

    def _values(self, shape, gen):
        return _empty(shape).uniform_(self.low, self.high, generator=gen)


class XavierNormal(Initializer):
    """Normal of std ``gain · sqrt(2 / (fan_in + fan_out))``."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def std(self, shape) -> float:
        fi, fo = _fan_in_out(shape)
        return self.gain * math.sqrt(2.0 / ((self.fan_in or fi)
                                            + (self.fan_out or fo)))

    def _values(self, shape, gen):
        return _empty(shape).normal_(0.0, self.std(shape), generator=gen)


class XavierUniform(Initializer):
    """Uniform within ``±gain · sqrt(6 / (fan_in + fan_out))``."""

    def __init__(self, fan_in=None, fan_out=None, gain=1.0):
        self.fan_in, self.fan_out, self.gain = fan_in, fan_out, gain

    def limit(self, shape) -> float:
        fi, fo = _fan_in_out(shape)
        return self.gain * math.sqrt(6.0 / ((self.fan_in or fi)
                                            + (self.fan_out or fo)))

    def _values(self, shape, gen):
        lim = self.limit(shape)
        return _empty(shape).uniform_(-lim, lim, generator=gen)


class KaimingNormal(Initializer):
    """Normal of std ``gain / sqrt(fan_in)``."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def std(self, shape) -> float:
        fi = self.fan_in or _fan_in_out(shape)[0]
        return calculate_gain(self.nonlinearity,
                              self.negative_slope) / math.sqrt(fi)

    def _values(self, shape, gen):
        return _empty(shape).normal_(0.0, self.std(shape), generator=gen)


class KaimingUniform(Initializer):
    """Uniform within ``±gain · sqrt(3 / fan_in)``."""

    def __init__(self, fan_in=None, negative_slope=0.0, nonlinearity="relu"):
        self.fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def limit(self, shape) -> float:
        fi = self.fan_in or _fan_in_out(shape)[0]
        return calculate_gain(self.nonlinearity,
                              self.negative_slope) * math.sqrt(3.0 / fi)

    def _values(self, shape, gen):
        lim = self.limit(shape)
        return _empty(shape).uniform_(-lim, lim, generator=gen)


class Orthogonal(Initializer):
    """``gain`` times the Q of a normal draw's QR (signs fixed by R's
    diagonal), over ``[rows, prod(rest)]``, as the JAX initializer."""

    def __init__(self, gain=1.0):
        self.gain = gain

    def _values(self, shape, gen):
        rows = shape[0]
        cols = int(np.prod(shape[1:]))
        flat = _empty((max(rows, cols), min(rows, cols))).normal_(
            generator=gen)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        if rows < cols:
            q = q.t()
        return self.gain * q[:rows, :cols].reshape(shape)


class Dirac(Initializer):
    """1 at the centre tap of output channel ``g · out/groups + i`` from
    input channel ``i``, 0 elsewhere (exact)."""

    def __init__(self, groups=1):
        self.groups = groups

    def _values(self, shape, gen):
        out = np.zeros(shape, np.float32)
        per_group = shape[0] // self.groups
        mid = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(per_group, shape[1])):
                out[(g * per_group + i, i) + mid] = 1.0
        return torch.from_numpy(out)


class Bilinear(Initializer):
    """The bilinear upsampling kernel on the last two axes (exact)."""

    def _values(self, shape, gen):
        k = shape[-1]
        factor = (k + 1) // 2
        center = factor - 1 if k % 2 == 1 else factor - 0.5
        og = np.ogrid[:k, :k]
        filt = ((1 - abs(og[0] - center) / factor)
                * (1 - abs(og[1] - center) / factor))
        out = np.zeros(shape, np.float32)
        out[range(shape[0]), range(shape[1]) if shape[1] == shape[0] else 0,
            :, :] = filt
        return torch.from_numpy(out)


class Assign(Initializer):
    """``value`` (an array, a list or a tensor) reshaped to the JAX shape
    (exact)."""

    def __init__(self, value):
        self.value = value

    def _values(self, shape, gen):
        v = self.value
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            if v.dtype == torch.bfloat16:
                v = v.float()
            v = v.numpy()
        return torch.from_numpy(np.array(v).reshape(shape))
