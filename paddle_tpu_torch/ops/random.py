"""Random ops (port of ``paddle_tpu/ops/random.py``).

Every draw comes from torch's default generator of the device it lands on
(the CPU's or the CUDA device's), which ``paddle.seed`` seeds: one seed
repeats a stream. The streams are torch's, not JAX's threefry, so the
same seed gives other values in the two packages; shapes, dtypes, bounds
and moments agree. A new tensor lands on the default device; an in-place
draw (``uniform_``, ``normal_``, ...) and a ``*_like`` one on the given
tensor's.
"""
from __future__ import annotations

import math

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from . import _common as c

__all__ = ["bernoulli", "bernoulli_", "binomial", "cauchy_", "dirichlet",
           "exponential_", "gaussian", "geometric_", "log_normal_",
           "multinomial", "normal", "normal_", "poisson", "rand", "randint",
           "randint_like", "randn", "randperm", "shuffle", "standard_gamma",
           "standard_normal", "truncated_normal", "uniform", "uniform_"]


def _dev():
    return resolve_device(DEFAULT_DEVICE)


def _generator(seed, device):
    """A generator seeded ``seed`` on ``device``; None (the default one)
    for seed 0, as Paddle reads 0 as "no seed"."""
    if not seed:
        return None
    return torch.Generator(device=device).manual_seed(int(seed))


def rand(shape, dtype=None, name=None):
    """Uniform on [0, 1)."""
    return torch.rand(c.shape(shape), dtype=c.dtype(dtype), device=_dev())


def randn(shape, dtype=None, name=None):
    """Standard normal."""
    return torch.randn(c.shape(shape), dtype=c.dtype(dtype), device=_dev())


def standard_normal(shape, dtype=None, name=None):
    return randn(shape, dtype)


def normal(mean=0.0, std=1.0, shape=None, name=None):
    """Normal(``mean``, ``std``): tensors broadcast to the shape of the
    draw, numbers need ``shape`` (default ``[1]``)."""
    if isinstance(mean, torch.Tensor) or isinstance(std, torch.Tensor):
        m = c.tensor(mean) if isinstance(mean, torch.Tensor) else mean
        s = c.tensor(std) if isinstance(std, torch.Tensor) else std
        like = m if isinstance(m, torch.Tensor) else s
        size = torch.broadcast_shapes(getattr(m, "shape", ()),
                                      getattr(s, "shape", ()))
        return torch.randn(size, dtype=like.dtype, device=like.device) * s + m
    return torch.randn(c.shape(shape or [1]), dtype=c.dtype(None),
                       device=_dev()) * std + mean


def gaussian(shape, mean=0.0, std=1.0, seed=0, dtype=None, name=None):
    """Normal(``mean``, ``std``) of ``shape``; a nonzero ``seed`` draws
    from a generator of its own."""
    dev = _dev()
    out = torch.randn(c.shape(shape), dtype=c.dtype(dtype), device=dev,
                      generator=_generator(seed, dev))
    return out * std + mean


def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0,  # noqa: A002
            name=None):
    """Uniform on [``min``, ``max``); a nonzero ``seed`` draws from a
    generator of its own."""
    dev = _dev()
    out = torch.rand(c.shape(shape), dtype=c.dtype(dtype), device=dev,
                     generator=_generator(seed, dev))
    return out * (max - min) + min


def uniform_(x, min=-1.0, max=1.0, seed=0, name=None):  # noqa: A002
    with torch.no_grad():
        torch.Tensor.uniform_(x, min, max,
                              generator=_generator(seed, x.device))
    return x


def randint(low=0, high=None, shape=(1,), dtype="int64", name=None):
    """Integers uniform on [``low``, ``high``) (on [0, ``low``) when
    ``high`` is None)."""
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), c.shape(shape),
                         dtype=c.dtype(dtype), device=_dev())


def randint_like(x, low=0, high=None, dtype=None, name=None):
    x = c.tensor(x)
    if high is None:
        low, high = 0, low
    return torch.randint(int(low), int(high), x.shape,
                         dtype=c.dtype(dtype, x.dtype), device=x.device)


def randperm(n, dtype="int64", name=None):
    return torch.randperm(int(n), dtype=c.dtype(dtype), device=_dev())


def shuffle(x, axis=0):
    """``x`` with its slices along ``axis`` in a random order."""
    x = c.tensor(x)
    perm = torch.randperm(x.shape[axis], device=x.device)
    return torch.index_select(x, axis, perm)


def multinomial(x, num_samples=1, replacement=False, name=None):
    """Class indices drawn from the rows of ``x`` (unnormalized
    probabilities)."""
    x = c.tensor(x)
    return torch.multinomial(x.float(), int(num_samples), replacement)


def bernoulli(x, name=None):
    """1 with probability ``x``, else 0, in ``x``'s dtype."""
    x = c.tensor(x)
    return torch.bernoulli(x)


def bernoulli_(x, p=0.5, name=None):
    with torch.no_grad():
        torch.Tensor.bernoulli_(x, p)
    return x


def poisson(x, name=None):
    """Poisson counts with rates ``x``, in ``x``'s dtype."""
    return torch.poisson(c.tensor(x))


def binomial(count, prob, name=None):
    """Binomial(``count``, ``prob``) counts as int64."""
    count, prob = c.operands(count, prob)
    dist = torch.distributions.Binomial(total_count=count.float(),
                                        probs=prob.float())
    return dist.sample().to(torch.int64)


def exponential_(x, lam=1.0, name=None):
    with torch.no_grad():
        torch.Tensor.exponential_(x, lam)
    return x


def cauchy_(x, loc=0, scale=1, name=None):
    with torch.no_grad():
        torch.Tensor.cauchy_(x, loc, scale)
    return x


def geometric_(x, probs, name=None):
    """Trials to the first success with probability ``probs``, as
    ``ceil(log(u) / log(1 - probs))`` over a uniform ``u``."""
    with torch.no_grad():
        u = torch.rand(x.shape, dtype=x.dtype, device=x.device).clamp_min(
            1e-7)
        torch.Tensor.copy_(x, torch.ceil(torch.log(u) / math.log1p(-probs)))
    return x


def log_normal_(x, mean=1.0, std=2.0, name=None):
    with torch.no_grad():
        torch.Tensor.log_normal_(x, mean, std)
    return x


def normal_(x, mean=0.0, std=1.0, name=None):
    with torch.no_grad():
        torch.Tensor.normal_(x, mean, std)
    return x


def truncated_normal(shape, mean=0.0, std=1.0, a=-2.0, b=2.0, dtype=None,
                     name=None):
    """Normal(``mean``, ``std``) held to [``a``, ``b``] by redrawing, as
    ``torch.nn.init.trunc_normal_`` does."""
    out = torch.empty(c.shape(shape), dtype=torch.float32, device=_dev())
    torch.nn.init.trunc_normal_(out, mean, std, a, b)
    return out.to(c.dtype(dtype))


def standard_gamma(x, name=None):
    """Gamma(``x``, 1) draws."""
    x = c.tensor(x)
    return torch._standard_gamma(x)


def dirichlet(alpha, name=None):
    """Dirichlet(``alpha``) draws over the last axis."""
    alpha = c.tensor(alpha)
    return torch._sample_dirichlet(alpha)
