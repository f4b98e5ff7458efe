"""SPMD regions (port of ``paddle_tpu/distributed/spmd.py``).

The JAX package runs per-device code inside ``shard_map`` over mesh axes,
from one controller. The port runs one process a rank, so every rank calls
``spmd(fn, in_specs, out_specs, axes)`` on the same global inputs, and the
wrapper

- hands ``fn`` this rank's shard of each input, as the input's
  :class:`PartitionSpec` cuts it over the mesh (a copy: ``fn`` may write
  it in place, the caller's tensor stays);
- runs ``fn`` inside :func:`spmd_region`, where a collective called with no
  group, or with a group over other axes too, acts over the region's axes;
- rebuilds each output from the ranks' blocks by its spec, through one sum
  over the world: each block lands at its place in a zero tensor, and only
  the ranks at coordinate 0 of the axes the spec does not name contribute
  (the copy ``shard_map`` reads).

So a script written for the JAX package runs unchanged under the launcher,
and gives the JAX numbers. The gradients are ``shard_map``'s too (its
transpose with ``check_vma=False``): an output's cotangent reaches each
rank's block divided by the product of the axes its spec does not name,
and an input's cotangent is the sum over the ranks of their blocks' (which
sums over the axes its spec does not name).

``PartitionSpec`` (alias ``P``) is the port's own: ``P("dp")``,
``P(None, "dp")``, ``P(("dp", "mp"))`` as in ``jax.sharding``.
"""
from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Optional, Sequence

import torch

from ..core.tensor import plain, wrap
from . import env as env_mod

__all__ = ["P", "PartitionSpec", "current_region_axes", "in_spmd_region",
           "spmd", "spmd_region"]

_tls = threading.local()


class PartitionSpec(tuple):
    """One entry per leading dimension: None (whole), an axis name, or a
    tuple of axis names (the first major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def _region_stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = []
    return _tls.stack


def current_region_axes() -> Optional[tuple]:
    stack = _region_stack()
    return stack[-1] if stack else None


def in_spmd_region() -> bool:
    return bool(_region_stack())


@contextlib.contextmanager
def spmd_region(axes: Sequence[str]):
    _region_stack().append(tuple(axes))
    try:
        yield
    finally:
        _region_stack().pop()


def _dim_axes(spec, ndim: int) -> list:
    """Per dimension, the tuple of mesh axes that cut it."""
    entries = list(spec) + [None] * (ndim - len(spec))
    if len(entries) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    return [() if e is None else (tuple(e) if isinstance(e, (tuple, list))
                                  else (e,)) for e in entries]


class _Layout:
    """Where this rank's block of a global tensor lies under one spec."""

    def __init__(self, spec, ndim: int):
        mesh = env_mod.get_mesh()
        coords = mesh.coords(env_mod.get_rank())
        self.dims = _dim_axes(spec, ndim)
        named = {ax for axes in self.dims for ax in axes}
        self.parts, self.index = [], []
        for axes in self.dims:
            n, idx = 1, 0
            for ax in axes:
                n *= mesh.shape[ax]
                idx = idx * mesh.shape[ax] + coords[ax]
            self.parts.append(n)
            self.index.append(idx)
        others = [ax for ax in mesh.axis_names if ax not in named]
        # the copy shard_map reads, and the cotangent's divisor
        self.reader = all(coords[ax] == 0 for ax in others)
        self.unnamed = math.prod(mesh.shape[ax] for ax in others)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        for d, (n, i) in enumerate(zip(self.parts, self.index)):
            if n > 1:
                if x.shape[d] % n:
                    raise ValueError(f"dimension {d} of size {x.shape[d]} "
                                     f"does not split over {n} ranks")
                size = x.shape[d] // n
                x = x.narrow(d, i * size, size)
        return x

    def place(self, block: torch.Tensor, keep: bool) -> torch.Tensor:
        """A zero global tensor holding ``block`` at its place (when
        ``keep``), summed over the world: every block, once."""
        from .communication import _world_sum

        shape = [s * n for s, n in zip(block.shape, self.parts)]
        out = block.new_zeros(shape)
        if keep:
            self.block(out).copy_(block)
        return _world_sum(out)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return layout.block(x).clone()

    @staticmethod
    def backward(ctx, ct):
        return ctx.layout.place(ct.contiguous(), True), None


class _Assemble(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, layout):
        ctx.layout = layout
        return layout.place(y.contiguous(), layout.reader)

    @staticmethod
    def backward(ctx, ct):
        layout = ctx.layout
        return layout.block(ct) / layout.unnamed, None


def _specs(specs, n: int) -> list:
    if specs is None:
        return [P()] * n
    if isinstance(specs, PartitionSpec):
        return [specs] * n
    specs = list(specs)
    if len(specs) != n:
        raise ValueError(f"{len(specs)} specs for {n} values")
    return specs


def spmd(fn=None, *, mesh=None, in_specs=None, out_specs=None, axes=None,
         check_vma=False):
    """Wrap ``fn`` to run on this rank's shards over the mesh (collectives
    enabled). ``in_specs``/``out_specs``: a :class:`PartitionSpec`, or one
    per argument or output; default fully replicated. ``axes``: the mesh
    axes the body communicates over (default: all). ``mesh`` must be the
    installed one; ``check_vma`` is accepted, as JAX's."""
    if fn is None:
        return functools.partial(spmd, mesh=mesh, in_specs=in_specs,
                                 out_specs=out_specs, axes=axes,
                                 check_vma=check_vma)
    if mesh is not None and mesh is not env_mod.get_mesh():
        raise ValueError("spmd runs over the installed mesh (set_mesh)")

    @functools.wraps(fn)
    def wrapped(*args):
        m = env_mod.get_mesh()
        region_axes = tuple(axes) if axes is not None else m.axis_names
        shards = []
        for x, spec in zip(args, _specs(in_specs, len(args))):
            x = plain(x)
            shards.append(wrap(_Shard.apply(x, _Layout(spec, x.ndim))))
        with spmd_region(region_axes):
            out = fn(*shards)
        single = not isinstance(out, (tuple, list))
        outs = [out] if single else list(out)
        specs = ([out_specs if out_specs is not None else P()] if single
                 else _specs(out_specs, len(outs)))
        done = []
        for y, spec in zip(outs, specs):
            if not isinstance(y, torch.Tensor):
                done.append(y)
                continue
            y = plain(y)
            done.append(wrap(_Assemble.apply(y, _Layout(spec, y.ndim))))
        return done[0] if single else tuple(done)

    return wrapped
