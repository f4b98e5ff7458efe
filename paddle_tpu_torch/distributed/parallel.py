"""``DataParallel`` and the data-parallel entry points (port of
``paddle_tpu/distributed/parallel.py``).

The JAX ``DataParallel`` keeps a global batch and lets XLA's partitioner
insert the gradient all-reduce. The port runs one process a rank, as
upstream Paddle does (``python/paddle/distributed/parallel.py:219`` and its
C++ ``Reducer``):

- at wrap, every parameter and buffer is broadcast from rank 0 of the
  ``dp`` group (:func:`replicate_layer`), so every rank starts equal;
- each rank's forward runs on its own rows (:func:`shard_batch`, or a
  ``DistributedBatchSampler``); ``forward`` passes its inputs through;
- at the end of each backward (an autograd final callback, queued by the
  first parameter whose gradient lands), the gradients are all-reduced in
  flat buckets of ``comm_buffer_size`` MB (the first, which holds the last
  parameters, of ``last_comm_buffer_size`` MB), in reverse parameter order,
  one dtype a bucket, and divided by the ``dp`` degree: each rank ends the
  backward holding the mean of the ranks' gradients.

So the averaged gradient is the JAX package's global-batch gradient when
the loss is a mean over equal rank batches, as every training loss here
is. For a sum loss it is that gradient over the degree (upstream Paddle's
behaviour too; ``ROADMAP.md`` queue 3).

Inside a ``TrainStep`` the reduction runs between the backward and the
optimizer's update; on NCCL the whole step, its all-reduces included, is
one CUDA graph. ``no_sync()`` skips the reduction (gradients accumulate
locally); ``find_unused_parameters=True`` reduces zeros for a parameter
that got no gradient (without it, such a parameter raises).
``FLAGS_comm_quantize_dp_grads`` asks for the int8 tier of
``collective_opt``, which is not ported (``ROADMAP.md``, queue 7): the
wrapper raises while it is on.
"""
from __future__ import annotations

import contextlib
from typing import List

import numpy as np
import torch

from ..base.flags import get_flag
from ..core.tensor import Tensor, plain
from ..nn.layer.layers import Layer
from . import communication as comm
from . import env as env_mod
from .env import init_parallel_env  # re-export  # noqa: F401

__all__ = ["DataParallel", "GradientReducer", "ParallelEnv",
           "init_parallel_env", "replicate_layer", "shard_batch"]

_MB = 1 << 20


def shard_batch(x, mesh=None, axis: str = "dp", dim: int = 0):
    """This rank's contiguous rows of the global batch ``x`` along ``dim``:
    the shard that device ``r`` holds under ``P("dp")`` in the JAX package,
    ``r`` this rank's coordinate on ``axis``. A ``Tensor`` is cut in
    place (and returned); a plain tensor or an array comes back cut."""
    mesh = mesh or env_mod.get_mesh()
    n = mesh.shape[axis]
    if n == 1:
        return x
    size = x.shape[dim]
    if size % n:
        raise ValueError(f"shard_batch: dimension {dim} of size {size} "
                         f"does not split over {n} ranks of '{axis}'")
    idx = mesh.coords(env_mod.get_rank())[axis]
    rows = size // n
    if isinstance(x, np.ndarray):
        return np.take(x, np.arange(idx * rows, (idx + 1) * rows), axis=dim)
    cut = plain(x).detach().narrow(dim, idx * rows, rows).contiguous()
    # a Tensor itself, not any torch tensor (isinstance holds for those)
    if issubclass(type(x), Tensor):
        x.data = cut
        return x
    return cut


def _dp_group() -> comm.Group:
    group = comm.Group(("dp",))
    env_mod.axes_group(group.axes)  # every rank creates it now
    return group


def replicate_layer(layer: Layer, mesh=None, group=None):
    """Every parameter and buffer of ``layer`` set to rank 0's (of the
    ``dp`` group, or ``group``), in place."""
    c = comm._comm(group if group is not None else _dp_group())
    with torch.no_grad():
        for t in list(layer.parameters()) + list(layer.buffers()):
            comm._broadcast_(plain(t), 0, c)
    return layer


def _buckets(params: List[torch.Tensor], size_mb: float,
             first_mb: float) -> List[List[torch.Tensor]]:
    """``params`` in reverse order, cut into buckets of one dtype and
    device: the first up to ``first_mb`` MB, the others up to ``size_mb``
    MB (a larger tensor is a bucket of its own)."""
    buckets, current, nbytes = [], [], 0
    limit = first_mb * _MB
    for p in reversed(params):
        size = p.numel() * p.element_size()
        if current and (p.dtype != current[0].dtype
                        or p.device != current[0].device
                        or nbytes + size > limit):
            buckets.append(current)
            current, nbytes = [], 0
            limit = size_mb * _MB
        current.append(p)
        nbytes += size
    if current:
        buckets.append(current)
    return buckets


class GradientReducer:
    """The gradients of ``params`` summed over ``group`` and divided by
    ``divisor`` (default: the group's size, the mean), at the end of a
    backward (an autograd final callback, queued by the first parameter
    whose gradient lands), in flat buckets of one dtype (:func:`_buckets`).
    ``DataParallel`` and the sequence-parallel hooks both reduce with it.

    Any number of backwards may run before the optimizer's step. The
    reduction is a mean, which leaves a gradient that is already reduced
    (the same on every member) as it is, so it reduces only what the new
    backward added. A ``divisor`` other than the group's size ``n`` is
    reached by scaling each incoming gradient by ``n / divisor`` (a tensor
    hook) before it accumulates: the mean of the scaled sums is then
    ``Σ g / divisor``. While ``sync`` is off (``DataParallel.no_sync``),
    and on every backward but each ``accumulation_steps``-th, nothing is
    reduced and the gradients accumulate on each rank (scaled so, when
    ``divisor`` is given). On NCCL a captured ``TrainStep`` holds the
    all-reduces in its graph; a captured step runs one backward, so it
    takes ``accumulation_steps`` 1."""

    def __init__(self, params: List[torch.Tensor], group, divisor=None,
                 size_mb: float = 25.0, first_mb: float = 25.0,
                 find_unused_parameters: bool = False,
                 accumulation_steps: int = 1):
        if int(accumulation_steps) < 1:
            raise ValueError(f"accumulation_steps must be at least 1, got "
                             f"{accumulation_steps}")
        self.params = list(params)
        self.group = group
        self.comm = comm._comm(group)
        self.find_unused_parameters = find_unused_parameters
        self.accumulation_steps = int(accumulation_steps)
        self.sync = True
        self.buckets = _buckets(self.params, size_mb, first_mb)
        self._queued = False
        self._backwards = 0
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in self.params]
        n = self.comm.n
        self.divisor = n if divisor is None else divisor
        if self.divisor != n:
            scale = n / self.divisor
            self._hooks += [p.register_hook(lambda g: g * scale)
                            for p in self.params]

    def _on_grad(self, param) -> None:
        if not self._queued:
            if (self.accumulation_steps > 1 and torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    "a captured step runs one backward: reduce with "
                    "accumulation_steps=1")
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._end_backward)

    def _end_backward(self) -> None:
        self._queued = False
        self._backwards += 1
        if self.sync and self._backwards % self.accumulation_steps == 0:
            self.reduce()

    def reduce(self) -> None:
        """Every bucket's gradients all-reduced and divided by the group's
        size, in place."""
        n = self.comm.n
        with torch.no_grad():
            for bucket in self.buckets:
                grads = []
                for p in bucket:
                    if p.grad is None:
                        if not self.find_unused_parameters:
                            name = getattr(p, "param_name", None) or \
                                tuple(p.shape)
                            raise RuntimeError(
                                f"parameter {name} got no gradient in "
                                f"this backward; pass DataParallel "
                                f"find_unused_parameters=True to reduce "
                                f"zeros for it")
                        p.grad = torch.zeros_like(p)
                    grads.append(p.grad)
                flat = torch.cat([g.reshape(-1) for g in grads])
                comm.all_reduce(flat, group=self.group)
                flat.div_(n)
                at = 0
                for g in grads:
                    g.copy_(flat[at:at + g.numel()].view_as(g))
                    at += g.numel()


class DataParallel(Layer):
    """Data-parallel wrapper (reference parallel.py:219): ``model =
    paddle.DataParallel(model)`` after ``init_parallel_env()``; each rank
    feeds its own rows, and every backward leaves each rank the mean of
    the ranks' gradients (their sum over ``grad_divisor``, when given: the
    port's keyword, which ``fleet`` uses to sum over ``("dp", "sep")`` and
    divide by the ``dp`` degree alone)."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None, *, grad_divisor=None):
        if get_flag("comm_quantize_dp_grads"):
            raise NotImplementedError(
                "DataParallel with FLAGS_comm_quantize_dp_grads: the int8 "
                "gradient all-reduce of collective_opt is not ported yet "
                "(ROADMAP.md, queue 7)")
        super().__init__()
        self._layers = layers
        self.find_unused_parameters = find_unused_parameters
        self.comm_buffer_size = comm_buffer_size
        self.last_comm_buffer_size = last_comm_buffer_size
        self._group = group if group is not None else _dp_group()
        replicate_layer(layers, group=self._group)
        self._reducer = GradientReducer(
            [p for p in layers.parameters() if p.requires_grad],
            self._group, grad_divisor, comm_buffer_size,
            last_comm_buffer_size, find_unused_parameters)

    @property
    def bucket_sizes(self) -> List[int]:
        """Bytes of each gradient bucket, in the order they are reduced."""
        return [sum(p.numel() * p.element_size() for p in b)
                for b in self._reducer.buckets]

    @property
    def backend(self):
        return self._reducer.comm.backend()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside run without the gradient all-reduce (reference
        parallel.py ``DataParallel.no_sync``): gradients accumulate on
        each rank until a backward outside reduces them."""
        before = self._reducer.sync
        self._reducer.sync = False
        try:
            yield
        finally:
            self._reducer.sync = before

    # state passthrough: checkpoints see the inner layer's names
    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, state_dict, *a, **k):
        return self._layers.set_state_dict(state_dict, *a, **k)

    def parameters(self, include_sublayers=True, recurse=None):
        return self._layers.parameters(include_sublayers, recurse)

    def named_parameters(self, prefix="", include_sublayers=True,
                         recurse=None, remove_duplicate=True):
        return self._layers.named_parameters(prefix, include_sublayers,
                                             recurse, remove_duplicate)

    def train(self, mode: bool = True):
        self._layers.train(mode)
        return super().train(mode)

    def eval(self):
        return self.train(False)


class ParallelEnv:
    """Env-var view (reference base/dygraph ParallelEnv)."""

    @property
    def rank(self):
        return env_mod.get_rank()

    @property
    def local_rank(self):
        return env_mod.instance().local_rank

    @property
    def world_size(self):
        return env_mod.get_world_size()

    nranks = world_size

    @property
    def device_id(self):
        return env_mod.instance().device_id

    dev_id = device_id
