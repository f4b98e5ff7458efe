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

__all__ = ["DataParallel", "ParallelEnv", "init_parallel_env",
           "replicate_layer", "shard_batch"]

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


class DataParallel(Layer):
    """Data-parallel wrapper (reference parallel.py:219): ``model =
    paddle.DataParallel(model)`` after ``init_parallel_env()``; each rank
    feeds its own rows, and every backward leaves each rank the mean of
    the ranks' gradients."""

    def __init__(self, layers: Layer, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
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
        self._comm = comm._comm(self._group)
        replicate_layer(layers, group=self._group)
        self._sync = True
        self._queued = False
        params = [p for p in layers.parameters() if p.requires_grad]
        self._grad_buckets = _buckets(params, comm_buffer_size,
                                      last_comm_buffer_size)
        self._hooks = [p.register_post_accumulate_grad_hook(self._on_grad)
                       for p in params]

    @property
    def bucket_sizes(self) -> List[int]:
        """Bytes of each gradient bucket, in the order they are reduced."""
        return [sum(p.numel() * p.element_size() for p in b)
                for b in self._grad_buckets]

    @property
    def backend(self):
        return self._comm.backend()

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def _on_grad(self, param) -> None:
        if self._sync and not self._queued:
            self._queued = True
            torch.autograd.Variable._execution_engine.queue_callback(
                self._reduce)

    def _reduce(self) -> None:
        """The end of a backward: every bucket's gradients all-reduced and
        divided by the degree, in place."""
        self._queued = False
        n = self._comm.n
        with torch.no_grad():
            for bucket in self._grad_buckets:
                grads = []
                for p in bucket:
                    if p.grad is None:
                        if not self.find_unused_parameters:
                            name = getattr(p, "param_name", None) or \
                                tuple(p.shape)
                            raise RuntimeError(
                                f"DataParallel: parameter {name} got no "
                                f"gradient in this backward; pass "
                                f"find_unused_parameters=True to reduce "
                                f"zeros for it")
                        p.grad = torch.zeros_like(p)
                    grads.append(p.grad)
                flat = torch.cat([g.reshape(-1) for g in grads])
                comm.all_reduce(flat, group=self._group)
                flat.div_(n)
                at = 0
                for g in grads:
                    g.copy_(flat[at:at + g.numel()].view_as(g))
                    at += g.numel()

    @contextlib.contextmanager
    def no_sync(self):
        """Backwards inside run without the gradient all-reduce (reference
        parallel.py ``DataParallel.no_sync``): gradients accumulate on
        each rank until a backward outside reduces them."""
        before = self._sync
        self._sync = False
        try:
            yield
        finally:
            self._sync = before

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
