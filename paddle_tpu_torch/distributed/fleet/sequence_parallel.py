"""Megatron-style sequence parallelism (port of
``paddle_tpu/distributed/fleet/sequence_parallel.py``).

Reference: fleet/utils/sequence_parallel_utils.py — ``ScatterOp`` (:85),
``GatherOp`` (:97), ``AllGatherOp`` (:111), ``ReduceScatterOp`` (:127) and
``ColumnSequenceParallelLinear``/``RowSequenceParallelLinear`` (:429/:564).

Between the tensor-parallel matmul pairs the activations' sequence dim
(dim 1 of ``[B, S, H]``) lives cut over ``mp``: a column-parallel input is
all-gathered (its gradient reduce-scattered), a row-parallel output is
reduce-scattered (its gradient all-gathered). The JAX package states each
as a sharding constraint and lets GSPMD emit the pair; the port issues
them (``mpu``'s autograd ops).

:func:`register_sequence_parallel_allreduce_hooks` is not a no-op here, as
it is in the JAX package, whose replicated layouts keep every gradient
whole (``paddle_tpu/distributed/fleet/sequence_parallel.py:103-107``). A
rank sees only its sequence part, so the gradients of the parameters that
act on sequence-cut activations — the LayerNorm/RMSNorm weights and
biases, ``ln_f`` and ``norm``, the row-parallel biases — are partial
sums: the hooks all-reduce them over ``mp`` at the end of each backward,
before the optimizer runs, with the reducer ``DataParallel`` uses, so
that several backwards before a step add up as there. The models mark
those parameters (:func:`mark_as_sequence_parallel_parameter`), and
``fleet.distributed_model`` registers the hooks for a sequence-parallel
model.
"""
from __future__ import annotations

from .. import communication as comm
from ..parallel import GradientReducer
from . import mpu
from .mpu import ColumnParallelLinear, RowParallelLinear

__all__ = ["AllGatherOp", "ColumnSequenceParallelLinear", "GatherOp",
           "ReduceScatterOp",
           "RowSequenceParallelLinear", "ScatterOp", "all_gather",
           "is_sequence_parallel_parameter", "mark_as_sequence_parallel",
           "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks", "reduce_scatter",
           "scatter"]

SP_AXIS = "mp"  # Megatron-SP rides the mp axis; sep has an axis of its own


def mark_as_sequence_parallel(x, seq_dim: int = 1, axis=SP_AXIS):
    """This rank's part of ``x``'s sequence dim (the ``ScatterOp``
    analog; the JAX function constrains ``x`` sequence-cut)."""
    return mpu.scatter_to_model_parallel(x, seq_dim, axis)


class ScatterOp:
    """reference :85 — this rank's sequence part forward, all-gather
    backward."""

    @staticmethod
    def apply(x, seq_dim=1):
        return mpu.scatter_to_model_parallel(x, seq_dim)


class GatherOp:
    """reference :97 — all-gather of the sequence forward, this rank's part
    backward."""

    @staticmethod
    def apply(x, seq_dim=1):
        return mpu.gather_from_model_parallel(x, seq_dim)


class AllGatherOp:
    """reference :111 — all-gather forward, reduce-scatter backward: the
    boundary into a tensor-parallel block."""

    @staticmethod
    def apply(x, seq_dim=1):
        return mpu.all_gather_sequence(x, seq_dim)


class ReduceScatterOp:
    """reference :127 — reduce-scatter forward, all-gather backward: the
    boundary out of a tensor-parallel block."""

    @staticmethod
    def apply(x, seq_dim=1):
        return mpu.reduce_scatter_sequence(x, seq_dim)


def scatter(x, seq_dim=1):
    return ScatterOp.apply(x, seq_dim)


def all_gather(x, seq_dim=1):
    return AllGatherOp.apply(x, seq_dim)


def reduce_scatter(x, seq_dim=1):
    return ReduceScatterOp.apply(x, seq_dim)


def mark_as_sequence_parallel_parameter(param) -> None:
    """Mark ``param`` as acting on sequence-cut activations (upstream's
    name): its gradient is a partial sum over ``mp``."""
    param.sequence_parallel = True


def is_sequence_parallel_parameter(param) -> bool:
    return bool(getattr(param, "sequence_parallel", False))


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """reference :429 — a column-parallel linear whose input arrives
    sequence-cut: all-gathered before the matmul (the gather's backward
    reduce-scatter sums the ranks' input gradients)."""

    def _input(self, x):
        return AllGatherOp.apply(x)


class RowSequenceParallelLinear(RowParallelLinear):
    """reference :564 — a row-parallel linear whose output leaves
    sequence-cut: reduce-scattered after the matmul, then the bias, whose
    gradient is then a partial sum (marked)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.bias is not None:
            mark_as_sequence_parallel_parameter(self.bias)

    def _output(self, y):
        return ReduceScatterOp.apply(y)


# the fused buckets' size, as DataParallel's default
_BUCKET_MB = 25.0


def register_sequence_parallel_allreduce_hooks(model, accumulation_steps=1,
                                               fuse=False):
    """reference :192 — all-reduce over ``mp``, at the end of each
    backward, the gradients of ``model``'s parameters marked
    sequence-parallel (:func:`mark_as_sequence_parallel_parameter`),
    summed (a ``GradientReducer`` with divisor 1). As upstream, they are
    reduced on every ``accumulation_steps``-th backward and accumulate on
    each rank in between; ``fuse`` reduces them in flat buckets, else one
    all-reduce a parameter. A step after any multiple of
    ``accumulation_steps`` backwards sees their summed gradients. Nothing is
    registered when ``mp`` has one rank or no parameter is marked.
    Returns ``model``; the reducer is ``model._sp_grad_reducer``."""
    if mpu.group_comm().n == 1:
        return model
    params = [p for p in model.parameters()
              if p.requires_grad and is_sequence_parallel_parameter(p)]
    if params and getattr(model, "_sp_grad_reducer", None) is None:
        size_mb = _BUCKET_MB if fuse else 0.0
        object.__setattr__(model, "_sp_grad_reducer", GradientReducer(
            params, comm.Group((SP_AXIS,)), divisor=1, size_mb=size_mb,
            first_mb=size_mb, accumulation_steps=accumulation_steps))
    return model
