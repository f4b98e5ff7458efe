"""``fleet``: hybrid-parallel training, one process a rank (port of
``paddle_tpu/distributed/fleet``).

Reference: python/paddle/distributed/fleet/ — ``fleet.init``
(fleet.py:218), ``distributed_model`` (model.py:32),
``distributed_optimizer`` (fleet.py:1427), ``HybridCommunicateGroup``
(base/topology.py:189), ``DistributedStrategy``.

``fleet.init`` builds the five-axis mesh from
``strategy.hybrid_configs`` over the ranks and the axis groups
(``topology``). The tensor-parallel layers (``mpu``, also
``meta_parallel``), sequence parallelism (``sequence_parallel``) and ring
and Ulysses attention (``context_parallel``) carry their own collectives.
``distributed_model`` adds what the JAX package's whole-step partitioner
does for the gradients:

- pure data parallelism: ``DataParallel`` over the ``dp`` group, as in
  JAX;
- ``sep > 1``: each ``sep`` rank saw only its part of the sequence, so the
  replicated parameters' gradients are summed over ``("dp", "sep")`` (and
  divided by the ``dp`` degree), upstream's dp_sep group; ``dp > 1``
  alone: averaged over ``dp``;
- a sequence-parallel model: its marked parameters' gradients all-reduced
  over ``mp`` (``register_sequence_parallel_allreduce_hooks``);
- ``pp > 1``: nothing more. A pipelined model (``PipelinedStack``,
  ``PipelineLayer``) keeps its layers' gradients on their stage and the
  layers around the stack whole and equal on every ``pp`` rank
  (``pipeline_schedules``); ``dp`` and ``mp`` act as above, ``DataParallel``
  over ``dp`` covering the stage's layers and the edges alike.

Pipeline parallelism (``pipeline``, ``pipeline_schedules``: one process a
stage) and activation recompute (``recompute``) are ported. Not ported yet
(``ROADMAP.md``, queue 7 item 7.3; it raises ``NotImplementedError``
naming it): the sharded optimizer (``distributed_optimizer`` with a
sharding stage, a ``sharding_degree`` above 1).
"""
from __future__ import annotations

import os
from typing import Optional

from .. import env as env_mod
from ..parallel import DataParallel
from . import context_parallel, mpu, sequence_parallel  # noqa: F401
from .context_parallel import ring_attention, ulysses_attention  # noqa: F401
from .pipeline import (LayerDesc, PipelineLayer,  # noqa: F401
                       PipelineParallel, SegmentLayers, SharedLayerDesc)
from .pipeline_schedules import (  # noqa: F401
    PipelinedStack,
    forward_backward_pipeline_1f1b,
    forward_backward_pipeline_eager_1f1b,
    forward_backward_pipeline_interleave,
    forward_backward_pipeline_rotation,
    forward_backward_pipeline_zero_bubble,
    schedule_cost_report,
)
from .recompute import no_recompute, recompute, recompute_sequential  # noqa: F401
from .mpu import (ColumnParallelLinear, ParallelCrossEntropy,  # noqa: F401
                  RowParallelLinear, VocabParallelEmbedding,
                  get_rng_state_tracker, model_parallel_random_seed)
from .sequence_parallel import register_sequence_parallel_allreduce_hooks
from .strategy import DistributedStrategy
from .topology import (CommunicateTopology,  # noqa: F401
                       HybridCommunicateGroup, ParallelMode,
                       get_hybrid_communicate_group,
                       set_hybrid_communicate_group)

meta_parallel = mpu  # the fleet.meta_parallel.* layer surface


class _Fleet:
    """The fleet singleton (reference fleet/base/fleet_base)."""

    def __init__(self):
        self._strategy: Optional[DistributedStrategy] = None
        self._is_initialized = False

    def init(self, role_maker=None, is_collective=True,
             strategy: Optional[DistributedStrategy] = None,
             log_level="INFO"):
        """Start the world (if it is not) and lay the mesh of
        ``strategy.hybrid_configs`` over its ranks; every rank makes every
        axis group."""
        self._strategy = strategy or DistributedStrategy()
        degrees = self._strategy.to_degrees()
        env_mod.init_parallel_env(degrees)
        set_hybrid_communicate_group(HybridCommunicateGroup(degrees))
        self._is_initialized = True
        return self

    def is_first_worker(self):
        return env_mod.get_rank() == 0

    def worker_index(self):
        return env_mod.get_rank()

    def worker_num(self):
        return env_mod.get_world_size()

    def is_worker(self):
        return True

    def worker_endpoints(self, to_string=False):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "").split(",")
        return ",".join(eps) if to_string else eps

    def barrier_worker(self):
        env_mod.barrier()

    @property
    def _hcg(self):
        return get_hybrid_communicate_group()

    def get_hybrid_communicate_group(self):
        return self._hcg

    def distributed_model(self, model):
        """reference fleet/model.py:32: ``model`` wrapped for the mesh (see
        the module's notes). Returns the ``DataParallel`` wrapper when
        ``dp`` or ``sep`` has more than one rank, else ``model``."""
        hcg = self._hcg
        if hcg is None:
            self.init()
            hcg = self._hcg
        if hcg.get_sharding_parallel_world_size() > 1:
            raise NotImplementedError(
                "fleet.distributed_model with sharding_degree > 1: the "
                "sharded optimizer is not ported yet (ROADMAP.md, queue 7 "
                "item 7.3)")
        register_sequence_parallel_allreduce_hooks(model, fuse=True)
        dp = hcg.get_data_parallel_world_size()
        if hcg.get_sep_parallel_world_size() > 1:
            return DataParallel(model, group=hcg.get_dp_sep_parallel_group(),
                                grad_divisor=dp)
        if dp > 1:
            return DataParallel(model, group=hcg.get_data_parallel_group())
        return model

    def distributed_optimizer(self, optimizer, strategy=None):
        """reference fleet.py:1427: the optimizer as it is; a sharding
        stage raises (``ROADMAP.md``, queue 7 item 7.3)."""
        st = strategy or self._strategy or DistributedStrategy()
        if (st.sharding or st.hybrid_configs.get("sharding_degree", 1) > 1
                or env_mod.instance().axis_degrees.get("sharding", 1) > 1):
            raise NotImplementedError(
                "fleet.distributed_optimizer with a sharding stage: the "
                "sharded optimizer (zero1, ShardingStage1-3) is not ported "
                "yet (ROADMAP.md, queue 7 item 7.3)")
        return optimizer

    def set_log_level(self, level):
        from ...base.log import get_logger

        get_logger().setLevel(level)


fleet = _Fleet()
init = fleet.init
distributed_model = fleet.distributed_model
distributed_optimizer = fleet.distributed_optimizer
worker_index = fleet.worker_index
worker_num = fleet.worker_num
is_first_worker = fleet.is_first_worker
barrier_worker = fleet.barrier_worker

__all__ = [
    "fleet",
    "init",
    "DistributedStrategy",
    "HybridCommunicateGroup",
    "ParallelMode",
    "distributed_model",
    "distributed_optimizer",
    "get_hybrid_communicate_group",
    "ColumnParallelLinear",
    "RowParallelLinear",
    "VocabParallelEmbedding",
    "ParallelCrossEntropy",
    "get_rng_state_tracker",
    "recompute",
    "PipelineLayer",
    "LayerDesc",
]
