"""``paddle_tpu_torch.distributed``: the distributed tier of the port (of
``paddle_tpu/distributed``), one process a rank over ``torch.distributed``.

Ported: the environment (``init_parallel_env``, the mesh over the ranks),
the functional collectives and ``Group``, ``spmd`` regions, ``DataParallel``
with ``shard_batch`` and ``replicate_layer``, ``spawn``, the launcher
(``python -m paddle_tpu_torch.distributed.launch``) and its ``Master``
rendezvous, the comm watchdog, and the sharded checkpoint
(``checkpoint.sharded``), and ``fleet``: the tensor-, sequence- and
context-parallel tier (``fleet.init``, the topology, the ``mpu`` layers,
``sequence_parallel``, ring and Ulysses attention, ``distributed_model``),
pipeline parallelism (``PipelineLayer``, ``PipelinedStack`` and its
schedules, one process a stage) and recompute. ``TCPStore`` is
``torch.distributed.TCPStore``.

Not ported yet (``ROADMAP.md``, queue 7; each raises
``NotImplementedError`` naming it): fleet's sharded optimizer (item 7.3);
``auto_parallel`` and its
``ProcessMesh``/``shard_tensor``/``reshard`` family, ``sharding``, ``ps``,
``rpc``, ``auto_tuner``, ``moe_utils`` and ``collective_opt``.
"""
from __future__ import annotations

import torch.distributed as _tdist

from .env import (  # noqa: F401
    HYBRID_AXES,
    Mesh,
    ParallelEnv as _Env,
    barrier,
    destroy_process_group,
    get_mesh,
    get_rank,
    get_world_size,
    init_parallel_env,
    is_initialized,
    set_mesh,
)
from .communication import (  # noqa: F401
    Group,
    P2POp,
    ReduceOp,
    all_gather,
    all_gather_object,
    all_reduce,
    all_to_all,
    all_to_all_single,
    alltoall,
    batch_isend_irecv,
    broadcast,
    gather,
    get_backend,
    get_group,
    irecv,
    isend,
    new_group,
    recv,
    reduce,
    reduce_scatter,
    scatter,
    send,
    shift,
    wait,
)
from .parallel import (DataParallel, ParallelEnv, replicate_layer,  # noqa: F401
                       shard_batch)
from .spmd import P, PartitionSpec, in_spmd_region, spmd, spmd_region  # noqa: F401
from .spawn import spawn  # noqa: F401
from . import checkpoint  # noqa: F401
from . import fleet  # noqa: F401

TCPStore = _tdist.TCPStore

# the JAX package's distributed names that wait for later slices
_NOT_PORTED = ("auto_parallel", "ProcessMesh", "Partial",
               "Placement", "Replicate", "Shard", "dtensor_from_fn",
               "reshard", "shard_layer", "shard_optimizer", "shard_tensor",
               "unshard_dtensor", "sharding", "ps", "rpc", "auto_tuner",
               "moe_utils", "collective_opt")


# the queue 7 item each waits for (7.4 unless listed)
_ITEM = {"sharding": "7.3"}


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"paddle_tpu_torch.distributed.{name} is not ported yet "
            f"(ROADMAP.md, queue 7 item "
            f"{_ITEM.get(name, '7.4')})")
    raise AttributeError(f"module 'paddle_tpu_torch.distributed' has no "
                         f"attribute {name!r}")


def get_world_process_group():
    return get_group(0)


def is_available() -> bool:
    return _tdist.is_available()
