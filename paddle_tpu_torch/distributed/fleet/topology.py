"""Hybrid-parallel topology (port of
``paddle_tpu/distributed/fleet/topology.py``).

Reference: fleet/base/topology.py — ``CommunicateTopology`` (:70) and
``HybridCommunicateGroup`` (:189) carve the world into pp/dp/sharding/sep/
mp process groups.

The port lays the topology over the distributed tier's mesh
(``env.build_mesh``): the degrees size its five named axes, and each
``get_*_parallel_group()`` is a ``communication.Group`` over one axis,
whose process group is this rank's sub-mesh over it (``env.axes_group``).
Every rank builds every group, in one order, when the
``HybridCommunicateGroup`` is made.

Divergence from the JAX package: the ranks (``get_model_parallel_rank``,
``get_stage_id``, ...) are this process's real coordinates on the mesh.
The JAX single controller drives every device from one process and
returns 0 for each (``paddle_tpu/distributed/fleet/topology.py:92-108``).
"""
from __future__ import annotations

from typing import Dict, Optional

from .. import env as env_mod
from ..communication import Group

__all__ = ["CommunicateTopology", "HybridCommunicateGroup", "ParallelMode",
           "get_hybrid_communicate_group", "set_hybrid_communicate_group"]


class CommunicateTopology:
    def __init__(self, hybrid_group_names=None, dims=None):
        self._names = list(hybrid_group_names
                           or ["pipe", "data", "sharding", "sep", "model"])
        self._dims = list(dims or [1] * len(self._names))

    def get_hybrid_group_names(self):
        return list(self._names)

    def get_dim(self, name):
        return self._dims[self._names.index(name)]

    def world_size(self):
        out = 1
        for d in self._dims:
            out *= d
        return out


class ParallelMode:
    DATA_PARALLEL = 0
    TENSOR_PARALLEL = 1
    PIPELINE_PARALLEL = 2
    SHARDING_PARALLEL = 3
    SEGMENT_PARALLEL = 4


def axis_group(axes) -> Group:
    """A ``Group`` over mesh ``axes`` whose process group every rank has
    made (collective: every rank calls it with the same axes, in one
    order)."""
    group = Group(tuple(axes))
    env_mod.axes_group(group.axes)
    return group


class HybridCommunicateGroup:
    """The axis groups of the mesh (reference topology.py:189)."""

    def __init__(self, degrees: Optional[Dict[str, int]] = None):
        env_mod.init_parallel_env(dict(degrees or {}))
        self._mesh = env_mod.get_mesh()
        self._degrees = dict(env_mod.instance().axis_degrees)
        self._coords = self._mesh.coords(env_mod.get_rank())
        self._topo = CommunicateTopology(
            ["pipe", "data", "sharding", "sep", "model"],
            [self._degrees[a] for a in ("pp", "dp", "sharding", "sep",
                                        "mp")])
        self._groups: Dict[str, Group] = {
            ax: axis_group((ax,)) for ax in env_mod.HYBRID_AXES}
        # the fused groups: sharded data parallel, and the data-parallel
        # gradient reduction under sep (upstream's dp_sep group)
        self._groups["dp_sharding"] = axis_group(("dp", "sharding"))
        self._groups["dp_sep"] = axis_group(("dp", "sep"))

    @property
    def topology(self):
        return self._topo

    def get_parallel_mode(self):
        if self._degrees["pp"] > 1:
            return ParallelMode.PIPELINE_PARALLEL
        if self._degrees["mp"] > 1:
            return ParallelMode.TENSOR_PARALLEL
        if self._degrees["sharding"] > 1:
            return ParallelMode.SHARDING_PARALLEL
        if self._degrees["sep"] > 1:
            return ParallelMode.SEGMENT_PARALLEL
        return ParallelMode.DATA_PARALLEL

    # ------------------------------------------------------------ sizes
    def get_data_parallel_world_size(self):
        return self._degrees["dp"]

    def get_model_parallel_world_size(self):
        return self._degrees["mp"]

    def get_pipe_parallel_world_size(self):
        return self._degrees["pp"]

    def get_sharding_parallel_world_size(self):
        return self._degrees["sharding"]

    def get_sep_parallel_world_size(self):
        return self._degrees["sep"]

    # ------------------------------------------- this process's coordinates
    def get_data_parallel_rank(self):
        return self._coords["dp"]

    def get_model_parallel_rank(self):
        return self._coords["mp"]

    def get_stage_id(self):
        return self._coords["pp"]

    def get_sharding_parallel_rank(self):
        return self._coords["sharding"]

    def get_sep_parallel_rank(self):
        return self._coords["sep"]

    # ------------------------------------------------------------ groups
    def get_data_parallel_group(self) -> Group:
        return self._groups["dp"]

    def get_model_parallel_group(self) -> Group:
        return self._groups["mp"]

    def get_pipe_parallel_group(self) -> Group:
        return self._groups["pp"]

    def get_sharding_parallel_group(self) -> Group:
        return self._groups["sharding"]

    def get_sep_parallel_group(self) -> Group:
        return self._groups["sep"]

    def get_dp_sep_parallel_group(self) -> Group:
        return self._groups["dp_sep"]

    def get_check_parallel_group(self, *a, **k) -> Group:
        return self._groups["mp"]

    def get_data_parallel_group_src_rank(self):
        """The global rank of this rank's ``dp`` group's first member."""
        return self._groups["dp"].process_ids[0]

    def get_model_parallel_group_src_rank(self):
        return self._groups["mp"].process_ids[0]

    @property
    def mesh(self):
        return self._mesh

    @property
    def nranks(self):
        return self._mesh.size


_hcg: Optional[HybridCommunicateGroup] = None


def set_hybrid_communicate_group(hcg):
    global _hcg
    _hcg = hcg


def get_hybrid_communicate_group() -> Optional[HybridCommunicateGroup]:
    return _hcg
