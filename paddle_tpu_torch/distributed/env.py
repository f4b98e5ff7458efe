"""The distributed environment (port of ``paddle_tpu/distributed/env.py``).

The JAX package drives every device from one controller: its ranks are
mesh coordinates inside compiled programs, and its "process groups" are
mesh axes. The port runs one process a rank, as upstream Paddle and torch
do, over ``torch.distributed``:

- :func:`init_parallel_env` reads the launcher's env contract
  (``PADDLE_MASTER``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, with
  ``MASTER_ADDR``/``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` as the
  fallbacks), meets the other ranks through a ``torch.distributed.TCPStore``
  hosted by rank 0 (the JAX package's native ``TCPStore``), and starts the
  default process group: NCCL for CUDA, gloo for the CPU.
  ``PADDLE_DISTRI_BACKEND=gloo`` (upstream Paddle's variable) takes gloo for
  CUDA tensors too, so that several ranks can share one card. A world of
  one with no launcher builds its own store on a free port.
- The mesh keeps the JAX mesh's five named axes (:data:`HYBRID_AXES`) and
  its degree rules (:meth:`ParallelEnv.build_mesh`), laid over the ranks:
  rank ``r`` sits at ``np.unravel_index(r, shape)``. A group over some axes
  is the process group of the ranks that share this rank's coordinates on
  every other axis (:func:`axes_group`).

Entry points run on CUDA unless the caller asks for the CPU
(``device="cpu"``): each rank then binds ``cuda:<local rank>`` (modulo the
cards present, so that ranks may share one).
"""
from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

from ..base.log import get_logger
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["HYBRID_AXES", "Mesh", "ParallelEnv", "axes_group", "barrier",
           "destroy_process_group", "get_mesh", "get_rank", "get_world_size",
           "init_parallel_env", "instance", "is_initialized", "set_mesh"]

# canonical hybrid axis order, outermost first (the JAX package's order:
# the reference's 5-D topology pp -> dp -> sharding -> sep -> mp)
HYBRID_AXES = ("pp", "dp", "sharding", "sep", "mp")

# how long a rank waits for the others at the store and in a collective
TIMEOUT = datetime.timedelta(seconds=300)


class Mesh:
    """The ranks laid out over named axes: ``devices`` is the array of
    global ranks (the JAX ``Mesh``'s device array), ``shape`` maps each
    axis to its degree."""

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str]):
        self.devices = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"a mesh of shape {self.devices.shape} cannot "
                             f"carry the axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """The mesh coordinates of global ``rank``."""
        where = np.argwhere(self.devices == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def members(self, rank: int, axes: Sequence[str]) -> List[int]:
        """The global ranks that share ``rank``'s coordinates off ``axes``,
        ordered by their coordinates on ``axes`` (the first axis major)."""
        at = self.coords(rank)
        index = tuple(slice(None) if ax in axes else at[ax]
                      for ax in self.axis_names)
        return [int(r) for r in self.devices[index].reshape(-1)]

    def __repr__(self):
        return f"Mesh({self.shape})"


class ParallelEnv:
    """The world: this process's rank, the world size, the mesh and the
    axis degrees, the backend; also upstream Paddle's ``ParallelEnv``
    env-var view (``rank``, ``world_size``, ``device_id``)."""

    _instance: Optional["ParallelEnv"] = None

    def __init__(self):
        self.initialized = False
        self.mesh: Optional[Mesh] = None
        self.axis_degrees: Dict[str, int] = {}
        self.device_kind = "unknown"
        self.device: Optional[torch.device] = None
        self.backend: Optional[str] = None
        self.store = None
        # process groups by the axes they span
        self._groups: Dict[tuple, object] = {}

    # ---------------------------------------------------------------- process
    @property
    def rank(self) -> int:
        if self.initialized:
            return tdist.get_rank()
        return int(os.environ.get("PADDLE_TRAINER_ID",
                                  os.environ.get("RANK", 0)))

    @property
    def world_size(self) -> int:
        if self.initialized:
            return tdist.get_world_size()
        return int(os.environ.get("PADDLE_TRAINERS_NUM",
                                  os.environ.get("WORLD_SIZE", 1)))

    @property
    def local_rank(self) -> int:
        return int(os.environ.get("PADDLE_LOCAL_RANK",
                                  os.environ.get("LOCAL_RANK", 0)))

    @property
    def nranks(self) -> int:
        return self.world_size

    @property
    def device_id(self) -> int:
        if self.device is not None and self.device.type == "cuda":
            return int(self.device.index)
        return 0

    # ---------------------------------------------------------------- mesh
    def build_mesh(self, degrees: Optional[Dict[str, int]] = None,
                   devices=None) -> Mesh:
        """The mesh over ``devices`` (default: every rank of the world).

        ``degrees`` maps axes of :data:`HYBRID_AXES` to sizes (missing axes
        get 1; one axis may be -1 to take the ranks left; by default ``dp``
        takes them all), as the JAX ``build_mesh`` rules them."""
        ranks = list(devices if devices is not None
                     else range(self.world_size))
        n = len(ranks)
        degrees = dict(degrees or {})
        for ax in HYBRID_AXES:
            degrees.setdefault(
                ax, -1 if ax == "dp" and -1 not in degrees.values() else 1)
        fixed = int(np.prod([d for d in degrees.values() if d != -1]))
        if any(d == -1 for d in degrees.values()):
            if n % fixed != 0:
                raise ValueError(f"device count {n} not divisible by fixed "
                                 f"degrees {degrees}")
            fill = n // fixed
            degrees = {k: (fill if v == -1 else v)
                       for k, v in degrees.items()}
        total = int(np.prod(list(degrees.values())))
        if total != n:
            raise ValueError(f"mesh degrees {degrees} product {total} != "
                             f"device count {n}")
        shape = tuple(degrees[ax] for ax in HYBRID_AXES)
        self.mesh = Mesh(np.array(ranks).reshape(shape), HYBRID_AXES)
        self.axis_degrees = degrees
        self.device_kind = (self.device.type if self.device is not None
                            else "unknown")
        self._groups = {}
        return self.mesh


def instance() -> ParallelEnv:
    if ParallelEnv._instance is None:
        ParallelEnv._instance = ParallelEnv()
    return ParallelEnv._instance


def _backend_for(device: torch.device) -> str:
    asked = os.environ.get("PADDLE_DISTRI_BACKEND", "").strip().lower()
    if device.type == "cpu":
        if asked not in ("", "gloo"):
            raise ValueError(f"PADDLE_DISTRI_BACKEND={asked!r}: the CPU "
                             f"runs gloo only")
        return "gloo"
    if asked not in ("", "nccl", "gloo"):
        raise ValueError(f"PADDLE_DISTRI_BACKEND={asked!r}: use 'nccl' or "
                         f"'gloo'")
    return asked or "nccl"


def _master_endpoint():
    """(host, port) of the rendezvous store from the env contract, or
    None when no launcher set it."""
    master = os.environ.get("PADDLE_MASTER") or os.environ.get("MASTER_ADDR")
    if not master:
        return None
    port = os.environ.get("MASTER_PORT")
    if ":" in master:
        host, _, port = master.rpartition(":")
    else:
        host = master
    if not port:
        return None
    return host, int(port)


def init_parallel_env(degrees: Optional[Dict[str, int]] = None, *,
                      device=DEFAULT_DEVICE) -> ParallelEnv:
    """Start the world (reference ``parallel.py:978``) and build the mesh
    over its ranks; called again, it only rebuilds the mesh when
    ``degrees`` are given. ``device`` (default CUDA) picks the backend:
    NCCL on CUDA (gloo with ``PADDLE_DISTRI_BACKEND=gloo``), gloo on the
    CPU."""
    env = instance()
    if env.initialized:
        if degrees:
            env.build_mesh(degrees)
        return env
    dev = resolve_device(device)
    backend = _backend_for(dev)
    world = env.world_size
    rank = env.rank
    if dev.type == "cuda":
        dev = torch.device("cuda", env.local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    endpoint = _master_endpoint()
    if world > 1 and endpoint is None:
        raise RuntimeError(
            f"init_parallel_env: a world of {world} ranks needs the "
            f"rendezvous address (PADDLE_MASTER or MASTER_ADDR/MASTER_PORT); "
            f"start the ranks with python -m paddle_tpu_torch.distributed."
            f"launch or distributed.spawn")
    if world == 1 and endpoint is None:
        # no launcher: a store of our own on a free port
        store = tdist.TCPStore("127.0.0.1", 0, 1, True, timeout=TIMEOUT)
    else:
        host, port = endpoint
        store = tdist.TCPStore(host, port, world, rank == 0, timeout=TIMEOUT,
                               wait_for_workers=False)
    get_logger().info("init_process_group(%s, rank %d of %d, %s)", backend,
                      rank, world, dev)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world, timeout=TIMEOUT)
    env.store = store
    env.backend = backend
    env.device = dev
    env.initialized = True
    env.build_mesh(degrees)
    return env


def destroy_process_group() -> None:
    """End the world: the process groups and the store go, and the
    environment reads the env contract again (upstream Paddle's
    ``destroy_process_group``)."""
    env = instance()
    if env.initialized:
        tdist.destroy_process_group()
    ParallelEnv._instance = None


def get_mesh() -> Mesh:
    env = instance()
    if env.mesh is None:
        env.build_mesh()
    return env.mesh


def set_mesh(mesh: Mesh):
    env = instance()
    if mesh.size != env.world_size:
        raise ValueError(f"a mesh of {mesh.size} ranks over a world of "
                         f"{env.world_size}")
    env.mesh = mesh
    env.axis_degrees = dict(mesh.shape)
    env._groups = {}


def get_rank() -> int:
    return instance().rank


def get_world_size() -> int:
    return instance().world_size


def is_initialized() -> bool:
    return instance().initialized


def axes_group(axes: Sequence[str]):
    """The process group of this rank's sub-mesh over ``axes`` and its
    members (global ranks, the first axis major): the world's group when
    the sub-mesh is the world (of one rank too), None when it is this rank
    alone in a larger world or the world is not initialized. Every
    rank must ask for the same axes in the same order, as every rank
    creates every such group (``torch.distributed.new_group``)."""
    env = instance()
    mesh = get_mesh()
    axes = tuple(axes)
    unknown = [ax for ax in axes if ax not in mesh.axis_names]
    if unknown:
        raise ValueError(f"axes {unknown} are not mesh axes "
                         f"{mesh.axis_names}")
    if list(axes) != sorted(axes, key=mesh.axis_names.index):
        raise ValueError(f"list the axes {axes} in the mesh's order "
                         f"{mesh.axis_names}")
    rank = env.rank
    members = mesh.members(rank, axes)
    if not env.initialized:
        return None, members
    if len(members) == env.world_size:
        # the world, even of one rank: its collectives run on the backend
        return tdist.group.WORLD, members
    if len(members) == 1:
        return None, members
    if axes not in env._groups:
        # every rank creates every sub-mesh's group, in one order
        others = [ax for ax in mesh.axis_names if ax not in axes]
        mine = None
        for combo in np.ndindex(*(mesh.shape[ax] for ax in others)):
            at = dict(zip(others, combo))
            index = tuple(slice(None) if ax in axes else at[ax]
                          for ax in mesh.axis_names)
            ranks = sorted(int(r) for r in mesh.devices[index].reshape(-1))
            group = tdist.new_group(ranks, timeout=TIMEOUT)
            if rank in ranks:
                mine = group
        env._groups[axes] = mine
    return env._groups[axes], members


def barrier(group=None):
    """Block until every rank of ``group`` (default: the world) reaches
    here; the identity on a world of one that was never initialized."""
    from .communication import barrier as _barrier

    return _barrier(group)
