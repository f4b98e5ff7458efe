"""``paddle.distributed.spawn`` (port of ``paddle_tpu/distributed/spawn.py``;
reference ``distributed/spawn.py``): the launcher's alternative from
inside Python. ``nprocs`` ranks start with ``torch.multiprocessing``'s
``spawn`` method (CUDA forbids ``fork``), each with the launcher's env
contract (``PADDLE_MASTER``, ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_RANK``, and the torch names beside them) and a rendezvous
port of its own, and runs ``func(*args)``; ``init_parallel_env()`` inside
meets the others. A rank that fails fails the call (``RuntimeError``
naming its exit code) once every rank has ended. ``nprocs=1`` runs
``func`` in this process, as the JAX package does.
"""
from __future__ import annotations

import os
import socket

import torch.multiprocessing as mp

__all__ = ["spawn"]


def free_port() -> int:
    """A TCP port nothing listens on now (the OS picks it)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(master: str, rank: int, local_rank: int, world: int,
             nnodes: int = 1, node_rank: int = 0) -> dict:
    """The env contract one rank runs under."""
    host, _, port = master.rpartition(":")
    return {"PADDLE_MASTER": master, "MASTER_ADDR": host,
            "MASTER_PORT": port, "PADDLE_TRAINER_ID": str(rank),
            "RANK": str(rank), "PADDLE_TRAINERS_NUM": str(world),
            "WORLD_SIZE": str(world), "PADDLE_LOCAL_RANK": str(local_rank),
            "LOCAL_RANK": str(local_rank), "PADDLE_NNODES": str(nnodes),
            "PADDLE_NODE_RANK": str(node_rank)}


def _worker(fn, rank, nprocs, args, env):
    os.environ.update(env)
    os.environ.update(rank_env(env["PADDLE_MASTER"], rank, rank, nprocs))
    fn(*args)


def spawn(func, args=(), nprocs=1, join=True, daemon=False, **options):
    if nprocs <= 1:
        func(*args)
        return None
    ctx = mp.get_context("spawn")
    env = {k: v for k, v in os.environ.items()
           if k.startswith(("PADDLE_", "MASTER_", "NCCL_"))}
    env["PADDLE_MASTER"] = f"127.0.0.1:{free_port()}"
    procs = []
    for rank in range(nprocs):
        p = ctx.Process(target=_worker, args=(func, rank, nprocs, args, env),
                        daemon=daemon)
        p.start()
        procs.append(p)
    if join:
        for p in procs:
            p.join()
        failed = [(i, p.exitcode) for i, p in enumerate(procs)
                  if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"spawned ranks failed (rank, exit code): "
                               f"{failed}")
    return procs
