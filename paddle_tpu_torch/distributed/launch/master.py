"""The rendezvous service for a multi-node launch (port of
``paddle_tpu/distributed/launch/master.py``; reference
``python/paddle/distributed/launch/controllers/master.py:73``): nodes
exchange their endpoints through a KV store and agree on a restart
generation.

The store is ``torch.distributed.TCPStore`` (the JAX package's native
``TCPStore``); the node of rank 0 hosts it and every node's launcher
connects as a client. The keys, all under ``rdzv/<job>/``, are the JAX
package's:

- ``peers/<rank>``: the node's endpoint and process count, set at
  :meth:`Master.register`;
- ``joined``: the atomic join counter (``store.add``); :meth:`sync_peers`
  waits until it reaches ``nnodes``, then returns the peers by rank;
- ``gen``: the restart generation, bumped when the job re-forms.
"""
from __future__ import annotations

import datetime
import json
import os
import time
from typing import List, Optional

import torch.distributed as tdist

__all__ = ["Master", "master_from_env"]


class Master:
    """KV rendezvous over a ``torch.distributed.TCPStore``."""

    def __init__(self, endpoint: str, rank: int, nnodes: int,
                 job_id: str = "default", is_master: Optional[bool] = None,
                 timeout: float = 120.0):
        host, _, port = endpoint.rpartition(":")
        self.endpoint = endpoint
        self.rank = rank
        self.nnodes = nnodes
        self.job_id = job_id
        self.is_master = (rank == 0) if is_master is None else is_master
        self.store = tdist.TCPStore(
            host or "127.0.0.1", int(port), nnodes, self.is_master,
            timeout=datetime.timedelta(seconds=timeout),
            wait_for_workers=False)

    def _k(self, key: str) -> str:
        return f"rdzv/{self.job_id}/{key}"

    # ------------------------------------------------------------ rendezvous
    def register(self, node_endpoint: str, nproc: int) -> None:
        info = json.dumps({"endpoint": node_endpoint, "nproc": nproc,
                           "rank": self.rank})
        self.store.set(self._k(f"peers/{self.rank}"), info)
        self.store.add(self._k("joined"), 1)

    def sync_peers(self, timeout: float = 120.0) -> List[dict]:
        """Block until all nnodes registered; return the peers sorted by
        rank (reference master.sync_peers)."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.store.add(self._k("joined"), 0) >= self.nnodes:
                peers = [json.loads(self.get(f"peers/{r}").decode())
                         for r in range(self.nnodes)]
                return sorted(peers, key=lambda p: p["rank"])
            time.sleep(0.2)
        raise TimeoutError(
            f"rendezvous: {self.store.add(self._k('joined'), 0)}/"
            f"{self.nnodes} nodes joined within {timeout}s")

    # ---------------------------------------------------------- generations
    def generation(self) -> int:
        return self.store.add(self._k("gen"), 0)

    def bump_generation(self) -> int:
        """Start a new rendezvous round after the job re-forms."""
        return self.store.add(self._k("gen"), 1)

    def wait_generation(self, current: int, timeout: float = 60.0) -> int:
        deadline = time.time() + timeout
        while time.time() < deadline:
            g = self.generation()
            if g > current:
                return g
            time.sleep(0.2)
        return current

    # ------------------------------------------------------------------- kv
    def set(self, key: str, value) -> None:
        self.store.set(self._k(key), value)

    def get(self, key: str, timeout: Optional[float] = None) -> bytes:
        key = self._k(key)
        if timeout is not None:
            self.store.wait([key], datetime.timedelta(seconds=timeout))
        return self.store.get(key)

    def add(self, key: str, amount: int = 1) -> int:
        return self.store.add(self._k(key), amount)

    def close(self):
        self.store = None


def master_from_env(job_id: str = "default") -> Optional[Master]:
    """A Master client from the launcher's env contract (PADDLE_MASTER,
    PADDLE_NNODES, the node rank)."""
    endpoint = os.environ.get("PADDLE_MASTER")
    if not endpoint:
        return None
    nnodes = int(os.environ.get("PADDLE_NNODES", "1"))
    rank = int(os.environ.get("PADDLE_NODE_RANK",
                              os.environ.get("PADDLE_TRAINER_ID", "0")))
    return Master(endpoint, rank, nnodes, job_id=job_id)
