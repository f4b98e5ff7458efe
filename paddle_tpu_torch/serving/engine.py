"""The serving engines' shared chassis (port of ``EngineBase`` from
``paddle_tpu/serving/engine.py``).

Queue with admission control, a tenant registry with live add/drop and
priority tiers, the start/shutdown lifecycle of the scheduler thread,
and the zero-recompile proof (``compiles_after_warmup``). The JAX
package's telemetry exporter and circuit breakers are left out of this
slice.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Set

from ..profiler.pipeline import ServingStats
from .request_queue import AdmissionController, RejectedError, RequestQueue

__all__ = ["EngineBase"]


class EngineBase:
    """Subclasses set ``_scheduler`` (an object with ``start``/``alive``/
    ``join``), provide their own ``warmup``/``submit`` and
    ``compile_count``; ``warmup`` ends in :meth:`_start_serving`."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 request_ttl_ms: Optional[float] = None,
                 stats: Optional[ServingStats] = None):
        self.stats = stats if stats is not None else ServingStats()
        self._tenants: Set[str] = set()
        self._tenant_lock = threading.Lock()
        self.queue = RequestQueue(AdmissionController(
            max_queue=max_queue, tenant_quota=tenant_quota,
            request_ttl_ms=request_ttl_ms), stats=self.stats)
        self._compiles_at_warmup: Optional[int] = None
        self._started = False
        self._scheduler = None

    # ------------------------------------------------------------ lifecycle
    def _start_serving(self) -> None:
        """Snapshot the compile count, start the scheduler thread: the
        tail of every subclass's ``warmup()``."""
        self._compiles_at_warmup = self.compile_count
        if not self._started:
            self._scheduler.start()
            self._started = True

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting; with ``drain`` serve everything already
        admitted before the scheduler exits, otherwise fail pending
        requests with :class:`RejectedError`."""
        self.queue.close()
        if not drain:
            self.queue.fail_pending(RejectedError("serving engine shut down"))
        if self._started:
            if not self._scheduler.join(timeout):
                raise TimeoutError(
                    f"serving scheduler did not drain in {timeout}s")
            self._started = False

    def __enter__(self):
        return self.warmup()

    def __exit__(self, *exc) -> None:
        self.shutdown(drain=exc == (None, None, None))

    # ------------------------------------------------------------ tenants
    def tenant(self, name: str) -> None:
        """Register a tenant lane (a no-op when it exists)."""
        with self._tenant_lock:
            self._tenants.add(name)

    @property
    def tenants(self) -> List[str]:
        with self._tenant_lock:
            return sorted(self._tenants)

    def drop_tenant(self, name: str) -> bool:
        """Retire a tenant mid-traffic: requests already admitted still
        complete; its stats lane is dropped. Returns whether it existed."""
        with self._tenant_lock:
            existed = name in self._tenants
            self._tenants.discard(name)
        self.stats.retire_tenant(name)
        return existed

    def set_tenant_tier(self, name: str, tier) -> None:
        """Pin a tenant's admission priority: ``"interactive"`` (default)
        or ``"bulk"``."""
        self.queue.admission.set_tier(name, tier)

    # ---------------------------------------------------------- accounting
    @property
    def compile_count(self) -> int:
        raise NotImplementedError

    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """Program signatures met since warmup (None before warmup). Every
        rung is armed at warmup, so traffic must hold this at 0."""
        if self._compiles_at_warmup is None:
            return None
        return self.compile_count - self._compiles_at_warmup
