"""The serving engines' shared chassis (port of ``EngineBase`` from
``paddle_tpu/serving/engine.py``).

Queue with admission control, a tenant registry with live add/drop and
priority tiers, per-tenant circuit breakers (the scheduler feeds them; an
open one sheds its tenant at the door with ``AdmissionError(reason=
"circuit")`` and ``/healthz`` reads ``degraded``), the engine-owned
telemetry exporter, the start/shutdown lifecycle of the scheduler thread,
and the zero-recompile proof (``compiles_after_warmup``).
"""
from __future__ import annotations

import logging
from typing import List, Optional, Set

from ..base.flags import get_flag
from ..observability.export import TelemetryServer
from ..observability.locks import named_lock
from ..observability.metrics import registry
from ..profiler.pipeline import ServingStats
from ..reliability.policy import BreakerBoard
from .request_queue import AdmissionController, RejectedError, RequestQueue

__all__ = ["EngineBase"]

_log = logging.getLogger("paddle_tpu_torch")


class EngineBase:
    """Subclasses set ``_scheduler`` (an object with ``start``/``alive``/
    ``join``), provide their own ``warmup``/``submit`` and
    ``compile_count``; ``warmup`` ends in :meth:`_start_serving`.

    ``serve_telemetry_port``: ``None`` defers to ``FLAGS_telemetry_port``
    (0 there: no exporter); an explicit integer always serves (0 picks an
    ephemeral port). The exporter starts at warmup and stops at
    shutdown."""

    def __init__(self, *, max_queue: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 request_ttl_ms: Optional[float] = None,
                 serve_telemetry_port: Optional[int] = None,
                 stats: Optional[ServingStats] = None):
        self.stats = stats if stats is not None else ServingStats()
        self._tenants: Set[str] = set()
        self._tenant_lock = named_lock("serving.engine.tenants")
        self.breakers = BreakerBoard()
        self.queue = RequestQueue(AdmissionController(
            max_queue=max_queue, tenant_quota=tenant_quota,
            request_ttl_ms=request_ttl_ms, breaker_board=self.breakers),
            stats=self.stats)
        self._compiles_at_warmup: Optional[int] = None
        self._started = False
        self._scheduler = None
        if serve_telemetry_port is None:
            flag_port = int(get_flag("telemetry_port"))
            self._telemetry_port = flag_port if flag_port > 0 else None
        else:
            self._telemetry_port = int(serve_telemetry_port)
        self._telemetry_port_explicit = serve_telemetry_port is not None
        self._telemetry_server: Optional[TelemetryServer] = None
        # the process registry's "serving" namespace reads the newest
        # engine's stats
        registry.register_collector("serving", self.stats.summary)

    # ------------------------------------------------------------ lifecycle
    def _start_serving(self) -> None:
        """Snapshot the compile count, bind the exporter, start the
        scheduler thread: the tail of every subclass's ``warmup()``.

        The exporter binds before the scheduler thread starts, so an
        explicit ``serve_telemetry_port`` that cannot bind raises with no
        thread running. A ``FLAGS_telemetry_port`` that cannot bind is
        logged and the engine serves on without egress: every engine of
        the process resolves the same flag port, and telemetry must never
        take down serving."""
        self._compiles_at_warmup = self.compile_count
        if self._telemetry_port is not None and self._telemetry_server is None:
            try:
                self._telemetry_server = TelemetryServer(
                    port=self._telemetry_port,
                    health_fn=self.telemetry_health).start()
            except OSError as e:
                if self._telemetry_port_explicit:
                    raise
                _log.warning("telemetry exporter port %d unavailable (%s); "
                             "serving continues without egress",
                             self._telemetry_port, e)
        if not self._started:
            self._scheduler.start()
            self._started = True

    def shutdown(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop admitting; with ``drain`` serve everything already
        admitted before the scheduler exits, otherwise fail pending
        requests with :class:`RejectedError`. Stops the exporter."""
        self.queue.close()
        if not drain:
            self.queue.fail_pending(RejectedError("serving engine shut down"))
        try:
            if self._started:
                if not self._scheduler.join(timeout):
                    raise TimeoutError(
                        f"serving scheduler did not drain in {timeout}s")
                self._started = False
        finally:
            if self._telemetry_server is not None:
                self._telemetry_server.stop()
                self._telemetry_server = None

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

    # ------------------------------------------------------------ telemetry
    @property
    def telemetry_url(self) -> Optional[str]:
        """The engine-owned exporter's base URL (None when not serving)."""
        srv = self._telemetry_server
        return srv.url if srv is not None else None

    def telemetry_health(self) -> dict:
        """The ``/healthz`` payload: scheduler-worker liveness, queue
        depth, open circuits and the zero-recompile proof. ``ok`` follows
        worker liveness while the engine is serving; open circuits make
        ``health`` read ``degraded`` (their tenants are shed, the rest
        serve)."""
        alive = self._scheduler.alive() if self._scheduler else False
        open_circuits = self.breakers.open_keys()
        return {
            "ok": bool(alive) if self._started else True,
            "health": "degraded" if open_circuits else "ok",
            "open_circuits": open_circuits,
            "worker_alive": bool(alive),
            "started": self._started,
            "queue_depth_requests": len(self.queue),
            "queue_depth_samples": self.queue.depth_samples(),
            "compiles_after_warmup": self.compiles_after_warmup,
            "tenants": len(self._tenants),
        }

    # ---------------------------------------------------------- accounting
    @property
    def compiles_after_warmup(self) -> Optional[int]:
        """Program signatures met since warmup (None before warmup). Every
        rung is armed at warmup, so traffic must hold this at 0."""
        if self._compiles_at_warmup is None:
            return None
        return self.compile_count - self._compiles_at_warmup
