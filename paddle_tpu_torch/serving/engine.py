"""The serving engines (port of ``paddle_tpu/serving/engine.py``): the
shared chassis ``EngineBase`` and the batch tier's ``ServingEngine``.

``EngineBase``: a queue with admission control, a tenant registry with
live add/drop and priority tiers, per-tenant circuit breakers (the scheduler feeds them; an
open one sheds its tenant at the door with ``AdmissionError(reason=
"circuit")`` and ``/healthz`` reads ``degraded``), the engine-owned
telemetry exporter, the start/shutdown lifecycle of the scheduler thread,
and the zero-recompile proof (``compiles_after_warmup``). The decode tier
(``serving/decode.py`` ``DecodeEngine``) and the batch tier serve through
it.

``ServingEngine``: one exported model (``jit.save``) serving many
tenants through ``inference.Predictor``. Each tenant gets a clone, which
shares the weights and the batch program's graphs; client threads submit
and block on ``Request.result()``; one scheduler thread assembles
mixed-size requests into bucketed batches and replays the rung's graph;
no rung is added after ``warmup()``. Each batch passes the fault point
``serving.execute`` under a retry policy, and each request emits a
``serving.request`` span. ``swap_weights`` rolls new weights in between
two batches. The JAX engine's feeds to the anomaly monitor and the
device-memory sampler (``observability.anomaly``, ``observability.memory``)
wait in ``ROADMAP.md`` queue 8.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE
from ..inference import Config, Predictor
from ..jit.bucketing import bucket_for
from ..observability.export import TelemetryServer
from ..observability.locks import named_lock
from ..observability.metrics import registry
from ..profiler.pipeline import ServingStats
from ..observability.tracing import tracer
from ..reliability.faults import fault_point
from ..reliability.policy import BreakerBoard, RetryPolicy
from .request_queue import (AdmissionController, RejectedError, Request,
                            RequestQueue)
from .scheduler import (Scheduler, fetch_outputs, scatter_outputs,
                        stack_requests)

__all__ = ["EngineBase", "ServingEngine"]

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
        # tenant -> its lane (the batch tier's Predictor clone, else None)
        self._tenants: Dict[str, object] = {}
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
    def tenant(self, name: str):
        """Register a tenant lane (a no-op when it exists) and return it
        (``None`` here; the batch tier's lane is a Predictor clone)."""
        with self._tenant_lock:
            return self._tenants.setdefault(name, None)

    @property
    def tenants(self) -> List[str]:
        with self._tenant_lock:
            return sorted(self._tenants)

    def drop_tenant(self, name: str) -> bool:
        """Retire a tenant mid-traffic: requests already admitted still
        complete; its stats lane is dropped. Returns whether it existed."""
        with self._tenant_lock:
            existed = name in self._tenants
            self._tenants.pop(name, None)
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


class ServingEngine(EngineBase):
    """Continuous bucketed batching over one exported model.

    ``model``: a ``jit.save`` path prefix, loaded on ``device`` (default
    CUDA; raises without it unless ``device="cpu"``), or a ready
    :class:`~..inference.Predictor`. ``buckets`` overrides the batch
    ladder (default: powers of two up to ``FLAGS_serving_max_batch``),
    ``seq_buckets`` the seq ladder of a two-axis export; ``linger_ms`` is
    the batching window (``FLAGS_serving_batch_timeout_ms``)."""

    def __init__(self, model: Union[str, Predictor], *,
                 buckets: Optional[Sequence[int]] = None,
                 seq_buckets: Optional[Sequence[int]] = None,
                 max_queue: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 request_ttl_ms: Optional[float] = None,
                 linger_ms: Optional[float] = None,
                 serve_telemetry_port: Optional[int] = None,
                 stats: Optional[ServingStats] = None,
                 device=DEFAULT_DEVICE):
        super().__init__(max_queue=max_queue, tenant_quota=tenant_quota,
                         request_ttl_ms=request_ttl_ms,
                         serve_telemetry_port=serve_telemetry_port,
                         stats=stats)
        self.predictor = (model if isinstance(model, Predictor)
                          else Predictor(Config(model, device=device)))
        if buckets is not None:
            self.predictor.set_batch_ladder(buckets)
        if seq_buckets is not None:
            self.predictor.set_seq_ladder(seq_buckets)
        linger = (float(get_flag("serving_batch_timeout_ms"))
                  if linger_ms is None else float(linger_ms)) / 1e3
        prog = self.predictor._ensure_batch_program()
        self._n_inputs = len(self.predictor.get_input_names())
        self._dynamic_axes = dict(prog.dynamic_axes)
        # the second bucket axis: {input: seq axis} of the rank-1 dims
        self._seq_axes = {i: ax for (i, ax), r in prog.dynamic_ranks.items()
                          if r == 1}
        self._scheduler = Scheduler(
            self.queue, self._execute, lambda: prog.ladder,
            linger_s=linger, on_batch=self._on_batch,
            retry=RetryPolicy("serving.execute"), breakers=self.breakers)

    # ------------------------------------------------------------ lifecycle
    def warmup(self) -> "ServingEngine":
        """Arm the whole ladder (the full grid on a two-axis export; on
        the card every rung captured), snapshot the rung count, start the
        scheduler thread."""
        self.predictor.warmup_ladder()
        self._start_serving()
        return self

    # ------------------------------------------------------------ tenants
    def tenant(self, name: str) -> Predictor:
        """The tenant's own Predictor clone (weights and graphs shared with
        every other tenant; IO handles its own)."""
        with self._tenant_lock:
            pred = self._tenants.get(name)
            if pred is None:
                pred = self._tenants[name] = self.predictor.clone()
            return pred

    # ------------------------------------------------------------ serving
    def submit(self, tenant: str, inputs, n: Optional[int] = None) -> Request:
        """Enqueue ``n`` samples for ``tenant``; returns the
        :class:`Request` future. ``inputs``: one array or a list matching
        the model's inputs, each with ``n`` rows on its batch axis. A
        request larger than the top batch rung, or longer than the top seq
        rung, raises ``ValueError``; a refusing gate raises
        ``AdmissionError``."""
        if not self._started:
            raise RuntimeError("engine not started: call warmup() first")
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        arrays = [np.asarray(a) for a in inputs]
        if n is None:
            idx0, ax0 = (next(iter(self._dynamic_axes.items()))
                         if self._dynamic_axes else (0, 0))
            n = int(arrays[idx0].shape[ax0])
        max_batch = self.predictor.batch_ladder[-1]
        if n > max_batch:
            raise ValueError(
                f"request of {n} samples exceeds the largest bucket "
                f"({max_batch}); split it or raise FLAGS_serving_max_batch")
        seq = None
        if self._seq_axes:
            seq = max(int(arrays[i].shape[ax])
                      for i, ax in self._seq_axes.items())
            top = self.predictor.seq_ladder[-1]
            if seq > top:
                raise ValueError(
                    f"request sequence length {seq} exceeds the largest "
                    f"seq bucket ({top}); split it or raise the seq ladder")
        self.tenant(tenant)
        return self.queue.submit(Request(tenant, arrays, n, seq=seq))

    def run(self, tenant: str, inputs, n: Optional[int] = None,
            timeout: Optional[float] = 60.0) -> List[np.ndarray]:
        """submit + block."""
        return self.submit(tenant, inputs, n).result(timeout)

    def _execute(self, requests: List[Request], bucket: int) -> None:
        """One program call for one assembled batch (scheduler thread):
        the fault point, the rung's replay, one device-to-host round of
        the real rows, the rows scattered back and each request
        completed."""
        prog = self.predictor._ensure_batch_program()
        seq_bucket = None
        if self._seq_axes:
            seq_bucket = bucket_for(max(r.seq or 1 for r in requests),
                                    prog.seq_ladder)
        stacked = stack_requests(requests, bucket, self._dynamic_axes,
                                 self._n_inputs, seq_axes=self._seq_axes,
                                 seq_bucket=seq_bucket)
        fault_point("serving.execute")
        rung = (bucket, seq_bucket) if seq_bucket is not None else bucket
        # the pad stays on the card: real rows, up to the longest request
        seq = max(r.seq for r in requests) if seq_bucket else None
        leaves = fetch_outputs(prog(stacked, rung),
                               rows=sum(r.n for r in requests), seq=seq,
                               out_seq_axes=prog.out_seq_axes)
        rows = scatter_outputs(leaves, requests, seq_bucket=seq,
                               out_seq_axes=prog.out_seq_axes)
        for r, outs in zip(requests, rows):
            self.queue.admission.on_complete(r.tenant, r.n)
            r._complete(outs)
            self.stats.record_request(r.t_enqueue, r.t_admit, r.t_dispatch,
                                      r.t_complete, r.n, tenant=r.tenant)
            if tracer.enabled:
                tracer.emit(
                    "serving.request", r.t_enqueue,
                    r.t_complete - r.t_enqueue,
                    track=f"serving.requests.{r.tenant}", request_id=r.id,
                    n=r.n, bucket=rung,
                    queue_wait_ms=(r.t_dispatch - r.t_admit) * 1e3,
                    execute_ms=(r.t_complete - r.t_dispatch) * 1e3)

    def _on_batch(self, n_samples: int, bucket: int, depth: int,
                  requests: List[Request]) -> None:
        tokens = token_slots = None
        if self._seq_axes:
            seq_bucket = bucket_for(max(r.seq for r in requests),
                                    self.predictor.seq_ladder)
            tokens = sum(r.n * r.seq for r in requests)
            token_slots = bucket * seq_bucket
        self.stats.record_batch(n_samples, bucket, tokens, token_slots)
        self.stats.record_queue_depth(depth)

    # ------------------------------------------------------------ hot swap
    def swap_weights(self, source) -> dict:
        """Roll new weights into the live engine between two batches: no
        request dropped, no rung added. ``source`` is a sharded checkpoint
        directory or a ``{name: tensor}`` dict (see
        :meth:`~..inference.Predictor.swap_weights`); every tenant's clone
        serves the new weights from the next batch on. Returns the
        predictor's report plus ``compiles_after_warmup``."""
        t0 = time.perf_counter()
        what = (str(source)[:120] if isinstance(source, (str, os.PathLike))
                else f"dict of {len(source)} tensors")
        with tracer.span("serving.swap_weights", track="serving.scheduler",
                         source=what):
            report = self.predictor.swap_weights(source)
        report["compiles_after_warmup"] = self.compiles_after_warmup
        report["seconds"] = time.perf_counter() - t0
        return report

    # ---------------------------------------------------------- accounting
    @property
    def compile_count(self) -> int:
        return self.predictor.compile_count

    def serving_report(self) -> dict:
        """Stats summary plus the ladder and the recompile proof."""
        report = self.stats.summary()
        report.update(
            buckets=list(self.predictor.batch_ladder),
            seq_buckets=self.predictor.seq_ladder,
            n_tenants=len(self._tenants),
            compiled_rungs=self.predictor.compile_count,
            compiles_after_warmup=self.compiles_after_warmup,
        )
        return report
