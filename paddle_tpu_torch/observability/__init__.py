"""paddle_tpu_torch.observability — the serving tier's runtime telemetry
(port of the part of ``paddle_tpu.observability`` the decode engine uses).

- :mod:`metrics`: the process registry of Counter/Gauge/Histogram
  instruments with labels plus pull-time collectors;
  ``registry.snapshot()`` is the JSON surface.
- :mod:`tracing`: the host span tracer onto one chrome://tracing /
  Perfetto timeline; ``FLAGS_telemetry_trace`` gates recording.
- :mod:`export`: Prometheus text exposition and the
  :class:`TelemetryServer` HTTP thread (``/metrics``, ``/healthz``,
  ``/snapshot.json``, ``/trace.json``), owned by
  ``DecodeEngine(serve_telemetry_port=...)`` / ``FLAGS_telemetry_port``.
- :mod:`locks`: the named-lock registry and the runtime lock-order witness
  (``FLAGS_concurrency_witness``).

Not ported yet (``ROADMAP.md``, queue 8): the anomaly flight recorder
(``anomaly.py``), the device-memory sampler (``memory.py``), device-trace
capture (``SpanTracer.capture_device`` raises) and the ``tools.telemetry``
command line.
"""
from __future__ import annotations

from ..base.flags import on_flag_change
from .export import TelemetryServer, prometheus_text
from .locks import (NamedCondition, NamedLock, named_condition, named_lock,
                    set_witness, witness_enabled, witness_report)
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, registry
from .tracing import SpanTracer, tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NamedCondition",
    "NamedLock", "SpanTracer", "TelemetryServer", "named_condition",
    "named_lock", "prometheus_text", "registry", "set_witness", "tracer",
    "witness_enabled", "witness_report",
]

# FLAGS_telemetry_trace is mirrored into the tracer's hot-path `enabled`
# attribute (instrumented sites pay one attribute read, never a registry
# lookup); these hooks keep a runtime set_flags(...) in sync
on_flag_change("telemetry_trace",
               lambda v: setattr(tracer, "enabled", bool(v)))
on_flag_change("concurrency_witness", lambda v: set_witness(bool(v)))

