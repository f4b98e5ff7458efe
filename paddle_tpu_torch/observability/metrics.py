"""Process-wide metrics registry (port of
``paddle_tpu/observability/metrics.py``): one namespace for the serving
tier's counters, gauges and histograms.

- **Instruments**: :class:`Counter` / :class:`Gauge` / :class:`Histogram`
  with optional labels, each a short lock-guarded update.
- **Collectors**: zero-arg callables registered under a namespace and
  pulled at :meth:`MetricsRegistry.snapshot` time (the serving engine
  registers its ``ServingStats`` summary as ``serving``).
- **snapshot()**: one JSON-able dict of every instrument and collector:
  ``{"ts_unix", "metrics": {name: {"type", "values"|payload}}}``.

Asking for an existing name with the same instrument kind returns the
same instrument; asking with a different kind is a schema collision,
recorded in ``collisions``, and the caller gets a detached instrument.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from .locks import named_lock

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "registry"]


def _label_key(labels: dict):
    return tuple(sorted(labels.items())) if labels else ()


class _Instrument:
    """Shared label-cell machinery. One cell per distinct label set."""

    kind = "instrument"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = named_lock("metrics.instrument")
        self._cells: Dict[tuple, object] = {}

    def _values(self) -> list:
        with self._lock:
            return [{"labels": dict(k), "value": v} if k else {"value": v}
                    for k, v in self._cells.items()]

    def to_dict(self) -> dict:
        d = {"type": self.kind, "values": self._values()}
        if self.help:
            d["help"] = self.help
        return d

class Counter(_Instrument):
    """Monotonically increasing count (events, bytes, builds)."""

    kind = "counter"

    def inc(self, n: float = 1, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def value(self, **labels) -> float:
        with self._lock:
            return self._cells.get(_label_key(labels), 0)


class Gauge(_Instrument):
    """Point-in-time value (queue depth, live bytes, config)."""

    kind = "gauge"

    def set(self, v: float, **labels) -> None:
        with self._lock:
            self._cells[_label_key(labels)] = v

    def add(self, n: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._cells[key] = self._cells.get(key, 0) + n

    def value(self, **labels):
        with self._lock:
            return self._cells.get(_label_key(labels))


class Histogram(_Instrument):
    """Distribution summary: count/sum/min/max plus p50/p99 from a bounded
    ring of the most recent ``max_samples`` observations."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", max_samples: int = 2048):
        super().__init__(name, help)
        self._max_samples = int(max_samples)

    def observe(self, v: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                cell = self._cells[key] = {
                    "count": 0, "sum": 0.0,
                    "min": float("inf"), "max": float("-inf"), "ring": []}
            cell["count"] += 1
            cell["sum"] += v
            if v < cell["min"]:
                cell["min"] = v
            if v > cell["max"]:
                cell["max"] = v
            ring = cell["ring"]
            ring.append(v)
            if len(ring) > self._max_samples:
                del ring[: len(ring) - self._max_samples]

    @staticmethod
    def _pct(sorted_vals: list, q: float):
        """Percentile over the ring; ``None`` with no samples, and the
        Prometheus exposition then omits the quantile line (never NaN)."""
        if not sorted_vals:
            return None
        idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
        return sorted_vals[idx]

    def summary(self, **labels) -> Optional[dict]:
        """``None`` when the label set has never observed anything (the
        same contract as the empty-ring percentile: absent, not NaN);
        otherwise count/sum/min/max/mean plus p50/p99 over the bounded
        ring (which are themselves ``None`` if the ring is empty)."""
        with self._lock:
            cell = self._cells.get(_label_key(labels))
            if cell is None or cell["count"] == 0:
                return None
            ring = sorted(cell["ring"])
            return {"count": cell["count"], "sum": cell["sum"],
                    "min": cell["min"], "max": cell["max"],
                    "mean": cell["sum"] / cell["count"],
                    "p50": self._pct(ring, 0.50),
                    "p99": self._pct(ring, 0.99)}

    def _values(self) -> list:
        with self._lock:
            keys = list(self._cells)
        out = []
        for k in keys:
            s = self.summary(**dict(k))
            if s is not None:
                out.append({"labels": dict(k), **s} if k else s)
        return out


class MetricsRegistry:
    """Name → instrument map plus pull-time collectors; the one schema
    every subsystem's telemetry lands in."""

    def __init__(self):
        self._lock = named_lock("metrics.registry")
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        # (name, requested_kind, existing_kind) schema collisions
        self.collisions: List[tuple] = []

    # ------------------------------------------------------------ register
    def _get(self, name: str, cls, help: str = "", **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kwargs)
                return inst
            if isinstance(inst, cls) and type(inst) is cls:
                return inst
            self.collisions.append((name, cls.kind, inst.kind))
        # detached: the caller keeps working, `collisions` reports the clash
        return cls(name, help, **kwargs)

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(name, Counter, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(name, Gauge, help)

    def histogram(self, name: str, help: str = "",
                  max_samples: int = 2048) -> Histogram:
        return self._get(name, Histogram, help, max_samples=max_samples)

    def register_collector(self, namespace: str,
                           fn: Callable[[], dict]) -> None:
        """Pull-time source merged into :meth:`snapshot` under
        ``namespace``. Re-registration replaces."""
        with self._lock:
            self._collectors[namespace] = fn

    # ------------------------------------------------------------ reporting
    def snapshot(self) -> dict:
        """Everything, one JSON-able dict. Collector failures degrade to
        an ``{"error": ...}`` payload — a broken silo must never take the
        whole surface down with it."""
        with self._lock:
            instruments = list(self._instruments.items())
            collectors = list(self._collectors.items())
            collisions = list(self.collisions)
        metrics = {name: inst.to_dict() for name, inst in instruments}
        for namespace, fn in collectors:
            try:
                payload = fn()
            except Exception as e:
                payload = {"error": f"{type(e).__name__}: {e}"}
            metrics[namespace] = {"type": "collected", **payload} \
                if isinstance(payload, dict) else {"type": "collected",
                                                   "value": payload}
        out = {"ts_unix": time.time(), "metrics": metrics}
        if collisions:
            out["collisions"] = [list(c) for c in collisions]
        return out


registry = MetricsRegistry()
