"""Structured span tracer (port of ``paddle_tpu/observability/tracing.py``,
host spans only): one bounded event ring with named tracks, exportable as
chrome://tracing / Perfetto JSON (:meth:`SpanTracer.to_chrome_trace`).

Tracks are named lanes (``serving.scheduler``, ``host``); each gets a
stable tid and a ``thread_name`` metadata row. Timestamps come from
``time.perf_counter``, so spans emitted afterwards from recorded stamps
(:meth:`SpanTracer.emit`) land correctly against live ones.

``FLAGS_telemetry_trace`` gates recording. Off (the default), an
instrumented site pays one attribute read (``tracer.enabled``); on, a
span costs two ``perf_counter`` calls and one locked append.

The JAX tracer also fuses ``jax.profiler`` device traces into the same
export (``capture_device``). The port's device capture is not written yet
(``ROADMAP.md``, queue 8): :meth:`SpanTracer.capture_device` raises
``NotImplementedError``.
"""
from __future__ import annotations

import os
import time
from typing import List, Optional

from ..base.flags import get_flag
from .locks import named_lock

__all__ = ["SpanTracer", "tracer"]


class _Span:
    """One open span; ``with tracer.span(...)`` closes it."""

    __slots__ = ("tracer", "name", "track", "args", "t0_us")

    def __init__(self, tracer_, name, track, args):
        self.tracer = tracer_
        self.name = name
        self.track = track
        self.args = args
        self.t0_us = time.perf_counter() * 1e6

    def end(self) -> None:
        self.tracer._close(self)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


class _NullSpan:
    """The disabled-tracer span: a shared, stateless no-op."""

    __slots__ = ()

    def end(self) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_SPAN = _NullSpan()


class SpanTracer:
    """Bounded, thread-safe event ring with chrome-trace export."""

    def __init__(self, enabled: Optional[bool] = None,
                 max_events: Optional[int] = None):
        self._lock = named_lock("tracing.spans")
        self._events: List[tuple] = []   # (ph, name, track, ts_us, dur_us, args)
        self._tids: dict = {}            # track name -> tid
        self._dropped = 0
        self._max_events = max_events
        if enabled is None:
            enabled = get_flag("telemetry_trace")
        self.enabled = bool(enabled)

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> "SpanTracer":
        self.enabled = True
        return self

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._dropped = 0

    def _cap(self) -> int:
        if self._max_events is not None:
            return int(self._max_events)
        return int(get_flag("telemetry_trace_max_events"))

    # ------------------------------------------------------------ recording
    def span(self, name: str, track: str = "host", **args):
        """Context manager (or explicit ``.end()``) recording one complete
        event. The no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, track, args or None)

    def _close(self, s: _Span) -> None:
        t1 = time.perf_counter() * 1e6
        with self._lock:
            self._append(("X", s.name, s.track, s.t0_us, t1 - s.t0_us, s.args))

    def emit(self, name: str, t0_s: float, dur_s: float,
             track: str = "host", **args) -> None:
        """Record a complete span from already-measured ``perf_counter``
        timestamps (seconds) — the retroactive path for events whose
        phases were stamped elsewhere (serving requests)."""
        if not self.enabled:
            return
        with self._lock:
            self._append(("X", name, track, t0_s * 1e6, dur_s * 1e6,
                          args or None))

    def instant(self, name: str, track: str = "host", **args) -> None:
        """Zero-duration marker (a memory sample tick)."""
        if not self.enabled:
            return
        with self._lock:
            self._append(("i", name, track, time.perf_counter() * 1e6, 0.0,
                          args or None))

    def _append(self, event: tuple) -> None:
        # caller holds self._lock
        self._events.append(event)
        cap = self._cap()
        if cap > 0 and len(self._events) > cap:
            drop = len(self._events) - cap
            del self._events[:drop]
            self._dropped += drop

    def capture_device(self, *args, **kwargs):
        """Device-trace capture is not ported: the JAX tracer drives
        ``jax.profiler`` here; the port's ``torch.profiler`` capture waits
        for ``ROADMAP.md``, queue 8."""
        raise NotImplementedError(
            "SpanTracer.capture_device (device-trace fusion) is not ported "
            "yet (ROADMAP.md, queue 8)")

    # ------------------------------------------------------------ reporting
    def _tid(self, track: str) -> int:
        with self._lock:  # two exporters racing a new track must not
            tid = self._tids.get(track)  # hand two tracks one tid
            if tid is None:
                tid = self._tids[track] = len(self._tids) + 1
            return tid

    def _event_dict(self, event: tuple, pid: int) -> dict:
        ph, name, track, ts, dur, args = event
        ev = {"ph": ph, "name": name, "pid": pid,
              "tid": self._tid(track), "ts": ts, "cat": track, "dur": dur}
        if args:
            ev["args"] = dict(args)
        return ev

    def tail_chrome_events(self, n: int = 512) -> List[dict]:
        """The most recent ``n`` events as chrome-trace dicts: the anomaly
        flight recorder's bounded span window."""
        if (n := int(n)) <= 0:
            return []
        pid = os.getpid()
        with self._lock:
            events = list(self._events[-n:])
        return [self._event_dict(e, pid) for e in events]

    def to_chrome_trace(self) -> dict:
        """The timeline as a chrome://tracing / Perfetto JSON object.
        Tracks become named tid lanes under one pid; span ``args`` ride
        through for the Perfetto details pane."""
        pid = os.getpid()
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        out = []
        for track in {e[2] for e in events}:
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": self._tid(track),
                        "args": {"name": track}})
        out.extend(self._event_dict(e, pid) for e in events)
        trace = {"traceEvents": out, "displayTimeUnit": "ms"}
        if dropped:
            trace["otherData"] = {"dropped_events": dropped}
        return trace


tracer = SpanTracer()
