"""Anomaly flight recorder: catch the forensic window, not the aftermath
(port of ``paddle_tpu/observability/anomaly.py``).

When a step suddenly slows or the serving queue blows its SLO, the
evidence — which spans ran long, what the queue looked like, what the
allocator watermark was — is gone by the time anyone attaches a
profiler. The :class:`AnomalyMonitor` watches the boundaries the runtime
already crosses (train-step close, serving batch/request close, metric
flush) through pluggable detectors and, on a trigger or an uncaught
train/serving-worker exception, dumps ONE bounded forensic bundle:

- the last-N span events from the unified tracer ring,
- the full ``MetricsRegistry.snapshot()``,
- the detector's verdict (what fired, against which threshold),
- the recent step-time window.

Built-in detectors (each a few comparisons per observation):

===================  =====================================================
step_time            rolling median + MAD over the last steps; a step
                     slower than ``median + FLAGS_anomaly_step_mad * MAD``
                     is a regression (robust to the odd logging step —
                     MAD, not stddev, so one outlier does not widen the
                     gate for the next one)
serving_slo          a completed request whose enqueue→complete latency
                     exceeded ``FLAGS_serving_slo_ms`` (verdict carries
                     the queue-wait share: was it assembly or compute)
reject_burst         ``FLAGS_anomaly_reject_burst`` admission rejections
                     inside one second — load shedding has become the
                     steady state, not the exception
memory_watermark     the caching allocator's bytes / high watermark vs
                     ``FLAGS_cost_hbm_budget_bytes`` (fed from the
                     sync-free boundary sampler's last reading)
===================  =====================================================

Cost discipline (same as the span tracer): disabled — the default —
every instrumented site pays ONE attribute read (``monitor.enabled``,
mirrored from ``FLAGS_telemetry_anomaly``); no clock read, no lock.
Dumping is rate-limited per anomaly kind (``FLAGS_anomaly_dump_cooldown_s``
— repeats tick ``anomaly.suppressed`` instead of writing) and the dump
directory is bounded (``max_bundles``, oldest deleted first). Every trigger ticks ``anomaly.triggered``
with a ``kind`` label so the scrape endpoint surfaces it; every dump is
logged to the ``paddle_tpu_torch`` logger. Two witnesses feed it too:
the numerics witness (``observability/numerics.py``) and the lock-order
witness's inversions (``observability/locks.py``).
"""
from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Dict, List, Optional

from ..base.flags import get_flag
from .locks import named_lock

__all__ = ["AnomalyMonitor", "Detector", "MemoryWatermarkDetector",
           "RejectBurstDetector", "ServingSLODetector",
           "StepTimeRegressionDetector", "monitor"]

_MONITOR_COUNT = [0]
_MONITOR_COUNT_LOCK = named_lock("anomaly.monitor_count")


_log = logging.getLogger("paddle_tpu_torch")


def _get_flag(name, default):
    try:
        return get_flag(name)
    except KeyError:
        return default


class Detector:
    """One anomaly rule. ``observe(...)`` returns a verdict dict when the
    rule trips, else None. ``observed`` counts feeds — a registered
    detector that nothing feeds is a dead monitor."""

    name = "detector"

    def __init__(self):
        self.observed = 0
        self.triggered = 0


class StepTimeRegressionDetector(Detector):
    """Rolling median + MAD over the last ``window`` step times."""

    name = "step_time"

    def __init__(self, window: int = 64, min_history: int = 8,
                 mad_threshold: Optional[float] = None):
        super().__init__()
        self._ring: deque = deque(maxlen=int(window))
        self._min_history = int(min_history)
        self._mad_threshold = mad_threshold
        # the ring is appended from the train thread but snapshotted by
        # step_window() from whichever thread dumps a bundle (e.g. the
        # serving scheduler) — iterating a deque during an append raises
        self._obs_lock = named_lock("anomaly.step_window")

    @staticmethod
    def _median(sorted_vals: List[float]) -> float:
        n = len(sorted_vals)
        mid = n // 2
        if n % 2:
            return sorted_vals[mid]
        return 0.5 * (sorted_vals[mid - 1] + sorted_vals[mid])

    def observe(self, step_s: float) -> Optional[dict]:
        threshold = (self._mad_threshold if self._mad_threshold is not None
                     else float(_get_flag("anomaly_step_mad", 0.0)))
        with self._obs_lock:
            # observed moves with the ring (CX1000: the counter is read
            # by whichever thread dumps a bundle, not just the feeder)
            self.observed += 1
            history = list(self._ring)
            self._ring.append(float(step_s))
        if threshold <= 0 or len(history) < self._min_history:
            return None
        srt = sorted(history)
        median = self._median(srt)
        mad = self._median(sorted(abs(v - median) for v in srt))
        # floor the MAD at 5% of the median: a perfectly steady window
        # (MAD→0) must not turn scheduler jitter into an anomaly storm
        gate = median + threshold * max(mad, 0.05 * median)
        if step_s <= gate:
            return None
        self.triggered += 1
        return {"kind": "step_time", "step_s": round(step_s, 6),
                "median_s": round(median, 6), "mad_s": round(mad, 6),
                "threshold_mads": threshold, "gate_s": round(gate, 6),
                "window": len(history)}


class ServingSLODetector(Detector):
    """A completed request breached the latency SLO."""

    name = "serving_slo"

    def __init__(self, slo_ms: Optional[float] = None):
        super().__init__()
        self._slo_ms = slo_ms

    def observe(self, total_s: float, queue_wait_s: float = 0.0,
                tenant: Optional[str] = None) -> Optional[dict]:
        self.observed += 1
        slo_ms = (self._slo_ms if self._slo_ms is not None
                  else float(_get_flag("serving_slo_ms", 0.0)))
        if slo_ms <= 0 or total_s * 1e3 <= slo_ms:
            return None
        self.triggered += 1
        return {"kind": "serving_slo", "latency_ms": round(total_s * 1e3, 3),
                "slo_ms": slo_ms,
                "queue_wait_ms": round(queue_wait_s * 1e3, 3),
                "queue_wait_share": (round(queue_wait_s / total_s, 4)
                                     if total_s > 0 else None),
                "tenant": tenant}


class RejectBurstDetector(Detector):
    """Admission rejections concentrating inside one second."""

    name = "reject_burst"

    def __init__(self, burst: Optional[int] = None,
                 window_s: float = 1.0):
        super().__init__()
        self._burst = burst
        self._window_s = float(window_s)
        self._stamps: deque = deque()
        # unlike the step/serving detectors (fed from one loop thread),
        # rejections arrive from arbitrary submitter threads OUTSIDE the
        # queue's condition lock, so the window needs its own lock
        self._obs_lock = named_lock("anomaly.reject_window")

    def observe(self, tenant: Optional[str] = None) -> Optional[dict]:
        burst = int(self._burst if self._burst is not None
                    else _get_flag("anomaly_reject_burst", 0))
        with self._obs_lock:
            self.observed += 1
            if burst <= 0:
                return None
            now = time.perf_counter()
            self._stamps.append(now)
            while self._stamps and now - self._stamps[0] > self._window_s:
                self._stamps.popleft()
            if len(self._stamps) < burst:
                return None
            self.triggered += 1
            count = len(self._stamps)
            self._stamps.clear()  # one verdict per burst, not per rejection
        return {"kind": "reject_burst", "rejections": count,
                "window_s": self._window_s, "burst_threshold": burst,
                "tenant": tenant}


class MemoryWatermarkDetector(Detector):
    """Measured device-memory watermark vs the static HBM budget."""

    name = "memory_watermark"

    def __init__(self, budget_bytes: Optional[int] = None):
        super().__init__()
        self._budget = budget_bytes

    def observe(self, stats: Optional[dict]) -> Optional[dict]:
        self.observed += 1
        if not stats:
            return None
        budget = int(self._budget if self._budget is not None
                     else _get_flag("cost_hbm_budget_bytes", 0))
        if budget <= 0:
            return None
        peak = max([stats.get("live_bytes", 0)]
                   + [d.get("peak_bytes_in_use", 0)
                      for d in stats.get("devices", {}).values()])
        if peak <= budget:
            return None
        self.triggered += 1
        return {"kind": "memory_watermark", "peak_bytes": int(peak),
                "budget_bytes": budget,
                "over_budget_x": round(peak / budget, 3)}


class AnomalyMonitor:
    """The flight recorder: boundary feeds in, bounded bundles out.

    ``enabled`` mirrors ``FLAGS_telemetry_anomaly`` (the package
    ``__init__`` registers the flag hook); instrumented boundaries check
    it before paying for a clock read. The default detector set is
    registered at construction, so each one's ``observed`` count says
    whether anything feeds it.
    """

    def __init__(self, enabled: Optional[bool] = None,
                 dump_dir: Optional[str] = None,
                 cooldown_s: Optional[float] = None,
                 max_bundles: int = 32,
                 span_tail: int = 512,
                 tracer=None, registry=None):
        if enabled is None:
            enabled = bool(_get_flag("telemetry_anomaly", False))
        self.enabled = bool(enabled)
        self._dump_dir = dump_dir
        self._cooldown_s = cooldown_s
        self.max_bundles = int(max_bundles)
        self.span_tail = int(span_tail)
        self._tracer = tracer
        self._registry = registry
        self._lock = named_lock("anomaly.monitor")
        self._last_dump: Dict[str, float] = {}   # kind -> perf_counter stamp
        self._last_note: Dict[str, float] = {}   # counted-not-dumped log stamp
        self._seq = 0
        # bundle names must survive a restart into the same persistent
        # dump dir: a bare per-process sequence would recreate run 1's
        # paths and truncate its post-mortems (monitor counter covers
        # same-pid same-second instances)
        with _MONITOR_COUNT_LOCK:
            _MONITOR_COUNT[0] += 1
            nth = _MONITOR_COUNT[0]
        self._run_id = f"{int(time.time()):x}-{os.getpid():x}-{nth:x}"
        self.bundles: List[str] = []             # paths written this process
        self.detectors: Dict[str, Detector] = {}
        for det in (StepTimeRegressionDetector(), ServingSLODetector(),
                    RejectBurstDetector(), MemoryWatermarkDetector()):
            self.register(det)

    # ------------------------------------------------------------ plumbing
    def register(self, detector: Detector) -> Detector:
        self.detectors[detector.name] = detector
        return detector

    @property
    def dump_dir(self) -> str:
        if self._dump_dir is not None:
            return self._dump_dir
        return str(_get_flag("telemetry_dump_dir", "") or "")

    def _cooldown(self) -> float:
        if self._cooldown_s is not None:
            return float(self._cooldown_s)
        return float(_get_flag("anomaly_dump_cooldown_s", 60.0))

    def _get_tracer(self):
        if self._tracer is None:
            from .tracing import tracer as _tracer

            self._tracer = _tracer
        return self._tracer

    def _get_registry(self):
        if self._registry is None:
            from .metrics import registry as _registry

            self._registry = _registry
        return self._registry

    def enable(self) -> "AnomalyMonitor":
        self.enabled = True
        return self

    def disable(self) -> "AnomalyMonitor":
        self.enabled = False
        return self

    # ------------------------------------------------------------- feeding
    def on_step(self, step_s: float) -> Optional[str]:
        """Train-step close (TrainStep.__call__ / the hapi fit loop)."""
        det = self.detectors.get("step_time")
        verdict = det.observe(step_s) if det is not None else None
        return self._trigger(verdict, det) if verdict else None

    def on_serving_request(self, total_s: float, queue_wait_s: float = 0.0,
                           tenant: Optional[str] = None) -> Optional[str]:
        """Serving request close (engine completion loop)."""
        det = self.detectors.get("serving_slo")
        verdict = (det.observe(total_s, queue_wait_s, tenant)
                   if det is not None else None)
        return self._trigger(verdict, det) if verdict else None

    def on_rejected(self, tenant: Optional[str] = None) -> Optional[str]:
        """Admission rejection (request queue's refusal path)."""
        det = self.detectors.get("reject_burst")
        verdict = det.observe(tenant) if det is not None else None
        return self._trigger(verdict, det) if verdict else None

    def on_flush(self) -> Optional[str]:
        """Metric-flush boundary: check the boundary memory sampler's
        last (sync-free) reading against the HBM budget."""
        det = self.detectors.get("memory_watermark")
        if det is None:
            return None
        from .memory import sampler

        verdict = det.observe(sampler.last)
        return self._trigger(verdict, det) if verdict else None

    def on_lock_inversion(self, verdict: dict) -> Optional[str]:
        """Lock-order inversion from the concurrency witness
        (observability/locks.py, CX1004): always a trigger — the witness
        being lit is the opt-in, so this feed does not also gate on
        ``enabled``. Rate-limited per kind like every other feed, which
        is what bounds an inversion storm to one bundle per cooldown."""
        v = dict(verdict)
        v["kind"] = "lock_inversion"
        return self._trigger(v, None)

    def on_numerics(self, verdict: dict) -> Optional[str]:
        """Numerics witness verdict (observability/numerics.py, NM1104
        non-finite / NM1105 range collapse): always a trigger — the
        witness being lit is the opt-in, so this feed does not also
        gate on ``enabled``. The per-kind cooldown bounds a NaN storm
        (every subsequent step is non-finite too) to one bundle."""
        v = dict(verdict)
        v["kind"] = "numerics"
        return self._trigger(v, None)

    def on_exception(self, where: str, exc: BaseException) -> Optional[str]:
        """Uncaught train-loop / serving-worker exception: always a
        trigger (rate-limited like the detectors); the bundle is the
        post-mortem the raising thread can no longer take. Deliberate
        interpreter exits are not anomalies: a Ctrl-C must propagate
        without snapshot/disk work in the interrupt path, and must not
        consume a ``max_bundles`` slot a real post-mortem needed."""
        if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
            return None
        verdict = {"kind": f"exception.{where}",
                   "exception": f"{type(exc).__name__}: {exc}"}
        return self._trigger(verdict, None)

    def step_window(self) -> List[float]:
        det = self.detectors.get("step_time")
        ring = getattr(det, "_ring", None)
        if ring is None:
            return []
        lock = getattr(det, "_obs_lock", None)
        if lock is None:
            return list(ring)
        with lock:
            return list(ring)

    # ----------------------------------------------------------- recording
    def _trigger(self, verdict: dict, detector: Optional[Detector]) -> Optional[str]:
        kind = verdict["kind"]
        reg = self._get_registry()
        reg.counter(
            "anomaly.triggered",
            "anomaly detector verdicts, by kind (the scrape-side alarm "
            "line: nonzero deltas mean the flight recorder fired)"
        ).inc(kind=kind)
        now = time.perf_counter()
        with self._lock:
            last = self._last_dump.get(kind)
            if last is not None and now - last < self._cooldown():
                reg.counter(
                    "anomaly.suppressed",
                    "triggers deduped inside the per-kind dump cooldown"
                ).inc(kind=kind)
                return None
            # provisional stamp: concurrent same-kind triggers must not
            # both dump while the first write is still in flight
            self._last_dump[kind] = now
        path = self._dump(kind, verdict, detector)
        if path is None and not self.dump_dir:
            # nothing was even attempted (dir unset): do not burn the
            # cooldown window — the operator who arms the dump dir next
            # must get the very next bundle. A FAILED write keeps the
            # stamp: under persistent failure (ENOSPC, lost perms) the
            # expensive bundle build must not repeat on every trigger on
            # the serving scheduler / train thread
            with self._lock:
                if self._last_dump.get(kind) == now:
                    del self._last_dump[kind]
        return path

    def _dump(self, kind: str, verdict: dict,
              detector: Optional[Detector]) -> Optional[str]:
        out_dir = self.dump_dir
        if not out_dir:
            # counted-not-dumped mode leaves the dump cooldown unburned
            # (see _trigger), so rate-limit this log on its own stamp: a
            # sustained SLO storm must not flood the log from the serving
            # scheduler thread — anomaly.triggered already carries the rate
            now = time.perf_counter()
            with self._lock:
                last = self._last_note.get(kind)
                quiet = last is not None and now - last < self._cooldown()
                if not quiet:
                    self._last_note[kind] = now
            if not quiet:
                _log.info(
                    "anomaly %s triggered (no FLAGS_telemetry_dump_dir: "
                    "counted, not dumped): %s", kind, verdict)
            return None
        reg = self._get_registry()
        tracer = self._get_tracer()
        bundle = {
            "ts_unix": time.time(),
            "kind": kind,
            "verdict": verdict,
            "detector": getattr(detector, "name", None),
            "step_window_s": self.step_window(),
            "spans": tracer.tail_chrome_events(self.span_tail),
            "metrics": reg.snapshot(),
        }
        try:
            from .export import process_metadata

            bundle["process"] = process_metadata()
        except Exception:
            pass
        with self._lock:
            self._seq += 1
            seq = self._seq
        safe_kind = "".join(c if c.isalnum() or c in "._-" else "_"
                            for c in kind)
        path = os.path.join(
            out_dir, f"anomaly_{safe_kind}_{self._run_id}_{seq:04d}.json")
        try:
            os.makedirs(out_dir, exist_ok=True)
            with open(path, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
            self._prune(out_dir)
        except Exception as e:
            _log.warning("anomaly bundle write failed: %s", e)
            return None
        with self._lock:
            self.bundles.append(path)
        reg.counter("anomaly.bundles",
                    "forensic bundles written by the flight recorder").inc()
        _log.warning(
            "anomaly flight recorder: %s -> %s (%d spans, %d-step window)",
            kind, path, len(bundle["spans"]), len(bundle["step_window_s"]))
        return path

    def _prune(self, out_dir: str) -> None:
        """Bound the dump directory: keep the newest
        ``max_bundles`` bundles, delete the oldest beyond that."""
        if self.max_bundles <= 0:
            return
        try:
            paths = [os.path.join(out_dir, n) for n in os.listdir(out_dir)
                     if n.startswith("anomaly_") and n.endswith(".json")]
            # oldest first by mtime (the kind is in the name, so a lexical
            # sort would interleave kinds, not ages)
            names = [os.path.basename(p) for p in
                     sorted(paths, key=lambda p: (os.path.getmtime(p), p))]
        except OSError:
            return
        for stale in names[:-self.max_bundles]:
            try:
                os.remove(os.path.join(out_dir, stale))
            except OSError:
                pass


monitor = AnomalyMonitor()
