"""Profiler (port of ``paddle_tpu/profiler/profiler.py``; reference
``python/paddle/profiler/profiler.py:358`` — the CLOSED/READY/RECORD/
RECORD_AND_RETURN state machine driven by a per-step scheduler, host events
through ``RecordEvent``, chrome://tracing export, summaries).

Host events are recorded in-process: ``RecordEvent`` spans, and one span
per op while the profiler records, through the ``op_profiler`` slot of
``core/hooks.py`` (every op the dispatcher runs, by its schema name:
``aten::mm``, ``paddle_tpu_torch::flash_attention_fwd``, ...). With
``ProfilerTarget.GPU`` among the targets, ``torch.profiler`` takes the
place of ``jax.profiler`` for the device timeline: it warms up in a
``READY`` step, records while the profiler does, and ``device_profile``
holds it (``key_averages()``, its
chrome trace). A graph replay is one op on the host and its kernels on the
device.
"""
from __future__ import annotations

import json
import os
import threading
import time
from enum import Enum
from typing import Callable, Iterable, Optional

from ..base.log import get_logger
from ..core import hooks
from ..observability.locks import named_lock

__all__ = ["Profiler", "ProfilerState", "ProfilerTarget", "RecordEvent",
           "SortedKeys", "export_chrome_tracing", "make_scheduler"]


class ProfilerState(Enum):
    CLOSED = 0
    READY = 1
    RECORD = 2
    RECORD_AND_RETURN = 3


class ProfilerTarget(Enum):
    CPU = 0
    GPU = 1
    XPU = 2
    CUSTOM_DEVICE = 3
    TPU = 4


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3


_global_events = []
_global_lock = named_lock("profiler.global")


class RecordEvent:
    """A host event span (reference RecordEvent): a context manager or
    ``begin``/``end``."""

    def __init__(self, name: str, event_type=None):
        self.name = name
        self._t0 = None

    def begin(self):
        self._t0 = time.perf_counter_ns()

    def end(self):
        if self._t0 is None:
            return
        t1 = time.perf_counter_ns()
        with _global_lock:
            _global_events.append(
                {"name": self.name, "ts": self._t0 / 1e3,
                 "dur": (t1 - self._t0) / 1e3,
                 "tid": threading.get_ident() % 100000, "cat": "op"})
        # the same span on the unified timeline (same perf_counter clock)
        from ..observability.tracing import tracer

        if tracer.enabled:
            tracer.emit(self.name, self._t0 / 1e9, (t1 - self._t0) / 1e9,
                        track="host", cat="op")
        self._t0 = None

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.end()


def make_scheduler(*, closed: int, ready: int, record: int, repeat: int = 0,
                   skip_first: int = 0) -> Callable[[int], ProfilerState]:
    """Per-step state schedule (reference make_scheduler)."""
    period = closed + ready + record

    def scheduler(step: int) -> ProfilerState:
        if step < skip_first:
            return ProfilerState.CLOSED
        s = step - skip_first
        if repeat and s >= repeat * period:
            return ProfilerState.CLOSED
        pos = s % period
        if pos < closed:
            return ProfilerState.CLOSED
        if pos < closed + ready:
            return ProfilerState.READY
        if pos == period - 1:
            return ProfilerState.RECORD_AND_RETURN
        return ProfilerState.RECORD

    return scheduler


def _default_scheduler(step: int) -> ProfilerState:
    return ProfilerState.RECORD


def export_chrome_tracing(dir_name: str, worker_name: Optional[str] = None):
    """An ``on_trace_ready`` callback writing the host events as
    chrome://tracing JSON (reference export_chrome_tracing), and the
    device timeline beside it when one was recorded."""

    def handler(prof: "Profiler"):
        os.makedirs(dir_name, exist_ok=True)
        name = worker_name or f"host_{os.getpid()}"
        stamp = int(time.time())
        path = os.path.join(dir_name, f"{name}_time_{stamp}.json")
        events = [{"name": e["name"], "ph": "X", "ts": e["ts"],
                   "dur": e["dur"], "pid": os.getpid(), "tid": e["tid"],
                   "cat": "host"} for e in prof._events]
        with open(path, "w") as f:
            json.dump({"traceEvents": events}, f)
        if prof.device_profile is not None:
            prof.device_profile.export_chrome_trace(os.path.join(
                dir_name, f"{name}_device_time_{stamp}.json"))
        get_logger().info("chrome trace exported to %s", path)
        prof._last_export = path

    return handler


_RECORDING = (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
_DEVICE_TRACE_PAD_S = 0.25


def _settle(torch) -> None:
    """Drain the card, then leave it idle while the device tracer comes
    up."""
    torch.cuda.synchronize()
    time.sleep(_DEVICE_TRACE_PAD_S)


class Profiler:
    def __init__(self, *, targets: Optional[Iterable[ProfilerTarget]] = None,
                 scheduler=None, on_trace_ready=None, record_shapes=False,
                 profile_memory=False, timer_only=False, emit_nvtx=False):
        if scheduler is None:
            self._scheduler = _default_scheduler
        elif callable(scheduler):
            self._scheduler = scheduler
        else:  # (start, end) tuple like the reference
            start, end = scheduler
            self._scheduler = make_scheduler(
                closed=max(start - 1, 0), ready=1 if start > 0 else 0,
                record=end - start, repeat=1)
        self.targets = list(targets or [ProfilerTarget.CPU])
        self.on_trace_ready = on_trace_ready
        self.step_num = 0
        self.current_state = ProfilerState.CLOSED
        self._events = []
        self.device_profile = None
        self._device = None
        self._device_recording = False
        self._last_export = None
        self.timer_only = timer_only
        self.record_shapes = record_shapes
        self.profile_memory = profile_memory
        self._step_times = []
        self._step_t0 = None

    # ------------------------------------------------------------- device
    def _prepare_device_trace(self):
        """A ``READY`` step: the device trace in ``torch.profiler``'s warmup
        cycle, tracing what the step runs and keeping none of it."""
        if ProfilerTarget.GPU in self.targets and self._device is None:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._device = torch.profiler.profile(
                activities=activities, record_shapes=self.record_shapes,
                profile_memory=self.profile_memory,
                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                 repeat=1),
                acc_events=True)
            self._device.__enter__()
            self._device_recording = False

    def _start_device_trace(self):
        """The device trace's record window, the card drained and idle for
        ``_DEVICE_TRACE_PAD_S`` first. Without a ``READY`` step before it,
        the warmup cycle runs one small op on the card instead: started
        at once, the tracer missed the first kernels of its window on an
        H100, and even so warmed it missed some in a long process, which
        a ``READY`` step running the user's own work does not."""
        if ProfilerTarget.GPU not in self.targets or self._device_recording:
            return
        import torch

        cuda = torch.cuda.is_available()
        if self._device is None:
            self._prepare_device_trace()
            if cuda:
                with hooks.suspended():
                    torch.ones(1, device="cuda").add_(1)
        if cuda:
            _settle(torch)
        self._device.step()
        self._device_recording = True

    def _stop_device_trace(self):
        """Stop the device trace once the card has run all it was given,
        idle for ``_DEVICE_TRACE_PAD_S``; a trace that never recorded is
        dropped."""
        if self._device is not None:
            import torch

            device, self._device = self._device, None
            if torch.cuda.is_available():
                _settle(torch)
            device.__exit__(None, None, None)
            if self._device_recording:
                self.device_profile = device
            self._device_recording = False

    # -------------------------------------------------------------- state
    def _sync_op_hook(self):
        """Per-op host events through the interception mode while
        recording."""
        recording = self.current_state in _RECORDING
        hooks.op_profiler = (RecordEvent if recording and not self.timer_only
                             else None)

    def start(self):
        with _global_lock:
            _global_events.clear()
        self.current_state = self._scheduler(self.step_num)
        self._sync_device_trace()
        self._sync_op_hook()
        self._step_t0 = time.perf_counter()

    def stop(self):
        self._collect()
        self._stop_device_trace()
        if self.on_trace_ready is not None and self._events:
            self.on_trace_ready(self)
        self.current_state = ProfilerState.CLOSED
        self._sync_op_hook()

    def step(self, num_samples: Optional[int] = None):
        now = time.perf_counter()
        if self._step_t0 is not None:
            self._step_times.append(now - self._step_t0)
        self._step_t0 = now
        prev = self.current_state
        self.step_num += 1
        self.current_state = self._scheduler(self.step_num)
        if prev == ProfilerState.RECORD_AND_RETURN or (
                prev == ProfilerState.RECORD
                and self.current_state == ProfilerState.CLOSED):
            self._collect()
            self._stop_device_trace()
            if self.on_trace_ready is not None:
                self.on_trace_ready(self)
        self._sync_device_trace()
        self._sync_op_hook()

    def _sync_device_trace(self):
        """The device trace in the state's phase: prepared when ``READY``,
        recording when recording, dropped when ``CLOSED``."""
        if self.current_state == ProfilerState.READY:
            self._prepare_device_trace()
        elif self.current_state in _RECORDING:
            self._start_device_trace()
        else:
            self._stop_device_trace()

    def _collect(self):
        with _global_lock:
            self._events = list(_global_events)
            _global_events.clear()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------ summary
    def summary(self, sorted_by=SortedKeys.CPUTotal, op_detail=True,
                thread_sep=False, time_unit="ms"):
        """Host events aggregated by name (reference profiler_statistic):
        printed, and returned as ``{name: {calls, total, max, min}}`` in
        microseconds."""
        agg = {}
        for e in self._events:
            st = agg.setdefault(e["name"], {"calls": 0, "total": 0.0,
                                            "max": 0.0, "min": float("inf")})
            st["calls"] += 1
            st["total"] += e["dur"]
            st["max"] = max(st["max"], e["dur"])
            st["min"] = min(st["min"], e["dur"])
        unit = {"ms": 1e3, "us": 1.0, "s": 1e6}[time_unit]
        rows = sorted(agg.items(), key=lambda kv: -kv[1]["total"])
        lines = [f"{'Name':<40}{'Calls':>8}{'Total(' + time_unit + ')':>14}"
                 f"{'Avg':>10}{'Max':>10}{'Min':>10}"]
        for name, st in rows:
            lines.append(
                f"{name[:39]:<40}{st['calls']:>8}{st['total'] / unit:>14.3f}"
                f"{st['total'] / st['calls'] / unit:>10.3f}"
                f"{st['max'] / unit:>10.3f}{st['min'] / unit:>10.3f}")
        print("\n".join(lines))
        return agg

    def benchmark(self):
        """Step-time statistics (reference profiler/timer.py)."""
        if not self._step_times:
            return {}
        import numpy as np

        ts = np.asarray(self._step_times)
        return {"steps": len(ts), "avg_s": float(ts.mean()),
                "p50_s": float(np.percentile(ts, 50)),
                "max_s": float(ts.max())}
