"""Communication watchdog (port of
``paddle_tpu/distributed/utils/watchdog.py``; reference
``paddle/phi/core/distributed/comm_task_manager.cc``): timeout detection
for hung collectives.

A collective on the card completes when its stream reaches an event
recorded after it: each watched launch records one on the current stream,
and a waiter thread synchronizes it and marks the task done, while a
monitor thread flags tasks past the deadline, logs the op's tag, ticks the
``comm.watchdog_timeout`` counter, hands the flight recorder a forensic
bundle and calls an optional handler. A collective on host tensors (gloo
on the CPU) has completed when its call returns, so its task is done at
once. Nothing is watched while a CUDA stream captures: a graph's
collectives run at its replays, which no event recorded now would see.

Enable with :func:`enable_comm_watchdog`; the functional collectives of
``distributed.communication`` register their outputs through
:func:`maybe_watch`. The ``comm.watchdog`` fault site simulates a hung
collective: the task is backdated past the deadline and never completes,
so the monitor's real timeout path runs.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from ...base.log import get_logger
from ...observability.locks import named_lock

__all__ = ["CommTaskManager", "disable_comm_watchdog",
           "enable_comm_watchdog", "maybe_watch"]


@dataclass
class _Task:
    tag: str
    start: float
    done: bool = False
    seq: int = 0


def _leaves(values) -> List[torch.Tensor]:
    if isinstance(values, torch.Tensor):
        return [values]
    if isinstance(values, (list, tuple)):
        return [t for v in values for t in _leaves(v)]
    if isinstance(values, dict):
        return [t for v in values.values() for t in _leaves(v)]
    return []


class CommTaskManager:
    def __init__(self, timeout: float = 30.0,
                 on_timeout: Optional[Callable[[str, float], None]] = None,
                 poll_interval: float = 0.5):
        self.timeout = timeout
        self.on_timeout = on_timeout
        self.poll_interval = poll_interval
        self._tasks: List[_Task] = []
        self._lock = named_lock("distributed.watchdog")
        self._stop = threading.Event()
        self._seq = 0
        self.timeouts: List[str] = []  # tags that exceeded the deadline
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True)
        self._monitor.start()

    def watch(self, tag: str, values) -> None:
        """Track the tensors of one collective launch."""
        leaves = _leaves(values)
        if not leaves:
            return
        cuda = [t for t in leaves if t.is_cuda]
        if cuda and torch.cuda.is_current_stream_capturing():
            return
        with self._lock:
            self._seq += 1
            task = _Task(tag=tag, start=time.time(), seq=self._seq)
            self._tasks.append(task)
        from ...reliability.faults import FaultInjection, fault_point

        try:
            fault_point("comm.watchdog")
        except FaultInjection:
            # a hung collective: backdated past the deadline and never done
            task.start = time.time() - self.timeout - 1.0
            return
        if not cuda:
            task.done = True
            return
        events = {}
        for t in cuda:
            if t.device not in events:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(t.device))
                events[t.device] = event

        def waiter():
            try:
                for event in events.values():
                    event.synchronize()
            except Exception as e:  # noqa: BLE001 — logged, task ends
                get_logger().error("collective %s failed: %s", tag, e)
            finally:
                task.done = True

        threading.Thread(target=waiter, daemon=True).start()

    def _monitor_loop(self):
        while not self._stop.wait(self.poll_interval):
            now = time.time()
            with self._lock:
                pending = [t for t in self._tasks if not t.done]
                self._tasks = pending
                overdue = [t for t in pending if now - t.start > self.timeout]
            for t in overdue:
                age = now - t.start
                get_logger().error(
                    "comm watchdog: collective '%s' (seq %d) not complete "
                    "after %.1fs", t.tag, t.seq, age)
                self.timeouts.append(t.tag)
                try:
                    from ...observability.anomaly import monitor
                    from ...observability.metrics import registry

                    registry.counter(
                        "comm.watchdog_timeout",
                        "collectives the comm watchdog flagged as hung "
                        "(exceeded the task deadline)").inc(tag=t.tag)
                    if monitor.enabled:
                        monitor.on_exception("comm.watchdog", TimeoutError(
                            f"collective '{t.tag}' (seq {t.seq}) not "
                            f"complete after {age:.1f}s (deadline "
                            f"{self.timeout}s)"))
                except Exception:  # noqa: BLE001 — the report must not die
                    pass
                if self.on_timeout is not None:
                    self.on_timeout(t.tag, age)
                t.done = True  # report once

    def shutdown(self):
        self._stop.set()
        self._monitor.join(timeout=5)


_manager: Optional[CommTaskManager] = None


def enable_comm_watchdog(timeout: float = 30.0,
                         on_timeout=None) -> CommTaskManager:
    global _manager
    if _manager is not None:
        _manager.shutdown()
    _manager = CommTaskManager(timeout=timeout, on_timeout=on_timeout)
    return _manager


def disable_comm_watchdog():
    global _manager
    if _manager is not None:
        _manager.shutdown()
        _manager = None


def maybe_watch(tag: str, out) -> None:
    """Called by the functional collectives after each launch."""
    if _manager is None:
        return
    _manager.watch(tag, out)
