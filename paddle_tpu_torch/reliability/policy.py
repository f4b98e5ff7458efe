"""Retry policy and circuit breakers (port of
``paddle_tpu/reliability/policy.py``): bounded recovery, visible give-up.

:class:`RetryPolicy` is the bounded retry loop around the decode tier's
program call:

- **bounded attempts** (``max_attempts``) with **exponential backoff**
  (``base_delay_s * 2^attempt``, capped at ``max_delay_s``),
  deterministic, no jitter, so fault schedules replay exactly;
- a **deadline budget** (``deadline_s``, wall clock across all attempts),
  required;
- a **transient-vs-fatal classifier**: transport and injected faults
  (OSError, TimeoutError, ConnectionError, a transient
  :class:`~.faults.FaultInjection`) retry; logic errors and interpreter
  exits propagate on the first attempt.

Per-site counters: ``fault.retry{site}``, ``fault.giveup{site,reason}``,
``fault.recovered{site}``.

:class:`CircuitBreaker` / :class:`BreakerBoard` sit above retry: after
``failure_threshold`` consecutive failures a key (a tenant) flips
**open**: its health reads ``degraded`` (``/healthz`` lists it) and the
serving admission controller sheds its load at the door (reason
``"circuit"``). After ``cooldown_s`` the breaker half-opens and probe
traffic decides: success closes it, failure re-opens it.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from ..base.flags import get_flag
from ..observability.locks import named_lock
from ..observability.metrics import registry
from .faults import FaultInjection

__all__ = ["BreakerBoard", "CircuitBreaker", "RetryPolicy",
           "default_classify"]


def default_classify(exc: BaseException) -> bool:
    """True = transient (retry), False = fatal (propagate now). Unknown
    exception types are FATAL: a logic bug replayed N times is N times
    the damage, not N chances."""
    if isinstance(exc, FaultInjection):
        return exc.transient
    if isinstance(exc, (KeyboardInterrupt, SystemExit, GeneratorExit)):
        return False
    if isinstance(exc, (MemoryError, RecursionError)):
        return False
    if isinstance(exc, (ConnectionError, TimeoutError, OSError)):
        return True
    return False


def _tick(name: str, help_text: str, **labels) -> None:
    registry.counter(name, help_text).inc(**labels)


class RetryPolicy:
    """Bounded-attempt, deadline-budgeted retry for one named site.

    ``run(fn, *args, **kwargs)`` is the whole API. The wrapped call must
    be IDEMPOTENT up to its own side effects on success — the policy
    replays the entire callable.
    """

    def __init__(self, site: str, *, max_attempts: Optional[int] = None,
                 base_delay_s: Optional[float] = None,
                 max_delay_s: float = 1.0,
                 deadline_s: Optional[float] = None,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 breaker: Optional["CircuitBreaker"] = None):
        self.site = site
        self.max_attempts = int(get_flag("retry_max_attempts")
                                if max_attempts is None else max_attempts)
        self.base_delay_s = float(
            get_flag("retry_base_delay_ms") / 1e3
            if base_delay_s is None else base_delay_s)
        self.max_delay_s = float(max_delay_s)
        # the deadline is not optional: a retry loop without a wall-clock
        # budget is an unbounded stall on the calling thread
        self.deadline_s = float(get_flag("retry_deadline_s")
                                if deadline_s is None else deadline_s)
        if self.deadline_s <= 0:
            raise ValueError(
                f"RetryPolicy({site!r}) needs a positive deadline_s "
                "(a retry without a deadline budget)")
        self.classify = classify or default_classify
        self.breaker = breaker

    def _delay(self, attempt: int, remaining: float) -> float:
        return max(0.0, min(self.base_delay_s * (2 ** (attempt - 1)),
                            self.max_delay_s, remaining))

    def run(self, fn: Callable, *args, **kwargs):
        """Call ``fn`` with bounded retries; the terminal failure (fatal,
        attempts exhausted, or deadline blown) re-raises the last
        exception after ticking ``fault.giveup``."""
        t0 = time.monotonic()
        attempt = 0
        while True:
            try:
                out = fn(*args, **kwargs)
            except BaseException as e:  # noqa: BLE001 — classified below
                attempt += 1
                transient = False
                try:
                    transient = bool(self.classify(e))
                except Exception:
                    transient = False
                remaining = self.deadline_s - (time.monotonic() - t0)
                if not transient:
                    reason = "fatal"
                elif attempt >= self.max_attempts:
                    reason = "attempts"
                elif remaining <= 0:
                    reason = "deadline"
                else:
                    reason = None
                if reason is not None:
                    _tick("fault.giveup",
                          "retry loops that exhausted their budget (or hit "
                          "a fatal error) and re-raised, by site and reason",
                          site=self.site, reason=reason)
                    if self.breaker is not None:
                        self.breaker.on_failure()
                    raise
                _tick("fault.retry",
                      "transient failures absorbed by a RetryPolicy "
                      "(attempt replayed after backoff), by site",
                      site=self.site)
                delay = self._delay(attempt, remaining)
                if delay > 0:
                    time.sleep(delay)
                continue
            if self.breaker is not None:
                self.breaker.on_success()
            if attempt:
                _tick("fault.recovered",
                      "calls that succeeded after at least one retry "
                      "(the proof recovery happened), by site",
                      site=self.site)
            return out


class CircuitBreaker:
    """closed → (``failure_threshold`` consecutive failures) → open →
    (``cooldown_s``) → half_open → closed on success / open on failure.

    Thread-safe; failures are counted CONSECUTIVELY — one success resets
    the streak, so a 1%-flaky path never opens a breaker sized for a
    hard-down one."""

    def __init__(self, key: str, *, failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        self.key = key
        self.failure_threshold = int(
            get_flag("circuit_failure_threshold")
            if failure_threshold is None else failure_threshold)
        self.cooldown_s = float(get_flag("circuit_cooldown_s")
                                if cooldown_s is None else cooldown_s)
        self.state = "closed"            # closed | open | half_open
        self._failures = 0
        self._opened_at = 0.0
        self._lock = named_lock("reliability.breaker")

    def on_success(self) -> None:
        with self._lock:
            self._failures = 0
            if self.state != "closed":
                self.state = "closed"

    def on_failure(self) -> None:
        with self._lock:
            self._failures += 1
            if self.state == "half_open" or (
                    self.state == "closed"
                    and self._failures >= self.failure_threshold):
                if self.state != "open":
                    self.state = "open"
                    _tick("fault.circuit_open",
                          "circuit breakers flipped open (key sheds load "
                          "until the cooldown's probe succeeds)",
                          key=self.key)
                self._opened_at = time.monotonic()

    def allow(self) -> bool:
        """May a call proceed? Open breakers deny until the cooldown
        elapses, then half-open and let probe traffic decide."""
        with self._lock:
            if self.state == "closed":
                return True
            if self.state == "open":
                if time.monotonic() - self._opened_at >= self.cooldown_s:
                    self.state = "half_open"
                    return True
                return False
            return True  # half_open: probes flow; on_success/failure decide

    @property
    def health(self) -> str:
        return "ok" if self.state == "closed" else "degraded"


class BreakerBoard:
    """Keyed registry of breakers (one per tenant / program). The
    serving engine owns one; admission consults :meth:`is_open`, the
    health endpoint reads :meth:`health` / :meth:`open_keys`."""

    def __init__(self, *, failure_threshold: Optional[int] = None,
                 cooldown_s: Optional[float] = None):
        self._failure_threshold = failure_threshold
        self._cooldown_s = cooldown_s
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lock = named_lock("reliability.breaker_board")

    def breaker(self, key: str) -> CircuitBreaker:
        with self._lock:
            b = self._breakers.get(key)
            if b is None:
                b = self._breakers[key] = CircuitBreaker(
                    key, failure_threshold=self._failure_threshold,
                    cooldown_s=self._cooldown_s)
            return b

    def record_success(self, key: str) -> None:
        self.breaker(key).on_success()

    def record_failure(self, key: str) -> None:
        self.breaker(key).on_failure()

    def is_open(self, key: str) -> bool:
        """True while the key's breaker denies traffic (open, cooling).
        Keys never seen have no breaker and are never open."""
        with self._lock:
            b = self._breakers.get(key)
        return b is not None and not b.allow()

    def open_keys(self) -> List[str]:
        with self._lock:
            items = list(self._breakers.items())
        return sorted(k for k, b in items if b.state != "closed")

    def health(self) -> str:
        return "degraded" if self.open_keys() else "ok"

    def states(self) -> Dict[str, str]:
        with self._lock:
            return {k: b.state for k, b in sorted(self._breakers.items())}
