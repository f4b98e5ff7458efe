"""Named locks and the runtime lock-order witness (port of
``paddle_tpu/observability/locks.py``).

- :func:`named_lock` / :func:`named_condition` build drop-in
  ``threading.Lock``/``Condition`` replacements carrying a stable *name*
  (the lock *class*: every ``KVPagePool``'s lock shares
  ``"serving.kv_pool"``), so the witness sees every lock of the port.
- With ``FLAGS_concurrency_witness`` on, every acquire records into a
  process-wide lock-order graph keyed by name: per-thread held stacks,
  per-name acquire/contended counters, hold times, and edges ``held ->
  acquired``. A new edge that closes a cycle is a lock-order inversion,
  recorded as a witness violation and handed to the anomaly flight
  recorder (``observability/anomaly.py``, one bundle per cooldown); a hold
  longer than ``FLAGS_concurrency_max_hold_ms`` (when > 0) is a hold
  violation.
- Off (the default), every acquire pays one module-global bool read and
  goes straight to the wrapped primitive.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List

from ..base.flags import get_flag

__all__ = ["NamedCondition", "NamedLock", "named_condition", "named_lock",
           "registered_locks", "set_witness", "witness_enabled",
           "witness_report", "witness_reset"]

# the ONE bool every instrumented acquire reads when the witness is dark
_enabled = False
# bumped on every witness toggle/reset: per-thread held stacks carry the
# epoch of their acquire, so entries recorded before a toggle can never
# feed false edges after it (a thread's stack is only visible to itself
# and gets filtered lazily on its next recorded acquire/release)
_epoch = 0
# this module IS the lock registry, so its own guard must stay a bare
# primitive: a NamedLock here would recurse into its own bookkeeping
_WLOCK = threading.Lock()
_tls = threading.local()

_names: Dict[str, int] = {}       # lock name -> constructions
_acquires: Dict[str, int] = {}    # name -> lit-mode acquires
_contended: Dict[str, int] = {}   # name -> lit-mode contended acquires
_hold_ms: Dict[str, float] = {}   # name -> lit-mode total hold milliseconds
_edges: Dict[str, set] = {}       # name -> names acquired while holding it
_violations: List[dict] = []      # inversion/hold verdicts, bounded
_MAX_VIOLATIONS = 256


def _max_hold_ms() -> float:
    return float(get_flag("concurrency_max_hold_ms"))


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    elif stack and stack[0][2] != _epoch:
        stack[:] = [e for e in stack if e[2] == _epoch]
    return stack


def _reaches(src: str, dst: str) -> bool:
    """Is ``dst`` reachable from ``src`` over the order graph? (caller
    holds ``_WLOCK``; runs only when an acquire adds a NEW edge, so the
    DFS cost amortizes to ~zero on steady-state lit traffic)."""
    seen = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(_edges.get(node, ()))
    return False


def _notify_inversion(verdict: dict) -> None:
    """Feed the flight recorder outside ``_WLOCK``. The monitor's own
    locks are named too, so its recording re-enters the witness: the
    per-thread ``busy`` latch keeps that recursion out of the verdict path
    (the re-entrant acquires still count, they cannot trigger a nested
    notification)."""
    if getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        from .anomaly import monitor

        monitor.on_lock_inversion(verdict)
    finally:
        _tls.busy = False


def _record_acquire(name: str, contended: bool) -> None:
    stack = _stack()
    now = time.perf_counter()
    verdict = None
    with _WLOCK:
        _acquires[name] = _acquires.get(name, 0) + 1
        if contended:
            _contended[name] = _contended.get(name, 0) + 1
        if stack:
            holder = stack[-1][0]
            # same-name nesting is the same lock CLASS (two metric
            # instruments, two breakers), not an order between classes
            if holder != name:
                succ = _edges.setdefault(holder, set())
                if name not in succ:
                    succ.add(name)
                    if _reaches(name, holder):
                        verdict = {
                            "code": "CX1004", "kind": "lock_inversion",
                            "edge": [holder, name],
                            "held_stack": [e[0] for e in stack] + [name],
                            "thread": threading.current_thread().name}
                        if len(_violations) < _MAX_VIOLATIONS:
                            _violations.append(verdict)
    stack.append([name, now, _epoch])
    if verdict is not None:
        _notify_inversion(verdict)


def _record_release(name: str) -> None:
    stack = _stack()
    t0 = None
    for i in range(len(stack) - 1, -1, -1):
        if stack[i][0] == name:
            t0 = stack[i][1]
            del stack[i]
            break
    if t0 is None:
        return  # acquired dark (or pre-toggle), released lit: no sample
    dt_ms = (time.perf_counter() - t0) * 1e3
    limit = _max_hold_ms()
    with _WLOCK:
        _hold_ms[name] = _hold_ms.get(name, 0.0) + dt_ms
        if 0 < limit < dt_ms and len(_violations) < _MAX_VIOLATIONS:
            _violations.append({
                "code": "CX1005", "kind": "lock_hold", "name": name,
                "held_ms": round(dt_ms, 3), "limit_ms": limit,
                "thread": threading.current_thread().name})


class NamedLock:
    """Registered ``threading.Lock`` wrapper. Dark: one bool read per
    acquire/release on top of the primitive. Lit: held-stack + order-
    graph recording (see module docstring)."""

    __slots__ = ("name", "_inner")

    def __init__(self, name: str):
        if not name or not isinstance(name, str):
            raise ValueError("named_lock needs a non-empty string name")
        self.name = name
        self._inner = threading.Lock()
        with _WLOCK:
            _names[name] = _names.get(name, 0) + 1

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._inner.acquire(blocking, timeout)
        contended = False
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                # a failed probe (Condition._is_owned) is not contention
                return False
            contended = True
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
        _record_acquire(self.name, contended)
        return True

    def release(self) -> None:
        if _enabled:
            _record_release(self.name)  # hold time measured while held
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> bool:
        self.release()
        return False

    def _at_fork_reinit(self) -> None:
        self._inner = threading.Lock()

    def __repr__(self) -> str:
        state = "locked" if self._inner.locked() else "unlocked"
        return f"<NamedLock {self.name!r} {state}>"


class NamedCondition(threading.Condition):
    """``threading.Condition`` over a :class:`NamedLock`. ``wait()``
    routes through the named lock's release/acquire, so the witness sees
    a wait as release (hold-time sample) + fresh re-acquire — the
    correct order semantics for condition sleeps."""

    def __init__(self, name: str):
        super().__init__(NamedLock(name))
        self.name = name


def named_lock(name: str) -> NamedLock:
    """A registered lock. ``name`` is the lock *class* (stable dotted
    id, e.g. ``"serving.kv_pool"``) — instances of the same subsystem
    role share it."""
    return NamedLock(name)


def named_condition(name: str) -> NamedCondition:
    """A registered condition variable (see :func:`named_lock`)."""
    return NamedCondition(name)


# ------------------------------------------------------------ witness API
def witness_enabled() -> bool:
    return _enabled


def set_witness(enabled: bool) -> bool:
    """Arm/disarm the witness; returns the previous state. Mirrored from
    ``FLAGS_concurrency_witness`` by the package flag hook."""
    global _enabled, _epoch
    with _WLOCK:
        was = _enabled
        _enabled = bool(enabled)
        _epoch += 1
    return was


def witness_reset() -> None:
    """Drop accumulated witness state (counters, order graph,
    violations). Lock registration counts survive — construction is a
    process fact, not a measurement window."""
    global _epoch
    with _WLOCK:
        _epoch += 1
        _acquires.clear()
        _contended.clear()
        _hold_ms.clear()
        _edges.clear()
        del _violations[:]


def registered_locks() -> Dict[str, int]:
    """name -> construction count for every named lock/condition ever
    built in this process (the migration-smoke surface)."""
    with _WLOCK:
        return dict(_names)


def witness_report() -> dict:
    """The full witness state: per-name counters, the order graph, and
    the recorded inversion and hold violations."""
    with _WLOCK:
        return {
            "enabled": _enabled,
            "acquires": dict(_acquires),
            "contended": dict(_contended),
            "hold_ms": {k: round(v, 3) for k, v in _hold_ms.items()},
            "edges": {k: sorted(v) for k, v in _edges.items()},
            "violations": [dict(v) for v in _violations],
            "locks": dict(_names),
        }


# armed from the env/flag default at import; the flag hook in
# observability/__init__ keeps runtime set_flags() in sync
_enabled = bool(get_flag("concurrency_witness"))
