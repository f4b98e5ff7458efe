"""Deterministic, seedable fault injection with named sites (port of
``paddle_tpu/reliability/faults.py``).

Every recovery path of the decode tier (the scheduler's fault wall, the
retry around a program call, the page-allocation shed, the checkpoint
writer's atomic commit) claims to survive a failure; a
:class:`FaultInjector` proves it under a repeatable schedule.

One injector = one seeded schedule. Each **site** (a named point in the
runtime, :data:`SITES`) rolls its own RNG stream,
``random.Random(f"{seed}/{site}")`` exactly as the JAX package does, so
the same seed and plan fire at the same visits in both packages, and
arming a second site never shifts the first one's pattern.

Kinds:

=========  ============================================================
raise      raise :class:`FaultInjection` (transient by default — the
           :class:`~.policy.RetryPolicy` classifier retries it)
latency    sleep ``delay_s`` at the site (a slow disk / stalled link)
corrupt    return ``"corrupt"`` to the caller, which flips bytes in its
           payload (:func:`corrupt_bytes`) — exercises checksum paths
=========  ============================================================

Configuration: ``FLAGS_fault_inject="site:rate:kind[:delay_ms][,...]"``
(seed from ``FLAGS_fault_seed``), or programmatic ``arm(FaultInjector
(seed=0).plan("serving.decode_step", rate=0.3))``. Every injection ticks
``fault.injected{site,kind}`` in ``observability``.

Off (the default), every :func:`fault_point` is one module-global read
(``_active is None``): no flag parse, no RNG, no lock.
"""
from __future__ import annotations

import random
import time
from typing import Dict, List, Optional

from ..base.flags import get_flag, on_flag_change
from ..observability.locks import named_lock
from ..observability.metrics import registry

__all__ = ["FaultInjection", "FaultInjector", "FaultPlan", "SITES",
           "active", "arm", "corrupt_bytes", "disarm", "fault_point"]

#: The port's injection sites and what cleans up after a fault there.
SITES: Dict[str, str] = {
    "serving.decode_step": (
        "decode fault wall: the step's lanes fail, their KV slots or pages "
        "release, pending prefills survive; a transient fault is retried "
        "first (the call is a pure function of its arguments and the pool "
        "rows its lanes own)"),
    "kv.commit": (
        "the pool refuses the step's writes: the decode fault wall fails "
        "the step's lanes and releases their slots or pages, whose rows no "
        "other lane reads"),
    "kv.page_alloc": (
        "KVPagePool.alloc raises before touching the free list; the paged "
        "scheduler sheds exactly the one request that wanted the pages "
        "(AdmissionError reason='kv_pages', pages it already held "
        "release) and every other lane keeps decoding"),
    "ckpt.write": (
        "atomic tmp+rename commit: a crash leaves the previous checkpoint "
        "intact and an ignorable tmp dir"),
}


class FaultInjection(RuntimeError):
    """An injected fault. ``transient=True`` (the default) classifies as
    retryable by :class:`~.policy.RetryPolicy`; ``site`` names where it
    fired."""

    def __init__(self, site: str, message: Optional[str] = None,
                 transient: bool = True):
        super().__init__(message or f"injected fault at site '{site}'")
        self.site = site
        self.transient = transient


class FaultPlan:
    """One site's schedule: fire with probability ``rate`` per visit,
    ``kind`` in {raise, latency, corrupt}, at most ``max_fires`` times
    (None = unbounded)."""

    __slots__ = ("site", "rate", "kind", "delay_s", "max_fires", "fires",
                 "transient")

    def __init__(self, site: str, rate: float = 1.0, kind: str = "raise",
                 delay_s: float = 0.05, max_fires: Optional[int] = None,
                 transient: bool = True):
        if kind not in ("raise", "latency", "corrupt"):
            raise ValueError(f"unknown fault kind {kind!r} "
                             "(raise|latency|corrupt)")
        self.site = site
        self.rate = float(rate)
        self.kind = kind
        self.delay_s = float(delay_s)
        self.max_fires = max_fires
        self.fires = 0
        self.transient = bool(transient)


class FaultInjector:
    """Deterministic per-site fault scheduler. Thread-safe: sites fire
    from scheduler/prefetch/train threads concurrently; each site's RNG
    stream advances under one lock so the (seed, visit-order-per-site)
    → firing-pattern mapping is exact."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self.plans: Dict[str, List[FaultPlan]] = {}
        self.injected: List[tuple] = []      # (site, kind) log, in order
        self.seen_sites: set = set()         # every site that consulted us
        self._rngs: Dict[str, random.Random] = {}
        self._lock = named_lock("reliability.faults")

    # ------------------------------------------------------------ config
    def plan(self, site: str, rate: float = 1.0, kind: str = "raise",
             delay_s: float = 0.05, max_fires: Optional[int] = None,
             transient: bool = True) -> "FaultInjector":
        self.plans.setdefault(site, []).append(
            FaultPlan(site, rate, kind, delay_s, max_fires, transient))
        return self

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse ``"site:rate:kind[:delay_ms][,site:rate:kind...]"`` —
        the ``FLAGS_fault_inject`` grammar."""
        inj = cls(seed=seed)
        for part in (spec or "").split(","):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 3:
                raise ValueError(
                    f"bad fault spec {part!r} (want site:rate:kind)")
            site, rate, kind = bits[0], float(bits[1]), bits[2]
            delay_s = float(bits[3]) / 1e3 if len(bits) > 3 else 0.05
            inj.plan(site, rate=rate, kind=kind, delay_s=delay_s)
        return inj

    # ------------------------------------------------------------ firing
    def _rng(self, site: str) -> random.Random:
        rng = self._rngs.get(site)
        if rng is None:
            # independent stream per site: arming site B never shifts
            # site A's draw sequence
            rng = self._rngs[site] = random.Random(f"{self.seed}/{site}")
        return rng

    def fire(self, site: str) -> Optional[str]:
        """Roll ``site``'s dice. Returns the kind fired (``"latency"`` /
        ``"corrupt"``) or None; kind ``"raise"`` raises
        :class:`FaultInjection` instead of returning."""
        with self._lock:
            self.seen_sites.add(site)
            plans = self.plans.get(site)
            fired = None
            if plans:
                rng = self._rng(site)
                for plan in plans:
                    if (plan.max_fires is not None
                            and plan.fires >= plan.max_fires):
                        continue
                    if rng.random() >= plan.rate:
                        continue
                    plan.fires += 1
                    fired = plan
                    self.injected.append((site, plan.kind))
                    break
        if fired is None:
            return None
        _tick_injected(site, fired.kind)
        if fired.kind == "latency":
            time.sleep(fired.delay_s)
            return "latency"
        if fired.kind == "corrupt":
            return "corrupt"
        raise FaultInjection(site, transient=fired.transient)

    def summary(self) -> dict:
        with self._lock:
            by_site: Dict[str, int] = {}
            for site, _kind in self.injected:
                by_site[site] = by_site.get(site, 0) + 1
            return {"seed": self.seed, "total_injected": len(self.injected),
                    "by_site": dict(sorted(by_site.items())),
                    "seen_sites": sorted(self.seen_sites)}


def _tick_injected(site: str, kind: str) -> None:
    registry.counter(
        "fault.injected",
        "faults fired by the reliability FaultInjector, by site and kind "
        "(nonzero outside a chaos run means an injector was left armed)"
    ).inc(site=site, kind=kind)


def corrupt_bytes(data: bytes, site: str, seed: int = 0) -> bytes:
    """Deterministically flip a handful of bytes — the payload half of a
    ``corrupt`` injection (the caller decides *which* payload)."""
    if not data:
        return data
    rng = random.Random(f"{seed}/{site}/corrupt")
    out = bytearray(data)
    for _ in range(max(1, len(out) // 4096)):
        i = rng.randrange(len(out))
        out[i] ^= 0xFF
    return bytes(out)


# ------------------------------------------------------------ module state
_active: Optional[FaultInjector] = None


def arm(injector: Optional[FaultInjector] = None, *, spec: Optional[str] = None,
        seed: int = 0) -> FaultInjector:
    """Install ``injector`` (or build one from ``spec``) as the process
    injector. Returns it. Chaos harnesses and tests must :func:`disarm`
    when done."""
    global _active
    if injector is None:
        injector = FaultInjector.from_spec(spec or "", seed=seed)
    _active = injector
    return injector


def disarm() -> Optional[FaultInjector]:
    """Remove the process injector; returns the previous one."""
    global _active
    prev, _active = _active, None
    return prev


def active() -> Optional[FaultInjector]:
    return _active


def fault_point(site: str) -> Optional[str]:
    """The instrumented sites' entry: one global read when dark. Returns
    the fired kind for ``latency``/``corrupt``, raises for ``raise``,
    None when nothing fires."""
    inj = _active
    if inj is None:
        return None
    return inj.fire(site)


def _arm_from_flag(value) -> None:
    """FLAGS_fault_inject hook: a non-empty spec arms, empty disarms."""
    spec = str(value or "").strip()
    if not spec:
        disarm()
        return
    arm(spec=spec, seed=int(get_flag("fault_seed")))


def _install_flag_hook() -> None:
    on_flag_change("fault_inject", _arm_from_flag)
    if str(get_flag("fault_inject") or "").strip():
        # FLAGS_fault_inject in the environment arms at import
        _arm_from_flag(get_flag("fault_inject"))
