"""Thread-safe request queue with per-tenant admission control (port of
``paddle_tpu/serving/request_queue.py``).

Client threads :meth:`RequestQueue.submit` requests; the decode scheduler
thread takes them in (priority tier, FIFO) order
(:meth:`RequestQueue.take_slots`), the batch scheduler thread in FIFO
prefixes sized by the bucket ladder (:meth:`RequestQueue.take_batch`). Admission is decided at
submit: a full queue, an over-quota tenant or a tenant whose circuit
breaker is open is told now, with an :class:`AdmissionError` naming the
gate that refused. Admissions, refusals and expiries tick the
``serving.admitted``, ``serving.refused`` and ``serving.expired``
counters of ``observability.registry``.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..base.flags import get_flag
from ..jit.bucketing import assemble_bucket
from ..observability.locks import named_condition, named_lock
from ..observability.metrics import registry

__all__ = ["AdmissionError", "RejectedError", "Request", "DecodeRequest",
           "AdmissionController", "RequestQueue"]


class AdmissionError(RuntimeError):
    """A submit the admission controller refused: ``reason`` is
    ``"queue"`` (global sample cap), ``"tenant"`` (per-tenant in-flight
    quota), ``"priority"`` (bulk tier refused to protect interactive
    headroom), ``"circuit"`` (the tenant's circuit breaker is open: its
    recent program calls kept failing, so its load is shed at the door
    until the breaker's cooldown probe succeeds), ``"ttl"`` (expired in
    queue) or ``"kv_pages"`` (shed by the scheduler: a KV page
    allocation failed)."""

    def __init__(self, reason: str, message: str):
        super().__init__(message)
        self.reason = reason


class RejectedError(RuntimeError):
    """Raised by :meth:`Request.result` when the queue shut down before the
    request was served."""


_req_ids = itertools.count()


class Request:
    """One request of ``n`` samples. The submitting thread blocks in
    :meth:`result`; the scheduler thread completes it. Resolution is
    first-result-wins: a later completion or failure (a retry or a
    shutdown racing a drain) is dropped and counted in
    ``serving.duplicate_resolution``, which must stay 0."""

    __slots__ = ("id", "tenant", "inputs", "n", "seq", "t_enqueue", "t_admit",
                 "t_dispatch", "t_complete", "_event", "_outputs", "_error")

    def __init__(self, tenant: str, inputs: Sequence[np.ndarray], n: int,
                 seq: Optional[int] = None):
        self.id = next(_req_ids)
        self.tenant = tenant
        self.inputs = inputs
        self.n = int(n)
        self.seq = None if seq is None else int(seq)
        self.t_enqueue = time.perf_counter()
        self.t_admit = None
        self.t_dispatch = None
        self.t_complete = None
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block until served; returns the outputs or raises the error."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.id} not served in {timeout}s")
        if self._error is not None:
            raise self._error
        return self._outputs

    def _resolved_already(self) -> bool:
        if not self._event.is_set():
            return False
        registry.counter(
            "serving.duplicate_resolution",
            "attempts to complete/fail an already-resolved request future "
            "(must stay 0: nonzero means a retry or shutdown path "
            "double-delivered)").inc()
        return True

    def _complete(self, outputs) -> None:
        if self._resolved_already():
            return
        self.t_complete = time.perf_counter()
        self._outputs = outputs
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        if self._resolved_already():
            return
        self.t_complete = time.perf_counter()
        self._error = error
        self._event.set()


class DecodeRequest(Request):
    """One generation request: a token prompt that holds KV state (a slot
    or pages) from admission to retirement. The future resolves to the
    generated token ids (``np.int32``, up to ``max_new_tokens`` or the
    engine's EOS). ``n`` is 1: admission counts requests for the decode
    tier.

    - Sampling: ``temperature == 0`` decodes greedily; a positive one
      samples after the ``top_k``/``top_p`` filters, with the key
      ``[seed, len(generated)]``, so the stream depends on the seed and
      never on the batch.
    - Speculation: ``speculate`` opts the request in; ``spec_live`` drops
      to False when its acceptance (``spec_accepted / spec_proposed``)
      falls under the engine's floor. The stream is the same either way.
    - ``slot`` (slot pools) or ``pages`` (the block table, paged pools)
      name its KV state.
    """

    __slots__ = ("prompt", "max_new_tokens", "generated", "slot", "seq_rung",
                 "pages", "temperature", "top_k", "top_p", "seed",
                 "speculate", "spec_live", "spec_proposed", "spec_accepted")

    def __init__(self, tenant: str, prompt, max_new_tokens: int,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 speculate: bool = False):
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("decode request needs a non-empty prompt")
        super().__init__(tenant, [prompt], 1, seq=int(prompt.size))
        self.prompt = prompt
        self.max_new_tokens = max(int(max_new_tokens), 1)
        self.generated: List[int] = []
        self.slot = None            # KV slot (slot pools, scheduler set)
        self.seq_rung = None        # prefill seq-ladder rung (scheduler set)
        self.pages: List[int] = []  # block table (paged pools)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.seed = int(seed)
        self.speculate = bool(speculate)
        self.spec_live = bool(speculate)
        self.spec_proposed = 0
        self.spec_accepted = 0

    @property
    def position(self) -> int:
        """The next KV write position: prompt rows 0..len-1 land at
        prefill; generated token ``i`` (the input of decode step ``i+1``)
        writes at ``len + i``."""
        return int(self.prompt.size) + max(len(self.generated) - 1, 0)


class AdmissionController:
    """Admission gates, all in samples: a global queued-sample cap, a
    per-tenant in-flight cap, a priority gate — tenants marked ``bulk``
    (:meth:`set_tier`) may fill only ``FLAGS_serving_bulk_queue_share`` of
    the global cap — and, with a ``breaker_board``
    (``reliability.BreakerBoard``), the circuit gate: a tenant whose
    breaker is open is refused here instead of queueing work a broken path
    would fail late. In-flight means admitted and not yet completed. The
    controller also owns the request TTL (``FLAGS_serving_request_ttl_ms``
    / ``request_ttl_ms``)."""

    #: named priority tiers (lower = more urgent); ints also accepted
    TIERS = {"interactive": 0, "bulk": 1}

    def __init__(self, max_queue: Optional[int] = None,
                 tenant_quota: Optional[int] = None,
                 request_ttl_ms: Optional[float] = None,
                 breaker_board=None):
        self.max_queue = int(get_flag("serving_max_queue")
                             if max_queue is None else max_queue)
        self.tenant_quota = int(get_flag("serving_tenant_quota")
                                if tenant_quota is None else tenant_quota)
        self._ttl_ms = request_ttl_ms  # None defers to the flag, live
        self.breaker_board = breaker_board
        self._tiers: Dict[str, int] = {}
        self._queued = 0
        self._inflight: Dict[str, int] = {}
        self._lock = named_lock("serving.admission")

    def set_tier(self, tenant: str, tier) -> None:
        with self._lock:
            self._tiers[tenant] = (self.TIERS[tier] if isinstance(tier, str)
                                   else int(tier))

    def tier_of(self, tenant: str) -> int:
        with self._lock:
            return self._tiers.get(tenant, 0)

    def ttl_s(self) -> float:
        """The live request TTL in seconds (<=0 disables)."""
        ms = self._ttl_ms
        if ms is None:
            ms = float(get_flag("serving_request_ttl_ms"))
        return float(ms) / 1e3

    def try_admit(self, tenant: str, n: int) -> Optional[str]:
        """None = admitted (state charged); else the refusing gate."""
        # consulted outside self._lock: the board has its own lock, and an
        # open breaker's cooldown probe must not serialize admissions
        if (self.breaker_board is not None
                and self.breaker_board.is_open(tenant)):
            return "circuit"
        with self._lock:
            if self.max_queue > 0 and self._queued + n > self.max_queue:
                return "queue"
            if self._tiers.get(tenant, 0) > 0 and self.max_queue > 0:
                cap = int(self.max_queue
                          * float(get_flag("serving_bulk_queue_share")))
                if self._queued + n > cap:
                    return "priority"
            if (self.tenant_quota > 0
                    and self._inflight.get(tenant, 0) + n > self.tenant_quota):
                return "tenant"
            self._queued += n
            self._inflight[tenant] = self._inflight.get(tenant, 0) + n
            return None

    def on_dispatch(self, tenant: str, n: int) -> None:
        with self._lock:
            self._queued -= n

    def on_complete(self, tenant: str, n: int) -> None:
        with self._lock:
            left = self._inflight.get(tenant, 0) - n
            if left > 0:
                self._inflight[tenant] = left
            else:
                self._inflight.pop(tenant, None)

    def inflight(self, tenant: str) -> int:
        with self._lock:
            return self._inflight.get(tenant, 0)

    def queued(self) -> int:
        with self._lock:
            return self._queued


class RequestQueue:
    """FIFO of admitted requests plus the condition the scheduler sleeps
    on. ``close()`` stops new submits; the scheduler keeps taking until
    the queue is drained."""

    def __init__(self, admission: AdmissionController, stats):
        self._dq: deque = deque()
        self._cond = named_condition("serving.queue")
        self.admission = admission
        self.closed = False
        self.stats = stats

    def __len__(self) -> int:
        with self._cond:
            return len(self._dq)

    def depth_samples(self) -> int:
        with self._cond:
            return sum(r.n for r in self._dq)

    def submit(self, request: Request) -> Request:
        """Admit and enqueue, or raise :class:`AdmissionError` /
        ``RuntimeError`` (closed). Stamps ``t_admit`` on success."""
        with self._cond:
            if self.closed:
                raise RuntimeError("serving queue is closed")
            gate = self.admission.try_admit(request.tenant, request.n)
            if gate is None:
                request.t_admit = time.perf_counter()
                self._dq.append(request)
                self._cond.notify()
        if gate is None:
            registry.counter(
                "serving.admitted",
                "requests admitted into the serving queue, by tenant"
            ).inc(tenant=request.tenant)
            return request
        registry.counter(
            "serving.refused",
            "submits refused at admission, by tenant and refusing gate "
            "(queue, tenant, priority, circuit)").inc(
                tenant=request.tenant, reason=gate)
        self.stats.record_rejected(tenant=request.tenant)
        raise AdmissionError(
            gate, f"request of {request.n} samples refused by the '{gate}' "
                  f"gate (tenant={request.tenant!r}: "
                  f"{self.admission.inflight(request.tenant)} in flight, "
                  f"queue={self.admission.queued()} samples)")

    def _expire_locked(self, now: float) -> None:
        """Fail every request whose queue wait exceeded the TTL (caller
        holds the condition). Requests enqueue in arrival order, so the
        overdue set is a prefix of the deque."""
        ttl = self.admission.ttl_s()
        if ttl <= 0:
            return
        while self._dq and (now - self._dq[0].t_enqueue) > ttl:
            r = self._dq.popleft()
            self.admission.on_dispatch(r.tenant, r.n)
            self.admission.on_complete(r.tenant, r.n)
            self.stats.record_expired(tenant=r.tenant)
            registry.counter(
                "serving.expired",
                "requests expired in queue past FLAGS_serving_request_ttl_ms "
                "(failed with AdmissionError reason='ttl', never executed)"
            ).inc(tenant=r.tenant)
            r._fail(AdmissionError(
                "ttl", f"request {r.id} expired after "
                       f"{(now - r.t_enqueue) * 1e3:.1f}ms in queue (> "
                       f"{ttl * 1e3:.1f}ms TTL); dead work is refused"))

    def take_slots(self, max_requests: int,
                   timeout: Optional[float] = None,
                   budget_fn=None) -> List[Request]:
        """Pop up to ``max_requests`` pending requests in (priority tier,
        FIFO) order, expiring TTL-overdue ones first. Returns ``[]`` on
        timeout or when closed and empty; with ``timeout`` 0/None it
        never blocks. ``budget_fn(request) -> bool`` is the page-budget
        gate: taking stops at the first request it refuses, which stays
        queued with nothing behind it jumping ahead."""
        if max_requests <= 0:
            return []
        with self._cond:
            self._expire_locked(time.perf_counter())
            if not self._dq and timeout:
                deadline = time.perf_counter() + timeout
                while not self._dq and not self.closed:
                    rest = deadline - time.perf_counter()
                    if rest <= 0:
                        break
                    self._cond.wait(rest)
                self._expire_locked(time.perf_counter())
            if not self._dq:
                return []
            order = sorted(
                range(len(self._dq)),
                key=lambda i: (self.admission.tier_of(self._dq[i].tenant), i))
            chosen = order[:int(max_requests)]
            if budget_fn is not None:
                fits = 0
                for i in chosen:
                    if not budget_fn(self._dq[i]):
                        break
                    fits += 1
                chosen = chosen[:fits]
            taken = [self._dq[i] for i in chosen]
            chosen_set = set(chosen)
            kept = [r for i, r in enumerate(self._dq) if i not in chosen_set]
            self._dq.clear()
            self._dq.extend(kept)
            for r in taken:
                self.admission.on_dispatch(r.tenant, r.n)
            return taken

    def take_batch(self, buckets, timeout: Optional[float] = None,
                   linger: float = 0.0):
        """The batch scheduler's take: block until requests are pending
        (or ``timeout``), then pop the FIFO prefix
        :func:`~..jit.bucketing.assemble_bucket` selects. Returns
        ``(requests, bucket)``, or ``([], None)`` on timeout or when
        closed and empty.

        ``buckets`` is a ladder or a zero-argument callable returning one,
        resolved after the wait, at assembly time; a batch holds at most
        the top rung's samples. ``linger``: once a request is pending, wait
        up to that long for the rung to fill before dispatching. TTL-overdue
        requests expire first; a head too large for the ladder fails
        alone."""
        deadline = (time.perf_counter() + timeout) if timeout else None

        def ladder_and_cap():
            ladder = list(buckets()) if callable(buckets) else list(buckets)
            return ladder, int(ladder[-1])

        with self._cond:
            self._expire_locked(time.perf_counter())
            while not self._dq:
                if self.closed:
                    return [], None
                rest = (deadline - time.perf_counter()) if deadline else None
                if rest is not None and rest <= 0:
                    return [], None
                self._cond.wait(rest if rest is not None else 0.1)
                self._expire_locked(time.perf_counter())
            ladder, cap = ladder_and_cap()
            if linger > 0 and not self.closed:
                until = time.perf_counter() + linger
                while sum(r.n for r in self._dq) < cap and not self.closed:
                    rest = until - time.perf_counter()
                    if rest <= 0:
                        break
                    self._cond.wait(rest)
                ladder, cap = ladder_and_cap()
                self._expire_locked(time.perf_counter())
                if not self._dq:
                    return [], None
            try:
                k, bucket = assemble_bucket([r.n for r in self._dq], ladder,
                                            cap)
            except ValueError as e:
                bad = self._dq.popleft()
                self.admission.on_dispatch(bad.tenant, bad.n)
                self.admission.on_complete(bad.tenant, bad.n)
                bad._fail(e)
                return [], None
            taken = [self._dq.popleft() for _ in range(k)]
            for r in taken:
                self.admission.on_dispatch(r.tenant, r.n)
            return taken, bucket

    def close(self) -> None:
        with self._cond:
            self.closed = True
            self._cond.notify_all()

    def fail_pending(self, error: BaseException) -> int:
        """Complete every still-queued request with ``error`` (non-drain
        shutdown). Returns how many were failed."""
        with self._cond:
            pending = list(self._dq)
            self._dq.clear()
        for r in pending:
            self.admission.on_dispatch(r.tenant, r.n)
            self.admission.on_complete(r.tenant, r.n)
            r._fail(error)
        return len(pending)
