"""The serving tiers' executor loops (port of
``paddle_tpu/serving/scheduler.py``).

**Batch tier.** :class:`Scheduler` drains the queue into bucketed
batches: a FIFO prefix of mixed-size requests (:meth:`RequestQueue.
take_batch`), stacked along the batch axis and padded to the rung
(:func:`stack_requests`), one program call, one device-to-host round
(:func:`fetch_outputs`), and the rows scattered back to their requests
(:func:`scatter_outputs`). Assembly happens again between every pair of
calls, so requests that arrived during a call ride the next one. Each
batch runs under the engine's :class:`~..reliability.RetryPolicy` inside
a ``serving.batch`` span; a batch that still fails fails exactly its own
requests, and each served tenant's circuit breaker is fed a success or a
failure.

**Decode tier.** :class:`DecodeScheduler` and
:class:`PagedDecodeScheduler` run one program call per beat — prefill or
decode, or a speculation round's draft and verify — and between any two
calls requests join (queued → slot or pages allocated) and leave
(finished → KV state released, future resolved).

Each decode program call passes the fault point ``serving.decode_step``
and runs under the engine's :class:`~..reliability.RetryPolicy`
(:meth:`DecodeScheduler._program_call`), then the pool's commit point
(``kv.commit``), inside a ``serving.decode`` span of the
``serving.scheduler`` track. A call that still fails reaches the
batch-scoped fault wall, which fails exactly the lanes that rode it and
feeds each of their tenants' circuit breakers a failure; a call that
succeeds feeds its tenants a success.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..base.flags import get_flag
from ..jit.bucketing import bucket_for
from ..observability.metrics import registry
from ..observability.tracing import tracer
from ..reliability.faults import FaultInjection, fault_point
from .request_queue import AdmissionError, RequestQueue

__all__ = ["Scheduler", "stack_requests", "fetch_outputs",
           "scatter_outputs", "DecodeScheduler", "PagedDecodeScheduler"]


# ------------------------------------------------------------ batch tier
def stack_requests(requests: Sequence, bucket: int,
                   dynamic_axes: Dict[int, int], n_inputs: int,
                   seq_axes: Optional[Dict[int, int]] = None,
                   seq_bucket: Optional[int] = None) -> List[np.ndarray]:
    """Each input concatenated across ``requests`` along its batch axis
    and zero-padded up to ``bucket``; on a two-axis export each request's
    seq axis (``seq_axes``: {input: axis}) is first right-padded to
    ``seq_bucket``. An input without a dynamic axis is per batch: every
    request must carry the same value, bit for bit, or this raises
    (another request's side input would leak across tenants)."""
    stacked = []
    axes = dynamic_axes or {i: 0 for i in range(n_inputs)}
    seq_axes = seq_axes or {}
    for i in range(n_inputs):
        if i not in axes:
            head = np.asarray(requests[0].inputs[i])
            for r in requests[1:]:
                if not np.array_equal(head, np.asarray(r.inputs[i])):
                    raise ValueError(
                        f"static input {i} differs across the assembled "
                        "batch (per-batch side inputs must match bit-wise "
                        "to share one program call)")
            stacked.append(head)
            continue
        ax = axes[i]
        parts = []
        for r in requests:
            a = np.asarray(r.inputs[i])
            sax = seq_axes.get(i)
            if (sax is not None and seq_bucket is not None
                    and a.shape[sax] < seq_bucket):
                widths = [(0, 0)] * a.ndim
                widths[sax] = (0, seq_bucket - a.shape[sax])
                a = np.pad(a, widths)
            parts.append(a)
        cat = parts[0] if len(parts) == 1 else np.concatenate(parts, axis=ax)
        short = bucket - cat.shape[ax]
        if short > 0:
            widths = [(0, 0)] * cat.ndim
            widths[ax] = (0, short)
            cat = np.pad(cat, widths)
        stacked.append(cat)
    return stacked


def fetch_outputs(outputs: Sequence, rows: Optional[int] = None,
                  seq: Optional[int] = None,
                  out_seq_axes: Optional[Dict[int, int]] = None
                  ) -> List[np.ndarray]:
    """The outputs of one batch on the host: one device-to-host round a
    batch, counted in ``serving.d2h_fetches``. ``rows`` (the batch's real
    rows) and ``seq`` (its longest request, on the ``out_seq_axes``) cut
    the pad off on the device first, so the pad never crosses to the
    host."""
    arrays = []
    for idx, t in enumerate(outputs):
        if rows is not None:
            t = t[:rows]
        ax = (out_seq_axes or {}).get(idx)
        if ax is not None and seq is not None:
            t = t.narrow(ax, 0, min(seq, t.shape[ax]))
        arrays.append(t.cpu().numpy())
    registry.counter(
        "serving.d2h_fetches",
        "device-to-host readback rounds of the batch scheduler (one per "
        "assembled batch, not one per output)").inc()
    return arrays


def scatter_outputs(outputs: Sequence[np.ndarray], requests: Sequence,
                    seq_bucket: Optional[int] = None,
                    out_seq_axes: Optional[Dict[int, int]] = None
                    ) -> List[List[np.ndarray]]:
    """Each output's leading axis split back into per-request row blocks
    (the pad rows dropped); on a two-axis export each block's seq pad is
    sliced back to the request's own length on the axes the export marks
    (``out_seq_axes``: {output: axis}), never by shape coincidence. The
    blocks are views of the batch's arrays, not copies."""
    per_request: List[List[np.ndarray]] = [[] for _ in requests]
    offsets, pos = [], 0
    for r in requests:
        offsets.append(pos)
        pos += r.n
    for idx, out in enumerate(outputs):
        arr = np.asarray(out)
        ax = (out_seq_axes or {}).get(idx)
        for j, r in enumerate(requests):
            rows = arr[offsets[j]: offsets[j] + r.n]
            if (ax is not None and seq_bucket is not None
                    and r.seq is not None and r.seq < seq_bucket
                    and rows.shape[ax] == seq_bucket):
                rows = rows[(slice(None),) * ax + (slice(0, r.seq),)]
            per_request[j].append(rows)
    return per_request


class Scheduler:
    """The batch tier's executor thread: drains the queue into bucketed
    batches and hands each to ``execute(requests, bucket)`` (the engine's
    program call). ``buckets`` is a ladder or a zero-argument callable
    returning the live one. ``retry`` (a ``reliability.RetryPolicy``)
    replays a transiently failed batch; a batch that still fails fails
    exactly its requests (the loop survives), and ``breakers`` (a
    ``reliability.BreakerBoard``) is fed each served tenant's outcome.
    ``on_batch(n_samples, bucket, depth, requests)`` taps every
    dispatch."""

    def __init__(self, queue: RequestQueue, execute: Callable, buckets, *,
                 linger_s: float = 0.0, on_batch: Optional[Callable] = None,
                 retry=None, breakers=None):
        self.queue = queue
        self.execute = execute
        self.buckets = buckets
        self.linger_s = float(linger_s)
        self.on_batch = on_batch
        self.retry = retry
        self.breakers = breakers
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "Scheduler":
        if self._thread is not None:
            raise RuntimeError("scheduler already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-torch-serving-batch",
                                        daemon=True)
        self._thread.start()
        return self

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _record(self, requests, ok: bool) -> None:
        if self.breakers is None:
            return
        for tenant in {r.tenant for r in requests}:
            (self.breakers.record_success if ok
             else self.breakers.record_failure)(tenant)

    def _loop(self) -> None:
        while True:
            requests, bucket = self.queue.take_batch(
                self.buckets, timeout=0.05, linger=self.linger_s)
            if not requests:
                if self.queue.closed and len(self.queue) == 0:
                    break
                continue
            now = time.perf_counter()
            for r in requests:
                r.t_dispatch = now
            n_samples = sum(r.n for r in requests)
            if self.on_batch is not None:
                self.on_batch(n_samples, bucket, self.queue.depth_samples(),
                              requests)
            try:
                with tracer.span("serving.batch", track="serving.scheduler",
                                 bucket=bucket, n_samples=n_samples,
                                 n_requests=len(requests)):
                    if self.retry is not None:
                        self.retry.run(self.execute, requests, bucket)
                    else:
                        self.execute(requests, bucket)
                self._record(requests, ok=True)
            except Exception as e:  # noqa: BLE001 — batch-scoped fault wall
                self._record(requests, ok=False)
                for r in requests:
                    self.queue.admission.on_complete(r.tenant, r.n)
                    r._fail(e)


# ----------------------------------------------------------- decode tier


class DecodeScheduler:
    """The decode loop over a :class:`~.kv_cache.KVSlotPool`, and the
    lifecycle and fault wall every decode scheduler shares.

    Step policy: prefill first — a waiting prompt joins the batch at the
    next boundary (its call also emits its first token), then decode
    steps serve every active lane at once. Prefill groups share one seq
    rung, anchored at the oldest waiting request, and hold at most
    ``prefill_max_batch`` lanes. ``retry`` (a ``reliability.RetryPolicy``)
    replays a program call that failed transiently; ``breakers`` (a
    ``reliability.BreakerBoard``) is fed each served tenant's success or
    failure. A crash in a program call that retry does not absorb fails
    only the lanes that rode it; the loop survives."""

    def __init__(self, queue: RequestQueue, programs, pool, *,
                 prefill_max_batch: int, eos_id: Optional[int] = None,
                 stats=None, retry=None, breakers=None):
        self.queue = queue
        self.programs = programs
        self.pool = pool
        self.prefill_max_batch = max(int(prefill_max_batch), 1)
        self.eos_id = eos_id
        self.stats = stats
        self.retry = retry        # replays a transient program call
        self.breakers = breakers  # per-tenant degraded accounting
        self.max_seq = int(programs.max_seq)
        self._active: Dict[int, object] = {}    # slot (or id) -> request
        self._pending: List[object] = []        # KV held, prefill due
        self._step_lanes: List[object] = []     # lanes riding the current call
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "DecodeScheduler":
        if self._thread is not None:
            raise RuntimeError("decode scheduler already started")
        self._thread = threading.Thread(target=self._loop,
                                        name="paddle-torch-serving-decode",
                                        daemon=True)
        self._thread.start()
        return self

    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def active_count(self) -> int:
        """Requests holding KV state right now (active, awaiting prefill,
        or riding the in-flight program call)."""
        seen = {id(r) for r in self._active.values()}
        seen.update(id(r) for r in self._pending)
        seen.update(id(r) for r in self._step_lanes)
        return len(seen)

    # ------------------------------------------------------------ the loop
    def _loop(self) -> None:
        while True:
            if not self._admit_and_step():
                if (self.queue.closed and len(self.queue) == 0
                        and not self._active and not self._pending):
                    break

    def _admit_and_step(self) -> bool:
        """One beat: admit queued requests into free slots, then run one
        prefill-or-decode call. Returns False when fully idle."""
        free = self.pool.free_count()
        if free > 0:
            idle = not self._active and not self._pending
            taken = self.queue.take_slots(free,
                                          timeout=0.05 if idle else 0.0)
            now = time.perf_counter()
            for r in taken:
                r.slot = self.pool.alloc()
                r.seq_rung = bucket_for(int(r.prompt.size),
                                        self.programs.seq_ladder)
                r.t_dispatch = now
                self._pending.append(r)
        if self._pending:
            self._guarded(self._prefill_step)
            return True
        if self._active:
            self._guarded(self._decode_step)
            return True
        return False

    def _guarded(self, step) -> None:
        """Batch-scoped fault wall: a crashed program call fails exactly
        the lanes it carried, frees their KV state and counts a failure on
        each of their tenants' breakers; pending prefills and active lanes
        that did not ride the call keep serving. Transient faults are
        absorbed by the retry inside the step (around the program call
        only); only a give-up reaches this wall."""
        try:
            step()
        except Exception as e:  # noqa: BLE001 — batch-scoped fault wall
            involved, self._step_lanes = self._step_lanes, []
            if self.breakers is not None:
                for tenant in {r.tenant for r in involved}:
                    self.breakers.record_failure(tenant)
            for r in involved:
                self._free_lane(r)
                self.queue.admission.on_complete(r.tenant, r.n)
                r._fail(e)

    def _program_call(self, fn):
        """One program call through the fault point
        ``serving.decode_step`` and the retry policy, then the pool's
        commit point. Only the call replays: admission and absorb
        bookkeeping never do.

        The JAX engine skips retry when its programs donate the pool. The
        port's programs write the pool in place, even inside a graph,
        which is like donation, and retry all the same, because a replay
        is safe: each program's pool writes are a function of its
        arguments alone (the same rows get the same values; the tokens
        come from the same logits and the same keys for the draw), and
        every row it reads is either untouched by the call or written by
        it before the read. A second run on the same arguments leaves the
        same pool and returns the same tokens
        (``tests/test_torch_cuda_serving.py`` runs one twice on the card).
        The fault point fires before the launch."""
        def attempt():
            fault_point("serving.decode_step")
            return fn()

        out = self.retry.run(attempt) if self.retry is not None else attempt()
        self.pool.commit()
        return out

    def _succeeded(self, lanes) -> None:
        """The call succeeded: nothing to fail, and each of its tenants'
        breakers counts a success."""
        self._step_lanes = []
        if self.breakers is not None:
            for tenant in {r.tenant for r in lanes}:
                self.breakers.record_success(tenant)

    def _free_lane(self, r) -> None:
        """Detach one request from its KV state: the one cleanup path the
        fault wall and retirement share."""
        if r.slot is not None:
            self._active.pop(r.slot, None)
            self.pool.release(r.slot)
            r.slot = None

    def _take_prefill_group(self):
        """The next prefill group: the pending requests on the oldest
        one's seq rung, at most ``prefill_max_batch``, and its batch
        rung."""
        rung = self._pending[0].seq_rung  # oldest request anchors the rung
        group = [r for r in self._pending
                 if r.seq_rung == rung][: self.prefill_max_batch]
        for r in group:
            self._pending.remove(r)
        self._step_lanes = list(group)  # the fault wall's blast radius
        return group, rung, bucket_for(len(group),
                                       self.programs.prefill_batch_rungs)

    # -------------------------------------------------------------- steps
    def _prefill_step(self) -> None:
        group, rung, b_rung = self._take_prefill_group()
        pad = self.pool.pad_slot
        tokens = np.zeros((b_rung, rung), np.int64)
        lengths = np.ones(b_rung, np.int64)
        slots = np.full(b_rung, pad, np.int64)
        for i, r in enumerate(group):
            L = int(r.prompt.size)
            tokens[i, :L] = r.prompt
            lengths[i] = L
            slots[i] = r.slot
        t0 = time.perf_counter()
        with tracer.span("serving.decode", track="serving.scheduler",
                         kind="prefill", rung=(b_rung, rung),
                         lanes=len(group)):
            toks = self._program_call(lambda: self.programs.prefill(
                tokens, lengths, slots))
        self._absorb(group, toks, kind="prefill",
                     seconds=time.perf_counter() - t0)

    def _decode_step(self) -> None:
        lanes = sorted(self._active.values(), key=lambda r: r.id)
        self._step_lanes = list(lanes)  # the fault wall's blast radius
        b_rung = bucket_for(len(lanes), self.programs.decode_rungs)
        pad = self.pool.pad_slot
        tokens = np.zeros(b_rung, np.int64)
        slots = np.full(b_rung, pad, np.int64)
        positions = np.zeros(b_rung, np.int64)
        for i, r in enumerate(lanes):
            tokens[i] = r.generated[-1]
            slots[i] = r.slot
            positions[i] = r.position
        t0 = time.perf_counter()
        with tracer.span("serving.decode", track="serving.scheduler",
                         kind="decode", rung=b_rung, lanes=len(lanes)):
            toks = self._program_call(lambda: self.programs.decode(
                tokens, slots, positions))
        self._absorb(lanes, toks, kind="decode",
                     seconds=time.perf_counter() - t0)

    def _is_done(self, r, tok: int) -> bool:
        """A request ends at ``max_new_tokens``, EOS or ``max_seq``."""
        return (len(r.generated) >= r.max_new_tokens
                or (self.eos_id is not None and tok == self.eos_id)
                or r.position >= self.max_seq)

    def _absorb(self, lanes, toks, *, kind: str, seconds: float) -> None:
        """Scatter one step's tokens back to their requests, retire the
        finished ones (slot released, future resolved), keep the rest
        active for the next step."""
        self._succeeded(lanes)
        for i, r in enumerate(lanes):
            tok = int(toks[i])
            r.generated.append(tok)
            self.pool.lengths[r.slot] = r.position
            if self._is_done(r, tok):
                self._retire(r)
            else:
                self._active[r.slot] = r
        if self.stats is not None:
            self.stats.record_decode_step(kind, seconds, len(lanes),
                                          len(lanes))
            self.stats.record_slot_occupancy(self.pool.in_use(),
                                             self.pool.max_slots)

    def _retire(self, r) -> None:
        self._free_lane(r)
        self.queue.admission.on_complete(r.tenant, r.n)
        r._complete(np.asarray(r.generated, np.int32))
        if self.stats is not None:
            self.stats.record_request(r.t_enqueue, r.t_admit, r.t_dispatch,
                                      r.t_complete, r.n, tenant=r.tenant)


class PagedDecodeScheduler(DecodeScheduler):
    """The decode loop over a :class:`~.kv_cache.KVPagePool`.

    - Admission is gated on lanes and on the page budget: a taken request
      allocates ``ceil(prompt / page_size)`` pages up front; one whose
      prompt pages do not fit stays queued, and an allocation failure
      sheds exactly that request (``AdmissionError(reason="kv_pages")``).
    - Before each decode step, lanes crossing a page boundary grow their
      block table by one page (:meth:`_ensure_pages`).
    - Each call carries the batch's block tables as one int array padded
      to the (batch × table) rung, and the per-lane sampling arguments.
    - With speculation on and any lane still speculating, a beat runs one
      draft + verify round (:meth:`_spec_round`) instead of a decode
      step; lanes that opted out ride it, since their committed tokens
      come from the same verify pass.
    - Retirement releases the request's pages.
    """

    def __init__(self, queue: RequestQueue, programs, pool, *,
                 max_lanes: int, prefill_max_batch: int,
                 eos_id: Optional[int] = None, stats=None, retry=None,
                 breakers=None, speculate_k: int = 0,
                 spec_min_accept: Optional[float] = None):
        super().__init__(queue, programs, pool,
                         prefill_max_batch=prefill_max_batch,
                         eos_id=eos_id, stats=stats, retry=retry,
                         breakers=breakers)
        self.max_lanes = max(int(max_lanes), 1)
        self.speculate_k = max(int(speculate_k), 0)
        self.spec_min_accept = float(
            get_flag("serving_spec_min_accept")
            if spec_min_accept is None else spec_min_accept)
        self.spec_enabled = self.speculate_k > 0
        # _active is keyed by request id here (no slot identity exists)
        self.shed_count = 0
        self._starved = set()  # lane ids waiting on a page (gate admission)

    def _pages_for(self, r) -> int:
        return -(-int(r.prompt.size) // self.pool.page_size)

    # ---------------------------------------------------------- admission
    def _admit_and_step(self) -> bool:
        free = self.max_lanes - self.active_count()
        # starved active lanes get first claim on freed pages
        if free > 0 and self.pool.free_count() > 0 and not self._starved:
            idle = not self._active and not self._pending
            budget = [self.pool.free_count()]

            def fits(r):
                need = self._pages_for(r)
                if need > budget[0]:
                    return False
                budget[0] -= need
                return True

            taken = self.queue.take_slots(
                free, timeout=0.05 if idle else 0.0, budget_fn=fits)
            now = time.perf_counter()
            for r in taken:
                r.seq_rung = bucket_for(int(r.prompt.size),
                                        self.programs.seq_ladder)
                r.t_dispatch = now
                try:
                    r.pages = self.pool.alloc(self._pages_for(r))
                except RuntimeError as e:
                    self._shed(r, e)
                    continue
                self._pending.append(r)
        if self._pending:
            self._guarded(self._prefill_step)
            return True
        if self._active:
            self._guarded(self._decode_step)
            return True
        return False

    def _shed(self, r, cause) -> None:
        """A page-allocation failure sheds one request: its pages return
        to the pool, its future fails with ``AdmissionError(reason=
        "kv_pages")``, its tenant's breaker counts a failure, every other
        lane keeps decoding."""
        self._free_lane(r)
        self.queue.admission.on_complete(r.tenant, r.n)
        if self.breakers is not None:
            self.breakers.record_failure(r.tenant)
        self.shed_count += 1
        registry.counter(
            "serving.kv_page_shed",
            "decode requests shed because a KV page allocation failed "
            "(pool pressure or an injected kv.page_alloc fault)").inc()
        r._fail(AdmissionError(
            "kv_pages",
            f"request {r.id} shed: KV page allocation failed ({cause})"))

    def _free_lane(self, r) -> None:
        self._active.pop(r.id, None)
        if r.pages:
            self.pool.release(r.pages)
            r.pages = []

    def _ensure_pages(self, lanes, lookahead: int = 0):
        """Grow each lane's block table to cover its next write position
        plus ``lookahead`` speculative ones (capped at the last legal
        position: past it the programs write to the pad page). An injected
        ``kv.page_alloc`` fault sheds its lane. A lane the pool cannot grow
        sits this step out and keeps its pages; only when every active
        lane is starved (no retirement can come) is the youngest starved
        lane shed. Returns the lanes ready to step."""
        ready, starved = [], []
        for r in lanes:
            last = min(int(r.position) + lookahead, self.max_seq - 1)
            need = last // self.pool.page_size + 1
            try:
                while len(r.pages) < need:
                    r.pages.extend(self.pool.alloc(1))
            except FaultInjection as e:
                self._shed(r, e)
                continue
            except RuntimeError:
                starved.append(r)
                continue
            ready.append(r)
        if not ready and starved and not self._pending:
            victim = max(starved, key=lambda r: r.id)
            starved.remove(victim)
            self._shed(victim, RuntimeError(
                "page pool deadlocked: every active lane needs a page "
                "and none can retire"))
        self._starved = {r.id for r in starved}
        return ready

    # -------------------------------------------------------------- steps
    @staticmethod
    def _sample_args(lanes, b_rung: int):
        """The per-lane sampling arguments of one call. The key is
        ``[seed, len(generated)]``, a pure function of the request, so a
        sampled stream is the same under any join/leave order. Pad lanes
        take temperature 0 (greedy)."""
        temps = np.zeros(b_rung, np.float32)
        top_ks = np.zeros(b_rung, np.int64)
        top_ps = np.ones(b_rung, np.float32)
        rkeys = np.zeros((b_rung, 2), np.int64)
        for i, r in enumerate(lanes):
            temps[i] = r.temperature
            top_ks[i] = r.top_k
            top_ps[i] = r.top_p
            rkeys[i] = (r.seed & 0xFFFFFFFF, len(r.generated))
        return temps, top_ks, top_ps, rkeys

    def _prefill_step(self) -> None:
        group, rung, b_rung = self._take_prefill_group()
        t_cols = self.programs.prefill_table_cols(rung)
        tokens = np.zeros((b_rung, rung), np.int64)
        lengths = np.ones(b_rung, np.int64)
        tables = np.zeros((b_rung, t_cols), np.int64)  # 0 = pad page
        for i, r in enumerate(group):
            L = int(r.prompt.size)
            tokens[i, :L] = r.prompt
            lengths[i] = L
            tables[i, :len(r.pages)] = r.pages
        sample = self._sample_args(group, b_rung)
        t0 = time.perf_counter()
        with tracer.span("serving.decode", track="serving.scheduler",
                         kind="prefill", rung=(b_rung, rung),
                         lanes=len(group)):
            toks = self._program_call(lambda: self.programs.prefill(
                tokens, lengths, tables, *sample))
        self._absorb(group, toks, kind="prefill",
                     seconds=time.perf_counter() - t0)

    def _step_inputs(self, lanes):
        """The (batch × table) rung of a decode step or speculation round
        and its last tokens, block tables and write positions."""
        b_rung = bucket_for(len(lanes), self.programs.decode_rungs)
        t_rung = bucket_for(max(len(r.pages) for r in lanes),
                            self.programs.table_rungs)
        tokens = np.zeros(b_rung, np.int64)
        tables = np.zeros((b_rung, t_rung), np.int64)  # 0 = pad page
        positions = np.zeros(b_rung, np.int64)
        for i, r in enumerate(lanes):
            tokens[i] = r.generated[-1]
            tables[i, :len(r.pages)] = r.pages
            positions[i] = r.position
        return b_rung, tokens, tables, positions

    def _decode_step(self) -> None:
        if (self.speculate_k > 0 and self.spec_enabled
                and any(r.spec_live for r in self._active.values())):
            self._spec_round()
            return
        lanes = sorted(self._active.values(), key=lambda r: r.id)
        lanes = self._ensure_pages(lanes)
        if not lanes:
            return
        self._step_lanes = list(lanes)  # the fault wall's blast radius
        b_rung, tokens, tables, positions = self._step_inputs(lanes)
        sample = self._sample_args(lanes, b_rung)
        t0 = time.perf_counter()
        with tracer.span("serving.decode", track="serving.scheduler",
                         kind="decode", rung=tables.shape,
                         lanes=len(lanes)):
            toks = self._program_call(lambda: self.programs.decode(
                tokens, tables, positions, *sample))
        self._absorb(lanes, toks, kind="decode",
                     seconds=time.perf_counter() - t0)

    def _spec_round(self) -> None:
        """One self-speculation round: one draft call proposes k tokens a
        lane through the truncated-layer program, one verify call scores
        all k+1 positions with the full model, then each lane commits its
        longest accepted prefix plus the verify pass's own next token —
        1 to k+1 tokens, always the tokens the plain loop would emit.
        Pages grown for the speculative suffix roll back in
        :meth:`_absorb_spec`."""
        k = self.speculate_k
        lanes = sorted(self._active.values(), key=lambda r: r.id)
        lanes = self._ensure_pages(lanes, lookahead=k)
        if not lanes:
            return
        self._step_lanes = list(lanes)  # the fault wall's blast radius
        b_rung, tokens, tables, positions = self._step_inputs(lanes)
        sample = self._sample_args(lanes, b_rung)
        with tracer.span("serving.decode", track="serving.scheduler",
                         kind="speculate", rung=tables.shape,
                         lanes=len(lanes), k=k):
            t0 = time.perf_counter()
            drafts = self._program_call(lambda: self.programs.draft(
                tokens, tables, positions, *sample))
            t_draft = time.perf_counter() - t0
            vin = np.zeros((b_rung, k + 1), np.int64)
            vin[:, 0] = tokens                # last committed token at p
            vin[:, 1:] = drafts               # proposals at p+1..p+k
            t1 = time.perf_counter()
            vtoks = self._program_call(lambda: self.programs.verify(
                vin, tables, positions, *sample))
            t_verify = time.perf_counter() - t1
        self._absorb_spec(lanes, drafts, vtoks, t_draft=t_draft,
                          t_verify=t_verify)

    def _absorb_spec(self, lanes, drafts, vtoks, *, t_draft: float,
                     t_verify: float) -> None:
        """Acceptance, commit and rollback of one speculation round. Lane
        i's accepted length m is the longest run of proposals the verify
        pass reproduced; verify tokens 0..m commit, stopping early at EOS
        or the length limits as :meth:`_absorb` does. Block-table pages
        past the new write position (grown for the speculative suffix)
        go back to the free list."""
        self._succeeded(lanes)
        k = self.speculate_k
        proposed = accepted = committed = 0
        for i, r in enumerate(lanes):
            m = 0
            while m < k and int(drafts[i, m]) == int(vtoks[i, m]):
                m += 1
            r.spec_proposed += k
            r.spec_accepted += m
            proposed += k
            accepted += m
            done = False
            for j in range(m + 1):
                tok = int(vtoks[i, j])
                r.generated.append(tok)
                committed += 1
                done = self._is_done(r, tok)
                if done:
                    break
            # after a fair window (two rounds' proposals) a lane whose
            # acceptance sits under the floor stops speculating; the
            # batch decodes plainly once every lane has
            if (r.spec_live and r.spec_proposed >= 2 * k
                    and r.spec_accepted
                    < self.spec_min_accept * r.spec_proposed):
                r.spec_live = False
            if done:
                self._retire(r)
            else:
                keep = int(r.position) // self.pool.page_size + 1
                if len(r.pages) > keep:  # the speculative suffix rolls back
                    self.pool.release(r.pages[keep:])
                    del r.pages[keep:]
                self._active[r.id] = r
        self._note_pool()
        if self.stats is not None:
            self.stats.record_decode_step("draft", t_draft, len(lanes), 0)
            self.stats.record_decode_step("verify", t_verify, len(lanes),
                                          committed)
            self.stats.record_spec_round(proposed, accepted, committed)
            self.stats.record_slot_occupancy(self.active_count(),
                                             self.max_lanes)
        registry.counter(
            "serving.spec_rounds",
            "self-speculation rounds (one draft + one verify call each) run "
            "by the decode scheduler").inc()
        registry.counter(
            "serving.spec_tokens_proposed",
            "draft tokens proposed by self-speculation rounds").inc(proposed)
        registry.counter(
            "serving.spec_tokens_accepted",
            "draft tokens the full-model verify pass accepted (the rest "
            "rolled back)").inc(accepted)

    def _note_pool(self) -> None:
        live_tokens = sum(int(r.prompt.size) + len(r.generated)
                          for r in self._active.values())
        self.pool.note_utilization(live_tokens)

    def _absorb(self, lanes, toks, *, kind: str, seconds: float) -> None:
        """Scatter one step's tokens back to their requests, retire the
        finished ones, keep the rest active for the next step."""
        self._succeeded(lanes)
        for i, r in enumerate(lanes):
            tok = int(toks[i])
            r.generated.append(tok)
            if self._is_done(r, tok):
                self._retire(r)
            else:
                self._active[r.id] = r
        self._note_pool()
        if self.stats is not None:
            self.stats.record_decode_step(kind, seconds, len(lanes),
                                          len(lanes))
            self.stats.record_slot_occupancy(self.active_count(),
                                             self.max_lanes)
