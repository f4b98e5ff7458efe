"""The decode tier's continuous-batching loop (port of ``DecodeScheduler``
and ``PagedDecodeScheduler`` from ``paddle_tpu/serving/scheduler.py``).

One executor thread runs one program call per beat — prefill or decode,
or a speculation round's draft and verify — and between any two calls
requests join (queued → slot or pages allocated) and leave (finished →
KV state released, future resolved). The JAX package's retry policy,
fault points and circuit breakers are left out of this slice; the
batch-scoped fault wall stays.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..base.flags import get_flag
from ..jit.bucketing import bucket_for
from .request_queue import AdmissionError, RequestQueue

__all__ = ["DecodeScheduler", "PagedDecodeScheduler"]


class DecodeScheduler:
    """The decode loop over a :class:`~.kv_cache.KVSlotPool`, and the
    lifecycle and fault wall every decode scheduler shares.

    Step policy: prefill first — a waiting prompt joins the batch at the
    next boundary (its call also emits its first token), then decode
    steps serve every active lane at once. Prefill groups share one seq
    rung, anchored at the oldest waiting request, and hold at most
    ``prefill_max_batch`` lanes. A crash in a program call fails only the
    lanes that rode it; the loop survives."""

    def __init__(self, queue: RequestQueue, programs, pool, *,
                 prefill_max_batch: int, eos_id: Optional[int] = None,
                 stats=None):
        self.queue = queue
        self.programs = programs
        self.pool = pool
        self.prefill_max_batch = max(int(prefill_max_batch), 1)
        self.eos_id = eos_id
        self.stats = stats
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
        the lanes it carried and frees their KV state; pending prefills
        and active lanes that did not ride the call keep serving."""
        try:
            step()
        except Exception as e:  # noqa: BLE001 — batch-scoped fault wall
            involved, self._step_lanes = self._step_lanes, []
            for r in involved:
                self._free_lane(r)
                self.queue.admission.on_complete(r.tenant, r.n)
                r._fail(e)

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
        toks = self.programs.prefill(tokens, lengths, slots)
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
        toks = self.programs.decode(tokens, slots, positions)
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
        self._step_lanes = []  # the call succeeded: nothing to fail
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
                 eos_id: Optional[int] = None, stats=None,
                 speculate_k: int = 0,
                 spec_min_accept: Optional[float] = None):
        super().__init__(queue, programs, pool,
                         prefill_max_batch=prefill_max_batch,
                         eos_id=eos_id, stats=stats)
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
        "kv_pages")``, every other lane keeps decoding."""
        self._free_lane(r)
        self.queue.admission.on_complete(r.tenant, r.n)
        self.shed_count += 1
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
        position: past it the programs write to the pad page). A lane the
        pool cannot grow sits this step out and keeps its pages; only when
        every active lane is starved (no retirement can come) is the
        youngest starved lane shed. Returns the lanes ready to step."""
        ready, starved = [], []
        for r in lanes:
            last = min(int(r.position) + lookahead, self.max_seq - 1)
            need = last // self.pool.page_size + 1
            try:
                while len(r.pages) < need:
                    r.pages.extend(self.pool.alloc(1))
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
        t0 = time.perf_counter()
        toks = self.programs.prefill(tokens, lengths, tables,
                                     *self._sample_args(group, b_rung))
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
        t0 = time.perf_counter()
        toks = self.programs.decode(tokens, tables, positions,
                                    *self._sample_args(lanes, b_rung))
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
        t0 = time.perf_counter()
        drafts = self.programs.draft(tokens, tables, positions, *sample)
        t_draft = time.perf_counter() - t0
        vin = np.zeros((b_rung, k + 1), np.int64)
        vin[:, 0] = tokens                # last committed token at p
        vin[:, 1:] = drafts               # proposals at p+1..p+k
        t1 = time.perf_counter()
        vtoks = self.programs.verify(vin, tables, positions, *sample)
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
        self._step_lanes = []  # the calls succeeded: nothing to fail
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

    def _note_pool(self) -> None:
        live_tokens = sum(int(r.prompt.size) + len(r.generated)
                          for r in self._active.values())
        self.pool.note_utilization(live_tokens)

    def _absorb(self, lanes, toks, *, kind: str, seconds: float) -> None:
        """Scatter one step's tokens back to their requests, retire the
        finished ones, keep the rest active for the next step."""
        self._step_lanes = []  # the call succeeded: nothing to fail
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
