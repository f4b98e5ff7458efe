"""Pipeline and serving statistics (port of ``PipelineStats`` and
``ServingStats`` from ``paddle_tpu/profiler/pipeline.py``).

:class:`PipelineStats` is the training loop's breakdown of a step's wall
time, one process-global instance, :data:`pipeline_stats`, that the
``DeviceLoader`` (``io/device_prefetch.py``), the ``MetricBuffer``
(``hapi/metric_buffer.py``) and ``Model.fit`` report into:

- ``h2d_wait_us``: the time the loop blocked waiting for the next batch on
  the device (0 when the prefetch keeps up);
- ``h2d_issue_us``: the time the prefetch thread spent pinning a batch and
  queueing its copy (the transfer cost being hidden);
- ``dispatch_us``: the time inside the step call (queueing a graph replay
  on CUDA, the whole step on the CPU);
- ``host_sync_us`` / ``host_syncs_per_step``: the time and count of
  blocking device-to-host reads (metric materialization). The steady
  state has none between log boundaries;
- ``overlap_ratio``: the share of the issue time the loop never waited
  for.

:class:`ServingStats`: every completed request reports its enqueue → admit → dispatch →
complete timestamps; the batch tier's scheduler reports each dispatched
batch (real rows against the rung's slots, and on a (batch × seq) grid
real tokens against the rung's token slots) and the queue depth it left;
every decode-tier program call reports its kind (prefill, decode, or a
speculation round's draft and verify), seconds and emitted tokens.
``summary()`` gives request latency p50/p99, requests and samples per
second over the window from the first enqueue to the last completion,
the share of requests inside ``FLAGS_serving_slo_ms``, the batches' row
fill (``batch_fill``) and token fill (``token_fill``) and the queue
depth; ``summary()["decode"]`` the decode tier's step latency by kind,
tokens per second and, once a speculation round ran, its acceptance. Times are host ``perf_counter`` seconds around calls that
end in a device-to-host read, so they cover the device work.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["PipelineStats", "ServingStats", "pipeline_stats", "timed"]


class ServingStats:
    """Request and step accounting of one serving engine. Samples are
    kept in bounded rings (last ``max_samples``) so percentile math never
    grows with uptime."""

    def __init__(self, max_samples: int = 8192):
        self._lock = threading.Lock()
        self._max_samples = int(max_samples)
        self.reset()

    def reset(self):
        with self._lock:
            self.requests = 0
            self.samples = 0
            self.rejected = 0
            self.expired = 0
            self.batches = 0
            self.batch_slots = 0
            self.padded_slots = 0
            self.token_slots = 0
            self.padded_tokens = 0
            self.depth_samples = 0
            self.queue_depth_sum = 0
            self.queue_depth_peak = 0
            self._t_first = None  # first enqueue, last completion
            self._t_last = None
            self._lat = []        # (total, queue_wait, exec) seconds, ring
            self._tenants = {}    # tenant -> {"requests", "rejected", "expired"}
            self._decode = {
                "prefill_steps": 0, "decode_steps": 0,
                "prefill_s": 0.0, "decode_s": 0.0,
                "prefill_ms": [], "decode_ms": [],   # bounded rings
                "prefill_tokens": 0, "decode_tokens": 0,
                # self-speculation: draft/verify calls keyed like the
                # other kinds, plus per-round acceptance
                "draft_steps": 0, "verify_steps": 0,
                "draft_s": 0.0, "verify_s": 0.0,
                "draft_ms": [], "verify_ms": [],
                "draft_tokens": 0, "verify_tokens": 0,
                "spec_rounds": 0, "spec_proposed": 0,
                "spec_accepted": 0, "spec_committed": 0,
                "t_first": None, "t_last": None,
                "occ_sum": 0, "occ_samples": 0, "occ_peak": 0, "slots": 0,
            }

    def _tenant_cell(self, tenant) -> dict:
        # caller holds the lock
        return self._tenants.setdefault(
            tenant, {"requests": 0, "rejected": 0, "expired": 0})

    def _ring_append(self, ring, value):
        ring.append(value)
        if len(ring) > self._max_samples:
            del ring[: len(ring) - self._max_samples]

    # ------------------------------------------------------------ recording
    def record_request(self, t_enqueue: float, t_admit: float,
                       t_dispatch: float, t_complete: float, n: int = 1,
                       tenant: str = None):
        with self._lock:
            self.requests += 1
            self.samples += int(n)
            self._ring_append(self._lat, (t_complete - t_enqueue,
                                          t_dispatch - t_admit,
                                          t_complete - t_dispatch))
            if tenant is not None:
                self._tenant_cell(tenant)["requests"] += 1
            if self._t_first is None:
                self._t_first = t_enqueue
            self._t_last = max(self._t_last or t_complete, t_complete)

    def record_batch(self, n_samples: int, bucket: int,
                     tokens: Optional[int] = None,
                     token_slots: Optional[int] = None):
        """One dispatched batch: ``n_samples`` real rows padded to
        ``bucket`` slots; on a (batch × seq) grid also ``tokens`` real
        tokens in the rung's ``token_slots`` (bucket × seq bucket), so the
        sequence padding shows as well as the row padding."""
        with self._lock:
            self.batches += 1
            self.batch_slots += int(bucket)
            self.padded_slots += int(bucket) - int(n_samples)
            if token_slots is not None:
                self.token_slots += int(token_slots)
                self.padded_tokens += int(token_slots) - int(tokens)

    def record_queue_depth(self, depth: int):
        """The queued samples left behind a dispatched batch."""
        with self._lock:
            self.depth_samples += 1
            self.queue_depth_sum += int(depth)
            self.queue_depth_peak = max(self.queue_depth_peak, int(depth))

    def record_rejected(self, n: int = 1, tenant: str = None):
        with self._lock:
            self.rejected += int(n)
            if tenant is not None:
                self._tenant_cell(tenant)["rejected"] += int(n)

    def record_expired(self, n: int = 1, tenant: str = None):
        with self._lock:
            self.expired += int(n)
            if tenant is not None:
                self._tenant_cell(tenant)["expired"] += int(n)

    def retire_tenant(self, tenant: str) -> bool:
        with self._lock:
            return self._tenants.pop(tenant, None) is not None

    def record_decode_step(self, kind: str, seconds: float, n_lanes: int,
                           n_tokens: int):
        """One decode-tier program call: ``kind`` is ``"prefill"``,
        ``"decode"``, ``"draft"`` or ``"verify"``; ``n_tokens`` real
        tokens were emitted by ``n_lanes`` real lanes (pad lanes excluded;
        a draft call emits 0, its round's committed tokens land on the
        verify call)."""
        now = time.perf_counter()
        with self._lock:
            cell = self._decode
            if cell["t_first"] is None:
                cell["t_first"] = now - seconds
            cell["t_last"] = now
            cell[f"{kind}_steps"] += 1
            cell[f"{kind}_s"] += float(seconds)
            self._ring_append(cell[f"{kind}_ms"], float(seconds) * 1e3)
            cell[f"{kind}_tokens"] += int(n_tokens)

    def record_spec_round(self, proposed: int, accepted: int,
                          committed: int):
        """One self-speculation round across its lanes: ``proposed`` draft
        tokens, ``accepted`` of them matched by the verify pass,
        ``committed`` tokens entered streams (accepted plus the verify
        pass's own token a lane, clipped by EOS and the length limits)."""
        with self._lock:
            cell = self._decode
            cell["spec_rounds"] += 1
            cell["spec_proposed"] += int(proposed)
            cell["spec_accepted"] += int(accepted)
            cell["spec_committed"] += int(committed)

    def record_slot_occupancy(self, in_use: int, capacity: int):
        with self._lock:
            cell = self._decode
            cell["occ_sum"] += int(in_use)
            cell["occ_samples"] += 1
            cell["occ_peak"] = max(cell["occ_peak"], int(in_use))
            cell["slots"] = max(cell["slots"], int(capacity))

    # ------------------------------------------------------------ reporting
    @staticmethod
    def _pct(sorted_vals, q):
        if not sorted_vals:
            return None
        idx = min(int(q * (len(sorted_vals) - 1) + 0.5), len(sorted_vals) - 1)
        return sorted_vals[idx]

    def summary(self, slo_ms: float = None) -> dict:
        if slo_ms is None:
            from ..base.flags import get_flag

            slo_ms = float(get_flag("serving_slo_ms"))
        with self._lock:
            total = sorted(t for t, _, _ in self._lat)
            queue_w = sorted(q for _, q, _ in self._lat)
            window = (self._t_last - self._t_first
                      if self._t_first is not None else 0.0)
            in_slo = sum(1 for t in total if t * 1e3 <= slo_ms)

            def ms(vals, q):
                v = self._pct(vals, q)
                return v * 1e3 if v is not None else None

            def rate(count):
                return count / window if window > 0 else None

            return {
                "requests": self.requests,
                "samples": self.samples,
                "rejected": self.rejected,
                "expired": self.expired,
                "p50_ms": ms(total, 0.50),
                "p99_ms": ms(total, 0.99),
                "queue_wait_p50_ms": ms(queue_w, 0.50),
                "requests_per_sec": rate(self.requests),
                "samples_per_sec": rate(self.samples),
                "slo_ms": slo_ms,
                "in_slo_fraction": in_slo / len(total) if total else None,
                "requests_per_sec_in_slo": (
                    rate(self.requests * in_slo / len(total))
                    if total else None),
                "batches": self.batches,
                "batch_slots": self.batch_slots,
                "padded_slots": self.padded_slots,
                "batch_fill": (1.0 - self.padded_slots / self.batch_slots
                               if self.batch_slots else None),
                "token_slots": self.token_slots,
                "padded_tokens": self.padded_tokens,
                "token_fill": (1.0 - self.padded_tokens / self.token_slots
                               if self.token_slots else None),
                "queue_depth_mean": (self.queue_depth_sum / self.depth_samples
                                     if self.depth_samples else None),
                "queue_depth_peak": self.queue_depth_peak,
                "tenants": {k: dict(v) for k, v in sorted(self._tenants.items())},
                "decode": self._decode_summary(),
            }

    def _decode_summary(self):
        """Prefill vs decode step latency and decode throughput (caller
        holds the lock); None when no step ran."""
        cell = self._decode
        if not cell["prefill_steps"] and not cell["decode_steps"]:
            return None
        prefill = sorted(cell["prefill_ms"])
        decode = sorted(cell["decode_ms"])
        tokens = (cell["prefill_tokens"] + cell["decode_tokens"]
                  + cell["verify_tokens"])
        window = cell["t_last"] - cell["t_first"]
        out = {
            "prefill_steps": cell["prefill_steps"],
            "decode_steps": cell["decode_steps"],
            "prefill_s": cell["prefill_s"],
            "decode_s": cell["decode_s"],
            "prefill_p50_ms": self._pct(prefill, 0.50),
            "prefill_p99_ms": self._pct(prefill, 0.99),
            "decode_p50_ms": self._pct(decode, 0.50),
            "decode_p99_ms": self._pct(decode, 0.99),
            "tokens": tokens,
            # every emitted token over the wall window of the steps
            "tokens_per_sec": tokens / window if window > 0 else None,
            # tokens the decode steps emitted over the time spent in them
            "decode_tokens_per_sec": (cell["decode_tokens"] / cell["decode_s"]
                                      if cell["decode_s"] > 0 else None),
            "slot_occupancy_mean": (cell["occ_sum"] / cell["occ_samples"]
                                    if cell["occ_samples"] else None),
            "slot_occupancy_peak": cell["occ_peak"],
            "slots": cell["slots"],
        }
        if cell["spec_rounds"]:
            draft = sorted(cell["draft_ms"])
            verify = sorted(cell["verify_ms"])
            spec_s = cell["draft_s"] + cell["verify_s"]
            out.update(
                spec_rounds=cell["spec_rounds"],
                spec_tokens_proposed=cell["spec_proposed"],
                spec_tokens_accepted=cell["spec_accepted"],
                spec_tokens_committed=cell["spec_committed"],
                spec_accept_rate=(cell["spec_accepted"]
                                  / max(cell["spec_proposed"], 1)),
                # tokens committed per full-model call (verify), against
                # the 1 of a plain decode step
                spec_net_tokens_per_full_pass=(
                    cell["spec_committed"] / max(cell["spec_rounds"], 1)),
                draft_steps=cell["draft_steps"],
                verify_steps=cell["verify_steps"],
                draft_s=cell["draft_s"],
                verify_s=cell["verify_s"],
                draft_p50_ms=self._pct(draft, 0.50),
                verify_p50_ms=self._pct(verify, 0.50),
                # committed tokens over the time spent in the rounds
                spec_tokens_per_sec=(cell["verify_tokens"] / spec_s
                                     if spec_s > 0 else None),
            )
        return out


class PipelineStats:
    """Thread-safe accumulator of the per-step pipeline breakdown."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.steps = 0
            self.h2d_wait_s = 0.0
            self.h2d_issue_s = 0.0
            self.dispatch_s = 0.0
            self.host_sync_s = 0.0
            self.host_syncs = 0

    def add_h2d_wait(self, seconds: float):
        with self._lock:
            self.h2d_wait_s += seconds

    def add_h2d_issue(self, seconds: float):
        with self._lock:
            self.h2d_issue_s += seconds

    def add_dispatch(self, seconds: float):
        with self._lock:
            self.dispatch_s += seconds

    def add_host_sync(self, seconds: float, count: int = 1):
        with self._lock:
            self.host_sync_s += seconds
            self.host_syncs += count

    def step(self, n: int = 1):
        with self._lock:
            self.steps += n

    def summary(self) -> dict:
        with self._lock:
            steps = max(self.steps, 1)
            overlap = (1.0 - min(self.h2d_wait_s / self.h2d_issue_s, 1.0)
                       if self.h2d_issue_s > 0 else None)
            return {
                "steps": self.steps,
                "h2d_wait_us": self.h2d_wait_s / steps * 1e6,
                "h2d_issue_us": self.h2d_issue_s / steps * 1e6,
                "dispatch_us": self.dispatch_s / steps * 1e6,
                "host_sync_us": self.host_sync_s / steps * 1e6,
                "host_syncs": self.host_syncs,
                "host_syncs_per_step": self.host_syncs / steps,
                "overlap_ratio": overlap,
            }


#: the process's training-loop breakdown
pipeline_stats = PipelineStats()


class timed:
    """``with timed(pipeline_stats.add_dispatch): step(batch)`` records the
    block's host seconds."""

    __slots__ = ("_add", "_t0")

    def __init__(self, add):
        self._add = add

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._add(time.perf_counter() - self._t0)
        return False
