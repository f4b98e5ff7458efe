"""MetricBuffer: keep per-step training metrics on the device (port of
``paddle_tpu/hapi/metric_buffer.py``).

A loop that reads ``float(loss)`` every step waits for the card once a
step: the host cannot queue the next step's replay until the last one has
run. The buffer is the non-blocking replacement: the loop appends the
steps' device scalars (no host sync), and floats materialize only at
sync boundaries, every ``sync_every`` steps (the log frequency) and at the
epoch flush. A boundary makes one ``torch.stack`` of the pending scalars
and one device-to-host copy, then converts element-wise to python floats,
so the values are bit for bit what a per-step ``float(...)`` would give.

Every materialization is timed and counted in ``profiler.pipeline_stats``
(``host_sync_us``, ``host_syncs``): between boundaries the count does not
move.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..observability.tracing import tracer
from ..profiler.pipeline import pipeline_stats


def to_float(value) -> float:
    """One blocking device-to-host scalar read, counted as a host sync:
    the sync point for code that must return a python float
    (``Model.train_batch(sync=True)``, ``eval_batch``)."""
    t0 = time.perf_counter()
    if isinstance(value, torch.Tensor):
        out = float(value.detach().reshape(-1)[0].item())
    else:
        out = float(value)
    dt = time.perf_counter() - t0
    pipeline_stats.add_host_sync(dt)
    if tracer.enabled:
        tracer.emit("host_sync", t0, dt, track="train_loop")
    return out


class MetricBuffer:
    """Per-name ring of device scalars with boundary-only materialization.

    ``sync_every=k`` → :meth:`should_sync` is True every k-th step (the
    loop materializes there, typically to feed a progress logger);
    ``sync_every=0``/``None`` → only explicit :meth:`flush` calls sync.
    """

    def __init__(self, sync_every: Optional[int] = None):
        self.sync_every = int(sync_every or 0)
        self._pending: Dict[str, List] = {}
        self._history: Dict[str, List[float]] = {}

    # ------------------------------------------------------------- appending
    def append(self, name: str, value) -> None:
        """Record one step's metric, a tensor (or a number); it is stored
        as it is, no host transfer happens."""
        self._pending.setdefault(name, []).append(value)

    def latest(self, name: str):
        """The most recent recorded value, still device-resident (pending)
        or the last materialized float."""
        pend = self._pending.get(name)
        if pend:
            return pend[-1]
        hist = self._history.get(name)
        return hist[-1] if hist else None

    def last_float(self, name: str):
        """The most recent MATERIALIZED value (a python float), or None
        when nothing has synced yet — never touches the device."""
        hist = self._history.get(name)
        return hist[-1] if hist else None

    def should_sync(self, step: int) -> bool:
        """True on sync boundaries: step is 0-based and with
        ``sync_every=k`` steps 0, k, 2k, ... materialize — the same
        cadence ``ProgBarLogger`` prints on (``step % log_freq == 0``),
        so the logger always receives already-materialized floats."""
        return self.sync_every > 0 and step % self.sync_every == 0

    # --------------------------------------------------------- materializing
    def materialize(self) -> Dict[str, float]:
        """Move every pending scalar to the host (one stack and one copy a
        metric), append them to the history and return the latest float
        of each metric. A float is the scalar's exact value, as a
        per-step ``float(v)`` gives it."""
        if not self._pending:
            return {k: v[-1] for k, v in self._history.items() if v}
        t0 = time.perf_counter()
        out = {}
        n_values = 0
        for name, vals in self._pending.items():
            stacked = torch.stack([torch.as_tensor(v).detach().reshape(())
                                   for v in vals])
            floats = [float(x) for x in stacked.cpu().tolist()]
            n_values += len(floats)
            self._history.setdefault(name, []).extend(floats)
            out[name] = floats[-1]
        self._pending.clear()
        dt = time.perf_counter() - t0
        pipeline_stats.add_host_sync(dt)
        if tracer.enabled:
            tracer.emit("metric.flush", t0, dt, track="train_loop",
                        metrics=len(out), values=n_values)
        return out

    def flush(self) -> Dict[str, dict]:
        """Epoch boundary: materialize everything and return per-metric
        ``{"last", "mean", "values"}``, then reset the history. ``mean``
        uses the same float64 accumulation over python floats as a
        per-step loop's ``np.mean(list_of_floats)``."""
        self.materialize()
        report = {}
        for name, vals in self._history.items():
            if not vals:
                continue
            report[name] = {"last": vals[-1],
                            "mean": float(np.mean(vals)),
                            "values": list(vals)}
        self._history.clear()
        return report
