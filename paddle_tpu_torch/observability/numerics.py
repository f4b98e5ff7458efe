"""Runtime NaN/Inf + dynamic-range witness (port of
``paddle_tpu/observability/numerics.py``, NM1104/NM1105).

- :func:`watch` is the instrumentation point on the training path: the
  ``TrainStep`` loss (``"train.loss"``) and ``GradScaler.unscale_``'s f32
  gradients (``"amp.unscaled_grad"``). When ``FLAGS_numerics_witness`` is
  lit, each call checks the value for non-finite entries (NM1104) and
  keeps a per-name dynamic-range watermark: the rolling max-abs and an
  underflow fraction. A sample whose max-abs falls below ``watermark *
  FLAGS_numerics_collapse_ratio`` once the watermark is established is an
  NM1105 verdict (gradients flushed to zero, an underflowed loss).
- Verdicts are kept as bounded witness violations and handed to the
  :class:`~.anomaly.AnomalyMonitor` flight recorder (one bundle per kind
  within its cooldown).
- Dark, the default, every watch site pays one module-global bool read and
  returns: no launch and no host read. Lit, a watch reads its tensor to
  the host, except while the calling thread captures a CUDA graph: a
  value inside a capture holds nothing yet, as the JAX witness skips
  tracers, so a site inside a captured ``TrainStep`` (the unscaled
  gradients) stays dark even with the flag lit; the loss is watched after
  the replay.
"""
from __future__ import annotations

import threading
from typing import Dict, List

import torch

from ..base.flags import get_flag

__all__ = ["set_witness", "watch", "witness_enabled", "witness_report",
           "witness_reset", "witness_stats", "witness_violations"]

# the ONE bool every watch site reads when the witness is dark
_enabled = False
# this guard predates nothing and nests inside nothing: keep it a bare
# primitive so witness bookkeeping never re-enters the lock witness
_WLOCK = threading.Lock()  # noqa: CX1003 — the witness's own guard
_tls = threading.local()

# name -> {"checks", "nonfinite", "watermark", "last_max_abs",
#          "underflow_frac", "samples"}
_state: Dict[str, dict] = {}
_violations: List[dict] = []      # NM1104/NM1105 verdicts, bounded
_MAX_VIOLATIONS = 256
# the watermark must see a few healthy samples before the collapse
# watcher arms — step 0 of a fresh run has no "normal range" yet
_MIN_WATERMARK_SAMPLES = 3
# |x| < tiny counts toward the underflow fraction (bf16's smallest
# normal is ~1.18e-38 but grads flush far earlier; this is a coarse
# "how much of the tensor is numerically dead" gauge)
_UNDERFLOW_TINY = 1e-30


def _collapse_ratio() -> float:
    return float(get_flag("numerics_collapse_ratio"))


def _notify(verdict: dict) -> None:
    """Feed the flight recorder OUTSIDE ``_WLOCK``.  The monitor's
    bundle write can touch instrumented code, so a per-thread ``busy``
    latch keeps any re-entrant watch from nesting a second
    notification."""
    if getattr(_tls, "busy", False):
        return
    _tls.busy = True
    try:
        from .anomaly import monitor

        monitor.on_numerics(verdict)
    except Exception:
        pass
    finally:
        _tls.busy = False


def _as_numpy(value):
    """A concrete numpy view of ``value``, or None where it cannot give one
    (a tensor of a graph being captured, a non-numeric object)."""
    import numpy as np

    if isinstance(value, torch.Tensor):
        if value.is_cuda and torch.cuda.is_current_stream_capturing():
            return None
        value = value.detach()
        if value.is_floating_point():
            value = value.float()
        return value.cpu().numpy()
    try:
        arr = np.asarray(value)
    except (TypeError, ValueError):
        return None
    if arr.dtype.kind not in "fciu":
        return None
    return arr


def watch(name: str, value) -> None:
    """Witness checkpoint: NaN/Inf sentinel + dynamic-range watermark
    for the tensor ``value`` under the stable site name ``name``.
    Dark: one bool read. Tensors of a graph being captured are always
    skipped."""
    if not _enabled:
        return
    import numpy as np

    arr = _as_numpy(value)
    if arr is None or arr.size == 0:
        return
    arr = np.abs(np.asarray(arr, dtype=np.float64).reshape(-1))
    mask = np.isfinite(arr)
    finite = bool(mask.all())
    max_abs = float(arr[mask].max()) if mask.any() else 0.0
    underflow = float(np.mean(arr < _UNDERFLOW_TINY))
    verdict = None
    with _WLOCK:
        st = _state.setdefault(name, {
            "checks": 0, "nonfinite": 0, "watermark": 0.0,
            "last_max_abs": 0.0, "underflow_frac": 0.0, "samples": 0})
        st["checks"] += 1
        st["last_max_abs"] = max_abs
        st["underflow_frac"] = underflow
        if not finite:
            st["nonfinite"] += 1
            verdict = {
                "code": "NM1104", "kind": "nonfinite", "name": name,
                "max_abs_finite": max_abs,
                "thread": threading.current_thread().name}
        else:
            ratio = _collapse_ratio()
            if (ratio > 0 and st["samples"] >= _MIN_WATERMARK_SAMPLES
                    and st["watermark"] > 0
                    and max_abs < st["watermark"] * ratio):
                verdict = {
                    "code": "NM1105", "kind": "range_collapse",
                    "name": name, "max_abs": max_abs,
                    "watermark": st["watermark"], "ratio": ratio,
                    "underflow_frac": underflow,
                    "thread": threading.current_thread().name}
            else:
                st["watermark"] = max(st["watermark"], max_abs)
                st["samples"] += 1
        if verdict is not None and len(_violations) < _MAX_VIOLATIONS:
            _violations.append(verdict)
    if verdict is not None:
        _notify(verdict)


# ------------------------------------------------------------ witness API
def witness_enabled() -> bool:
    return _enabled


def set_witness(enabled: bool) -> bool:
    """Arm/disarm the witness; returns the previous state.  Mirrored
    from ``FLAGS_numerics_witness`` by the package flag hook."""
    global _enabled
    with _WLOCK:
        was = _enabled
        _enabled = bool(enabled)
    return was


def witness_reset() -> None:
    """Drop accumulated witness state (per-name watermarks, counters,
    violations)."""
    with _WLOCK:
        _state.clear()
        del _violations[:]


def witness_report() -> dict:
    """The full witness state: per-name watermarks/counters and the
    recorded NM1104/NM1105 violations."""
    with _WLOCK:
        return {
            "enabled": _enabled,
            "tensors": {k: dict(v) for k, v in _state.items()},
            "violations": [dict(v) for v in _violations],
        }


def witness_stats() -> dict:
    """Scalar summary for the ``numerics`` metrics collector."""
    with _WLOCK:
        nonfinite = sum(1 for v in _violations if v["code"] == "NM1104")
        collapses = sum(1 for v in _violations if v["code"] == "NM1105")
        return {
            "witness_enabled": _enabled,
            "tensors_watched": len(_state),
            "checks": sum(st["checks"] for st in _state.values()),
            "nonfinite": nonfinite,
            "range_collapses": collapses,
        }


def witness_violations() -> List[dict]:
    """The recorded NM1104/NM1105 verdicts (copies)."""
    with _WLOCK:
        return [dict(v) for v in _violations]


# arm from the env/flag default at import (the flag hook in
# observability/__init__ keeps runtime set_flags() in sync)
_enabled = bool(get_flag("numerics_witness"))
