"""paddle_tpu_torch.reliability — fault injection, retries and circuit
breakers for the serving tiers, and preemption-safe train snapshots (port
of ``paddle_tpu.reliability``).

- :mod:`faults`: the deterministic, seedable :class:`FaultInjector` with
  named sites (the decode program call, the KV pool's page allocation and
  commit, the checkpoint's and the snapshot's commit, the prefetch
  thread's host-to-device copy, ``GradScaler``'s unscaled gradients, a
  collective's entry and the comm watchdog's task),
  configured via
  ``FLAGS_fault_inject="site:rate:kind"``; one global read when off.
- :mod:`policy`: :class:`RetryPolicy` (bounded attempts, exponential
  backoff, deadline budget, transient-vs-fatal classifier) around the
  decode program call, and the :class:`CircuitBreaker` /
  :class:`BreakerBoard` that flip a tenant to ``degraded`` (``/healthz``
  lists it; admission sheds its load with reason ``"circuit"``).
- :mod:`snapshot`: the :class:`TrainSnapshotter` that ``Model.fit`` drives
  (``snapshot_dir=``, ``resume=``, SIGTERM): atomic, rolling snapshots
  from which a new process continues the loss stream bit for bit.
"""
from __future__ import annotations

from .faults import (SITES, FaultInjection, FaultInjector, FaultPlan, active,
                     arm, corrupt_bytes, disarm, fault_point)
from .policy import BreakerBoard, CircuitBreaker, RetryPolicy, default_classify
from .snapshot import TrainSnapshotter

__all__ = [
    "BreakerBoard", "CircuitBreaker", "FaultInjection", "FaultInjector",
    "FaultPlan", "RetryPolicy", "SITES", "active", "arm", "corrupt_bytes",
    "TrainSnapshotter", "default_classify", "disarm", "fault_point",
]

# FLAGS_fault_inject set in the environment arms the injector at import;
# runtime set_flags({"fault_inject": ...}) arms and disarms through the hook
from .faults import _install_flag_hook as _hook  # noqa: E402

_hook()
del _hook
