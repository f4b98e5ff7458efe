"""Device-memory telemetry: boundary-only, sync-free watermark sampling
(port of ``paddle_tpu/observability/memory.py``).

The JAX sampler sums ``jax.live_arrays()`` and reads the backend
allocator's ``memory_stats()``. The port reads the CUDA caching
allocator's own counters, ``torch.cuda.memory_stats``: the bytes and the
blocks its tensors hold now and the peak bytes, per device. Those are host
counters the allocator keeps as it hands out and takes back memory, so a
sample copies nothing from the card and never waits for it: the train
loop's zero-host-sync steady state holds with sampling on. Devices whose
CUDA context was never created are not read (a read would create one); on
a CPU-only run the reading is empty.

Sampling happens only at step boundaries, every
``FLAGS_telemetry_memory_sample_every``-th one (0 disables). Gauges land
in the process registry (``memory.live_bytes``, ``memory.live_arrays``,
``memory.bytes_in_use`` and ``memory.peak_bytes_in_use`` by device); with
tracing on each sample also drops an instant on the ``memory`` track.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..base.flags import get_flag
from .locks import named_lock

__all__ = ["DeviceMemorySampler", "device_memory_stats", "sampler"]


def device_memory_stats() -> dict:
    """One sync-free reading: the bytes and the blocks the caching
    allocator's tensors hold over every initialized CUDA device, and per
    device the bytes in use and their peak."""
    out = {"live_bytes": 0, "live_arrays": 0, "devices": {}}
    if not torch.cuda.is_initialized():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        in_use = int(stats.get("allocated_bytes.all.current", 0))
        out["live_bytes"] += in_use
        out["live_arrays"] += int(stats.get("allocation.all.current", 0))
        out["devices"][str(i)] = {
            "bytes_in_use": in_use,
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0))}
    return out


class DeviceMemorySampler:
    """Throttled boundary sampler feeding the registry gauges.

    ``maybe_sample(boundary)`` is the loop's entry point: it counts calls
    and takes a real sample every ``FLAGS_telemetry_memory_sample_every``-th
    one (0 disables), one lock and one int otherwise."""

    def __init__(self, sample_every: Optional[int] = None):
        self._lock = named_lock("memory.sampler")
        self._calls = 0
        self.samples = 0
        self._sample_every = sample_every
        self.last: Optional[dict] = None

    def _every(self) -> int:
        if self._sample_every is not None:
            return int(self._sample_every)
        return int(get_flag("telemetry_memory_sample_every"))

    def maybe_sample(self, boundary: str = "step") -> Optional[dict]:
        every = self._every()
        if every <= 0:
            return None
        with self._lock:
            self._calls += 1
            if self._calls % every:
                return None
        return self.sample(boundary)

    def sample(self, boundary: str = "step") -> dict:
        """Unthrottled sample: read, publish the gauges, drop a trace
        instant."""
        from .metrics import registry
        from .tracing import tracer

        stats = device_memory_stats()
        registry.gauge(
            "memory.live_bytes",
            "bytes the caching allocator's tensors hold, all devices"
        ).set(stats["live_bytes"])
        registry.gauge(
            "memory.live_arrays",
            "blocks the caching allocator has handed out, all devices"
        ).set(stats["live_arrays"])
        in_use = registry.gauge(
            "memory.bytes_in_use", "caching allocator bytes in use")
        peak = registry.gauge(
            "memory.peak_bytes_in_use", "caching allocator high watermark")
        for dev_id, dev_stats in stats["devices"].items():
            in_use.set(dev_stats["bytes_in_use"], device=dev_id)
            peak.set(dev_stats["peak_bytes_in_use"], device=dev_id)
        tracer.instant("memory.sample", track="memory", boundary=boundary,
                       live_bytes=stats["live_bytes"],
                       live_arrays=stats["live_arrays"])
        with self._lock:
            self.samples += 1
            self.last = stats
        return stats


sampler = DeviceMemorySampler()
