"""Device prefetch: overlap the host-to-device copy of the next batches with
the training step (port of ``paddle_tpu/io/device_prefetch.py``).

:class:`DeviceLoader` wraps any iterable of collated host batches and keeps
a bounded queue of ``depth`` batches already on the card ahead of the
loop. A background thread takes each batch, pins its tensors (page-locked
host memory, so the copy is a DMA that does not wait for the host) and
queues their copies on a side CUDA stream, then records an event there.
The loop's ``next()`` makes its own stream wait for that event and marks
each tensor as used on its stream (``record_stream``), so

- the step (an eager call, or a ``CompiledFunction`` that copies the batch
  into its graph's static inputs and replays on the loop's stream) reads
  the batch only after its copy landed;
- the caching allocator reuses the batch's memory only after the loop's
  stream is done with it, although the side stream allocated it;
- the pinned host memory is released only once its copy has run (torch's
  host allocator records the copy's stream).

A failure in the thread, an injected ``io.h2d`` fault included, is put on
the queue and raised by the loop's ``next()``: the consumer (``Model.fit``)
gets the error instead of waiting forever. Waits and issue times go to
``profiler.pipeline_stats`` (``h2d_wait_us``, ``h2d_issue_us``).

On the CPU (``device="cpu"``) the batches are passed through as CPU
tensors, the thread and the queue unchanged. With ``sharding="auto"`` (the
default) and a mesh whose ``dp`` degree is above one
(``distributed.init_parallel_env``), each tensor whose leading dimension
the degree divides is cut to this rank's contiguous rows before its copy,
by ``distributed.shard_batch``'s rule: the shard the JAX package places on
device ``r`` under ``P("dp")``. Other tensors, and every tensor with
``sharding=None``, go whole.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.tracing import tracer
from ..profiler.pipeline import pipeline_stats
from ..reliability.faults import fault_point

__all__ = ["DeviceLoader"]

_SENTINEL = object()


def _map_tensors(fn, node):
    """``node`` (tuples, lists, dicts of tensors, numpy arrays and other
    leaves) with ``fn`` applied to each tensor, numpy arrays as tensors."""
    if isinstance(node, np.ndarray):
        node = torch.from_numpy(node)
    if isinstance(node, torch.Tensor):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_tensors(fn, v) for k, v in node.items()}
    if isinstance(node, (tuple, list)):
        return type(node)(_map_tensors(fn, v) for v in node)
    return node


def _tensors(node) -> list:
    out = []
    _map_tensors(lambda t: out.append(t) or t, node)
    return out


class _PrefetchIter:
    """One pass over the inner iterable with a staging thread."""

    def __init__(self, inner_iter, depth: int, device: torch.device,
                 rows=None):
        self._inner = inner_iter
        self._device = device
        # (rank's dp coordinate, dp degree) when batches are cut by rows
        self._rows = rows
        self._cuda = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self._cuda else None
        self._q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="io.prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """A bounded put that stays responsive to ``close()``; False once
        shut down."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _cut(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's rows of ``t`` when batches are cut and its leading
        dimension splits over the ``dp`` degree."""
        if self._rows is None or t.ndim == 0:
            return t
        idx, n = self._rows
        if t.shape[0] % n:
            return t
        rows = t.shape[0] // n
        return t.narrow(0, idx * rows, rows).contiguous()

    def _to_device(self, batch):
        """The batch on the device, its copies queued on the side stream,
        and the event after them (None on the CPU)."""
        if self._rows is not None:
            batch = _map_tensors(self._cut, batch)
        if not self._cuda:
            return _map_tensors(lambda t: t, batch), None
        with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
            moved = _map_tensors(
                lambda t: t.pin_memory().to(self._device, non_blocking=True)
                if t.device.type == "cpu" else t.to(self._device), batch)
            done = torch.cuda.Event()
            done.record(self._stream)
        return moved, done

    def _worker(self):
        try:
            for batch in self._inner:
                if self._stop.is_set():
                    return
                t0 = time.perf_counter()
                # the injected h2d fault (site "io.h2d"): it rides the
                # wall below into the queue, so the consumer gets the error
                fault_point("io.h2d")
                item = self._to_device(batch)
                dt = time.perf_counter() - t0
                pipeline_stats.add_h2d_issue(dt)
                if tracer.enabled:
                    tracer.emit("h2d.issue", t0, dt, track="io.prefetch")
                if not self._put(item):
                    return
        except BaseException as e:  # raised by the consumer's next()
            self._put(e)
            return
        self._put(_SENTINEL)

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        dt = time.perf_counter() - t0
        pipeline_stats.add_h2d_wait(dt)
        if tracer.enabled:
            tracer.emit("prefetch.wait", t0, dt, track="train_loop")
        if item is _SENTINEL:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        batch, done = item
        if done is not None:
            stream = torch.cuda.current_stream(self._device)
            stream.wait_event(done)
            for t in _tensors(batch):
                t.record_stream(stream)
        return batch

    def __iter__(self):
        return self

    def close(self):
        """Stop the staging thread and drop the queued batches. Safe to call
        again; called at exhaustion and on finalization."""
        self._stop.set()
        while True:  # unblock a thread waiting on a full queue
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=5)
        inner_close = getattr(self._inner, "close", None)
        if inner_close is not None:
            inner_close()

    def __del__(self):
        try:
            if hasattr(self, "_thread"):
                self.close()
        except Exception:  # at interpreter exit the modules may be gone
            pass


class DeviceLoader:
    """Iterable wrapper staging batches onto the device ahead of the loop.

    ``loader`` is any re-iterable of collated batches (a ``DataLoader``, a
    list of batch tuples). ``depth`` batches are kept in flight (2 =
    double buffering). ``device`` is where they go (default CUDA; raises
    without CUDA unless the CPU is asked for). ``sharding``: ``"auto"``
    (the default) cuts each batch to this rank's rows over the installed
    mesh's ``dp`` axis when its degree is above one; None (or ``"none"``)
    places each batch whole."""

    def __init__(self, loader: Any, depth: int = 2,
                 sharding: Optional[str] = "auto", *,
                 device=DEFAULT_DEVICE):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if sharding not in (None, "auto", "none"):
            raise ValueError(f"DeviceLoader(sharding={sharding!r}): use "
                             f"'auto' or None")
        self.loader = loader
        self.depth = depth
        self.sharding = sharding or "none"
        self.device = resolve_device(device)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0):
        """A prefetching iterator from batch ``start_batch`` on, through the
        inner loader's index-level cursor when it has one
        (``DataLoader.iter_from``), else by consuming."""
        start = int(start_batch)
        if start and hasattr(self.loader, "iter_from"):
            inner = self.loader.iter_from(start)
        else:
            inner = iter(self.loader)
            for _ in range(start):
                next(inner)
        return _PrefetchIter(inner, self.depth, self.device,
                             self._dp_rows())

    def _dp_rows(self):
        """(this rank's dp coordinate, the dp degree) when batches are cut,
        else None."""
        if self.sharding != "auto":
            return None
        from ..distributed import env as dist_env

        env = dist_env.instance()
        if env.mesh is None or env.axis_degrees.get("dp", 1) == 1:
            return None
        return (env.mesh.coords(env.rank)["dp"], env.axis_degrees["dp"])

    def set_epoch(self, epoch: int):
        """Pass the epoch to a ``set_epoch``-aware inner loader."""
        hook = getattr(self.loader, "set_epoch", None)
        if hook is not None:
            hook(epoch)

    def __len__(self):
        return len(self.loader)
