"""KV caches on the device (port of ``paddle_tpu/serving/kv_cache.py``).

Two residency modes, each one pair of device buffers allocated once, at
engine construction, and never resized:

- :class:`KVSlotPool` — ``[layers, max_slots+1, max_seq, heads,
  head_dim]``: one full ``max_seq`` row per request. Slot ``max_slots``
  is the pad slot: bucket-padding lanes write their garbage there.
- :class:`KVPagePool` — ``[layers, num_pages+1, page_size, heads,
  head_dim]``: a request holds only the pages its live tokens fill,
  named by its block table. Page 0 is the pad page: padding lanes and
  table padding point there, so writes and gathers need no mask.

Both hold ``float32`` or ``bfloat16`` (``kv_dtype``): rows are cast to
the pool's dtype on write, and the programs cast gathers back to the
model's dtype.

Where the JAX package updates the pool functionally and donates the old
buffers so XLA aliases the new ones onto them, the port updates the
buffers in place: the write functions below mutate ``cache`` and return
it. Every index is a tensor, so the writes run inside a CUDA graph.
Host-side bookkeeping (free lists, lengths, utilization) lives in the
pool classes, under the ``named_lock("serving.kv_pool")``; the pools set
the ``serving.kv_slots_in_use``, ``serving.kv_pages_in_use`` and
``serving.kv_page_utilization`` gauges, and carry the fault points
``kv.page_alloc`` (:meth:`KVPagePool.alloc`) and ``kv.commit``
(``commit``, a program call's commit point).
"""
from __future__ import annotations

from typing import Iterable, List, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.locks import named_lock
from ..observability.metrics import registry
from ..reliability.faults import fault_point

__all__ = ["KVSlotPool", "KVPagePool", "KV_DTYPES", "write_prompt",
           "write_prompt_batch", "append_token", "write_prompt_pages",
           "append_token_paged", "gather_pages"]

#: the pool dtypes a serving engine takes (``kv_dtype``)
KV_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pool_dtype(dtype: str) -> torch.dtype:
    if dtype not in KV_DTYPES:
        raise ValueError(f"kv_dtype must be one of {sorted(KV_DTYPES)}, "
                         f"got {dtype!r}")
    return KV_DTYPES[dtype]


# ------------------------------------------------------------ slot writes
def write_prompt(cache, slot, rows):
    """Write one prompt's K (or V) rows into one slot: ``rows`` is
    ``[layers, S, heads, dim]``, ``slot`` a one-element integer tensor (a
    tensor index, so the write needs no host read)."""
    return write_prompt_batch(cache, slot.reshape(1), rows[:, None])


def write_prompt_batch(cache, slot_ids, rows):
    """Batched prefill write: ``rows`` is ``[layers, B, S, heads, dim]``,
    ``slot_ids`` ``[B]``. Rows past a lane's real prompt carry garbage,
    which decode overwrites at position ``len`` before any step attends
    to it; padding lanes all name the pad slot."""
    S = rows.shape[2]
    cache[:, slot_ids.long(), :S] = rows.to(cache.dtype)
    return cache


def append_token(cache, layer, slot_ids, positions, rows):
    """One decode step's write for one layer: ``rows`` is ``[B, heads,
    dim]`` landing at ``(layer, slot_ids[b], positions[b])``. Pad lanes
    point at the pad slot."""
    cache[layer].index_put_((slot_ids.long(), positions.long()),
                            rows.to(cache.dtype))
    return cache


# ----------------------------------------------------------- paged writes
def write_prompt_pages(cache, tables, rows):
    """Batched paged prefill write: ``rows`` is ``[layers, B, T*ps, heads,
    dim]`` (prompt K/V padded up to whole pages), ``tables`` the ``[B, T]``
    integer block table. Table entries past a lane's real pages are 0, so
    garbage rows land in the pad page and never touch live state."""
    L, B, _, H, D = rows.shape
    T = tables.shape[1]
    ps = cache.shape[2]
    paged = rows.to(cache.dtype).reshape(L, B, T, ps, H, D)
    layers = torch.arange(L, device=cache.device)[:, None, None]
    return cache.index_put_((layers, tables.long()[None]), paged)


def append_token_paged(cache, layer, pages, offsets, rows):
    """One decode step's write for one layer: ``rows`` is ``[B, heads,
    dim]`` landing at ``(layer, pages[b], offsets[b])``; verify passes
    ``[B, K]`` pages and offsets and ``[B, K, heads, dim]`` rows. Pad lanes
    carry page 0."""
    cache[layer].index_put_((pages.long(), offsets.long()),
                            rows.to(cache.dtype))
    return cache


def gather_pages(cache, layer, tables):
    """A batch's contiguous K (or V) view ``[B, T*ps, heads, dim]``,
    gathered from the page array through the block tables; column ``j``
    is token position ``j``."""
    B, T = tables.shape
    ps, H, D = cache.shape[2], cache.shape[3], cache.shape[4]
    return cache[layer][tables.long()].reshape(B, T * ps, H, D)


class KVSlotPool:
    """Free-list slot allocator over one device-resident K/V buffer pair
    shaped ``[layers, max_slots+1, max_seq, heads, head_dim]``.

    ``alloc``/``release`` run on the scheduler thread under a lock; the
    buffers are updated in place by the programs, so
    :meth:`device_bytes` never changes after construction (recorded by
    :meth:`mark_warm` for the serving report). ``occupancy`` and
    ``occupancy_peak`` gauge the slots in use."""

    def __init__(self, num_layers: int, max_slots: int, max_seq: int,
                 num_heads: int, head_dim: int, dtype="float32", *,
                 device=DEFAULT_DEVICE):
        if max_slots < 1:
            raise ValueError("KVSlotPool needs at least one slot")
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.max_slots = int(max_slots)
        self.max_seq = int(max_seq)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        dt = _pool_dtype(dtype)
        # +1: the pad slot, which absorbs bucket-padding lanes' writes
        shape = (self.num_layers, self.max_slots + 1, self.max_seq,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        self.lengths = np.zeros(self.max_slots, np.int32)  # host-side
        # low slot ids hand out first: pop() from the tail
        self._free: List[int] = list(range(self.max_slots - 1, -1, -1))
        self._lock = named_lock("serving.kv_pool")
        self.bytes_at_warmup: Optional[int] = None
        self.occupancy = 0
        self.occupancy_peak = 0
        with self._lock:
            self._gauge_locked()

    @property
    def pad_slot(self) -> int:
        """The slot padding lanes write to (never allocated)."""
        return self.max_slots

    def _gauge_locked(self) -> None:
        self.occupancy = self.max_slots - len(self._free)
        self.occupancy_peak = max(self.occupancy_peak, self.occupancy)
        registry.gauge(
            "serving.kv_slots_in_use",
            "KV cache slots currently allocated to live decode sequences "
            "(capacity = the engine's max_slots)").set(self.occupancy)

    def alloc(self) -> int:
        """Borrow a free slot (its length resets to 0); raises
        ``RuntimeError`` when the pool is exhausted: the scheduler gates
        admission on :meth:`free_count`."""
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    f"KV slot pool exhausted ({self.max_slots} slots in "
                    "use); admission must wait for a retirement")
            slot = self._free.pop()
            self.lengths[slot] = 0
            self._gauge_locked()
        return slot

    def release(self, slot: int) -> None:
        """Return a slot to the free list (range and idempotence
        guarded)."""
        with self._lock:
            slot = int(slot)
            if not 0 <= slot < self.max_slots:
                raise ValueError(f"slot {slot} out of range")
            if slot in self._free:
                raise ValueError(f"slot {slot} is already free")
            self.lengths[slot] = 0
            self._free.append(slot)
            self._gauge_locked()

    def in_use(self) -> int:
        with self._lock:
            return self.max_slots - len(self._free)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def commit(self) -> None:
        """A program call's commit point. The programs write the pool in
        place, so there is nothing to install (the JAX pool's ``commit``
        takes the functional outputs); an injected ``kv.commit`` fault
        fails the step here, after its call and before its tokens are
        absorbed. The decode fault wall then fails the step's lanes and
        releases their KV state: the rows the call wrote belong to those
        lanes or the pad, and a later owner writes them before it reads
        them."""
        fault_point("kv.commit")

    def device_bytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def mark_warm(self) -> None:
        """Record the footprint at the end of engine warmup."""
        self.bytes_at_warmup = self.device_bytes()


class KVPagePool:
    """Free-list page allocator over one device-resident K/V buffer pair.

    ``alloc``/``release`` run on the scheduler thread under a lock;
    :meth:`device_bytes` never changes after construction (the buffers
    are updated in place), which :meth:`mark_warm` records for the
    serving report."""

    def __init__(self, num_layers: int, num_pages: int, page_size: int,
                 num_heads: int, head_dim: int, dtype="float32", *,
                 device=DEFAULT_DEVICE):
        if num_pages < 1:
            raise ValueError("KVPagePool needs at least one page")
        if page_size < 1 or (page_size & (page_size - 1)):
            raise ValueError(
                f"page_size must be a power of two, got {page_size}")
        self.device = resolve_device(device)
        self.num_layers = int(num_layers)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        dt = _pool_dtype(dtype)
        # +1: page 0 is the pad page — never allocated, absorbs garbage
        shape = (self.num_layers, self.num_pages + 1, self.page_size,
                 self.num_heads, self.head_dim)
        self.k = torch.zeros(shape, dtype=dt, device=self.device)
        self.v = torch.zeros(shape, dtype=dt, device=self.device)
        # low page ids hand out first: pop() from the tail
        self._free: List[int] = list(range(self.num_pages, 0, -1))
        self._lock = named_lock("serving.kv_pool")
        self.bytes_at_warmup: Optional[int] = None
        self._util_sum = 0.0
        self._util_min = 1.0
        self._util_samples = 0
        self._gauge_occupancy()

    def alloc(self, n: int = 1) -> List[int]:
        """Borrow ``n`` free pages; raises ``RuntimeError`` when the pool
        cannot cover the request (the scheduler sheds that one request).
        The ``kv.page_alloc`` fault point fires first, before the free
        list is touched."""
        fault_point("kv.page_alloc")
        with self._lock:
            if len(self._free) < n:
                raise RuntimeError(
                    f"KV page pool exhausted ({self.num_pages - len(self._free)}"
                    f"/{self.num_pages} pages in use, {n} requested); "
                    "admission must wait for a retirement")
            pages = [self._free.pop() for _ in range(n)]
        self._gauge_occupancy()
        return pages

    def release(self, pages: Iterable[int]) -> None:
        """Return a request's pages to the free list (idempotence and
        range guarded per page)."""
        with self._lock:
            for page in pages:
                page = int(page)
                if not 1 <= page <= self.num_pages:
                    raise ValueError(f"page {page} out of range")
                if page in self._free:
                    raise ValueError(f"page {page} is already free")
                self._free.append(page)
        self._gauge_occupancy()

    def in_use(self) -> int:
        with self._lock:
            return self.num_pages - len(self._free)

    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    def _gauge_occupancy(self) -> None:
        registry.gauge(
            "serving.kv_pages_in_use",
            "KV cache pages currently allocated to live decode sequences "
            "(capacity = the pool's num_pages)").set(self.in_use())

    def commit(self) -> None:
        """A program call's commit point (see :meth:`KVSlotPool.commit`)."""
        fault_point("kv.commit")

    def device_bytes(self) -> int:
        return (self.k.numel() * self.k.element_size()
                + self.v.numel() * self.v.element_size())

    def mark_warm(self) -> None:
        """Record the footprint at the end of engine warmup."""
        self.bytes_at_warmup = self.device_bytes()

    def note_utilization(self, live_tokens: int) -> None:
        """One page-utilization sample: live tokens over the token
        capacity of the pages in use (sampled each decode step)."""
        with self._lock:
            used = self.num_pages - len(self._free)
        if used <= 0:
            return
        util = min(1.0, float(live_tokens) / float(used * self.page_size))
        self._util_sum += util
        self._util_min = min(self._util_min, util)
        self._util_samples += 1
        registry.gauge(
            "serving.kv_page_utilization",
            "live tokens / token capacity of in-use KV pages (low values "
            "mean fragmentation)").set(util)

    def utilization_report(self) -> dict:
        n = self._util_samples
        return {
            "samples": n,
            "mean": (self._util_sum / n) if n else 1.0,
            "min": self._util_min if n else 1.0,
        }
