"""DataLoader (port of ``paddle_tpu/io/dataloader.py``; reference:
python/paddle/io/reader.py DataLoader, dataloader/dataloader_iter.py).

Batches come out as CPU ``torch.Tensor`` s (``default_collate_fn``); the
card is reached through ``device_prefetch=N`` (``io/device_prefetch.py``),
which stages N batches onto it from a side stream ahead of the loop, or by
the consumer (``Model.train_batch`` moves a host batch to its model).

Workers:

- ``num_workers=0``: the batches are fetched and collated in the caller's
  thread;
- ``worker_mode="process"`` (the default): ``num_workers`` worker
  processes, forked by the standard library's fork server, a process
  that imported this module once and never initialised CUDA (a child
  forked from a process that has initialised CUDA cannot use it, and a
  worker must not touch the card anyway; spawning each worker anew would
  import torch again every epoch, seconds on the card's host). Worker w
  takes batches w, w+W, 2W+w, ... of the epoch's index
  list, fetches and collates them into numpy trees and sends them through
  its own bounded queue; the loop reads the queues in turn, which keeps
  the order with no reorder buffer, and turns each batch into tensors in
  its own process. The dataset, the collate function and
  ``worker_init_fn`` must pickle. At each epoch's start the loop draws a
  seed from the process-wide host generator (``paddle.seed``'s), and
  worker w seeds its own copy of that generator with it plus w before
  ``worker_init_fn``: the random transforms built without a generator
  draw another stream in each worker and each epoch, the same ones under
  one seed. The JAX package moves these batches
  through its native shared-memory ring and runs threads by default; the
  port uses the standard library's queues and runs processes, as torch's
  loader does;
- ``worker_mode="thread"``: ``num_workers`` threads share the index
  iterator, and a sequence-numbered reorder buffer keeps the order, as in
  the JAX package.

``iter_from(k)`` starts an epoch at batch k at the index level (no sample
of the skipped prefix is fetched) for map-style datasets, in every worker
mode; ``set_epoch`` pins the shuffle to the epoch.
"""
from __future__ import annotations

import itertools
import pickle
import queue
import threading
import time
import traceback
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..base import global_state
from ..base.flags import get_flag
from ..device import DEFAULT_DEVICE, resolve_device
from ..observability.locks import named_lock
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler

__all__ = ["DataLoader", "WorkerInfo", "default_collate_fn",
           "default_convert_fn", "get_worker_info", "stop_fork_server"]

_worker_info = threading.local()

# seconds the loop waits for a process worker's next batch before it
# calls the worker lost (the JAX ring's pop timeout)
_WORKER_TIMEOUT_S = 300.0


@dataclass
class WorkerInfo:
    id: int
    num_workers: int
    dataset: Any


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a worker: its shard info (reference get_worker_info); None in
    the loop's own thread."""
    return getattr(_worker_info, "info", None)


def default_collate_fn(batch):
    """Stack a list of samples into batched CPU tensors (reference
    dataloader/collate.py::default_collate_fn): numpy arrays and tensors
    stack, ints become int64, floats float32, dicts and sequences recurse."""
    sample = batch[0]
    if isinstance(sample, torch.Tensor):
        return torch.stack([s.cpu() for s in batch])
    if isinstance(sample, np.ndarray):
        return torch.from_numpy(np.stack(batch))
    if isinstance(sample, (int, np.integer)):
        return torch.from_numpy(np.asarray(batch, dtype=np.int64))
    if isinstance(sample, (float, np.floating)):
        return torch.from_numpy(np.asarray(batch, dtype=np.float32))
    if isinstance(sample, dict):
        return {k: default_collate_fn([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(default_collate_fn(list(fields)) for fields in zip(*batch))
    raise TypeError(f"batch data can not be a {type(sample)}")


def default_convert_fn(batch):
    """numpy arrays in ``batch`` as CPU tensors; tensors and other leaves
    as they are."""
    if isinstance(batch, np.ndarray):
        return torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch
    if isinstance(batch, dict):
        return {k: default_convert_fn(v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return tuple(default_convert_fn(v) for v in batch)
    return batch


def _numpy_collate(batch):
    """The process worker's collate: numpy trees, which the loop turns into
    tensors (``default_convert_fn``)."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, np.integer)):
        return np.asarray(batch, dtype=np.int64)
    if isinstance(sample, (float, np.floating)):
        return np.asarray(batch, dtype=np.float32)
    if isinstance(sample, dict):
        return {k: _numpy_collate([s[k] for s in batch]) for k in sample}
    if isinstance(sample, (tuple, list)):
        return tuple(_numpy_collate(list(fields)) for fields in zip(*batch))
    if isinstance(sample, torch.Tensor):
        return np.stack([s.numpy() for s in batch])
    raise TypeError(f"batch data can not be a {type(sample)}")


def _batches(loader: "DataLoader", skip: int):
    """The epoch's index batches from ``skip`` on."""
    it = iter(loader.batch_sampler)
    return itertools.islice(it, skip, None) if skip else it


class _MapIter:
    """Iterator over a map dataset in the loop's thread, or over thread
    workers with a reorder buffer. ``skip`` drops the first batches at the
    index level."""

    def __init__(self, loader: "DataLoader", skip: int = 0):
        self.loader = loader
        self.batch_iter = enumerate(_batches(loader, skip))
        self.lock = named_lock("io.dataloader.batch_iter")
        self.n_workers = max(loader.num_workers, 0)
        if self.n_workers:
            depth = loader.prefetch_factor * self.n_workers
            self.out_q: "queue.Queue" = queue.Queue()
            self.reorder = {}
            self.next_seq = 0
            self.done_workers = 0
            self.threads = [
                threading.Thread(target=self._worker, args=(i,), daemon=True)
                for i in range(self.n_workers)
            ]
            self.sem = threading.Semaphore(depth)
            for t in self.threads:
                t.start()

    def _fetch(self, indices):
        ds = self.loader.dataset
        samples = [ds[i] for i in indices]
        return self.loader.collate_fn(samples)

    def _worker(self, wid):
        _worker_info.info = WorkerInfo(wid, self.n_workers, self.loader.dataset)
        if self.loader.worker_init_fn is not None:
            self.loader.worker_init_fn(wid)
        while True:
            self.sem.acquire()
            with self.lock:
                try:
                    seq, indices = next(self.batch_iter)
                except StopIteration:
                    seq = None
            if seq is None:
                # the end-of-epoch sentinel goes out after the iterator's
                # lock is released
                self.out_q.put((None, None))
                return
            try:
                self.out_q.put((seq, self._fetch(indices)))
            except BaseException as e:  # handed to the consumer, raised there
                self.out_q.put((seq, e))

    def __next__(self):
        if not self.n_workers:
            _, indices = next(self.batch_iter)
            return self._fetch(indices)
        while True:
            if self.next_seq in self.reorder:
                item = self.reorder.pop(self.next_seq)
                self.next_seq += 1
                self.sem.release()
                if isinstance(item, BaseException):
                    raise item
                return item
            if self.done_workers == self.n_workers and not self.reorder:
                raise StopIteration
            seq, item = self.out_q.get()
            if seq is None:
                self.done_workers += 1
                continue
            self.reorder[seq] = item

    def __iter__(self):
        return self


def stop_fork_server() -> None:
    """Stop the standard library's fork server that the worker processes
    are forked from, and reap it; it would otherwise outlive the loaders
    until this process exits. An epoch with worker processes starts it
    again."""
    from multiprocessing import forkserver

    forkserver._forkserver._stop()


def _process_worker(dataset, collate_fn, batches, out_q, stop, wid,
                    n_workers, worker_init_fn, host_seed):
    """One worker process: seed its host generator, then fetch, collate
    and send its batches, then ``None``; a failure is sent as
    ``("error", traceback)``."""
    _worker_info.info = WorkerInfo(wid, n_workers, dataset)
    global_state.host_random().seed(host_seed + wid)
    try:
        if worker_init_fn is not None:
            worker_init_fn(wid)
        collate = (_numpy_collate if collate_fn is default_collate_fn
                   else collate_fn)
        for indices in batches:
            if stop.is_set():
                return
            batch = collate([dataset[i] for i in indices])
            # pickled here, not by the queue's feeder thread, so a batch
            # that cannot pickle fails in this try and reaches the loop
            out_q.put(("batch", pickle.dumps(batch, protocol=4)))
    except BaseException:  # sent to the loop, which raises it
        out_q.put(("error", traceback.format_exc()))
        return
    out_q.put(None)


class _ProcessMapIter:
    """Worker processes over one epoch of a map dataset (see the module
    docstring). Worker w owns queue w; the loop reads the queues in turn."""

    def __init__(self, loader: "DataLoader", skip: int = 0):
        import multiprocessing

        self.loader = loader
        self.n_workers = loader.num_workers
        batches = list(_batches(loader, skip))
        # fork server: workers fork from a process that imported this
        # module once and never touched CUDA
        ctx = multiprocessing.get_context("forkserver")
        ctx.set_forkserver_preload([__name__])
        self.stop = ctx.Event()
        self.queues = [ctx.Queue(maxsize=loader.prefetch_factor)
                       for _ in range(self.n_workers)]
        self.procs = []
        host_seed = global_state.host_random().getrandbits(62)
        for w in range(self.n_workers):
            p = ctx.Process(
                target=_process_worker,
                args=(loader.dataset, loader.collate_fn,
                      batches[w::self.n_workers], self.queues[w], self.stop,
                      w, self.n_workers, loader.worker_init_fn, host_seed),
                daemon=True)
            p.start()
            self.procs.append(p)
        self.cursor = 0
        self.done = [False] * self.n_workers
        self.remaining = len(batches)
        self.timeout = float(loader.timeout) or _WORKER_TIMEOUT_S

    def __next__(self):
        while True:
            if self.remaining == 0 or all(self.done):
                self.close()
                raise StopIteration
            w = self.cursor % self.n_workers
            self.cursor += 1
            if self.done[w]:
                continue
            try:
                msg = self.queues[w].get(timeout=self.timeout)
            except queue.Empty:
                self.close()
                raise RuntimeError(f"DataLoader worker {w} sent nothing for "
                                   f"{self.timeout:.0f} s") from None
            if msg is None:
                self.done[w] = True
                continue
            kind, payload = msg
            if kind == "error":
                self.close()
                raise RuntimeError(f"DataLoader worker {w} failed:\n{payload}")
            self.remaining -= 1
            return default_convert_fn(pickle.loads(payload))

    def __iter__(self):
        return self

    def close(self):
        """Stop the workers: each is asked to stop, its queue drained so a
        blocked send returns, then joined (terminated after 5 s)."""
        if not getattr(self, "procs", None):
            return
        self.stop.set()
        deadline = time.monotonic() + 5.0
        for q, p in zip(self.queues, self.procs):
            while p.is_alive() and time.monotonic() < deadline:
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    p.join(timeout=0.05)
            if p.is_alive():
                p.terminate()
            p.join(timeout=5)
        for q in self.queues:
            q.close()
            q.cancel_join_thread()
        self.procs, self.queues = [], []

    def __del__(self):
        try:
            self.close()
        except Exception:  # at interpreter exit the modules may be gone
            pass


class _IterableIter:
    def __init__(self, loader: "DataLoader"):
        self.loader = loader
        _worker_info.info = WorkerInfo(0, max(loader.num_workers, 1), loader.dataset)
        self.stream = iter(loader.dataset)
        _worker_info.info = None

    def __next__(self):
        bs = self.loader.batch_size
        if bs is None:
            return self.loader.collate_fn(next(self.stream))
        batch = list(itertools.islice(self.stream, bs))
        if not batch or (self.loader.drop_last and len(batch) < bs):
            raise StopIteration
        return self.loader.collate_fn(batch)

    def __iter__(self):
        return self


class DataLoader:
    """Batched, optionally shuffled loader over a Dataset, with worker
    processes or threads and an optional device prefetch.

    The reference signature, plus ``worker_mode`` (``"process"`` or
    ``"thread"``), ``device_prefetch`` (batches staged on the card ahead
    of the loop; ``None`` defers to ``FLAGS_device_prefetch``, 0 disables)
    and ``device``, where the prefetch stages them (default CUDA; raises
    without CUDA unless the CPU is asked for). ``return_list`` defaults
    True: the static-graph feed dict has no counterpart here."""

    def __init__(
        self,
        dataset: Dataset,
        feed_list=None,
        places=None,
        return_list: bool = True,
        batch_sampler: Optional[BatchSampler] = None,
        batch_size: Optional[int] = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        collate_fn: Optional[Callable] = None,
        num_workers: int = 0,
        use_buffer_reader: bool = True,
        prefetch_factor: int = 2,
        use_shared_memory: bool = True,
        timeout: int = 0,
        worker_init_fn: Optional[Callable] = None,
        persistent_workers: bool = False,
        worker_mode: str = "process",
        device_prefetch: Optional[int] = None,
        *,
        device=DEFAULT_DEVICE,
    ):
        self.dataset = dataset
        self.return_list = return_list
        self.device_prefetch = (int(get_flag("device_prefetch"))
                                if device_prefetch is None
                                else int(device_prefetch))
        self.device = (resolve_device(device) if self.device_prefetch > 0
                       else None)
        self.num_workers = num_workers if use_buffer_reader else 0
        self.prefetch_factor = max(prefetch_factor, 1)
        self.worker_init_fn = worker_init_fn
        self.timeout = timeout
        if worker_mode not in ("thread", "process"):
            raise ValueError("worker_mode must be 'thread' or 'process'")
        self.worker_mode = worker_mode
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            if batch_sampler is not None or shuffle:
                raise ValueError("IterableDataset does not support batch_sampler/shuffle")
            self.batch_sampler = None
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.collate_fn = collate_fn or (default_collate_fn if batch_size is not None else default_convert_fn)
            return
        if batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = getattr(batch_sampler, "batch_size", None)
            self.drop_last = getattr(batch_sampler, "drop_last", False)
        else:
            if batch_size is None:
                raise ValueError("batch_size=None requires an explicit batch_sampler")
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle, batch_size=batch_size, drop_last=drop_last)
        self.collate_fn = collate_fn or default_collate_fn

    def set_epoch(self, epoch: int):
        """Pass the epoch to a ``set_epoch``-aware batch sampler, so the
        shuffle order is a pure function of the epoch: what lets a resumed
        process (``iter_from``) land on the exact batch its predecessor
        stopped at."""
        hook = getattr(self.batch_sampler, "set_epoch", None)
        if hook is not None:
            hook(epoch)

    def __iter__(self):
        return self.iter_from(0)

    def iter_from(self, start_batch: int = 0):
        """Iterate from batch ``start_batch`` on. Map-style datasets skip
        at the index level (no sample of the skipped prefix is fetched);
        iterable datasets consume the stream to advance it."""
        start = int(start_batch)
        if self._iterable:
            it = _IterableIter(self)
            for _ in range(start):
                next(it)
        elif self.worker_mode == "process" and self.num_workers > 0:
            it = _ProcessMapIter(self, skip=start)
        else:
            it = _MapIter(self, skip=start)
        if self.device_prefetch > 0:
            from .device_prefetch import _PrefetchIter

            return _PrefetchIter(it, self.device_prefetch, self.device)
        return it

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)
