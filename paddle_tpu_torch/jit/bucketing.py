"""Shape bucketing: the rung ladders of the serving and training paths.

Port of ``powers_of_two_buckets``, ``bucket_for``, ``bucket_grid``,
``bucket_pair_for``, ``table_ladder``, ``assemble_bucket``,
``pad_to_bucket`` and ``BucketedFunction`` from
``paddle_tpu/jit/bucketing.py``. Each rung is one CUDA graph on the card:
decode prefill pads prompts to a seq rung and decode pads its batch and
block tables to rungs; the batch tier pads an assembled batch to a
(batch, seq) rung of its grid; a bucketed ``TrainStep`` pads each batch's
variable dims to a rung of the log₂ ladder (:class:`BucketedFunction`).
A request's arithmetic is then the same whatever batch it rides in.
``bucket_collate`` is the ``DataLoader`` side: a collate function that pads
each sample's variable axis to the batch's rung before stacking.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

__all__ = ["powers_of_two_buckets", "bucket_for", "bucket_grid",
           "bucket_pair_for", "table_ladder", "assemble_bucket",
           "pad_to_bucket", "BucketedFunction", "bucket_collate"]


def powers_of_two_buckets(min_len: int, max_len: int) -> List[int]:
    """[min, 2·min, …, ≥max] — the log₂ ladder."""
    buckets = []
    b = max(int(min_len), 1)
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(b)
    return buckets


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(f"length {n} exceeds largest bucket {buckets[-1]}")


def bucket_grid(batch_ladder: Sequence[int],
                seq_ladder: Sequence[int]) -> List[tuple]:
    """Every ``(batch, seq)`` rung pair of a two-axis ladder: the warmup
    set of a seq-dynamic serving program."""
    return [(int(b), int(s)) for b in batch_ladder for s in seq_ladder]


def bucket_pair_for(n: int, seq_len: int, batch_ladder: Sequence[int],
                    seq_ladder: Sequence[int]) -> tuple:
    """The two-axis rung of one request shape: ``n`` and ``seq_len``
    each round up their own ladder."""
    return bucket_for(n, batch_ladder), bucket_for(seq_len, seq_ladder)


def table_ladder(max_seq: int, page_size: int) -> List[int]:
    """The block-table-width ladder of a paged KV pool: powers of two
    from one page up to ``ceil(max_seq / page_size)`` pages. A decode
    step's gather reads the table rung's pages, so a short context pays a
    short gather."""
    if page_size < 1:
        raise ValueError(f"page_size must be >= 1, got {page_size}")
    max_pages = -(-int(max_seq) // int(page_size))
    return powers_of_two_buckets(1, max_pages)


def assemble_bucket(counts: Sequence[int], buckets: Sequence[int],
                    max_total: Optional[int] = None):
    """Batch assembly for the serving tier: given the FIFO sample counts of
    pending requests, how many leading requests to take and the rung to
    pad them to. Returns ``(k, bucket)`` (take ``counts[:k]``, pad their
    sum up to ``bucket``) or ``(0, None)`` when nothing is pending.

    Greedy FIFO fill up to ``max_total`` (default and ceiling: the top
    rung), then a free top-up: later requests that fit in the rung's
    padding ride along, still within ``max_total``. Nothing is taken
    ahead of an older request. A head larger than the cap raises
    ``ValueError``."""
    cap = min(int(max_total) if max_total else int(buckets[-1]),
              int(buckets[-1]))
    total = k = 0
    for n in counts:
        n = int(n)
        if n > cap:
            if k == 0:
                raise ValueError(
                    f"request of {n} samples exceeds the largest bucket "
                    f"({cap}); split it or raise FLAGS_serving_max_batch")
            break
        if total + n > cap:
            break
        total += n
        k += 1
    if k == 0:
        return 0, None
    bucket = bucket_for(total, buckets)
    for n in counts[k:]:
        if total + int(n) > bucket or total + int(n) > cap:
            break
        total += int(n)
        k += 1
    return k, bucket


def pad_to_bucket(value, axis: int, bucket: int, pad_value=0):
    """``value`` right-padded along ``axis`` up to ``bucket`` with
    ``pad_value``, on its own device and in its dtype (no host sync);
    ``value`` itself when already that size. A value that is not a tensor
    is made one first."""
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(value)
    n = v.shape[axis]
    if n == bucket:
        return value
    if n > bucket:
        raise ValueError(f"dim {n} larger than bucket {bucket}")
    shape = list(v.shape)
    shape[axis] = bucket - n
    return torch.cat([v, v.new_full(shape, pad_value)], dim=axis)


class BucketedFunction:
    """A :class:`~.functionalize.CompiledFunction` with pad-to-bucket on
    declared argument axes: each rung of the ladder is one signature, so
    one CUDA graph on the card.

    ``bucket_axes``: ``{arg_index: axis}``, the positional args with a
    variable dim. All declared dims share one bucket per call, the rung of
    the largest; ``pad_values`` gives each arg's fill (``ignore_index`` for
    labels, say). Masking the padding out of the loss is the caller's
    contract, as with any padded batch. The padding runs before the call,
    outside the graph. ``compiled_kw`` goes to the ``CompiledFunction``."""

    def __init__(self, fn: Callable, *, bucket_axes: Dict[int, int],
                 min_len: int, max_len: int,
                 pad_values: Optional[Dict[int, float]] = None,
                 buckets: Optional[Sequence[int]] = None,
                 static_key_fn=None, name=None, **compiled_kw):
        from .functionalize import CompiledFunction

        self.buckets = (list(buckets) if buckets
                        else powers_of_two_buckets(min_len, max_len))
        self.bucket_axes = dict(bucket_axes)
        self.pad_values = dict(pad_values or {})
        self._compiled = CompiledFunction(
            fn, static_key_fn=static_key_fn,
            name=name or getattr(fn, "__name__", "fn"), **compiled_kw)

    @property
    def num_compiled(self) -> int:
        """Rungs met so far (one cache entry each)."""
        return len(self._compiled._cache)

    @property
    def stats(self) -> dict:
        return self._compiled.stats

    def graph_counts(self) -> dict:
        return self._compiled.graph_counts()

    def audit_report(self) -> dict:
        report = self._compiled.audit_report()
        report["buckets"] = list(self.buckets)
        return report

    def __call__(self, *args, **kwargs):
        if self.bucket_axes:
            bucket = bucket_for(max(args[i].shape[axis] for i, axis
                                    in self.bucket_axes.items()),
                                self.buckets)
            args = list(args)
            for i, axis in self.bucket_axes.items():
                args[i] = pad_to_bucket(args[i], axis, bucket,
                                        self.pad_values.get(i, 0))
        return self._compiled(*args, **kwargs)


def bucket_collate(axis: int = 0, min_len: int = 16, max_len: int = 4096,
                   pad_value=0, buckets: Optional[Sequence[int]] = None,
                   base_collate=None):
    """DataLoader ``collate_fn`` factory: pads each sample's ``axis`` to the
    rung of the batch's longest, then stacks (``io.default_collate_fn``),
    so the steps downstream see at most the ladder's shapes. Non-numeric
    leaves and leaves without ``axis`` stack as they are. ``base_collate``
    is accepted and read nowhere, as in the JAX package."""
    import numpy as np

    ladder = (list(buckets) if buckets
              else powers_of_two_buckets(min_len, max_len))

    def collate(batch):
        from ..io.dataloader import default_collate_fn

        def pad_leaf(samples):
            arrs = [np.asarray(s) for s in samples]
            if arrs[0].ndim <= axis or not np.issubdtype(arrs[0].dtype,
                                                         np.number):
                return default_collate_fn(samples)
            b = bucket_for(max(a.shape[axis] for a in arrs), ladder)
            out = []
            for a in arrs:
                widths = [(0, 0)] * a.ndim
                widths[axis] = (0, b - a.shape[axis])
                out.append(np.pad(a, widths, constant_values=pad_value))
            return default_collate_fn(out)

        sample = batch[0]
        if isinstance(sample, (tuple, list)):
            return tuple(pad_leaf(list(f)) for f in zip(*batch))
        if isinstance(sample, dict):
            return {k: pad_leaf([s[k] for s in batch]) for k in sample}
        return pad_leaf(batch)

    return collate
