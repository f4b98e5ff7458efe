"""Shape bucketing: the rung ladders of the serving paths.

Port of ``powers_of_two_buckets``, ``bucket_for``, ``bucket_grid``,
``bucket_pair_for``, ``table_ladder`` and ``assemble_bucket`` from
``paddle_tpu/jit/bucketing.py``. Each rung is one CUDA graph on the card:
decode prefill pads prompts to a seq rung and decode pads its batch and
block tables to rungs; the batch tier pads an assembled batch to a
(batch, seq) rung of its grid. A request's arithmetic is then the same
whatever batch it rides in.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

__all__ = ["powers_of_two_buckets", "bucket_for", "bucket_grid",
           "bucket_pair_for", "table_ladder", "assemble_bucket"]


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
