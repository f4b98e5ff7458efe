"""AMP numeric debugging (port of ``paddle_tpu/amp/debugging.py``;
reference ``python/paddle/amp/debugging.py`` — TensorCheckerConfig :173,
enable_operator_stats_collection :481, compare_accuracy :595,
enable_tensor_checker :654).

One observer on the ``op_observer`` slot of ``core/hooks.py`` sees every op
the dispatcher runs, forward and backward, by its schema name
(``aten::mm``, ``paddle_tpu_torch::rms_norm_fwd``, a ``register_op`` op's
``paddle_tpu_torch_custom::<name>``), not by the JAX package's primitive
names; ``checked_op_list``/``skipped_op_list`` take these names.

- **tensor checker**: each op's float outputs scanned for NaN/Inf, with
  abort or log behaviour, op allow/skip lists, a step window and optional
  per-op output statistics (jsonl) for offline comparison. The counts and
  statistics are reduced on the device and read in one copy per output
  (the JAX package copies the whole output to the host);
- **operator stats**: per-op call counts bucketed by output dtype
  (bf16/fp16/fp32/other);
- **compare_accuracy**: pair two statistics dumps (an fp32 run and a bf16
  run of one script) and rank ops by divergence.

Tool-grade, as in the JAX package: every observed op waits for its
outputs. Ops under CUDA-graph capture are not observed (their values do
not exist yet).
"""
from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence, Tuple

import torch

from ..base.log import get_logger
from ..core import hooks

__all__ = ["DebugMode", "TensorCheckerConfig", "advance_step",
           "collect_operator_stats", "compare_accuracy",
           "disable_operator_stats_collection", "disable_tensor_checker",
           "enable_operator_stats_collection", "enable_tensor_checker",
           "get_operator_stats", "tensor_checker_results"]


class DebugMode(Enum):
    """reference amp/debugging.py DebugMode (the subset the JAX package
    keeps)."""
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    DUMP_ALL = 2  # dump stats for every checked op (for compare_accuracy)


@dataclass
class TensorCheckerConfig:
    """reference amp/debugging.py:173. ``debug_step`` is an inclusive
    (start, end) window over training steps; advance the counter with
    :func:`advance_step` (one call per optimizer step)."""
    enable: bool = False
    debug_mode: DebugMode = DebugMode.CHECK_NAN_INF_AND_ABORT
    output_dir: Optional[str] = None
    checked_op_list: Optional[Sequence[str]] = None
    skipped_op_list: Optional[Sequence[str]] = None
    debug_step: Optional[Tuple[int, int]] = None
    stack_height_limit: int = 1
    # runtime state
    current_step: int = field(default=0, compare=False)

    def step_active(self) -> bool:
        if self.debug_step is None:
            return True
        lo, hi = self.debug_step
        return lo <= self.current_step <= hi

    def op_checked(self, name: str) -> bool:
        if self.skipped_op_list and name in self.skipped_op_list:
            return False
        if self.checked_op_list:
            return name in self.checked_op_list
        return True


def _stats(t: torch.Tensor, full: bool) -> dict:
    """NaN and Inf counts of ``t`` and, with ``full`` or when it holds
    either, min, max, mean and abs-mean over its finite values in f32,
    reduced on the device: one flag read for a finite tensor, one copy of
    seven numbers otherwise."""
    if not full and bool(torch.isfinite(t).all()):
        return {"num_nan": 0, "num_inf": 0}
    f = t.detach().float()
    nan, inf = torch.isnan(f).sum(), torch.isinf(f).sum()
    finite = torch.isfinite(f)
    n = finite.sum()
    masked = torch.where(finite, f, 0.0)
    big = torch.finfo(torch.float32).max
    row = torch.stack([
        nan.float(), inf.float(), n.float(),
        torch.where(finite, f, big).min() if f.numel() else f.new_zeros(()),
        torch.where(finite, f, -big).max() if f.numel() else f.new_zeros(()),
        masked.sum() / n.clamp_min(1), masked.abs().sum() / n.clamp_min(1),
    ]).tolist()
    has = row[2] > 0
    return {"num_nan": int(row[0]), "num_inf": int(row[1]),
            "min": row[3] if has else None, "max": row[4] if has else None,
            "mean": row[5] if has else None,
            "abs_mean": row[6] if has else None}


class _TensorChecker:
    def __init__(self, config: TensorCheckerConfig):
        self.config = config
        self.found: List[dict] = []
        self._dump_fh = None
        self._op_serial: dict = {}
        if config.output_dir:
            os.makedirs(config.output_dir, exist_ok=True)
            self._dump_fh = open(
                os.path.join(config.output_dir, "tensor_stats.jsonl"), "w")

    def close(self):
        if self._dump_fh:
            self._dump_fh.close()
            self._dump_fh = None

    def __call__(self, name: str, values):
        cfg = self.config
        if not cfg.step_active() or not cfg.op_checked(name):
            return
        serial = self._op_serial.get(name, 0)
        self._op_serial[name] = serial + 1
        dump_all = cfg.debug_mode == DebugMode.DUMP_ALL
        for idx, v in enumerate(values):
            if not v.is_floating_point():
                continue
            st = _stats(v, dump_all)
            num_nan, num_inf = st["num_nan"], st["num_inf"]
            rec = None
            if num_nan or num_inf or dump_all:
                rec = {"step": cfg.current_step, "op": name,
                       "serial": serial, "output": idx,
                       "dtype": str(v.dtype).replace("torch.", ""),
                       "shape": list(v.shape), **st}
            if rec is not None and self._dump_fh is not None:
                self._dump_fh.write(json.dumps(rec) + "\n")
            if num_nan or num_inf:
                self.found.append(rec)
                msg = (f"[tensor checker] op '{name}' output {idx} has "
                       f"{num_nan} NaN / {num_inf} Inf "
                       f"(step {cfg.current_step}, dtype {rec['dtype']})")
                if cfg.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT:
                    if self._dump_fh:
                        self._dump_fh.flush()
                    from ..base.enforce import PreconditionNotMetError

                    raise PreconditionNotMetError(msg)
                get_logger().warning(msg)


_checker: Optional[_TensorChecker] = None
_last_findings: List[dict] = []


def enable_tensor_checker(checker_config: TensorCheckerConfig) -> None:
    """reference amp/debugging.py:654 — install the per-op checker."""
    global _checker, _last_findings
    if not checker_config.enable:
        return
    disable_tensor_checker()
    _last_findings = []
    _checker = _TensorChecker(checker_config)
    _chain_observer()


def disable_tensor_checker() -> None:
    """reference amp/debugging.py:695 — uninstall; the findings stay
    readable through :func:`tensor_checker_results` until the next
    enable."""
    global _checker, _last_findings
    if _checker is not None:
        _checker.close()
        _last_findings = list(_checker.found)
    _checker = None
    _chain_observer()


def tensor_checker_results() -> List[dict]:
    """NaN/Inf findings of the active checker, or, after
    :func:`disable_tensor_checker`, of the last session."""
    return list(_checker.found) if _checker else list(_last_findings)


def advance_step(step: Optional[int] = None) -> None:
    """Advance (or set) the checker's training-step counter: one call per
    optimizer step, so ``debug_step`` windows line up."""
    if _checker is not None:
        cfg = _checker.config
        cfg.current_step = step if step is not None else cfg.current_step + 1


# ---- operator stats (reference :481/:519/:560) ------------------------------

_op_stats: Optional[dict] = None
_BUCKETS = {torch.bfloat16: "bf16", torch.float16: "fp16",
            torch.float32: "fp32"}


def _dtype_bucket(values) -> str:
    for v in values:
        bucket = _BUCKETS.get(v.dtype)
        if bucket is not None:
            return bucket
    return "other"


def enable_operator_stats_collection() -> None:
    """reference amp/debugging.py:481 — start counting op calls per output
    dtype (bf16/fp16/fp32/other)."""
    global _op_stats
    _op_stats = {}
    _chain_observer()


def disable_operator_stats_collection() -> None:
    """reference amp/debugging.py:519 — stop and log the table."""
    global _op_stats
    stats, _op_stats = _op_stats, None
    _chain_observer()
    if stats is not None:
        _print_operator_stats(stats)


def get_operator_stats() -> dict:
    """The live table, ``{op: {bucket: count}}`` (a copy)."""
    return {k: dict(v) for k, v in (_op_stats or {}).items()}


def _print_operator_stats(stats: dict) -> None:
    log = get_logger()
    log.info("<%s op list %s>", "-" * 40, "-" * 40)
    log.info("%-40s | %-10s | %-10s | %-10s | %-10s",
             "Op Name", "FP16", "BF16", "FP32", "Other")
    for op in sorted(stats):
        c = stats[op]
        log.info("%-40s | %-10d | %-10d | %-10d | %-10d", op,
                 c.get("fp16", 0), c.get("bf16", 0), c.get("fp32", 0),
                 c.get("other", 0))
    log.info("<%s op count: %d %s>", "-" * 36, len(stats), "-" * 36)


@contextlib.contextmanager
def collect_operator_stats():
    """reference amp/debugging.py:560 — scoped stats collection."""
    enable_operator_stats_collection()
    try:
        yield
    finally:
        disable_operator_stats_collection()


# ---- observer plumbing ------------------------------------------------------

def _observer(name, values):
    if _op_stats is not None:
        counts = _op_stats.setdefault(name, {})
        bucket = _dtype_bucket(values)
        counts[bucket] = counts.get(bucket, 0) + 1
    if _checker is not None:
        _checker(name, values)


def _chain_observer() -> None:
    hooks.op_observer = (
        _observer if (_checker is not None or _op_stats is not None) else None)


# ---- two-run accuracy compare (reference :595) ------------------------------

def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str, loss_scale: float = 1,
                     dump_all_tensors: bool = False) -> List[dict]:
    """reference amp/debugging.py:595 — pair the per-op statistics dumps of
    two runs of one script (written by a DUMP_ALL checker's
    ``output_dir``) and rank ops by divergence, most divergent first;
    writes a CSV. ``loss_scale`` is the scale the second run (the
    low-precision one) trained under: its statistics are divided by it.
    Ops pair by (op, serial, output), so the two runs must execute the same
    program."""
    if dump_all_tensors:
        raise NotImplementedError("dump_all_tensors is not supported")

    def load(path):
        fname = path if path.endswith(".jsonl") else os.path.join(
            path, "tensor_stats.jsonl")
        out = {}
        with open(fname) as f:
            for line in f:
                rec = json.loads(line)
                out[(rec["op"], rec["serial"], rec["output"])] = rec
        return out

    a, b = load(dump_path), load(another_dump_path)
    rows = []
    for key in sorted(a.keys() & b.keys()):
        ra, rb = a[key], b[key]
        row = {"op": key[0], "serial": key[1], "output": key[2],
               "dtype_a": ra["dtype"], "dtype_b": rb["dtype"],
               "num_nan_a": ra["num_nan"], "num_nan_b": rb["num_nan"],
               "num_inf_a": ra["num_inf"], "num_inf_b": rb["num_inf"]}
        divergence = 0.0
        for stat in ("mean", "abs_mean", "min", "max"):
            va, vb = ra.get(stat), rb.get(stat)
            row[f"{stat}_a"], row[f"{stat}_b"] = va, vb
            if va is None or vb is None:
                continue
            vb = vb / loss_scale  # unscale the low-precision run only
            denom = max(abs(va), abs(vb), 1e-12)
            divergence = max(divergence, abs(va - vb) / denom)
        if (row["num_nan_a"] != row["num_nan_b"]
                or row["num_inf_a"] != row["num_inf_b"]):
            divergence = float("inf")
        row["divergence"] = divergence
        rows.append(row)
    rows.sort(key=lambda r: (-r["divergence"]
                             if r["divergence"] != float("inf")
                             else float("-inf"), r["op"]))
    cols = ["op", "serial", "output", "divergence", "dtype_a", "dtype_b",
            "mean_a", "mean_b", "abs_mean_a", "abs_mean_b", "min_a", "min_b",
            "max_a", "max_b", "num_nan_a", "num_nan_b", "num_inf_a",
            "num_inf_b"]
    with open(output_filename, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(c, "")) for c in cols) + "\n")
    return rows
