"""Serving of the port (``paddle_tpu.serving`` parity).

- Batch tier: ``ServingEngine`` serves a ``jit.save`` export through
  ``inference.Predictor``: continuous bucketed batching, one CUDA graph a
  (batch, seq) rung, per-tenant clones, hot weight swaps
  (``engine.py``, ``scheduler.py`` ``Scheduler``).
- Decode tier: continuous-batching GPT decode over a paged or slot KV
  pool, greedy or sampled, with self-speculative decoding
  (``decode.py``).
"""
from .decode import DecodeEngine, DecodePrograms, PagedDecodePrograms
from .engine import EngineBase, ServingEngine
from .kv_cache import KVPagePool, KVSlotPool
from .request_queue import (AdmissionController, AdmissionError,
                            DecodeRequest, RejectedError, Request,
                            RequestQueue)
from .scheduler import (DecodeScheduler, Scheduler, fetch_outputs,
                        scatter_outputs, stack_requests)

__all__ = ["DecodeEngine", "DecodePrograms", "PagedDecodePrograms",
           "EngineBase", "ServingEngine", "KVPagePool", "KVSlotPool",
           "AdmissionController", "AdmissionError", "DecodeRequest",
           "RejectedError", "Request", "RequestQueue", "DecodeScheduler",
           "Scheduler", "fetch_outputs", "scatter_outputs", "stack_requests"]
