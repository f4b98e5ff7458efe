"""Decode serving of the port: continuous-batching GPT decode over a paged
or slot KV pool, greedy or sampled, with self-speculative decoding
(``paddle_tpu.serving`` parity, decode tier)."""
from .decode import DecodeEngine, DecodePrograms, PagedDecodePrograms
from .kv_cache import KVPagePool, KVSlotPool
from .request_queue import (AdmissionController, AdmissionError,
                            DecodeRequest, RejectedError, Request,
                            RequestQueue)

__all__ = ["DecodeEngine", "DecodePrograms", "PagedDecodePrograms",
           "KVPagePool", "KVSlotPool", "AdmissionController",
           "AdmissionError", "DecodeRequest", "RejectedError", "Request",
           "RequestQueue"]
