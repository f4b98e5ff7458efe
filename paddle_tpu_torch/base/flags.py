"""Process-level flags the serving path reads.

The port's copy of ``paddle_tpu/base/flags.py``, cut to the serving
flags of the decode path: same names, same defaults, each overridable by
a ``FLAGS_<name>`` environment variable.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

__all__ = ["define_flag", "get_flag"]

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "default", "value", "help", "type")

    def __init__(self, name: str, default: Any, help: str):
        self.name = name
        self.default = default
        self.help = help
        self.type = type(default)
        env = os.environ.get("FLAGS_" + name)
        self.value = _parse(env, self.type) if env is not None else default


def _parse(text: str, ty: type) -> Any:
    if ty is bool:
        return text.strip().lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(text)
    if ty is float:
        return float(text)
    return text


def define_flag(name: str, default: Any, help: str = "") -> None:
    """Register a flag (idempotent; later definitions keep the first default)."""
    with _lock:
        if name not in _registry:
            _registry[name] = _Flag(name, default, help)


def get_flag(name: str) -> Any:
    f = _registry.get(name)
    if f is None:
        raise KeyError(f"flag '{name}' is not defined")
    return f.value


define_flag("serving_max_queue", 1024,
            "serving tier: global admission cap on queued samples across "
            "tenants; a submit beyond it is rejected (AdmissionError)")
define_flag("serving_tenant_quota", 256,
            "serving tier: per-tenant cap on in-flight samples "
            "(queued + executing); <=0 disables the per-tenant gate")
define_flag("serving_max_slots", 8,
            "decode serving: the hard cap on concurrently decoding "
            "sequences (lanes of the decode batch)")
define_flag("serving_max_seq", 0,
            "decode serving: longest sequence (prompt + generated) a "
            "request may reach; 0 defers to the model's "
            "max_position_embeddings")
define_flag("serving_seq_bucket_min", 16,
            "decode serving: smallest rung of the sequence-length bucket "
            "ladder (powers of two from here up to serving_max_seq); "
            "prefill prompts pad up to their rung")
define_flag("serving_prefill_max_batch", 4,
            "decode serving: largest prefill batch rung — prompts sharing "
            "a seq rung group up to this many per prefill call")
define_flag("serving_request_ttl_ms", 0.0,
            "serving tier: expire requests whose queue wait exceeds this "
            "(AdmissionError reason='ttl') instead of executing dead "
            "work; <=0 disables")
define_flag("serving_bulk_queue_share", 0.5,
            "serving tier: fraction of serving_max_queue a bulk-tier "
            "tenant may fill — the headroom above it is reserved for "
            "interactive tiers (AdmissionController.set_tier)")
define_flag("serving_page_size", 16,
            "decode serving: tokens per KV page — KVPagePool allocates "
            "device memory in fixed pages this long; must be a power of "
            "two so the block-table ladder stays aligned")
define_flag("serving_pool_pages", 0,
            "decode serving: total pages the paged KV pool holds on the "
            "device (allocated once); 0 sizes it to max_slots * max_seq "
            "tokens")
define_flag("serving_spec_k", 0,
            "decode serving: draft tokens proposed per self-speculation "
            "round — one truncated-layer draft program proposes k tokens, "
            "one full-model verify pass scores all k+1 positions; 0 "
            "disables speculation and the draft/verify program families")
define_flag("serving_spec_draft_layers", 1,
            "decode serving: transformer layers in the truncated-layer "
            "draft prefix of self-speculative decoding (clamped to the "
            "model's layer count; the draft shares the serving weights, "
            "no copy)")
define_flag("serving_spec_min_accept", 0.3,
            "decode serving: rolling draft-acceptance floor — a "
            "speculating request whose acceptance rate drops below this "
            "fraction turns its own speculation off (the batch decodes "
            "plainly once every lane has)")
