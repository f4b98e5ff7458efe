"""Process-level flags the serving path reads.

The port's copy of ``paddle_tpu/base/flags.py``, cut to the flags of the
decode path and its operational tier (telemetry, fault injection, retries,
circuit breakers, the lock witness): same names, same defaults, each
overridable by a ``FLAGS_<name>`` environment variable and at run time by
:func:`set_flags`, whose changes reach the hooks registered with
:func:`on_flag_change`.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Mapping

__all__ = ["define_flag", "get_flag", "on_flag_change", "set_flags"]

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}
# flag name -> callbacks fired after set_flags changes it (the tracer's
# `enabled`, the fault injector, the lock witness mirror their flag)
_on_change: Dict[str, list] = {}


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


def set_flags(flags: Mapping[str, Any]) -> None:
    """Set flags (a string parses as the flag's type), then fire each
    changed flag's :func:`on_flag_change` hooks."""
    with _lock:
        for name, value in flags.items():
            f = _registry.get(name)
            if f is None:
                raise KeyError(f"flag '{name}' is not defined")
            f.value = (_parse(value, f.type)
                       if isinstance(value, str) and f.type is not str
                       else f.type(value))
    for name in flags:
        for fn in _on_change.get(name, ()):
            fn(_registry[name].value)


def on_flag_change(name: str, fn) -> None:
    """Register ``fn(new_value)`` to fire after :func:`set_flags` changes
    ``name``. The flag must already be defined."""
    if name not in _registry:
        raise KeyError(f"flag '{name}' is not defined")
    _on_change.setdefault(name, []).append(fn)


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
define_flag("telemetry_trace", False,
            "observability: record host spans (serving program calls) into "
            "the process span tracer for chrome://tracing / Perfetto export; "
            "off = one attribute read per instrumented site")
define_flag("telemetry_trace_max_events", 65536,
            "observability: span-tracer ring capacity — the trace keeps the "
            "most recent N events")
define_flag("telemetry_port", 0,
            "observability egress: default port of the serving engine's "
            "telemetry HTTP exporter (/metrics, /healthz, /snapshot.json, "
            "/trace.json) on 127.0.0.1; 0 disables it (an explicit "
            "serve_telemetry_port=0 still means 'pick an ephemeral port')")
define_flag("fault_inject", "",
            "reliability fault injection: 'site:rate:kind[:delay_ms][,...]' "
            "arms the process FaultInjector at that seeded schedule (kinds: "
            "raise, latency, corrupt; seed from FLAGS_fault_seed); empty "
            "disarms — the production default")
define_flag("fault_seed", 0,
            "reliability fault injection: seed of the per-site "
            "deterministic RNG streams — the same (seed, spec) pair replays "
            "the same fault schedule exactly")
define_flag("retry_max_attempts", 3,
            "reliability RetryPolicy default: bounded attempts per wrapped "
            "call (transient failures only; fatal errors propagate on the "
            "first attempt)")
define_flag("retry_deadline_s", 30.0,
            "reliability RetryPolicy default: wall-clock budget across all "
            "attempts of one wrapped call — no retry starts past it")
define_flag("retry_base_delay_ms", 20.0,
            "reliability RetryPolicy default: first backoff delay; doubles "
            "per attempt (deterministic, no jitter)")
define_flag("circuit_failure_threshold", 5,
            "reliability CircuitBreaker default: consecutive failures "
            "before a key (tenant) flips open and admission sheds its load "
            "(AdmissionError reason='circuit')")
define_flag("circuit_cooldown_s", 30.0,
            "reliability CircuitBreaker default: how long an open breaker "
            "sheds before half-opening for probe traffic")
define_flag("concurrency_witness", False,
            "record every named-lock acquire into the process lock-order "
            "witness (held stacks, acquire/contended/hold-time counters, "
            "order-graph edges; a cycle-closing edge is an inversion); off "
            "= one bool read per acquire")
define_flag("concurrency_max_hold_ms", 0.0,
            "lock witness: a lit-mode hold longer than this records a "
            "hold violation; <=0 disables the hold-time watcher")
