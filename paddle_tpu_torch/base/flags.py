"""Process-level flags the serving and training paths read.

The port's copy of ``paddle_tpu/base/flags.py``, cut to the flags of the
decode path and its operational tier (telemetry, fault injection, retries,
circuit breakers, the lock witness) and of the training loop (device
prefetch, metric syncs, snapshots, the anomaly flight recorder, the memory
sampler, the numerics witness) and of the op-interception tier
(``check_nan_inf``, ``check_nan_inf_level``, ``static_verify_program``):
same names, same defaults, each
overridable by a ``FLAGS_<name>`` environment variable and at run time by
:func:`set_flags`, whose changes reach the hooks registered with
:func:`on_flag_change`.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, Mapping, Optional, Union

__all__ = ["define_flag", "disable_check_model_nan_inf",
           "disable_check_nan_inf", "enable_check_model_nan_inf",
           "enable_check_nan_inf", "get_flag", "get_flags", "on_flag_change",
           "set_flags"]

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


def get_flags(names: Optional[Union[Iterable[str], str]] = None
              ) -> Dict[str, Any]:
    """The values of the named flags (one name or several), or of every
    flag when None."""
    if names is None:
        return {k: f.value for k, f in _registry.items()}
    if isinstance(names, str):
        names = [names]
    return {n: get_flag(n) for n in names}


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


define_flag("serving_max_batch", 64,
            "serving tier: largest batch bucket — the batch ladder is the "
            "powers-of-two rungs up to this; one CUDA graph per rung "
            "(paddle_tpu_torch.serving.ServingEngine)")
define_flag("serving_batch_timeout_ms", 2.0,
            "serving tier: how long the scheduler waits for more requests "
            "before dispatching a partially filled batch (continuous "
            "batching window)")
define_flag("serving_slo_ms", 50.0,
            "serving tier: the latency SLO the stats report requests/sec "
            "against (enqueue->complete, per request)")
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
define_flag("device_prefetch", 0,
            "DataLoader default for device_prefetch=N: stage N collated "
            "batches onto the device ahead of the train loop "
            "(io/device_prefetch.py DeviceLoader); 0 disables")
define_flag("metric_sync_every", 0,
            "hapi.Model.fit default for how often (in steps) the "
            "MetricBuffer materializes device metrics to host floats; "
            "0 defers to the loop's log_freq (log-boundary syncs only)")
define_flag("train_snapshot_every", 0,
            "hapi.Model.fit default for snapshot_every: land an atomic "
            "rolling train-state snapshot (step, params, optimizer, "
            "generator states, loader cursor) every N steps into "
            "snapshot_dir; 0 disables the cadence (a preemption still "
            "snapshots)")
define_flag("train_snapshot_keep", 2,
            "reliability TrainSnapshotter: rolling window — newest N "
            "snapshots survive, older ones are pruned after each commit")
define_flag("telemetry_anomaly", False,
            "observability: feed the anomaly flight recorder "
            "(observability/anomaly.py AnomalyMonitor) at train-step "
            "close and metric-flush boundaries; off = one attribute read "
            "per boundary, zero recording")
define_flag("telemetry_dump_dir", "",
            "anomaly flight recorder: directory for forensic bundles "
            "(last-N spans + metrics snapshot + detector verdict + "
            "step-time window) dumped on a detector trigger or an "
            "uncaught train-loop exception; empty disables dumping "
            "(triggers are still counted)")
define_flag("anomaly_step_mad", 8.0,
            "anomaly flight recorder: a step slower than "
            "median + N*MAD of the rolling step-time window trips the "
            "step-time regression detector; <=0 disables it")
define_flag("anomaly_dump_cooldown_s", 60.0,
            "anomaly flight recorder: per-anomaly-kind dedup window — "
            "repeat triggers of the same kind inside it tick "
            "anomaly.suppressed instead of writing another bundle")
define_flag("anomaly_reject_burst", 16,
            "anomaly flight recorder: admission rejections within one "
            "second that count as a rejection burst; <=0 disables the "
            "burst watcher")
define_flag("cost_hbm_budget_bytes", 16 << 30,
            "anomaly flight recorder: the per-device memory budget the "
            "boundary sampler's watermark is checked against")
define_flag("telemetry_memory_sample_every", 8,
            "observability: sample device-memory telemetry (the caching "
            "allocator's allocated and peak bytes) every N-th step "
            "boundary the train loop crosses; 0 disables sampling. "
            "Boundary-only and sync-free")
define_flag("numerics_witness", False,
            "observability/numerics.py: arm the runtime NaN/Inf + "
            "dynamic-range witness — every watch() site (the TrainStep "
            "loss, GradScaler's unscaled gradients) checks finiteness and "
            "tracks a per-name max-abs watermark; off = one bool read per "
            "site")
define_flag("numerics_collapse_ratio", 1e-4,
            "numerics witness (NM1105): once a watched tensor's max-abs "
            "watermark is established, a later sample whose max-abs "
            "falls below watermark*ratio records a range-collapse "
            "verdict")
define_flag("check_nan_inf", False, "scan op outputs for NaN/Inf and raise")
define_flag("check_nan_inf_level", 0, "0: raise on nan/inf; >0: log only")
define_flag("comm_quantize_dp_grads", False,
            "sync data-parallel gradients through the blockwise-int8 "
            "all-reduce tier of collective_opt: not ported yet "
            "(ROADMAP.md, queue 7), so DataParallel raises while this is on")
define_flag("static_verify_program", False,
            "run the analysis verify pass over a static Program before "
            "Executor.run compiles it (the port has no analysis/ yet: "
            "Executor.run raises while this is on)")


def enable_check_model_nan_inf():
    """(reference op: enable_check_model_nan_inf)."""
    set_flags({"check_nan_inf": True})


def disable_check_model_nan_inf():
    """(reference op: disable_check_model_nan_inf)."""
    set_flags({"check_nan_inf": False})


enable_check_nan_inf = enable_check_model_nan_inf
disable_check_nan_inf = disable_check_model_nan_inf
