"""The port's telemetry (``paddle_tpu_torch.observability``) against the
JAX package's, and the decode engine's exporter.

- ``prometheus_text`` of one snapshot equals JAX's text line for line but
  the process metadata (which names torch and the device where JAX names
  jax and its backend), and the port's registry renders as JAX's does;
- ``TelemetryServer`` on port 0 serves ``/metrics``, ``/snapshot.json``,
  ``/trace.json`` and ``/healthz`` (503 when the health callback says not
  ok or raises), 404 elsewhere;
- ``DecodeEngine(serve_telemetry_port=0)`` serves its health, the serving
  counters and its ``serving.decode`` spans over HTTP and stops the
  exporter at shutdown; an explicit port that cannot bind raises with no
  scheduler thread started; a ``FLAGS_telemetry_port`` that cannot bind
  logs and the engine serves on;
- device-trace capture raises ``NotImplementedError`` naming the
  ROADMAP; the lock witness records acquires and an order inversion.
"""
import json
import logging
import os
import re

import numpy as np
import pytest

from paddle_tpu.observability import export as jax_export
from paddle_tpu.observability import metrics as jax_metrics
from paddle_tpu_torch.base.flags import set_flags
from paddle_tpu_torch.models.gpt import GPTForCausalLM, gpt_tiny
from paddle_tpu_torch.observability import export, locks, metrics, tracer
from paddle_tpu_torch.serving import DecodeEngine

_PROM_LINE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
    r'(\{[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*"(,[a-zA-Z0-9_]+="(?:[^"\\]|\\.)*")*\})?'
    r" \S+$")
ENGINE = dict(max_slots=2, max_seq=64, seq_buckets=[32, 64],
              prefill_max_batch=2, page_size=32)


def assert_valid_prometheus(text):
    """Every line is a comment or a parseable sample; no NaN."""
    lines = [ln for ln in text.splitlines() if ln]
    assert lines
    for ln in lines:
        if ln.startswith("#"):
            continue
        assert _PROM_LINE.match(ln), f"bad exposition line: {ln!r}"
        v = float(ln.rsplit(" ", 1)[1])
        assert v == v, f"NaN sample leaked: {ln!r}"
    return lines


def _fill(reg):
    reg.counter("req.count").inc(3, tenant="a")
    reg.counter("req.count").inc(1, tenant='we"ird\\te\nnant')
    reg.counter("flag.count").inc(True)
    reg.gauge("queue.depth").set(7)
    reg.gauge("alive").set(True)
    h = reg.histogram("latency.ms")
    for v in (1.0, 2.0, 5.0):
        h.observe(v)
    h.observe(4.0, tenant="b")
    reg.histogram("odd").observe(float("nan"))
    reg.histogram("never.observed")
    reg.register_collector("silo", lambda: {
        "requests": 4, "p50_ms": None, "note": "text",
        "nested": {"ok": True, "ratio": 0.5}})
    reg.register_collector("broken", lambda: 1 / 0)
    return reg


def _without_metadata(text):
    return [ln for ln in text.splitlines()
            if "paddle_process_" not in ln]


def test_prometheus_text_equals_jax_but_metadata():
    port_snap = _fill(metrics.MetricsRegistry()).snapshot()
    jax_snap = _fill(jax_metrics.MetricsRegistry()).snapshot()
    port_text = export.prometheus_text(port_snap)
    assert_valid_prometheus(port_text)
    want = _without_metadata(jax_export.prometheus_text(jax_snap))
    assert _without_metadata(port_text) == want
    # one snapshot, both renderers
    assert _without_metadata(export.prometheus_text(jax_snap)) == want
    assert 'paddle_req_count_total{tenant="a"} 3' in want
    assert "paddle_odd_count 1" in want


def test_process_metadata_names_torch_and_the_device():
    import torch

    lines = assert_valid_prometheus(
        export.prometheus_text(metrics.MetricsRegistry().snapshot()))
    info = [ln for ln in lines if ln.startswith("paddle_process_info")]
    assert len(info) == 1
    assert f'pid="{os.getpid()}"' in info[0]
    assert f'torch_version="{torch.__version__}"' in info[0]
    assert 'device="cpu"' in info[0]
    assert any(ln.startswith("paddle_process_uptime_seconds ")
               for ln in lines)


def test_histogram_empty_ring_contract():
    h = metrics.Histogram("h")
    assert h.summary() is None
    h.observe(1.0, tenant="a")
    assert h.summary(tenant="b") is None
    assert h.summary(tenant="a")["p50"] == 1.0


def test_registry_kind_collision_is_recorded():
    reg = metrics.MetricsRegistry()
    c = reg.counter("x")
    assert reg.counter("x") is c
    g = reg.gauge("x")
    assert g is not c and reg.snapshot()["collisions"] == [
        ["x", "gauge", "counter"]]


# ------------------------------------------------------------------- server
@pytest.fixture
def fresh_tracer():
    tracer.reset()
    was = tracer.enabled
    yield tracer
    tracer.enabled = was
    tracer.reset()


def test_server_endpoints_roundtrip(fresh_tracer):
    fresh_tracer.enable()
    with fresh_tracer.span("demo.span", track="host"):
        pass
    with export.TelemetryServer(port=0) as srv:
        assert srv.running and srv.port > 0
        status, body = srv.scrape("/metrics")
        assert status == 200
        assert_valid_prometheus(body)
        status, body = srv.scrape("/snapshot.json")
        assert status == 200 and "metrics" in json.loads(body)
        status, body = srv.scrape("/trace.json")
        names = [e["name"] for e in json.loads(body)["traceEvents"]]
        assert status == 200 and "demo.span" in names
        status, body = srv.scrape("/healthz")
        assert status == 200 and json.loads(body)["ok"] is True
        assert srv.scrape("/nope")[0] == 404
    assert not srv.running


def test_health_fn_gates_status():
    with export.TelemetryServer(port=0, health_fn=lambda: {
            "ok": False, "worker_alive": False}) as srv:
        status, body = srv.scrape("/healthz")
        assert status == 503 and json.loads(body)["worker_alive"] is False

    def broken():
        raise RuntimeError("dead engine")

    with export.TelemetryServer(port=0, health_fn=broken) as srv:
        status, body = srv.scrape("/healthz")
        assert status == 503
        assert "dead engine" in json.loads(body)["health_error"]


def test_capture_device_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tracer.capture_device()


def test_lock_witness_records_inversion():
    a, b = locks.named_lock("test.witness.a"), locks.named_lock(
        "test.witness.b")
    was = locks.set_witness(True)
    try:
        with a, b:
            pass
        with b, a:
            pass
        report = locks.witness_report()
    finally:
        locks.set_witness(was)
        locks.witness_reset()
    assert report["acquires"]["test.witness.a"] == 2
    assert "test.witness.b" in report["edges"]["test.witness.a"]
    inversions = [v for v in report["violations"]
                  if v["kind"] == "lock_inversion"]
    assert [v["edge"] for v in inversions] == [
        ["test.witness.b", "test.witness.a"]]
    assert locks.registered_locks()["test.witness.a"] >= 1


# ---------------------------------------------------------- engine exporter
@pytest.fixture(scope="module")
def model():
    import torch

    return GPTForCausalLM(gpt_tiny(num_hidden_layers=1, hidden_size=16,
                                   num_attention_heads=2,
                                   max_position_embeddings=64),
                          device="cpu",
                          generator=torch.Generator().manual_seed(0)).eval()


def test_engine_serves_telemetry_on_port_0(model, fresh_tracer):
    set_flags({"telemetry_trace": True})
    engine = DecodeEngine(model, device="cpu", serve_telemetry_port=0,
                          **ENGINE)
    try:
        assert engine.telemetry_url is None
        engine.warmup()
        srv = engine._telemetry_server
        assert engine.telemetry_url == srv.url
        rs = np.random.RandomState(0)
        out = engine.submit("a", rs.randint(0, 512, 5), 3).result(60)
        assert out.shape == (3,)
        engine.swap_weights(model)
        status, body = srv.scrape("/healthz")
        payload = json.loads(body)
        assert status == 200 and payload["ok"] is True
        assert payload["worker_alive"] is True
        assert payload["compiles_after_warmup"] == 0
        assert payload["kv_pages_in_use"] == 0
        assert payload["health"] == "ok"
        status, body = srv.scrape("/metrics")
        lines = assert_valid_prometheus(body)
        assert status == 200
        for name in ("paddle_serving_weight_swaps_total",
                     'paddle_serving_admitted_total{tenant="a"}',
                     "paddle_serving_kv_pages_in_use",
                     "paddle_serving_requests"):
            assert any(ln.startswith(name) for ln in lines), name
        status, body = srv.scrape("/snapshot.json")
        assert status == 200
        assert "serving.weight_swaps" in json.loads(body)["metrics"]
        status, body = srv.scrape("/trace.json")
        events = json.loads(body)["traceEvents"]
        kinds = {e["args"]["kind"] for e in events
                 if e["name"] == "serving.decode"}
        assert {"prefill", "decode"} <= kinds
    finally:
        set_flags({"telemetry_trace": False})
        engine.shutdown(drain=True)
    assert engine.telemetry_url is None and not srv.running
    assert tracer.enabled is False


def test_no_exporter_by_default(model):
    engine = DecodeEngine(model, device="cpu", **ENGINE).warmup()
    try:
        assert engine.telemetry_url is None
    finally:
        engine.shutdown(drain=True)


def test_port_collisions(model, caplog):
    """An explicit port that cannot bind raises before the scheduler
    thread starts; the flag's port only degrades."""
    squatter = export.TelemetryServer(port=0).start()
    try:
        engine = DecodeEngine(model, device="cpu",
                              serve_telemetry_port=squatter.port, **ENGINE)
        with pytest.raises(OSError):
            engine.warmup()
        assert not engine._scheduler.alive() and not engine._started
        set_flags({"telemetry_port": squatter.port})
        try:
            engine = DecodeEngine(model, device="cpu", **ENGINE)
            with caplog.at_level(logging.WARNING, logger="paddle_tpu_torch"):
                engine.warmup()
            try:
                assert engine.telemetry_url is None
                assert "serving continues without egress" in caplog.text
                out = engine.submit("a", [1, 2, 3], 2).result(60)
                assert out.shape == (2,)
            finally:
                engine.shutdown(drain=True)
        finally:
            set_flags({"telemetry_port": 0})
    finally:
        squatter.stop()
