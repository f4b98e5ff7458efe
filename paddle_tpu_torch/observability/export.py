"""Telemetry egress (port of ``paddle_tpu/observability/export.py``):
scrapeable exposition of the process metrics and trace.

- :func:`prometheus_text`: ``MetricsRegistry.snapshot()`` rendered as
  Prometheus text exposition (version 0.0.4): counters as ``*_total``,
  gauges as gauges, histograms as summaries (quantile lines omitted, never
  NaN, when the ring is empty), collected namespaces flattened to their
  numeric leaves, plus process metadata (``paddle_process_info`` with the
  pid, the torch version, the device and the Python version, and
  ``paddle_process_uptime_seconds``).
- :class:`TelemetryServer`: a stdlib ``http.server`` on a daemon thread,
  serving

  ==================  ====================================================
  ``/metrics``        Prometheus text
  ``/healthz``        liveness JSON; with a ``health_fn`` (the serving
                      engine's) it carries queue depth, scheduler worker
                      liveness, ``compiles_after_warmup``, open circuits
                      and the KV pool, and answers 503 when it says not ok
  ``/snapshot.json``  the full ``snapshot()`` dict
  ``/trace.json``     the chrome-trace timeline of host spans
  ==================  ====================================================

``DecodeEngine(serve_telemetry_port=...)`` (default ``FLAGS_telemetry_port``)
starts one over its engine health. Every endpoint only reads shared state
under the instruments' own short locks, so a scrape never blocks the
scheduler thread.
"""
from __future__ import annotations

import json
import logging
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

from .locks import named_lock

_log = logging.getLogger("paddle_tpu_torch")

__all__ = ["TelemetryServer", "process_metadata", "prometheus_text"]

_PROC_T0_UNIX = time.time()

# --------------------------------------------------------------- exposition
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    s = _NAME_BAD.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return "paddle_" + s


def _prom_label_value(v) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace('"', r'\"')


def _prom_labels(labels: dict, extra: Optional[dict] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_NAME_BAD.sub("_", str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(merged.items()))
    return "{" + inner + "}"


def _is_number(v) -> bool:
    # bools are ints in python; export them as 0/1 numbers
    return isinstance(v, (int, float)) and v == v  # NaN never leaves


def _prom_value(v):
    # a bool Gauge/Counter value must land as 0/1, never "True"/"False"
    # (a single unparseable literal rejects the whole scrape page)
    return int(v) if isinstance(v, bool) else v


def _flatten_numeric(prefix: str, payload, out: list) -> None:
    """Collected-namespace flattening: every numeric leaf becomes one
    sample line; None leaves are OMITTED (the empty-percentile contract —
    a quantile with no data has no line, it is never NaN)."""
    if isinstance(payload, dict):
        for k, v in sorted(payload.items(), key=lambda kv: str(kv[0])):
            _flatten_numeric(f"{prefix}_{_NAME_BAD.sub('_', str(k))}", v, out)
    elif isinstance(payload, bool):
        out.append((prefix, int(payload)))
    elif _is_number(payload):
        out.append((prefix, payload))
    # None / str / list leaves carry no sample


def process_metadata() -> dict:
    """Pid, torch version, device and uptime: the scrape-side identity of
    this process (which worker is this, is it the torch build we deployed,
    on which card, did it restart since the last scrape). The device is
    ``torch.cuda.get_device_name()`` where the process has a CUDA device,
    else ``"cpu"``."""
    import os
    import sys

    import torch

    return {"pid": os.getpid(),
            "python_version": ".".join(map(str, sys.version_info[:3])),
            "start_time_unix": _PROC_T0_UNIX,
            "uptime_s": time.time() - _PROC_T0_UNIX,
            "torch_version": torch.__version__,
            "device": (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")}


def prometheus_text(snapshot: Optional[dict] = None) -> str:
    """Render a ``MetricsRegistry.snapshot()`` (default: the process
    registry's) as Prometheus text exposition."""
    if snapshot is None:
        from .metrics import registry

        snapshot = registry.snapshot()
    lines: List[str] = []
    for name, payload in sorted(snapshot.get("metrics", {}).items()):
        kind = payload.get("type")
        pname = _prom_name(name)
        if kind == "counter":
            lines.append(f"# TYPE {pname}_total counter")
            for cell in payload.get("values", []):
                if not _is_number(cell.get("value")):
                    continue
                labels = _prom_labels(cell.get("labels", {}))
                lines.append(
                    f"{pname}_total{labels} {_prom_value(cell['value'])}")
        elif kind == "gauge":
            lines.append(f"# TYPE {pname} gauge")
            for cell in payload.get("values", []):
                if not _is_number(cell.get("value")):
                    continue
                labels = _prom_labels(cell.get("labels", {}))
                lines.append(f"{pname}{labels} {_prom_value(cell['value'])}")
        elif kind == "histogram":
            # exposed as a Prometheus summary: quantiles + _sum + _count.
            # The empty-ring contract: a percentile that is None has its
            # quantile line OMITTED — a scraper sees a countable series
            # with no quantiles, never a NaN sample.
            cells = payload.get("values", [])
            if cells:  # a never-observed histogram emits nothing at all
                lines.append(f"# TYPE {pname} summary")
            for cell in cells:
                labels = cell.get("labels", {})
                for q, key in ((0.5, "p50"), (0.99, "p99")):
                    v = cell.get(key)
                    if _is_number(v):
                        ql = _prom_labels(labels, {"quantile": q})
                        lines.append(f"{pname}{ql} {v}")
                base = _prom_labels(labels)
                sv = cell.get("sum", 0.0)
                if _is_number(sv):  # a NaN observation poisons the sum;
                    lines.append(f"{pname}_sum{base} {sv}")  # omit, never NaN
                lines.append(f"{pname}_count{base} {cell.get('count', 0)}")
        else:  # collected namespace: flatten numeric leaves
            flat: list = []
            _flatten_numeric(pname, {k: v for k, v in payload.items()
                                     if k != "type"}, flat)
            for fname, value in flat:
                lines.append(f"{fname} {value}")
    meta = process_metadata()
    lines.append("# TYPE paddle_process_info gauge")
    info_labels = _prom_labels({
        "pid": meta["pid"], "torch_version": meta["torch_version"],
        "device": meta["device"],
        "python_version": meta["python_version"]})
    lines.append(f"paddle_process_info{info_labels} 1")
    lines.append("# TYPE paddle_process_start_time_seconds gauge")
    lines.append(f"paddle_process_start_time_seconds {meta['start_time_unix']}")
    lines.append("# TYPE paddle_process_uptime_seconds gauge")
    lines.append(f"paddle_process_uptime_seconds {meta['uptime_s']}")
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ server
class _Handler(BaseHTTPRequestHandler):
    server_version = "paddle-telemetry/1.0"

    def _send(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        srv: "TelemetryServer" = self.server.telemetry  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        try:
            if path == "/metrics":
                body = prometheus_text(srv.registry.snapshot()).encode()
                self._send(200, body,
                           "text/plain; version=0.0.4; charset=utf-8")
            elif path == "/snapshot.json":
                body = json.dumps(srv.registry.snapshot(),
                                  default=str).encode()
                self._send(200, body, "application/json")
            elif path == "/trace.json":
                body = json.dumps(srv.tracer.to_chrome_trace()).encode()
                self._send(200, body, "application/json")
            elif path == "/healthz":
                payload = srv.health()
                code = 200 if payload.get("ok", True) else 503
                self._send(code, json.dumps(payload).encode(),
                           "application/json")
            else:
                self._send(404, b'{"error": "not found"}',
                           "application/json")
        except Exception as e:  # a broken endpoint must answer, not hang
            try:
                self._send(500, json.dumps(
                    {"error": f"{type(e).__name__}: {e}"}).encode(),
                    "application/json")
            except Exception:
                pass

    def log_message(self, fmt, *args):  # stderr-per-request is noise
        _log.debug("telemetry http: " + fmt, *args)


class TelemetryServer:
    """The egress thread: ``start()`` binds ``host:port`` (port 0 = pick
    an ephemeral one, the test/bench path) and serves until ``stop()``.
    ``health_fn`` is a zero-arg callable merged into ``/healthz`` (the
    serving engine passes its ``telemetry_health``; ``ok=False`` in it
    turns the endpoint 503)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1", *,
                 tracer=None, registry=None,
                 health_fn: Optional[Callable[[], dict]] = None):
        if tracer is None:
            from .tracing import tracer
        if registry is None:
            from .metrics import registry
        self.tracer = tracer
        self.registry = registry
        self.health_fn = health_fn
        self.host = host
        self.port = int(port)
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        httpd = ThreadingHTTPServer((self.host, self.port), _Handler)
        httpd.daemon_threads = True
        httpd.telemetry = self  # type: ignore[attr-defined]
        self.port = httpd.server_address[1]
        self._httpd = httpd
        self._thread = threading.Thread(
            target=httpd.serve_forever, name="paddle-telemetry-exporter",
            daemon=True)
        self._thread.start()
        from .metrics import registry as proc_registry

        proc_registry.counter(
            "telemetry.exporter_starts",
            "telemetry HTTP exporter threads started this process").inc()
        _log.info("telemetry exporter serving on %s", self.url)
        return self

    def stop(self) -> None:
        httpd, thread = self._httpd, self._thread
        self._httpd = self._thread = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ------------------------------------------------------------ endpoints
    def health(self) -> dict:
        payload = {"ok": True, "pid": process_metadata()["pid"],
                   "uptime_s": round(time.time() - _PROC_T0_UNIX, 3)}
        if self.health_fn is not None:
            try:
                payload.update(self.health_fn())
            except Exception as e:
                payload["ok"] = False
                payload["health_error"] = f"{type(e).__name__}: {e}"
        return payload

    def scrape(self, path: str = "/metrics",
               timeout: float = 10.0) -> "tuple[int, str]":
        """In-process GET against this server: returns ``(status,
        body)``."""
        import http.client

        conn = http.client.HTTPConnection(self.host, self.port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            return resp.status, resp.read().decode()
        finally:
            conn.close()
