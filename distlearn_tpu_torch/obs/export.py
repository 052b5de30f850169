"""A copy of ``distlearn_tpu/obs/export.py``.

Telemetry export: JSONL snapshots and an opt-in ``/metrics`` +
``/healthz`` HTTP endpoint.

Two consumers, two formats:

* **JSONL** — :func:`write_snapshot` appends one ``{"type":
  "snapshot", ...}`` record (the full registry) to a run log; together
  with the span records ``obs.trace`` spills to the same file this is
  the trail ``tools/diststat.py`` summarizes and diffs.
* **HTTP** — :func:`start_http_server` runs a daemon thread serving
  Prometheus text on ``/metrics``, a JSON liveness document on
  ``/healthz``, and the full registry as one JSON ``snapshot`` record
  on ``/snapshot`` (the pull side of the fleet aggregation plane —
  ``obs.agg.Collector`` polls it and merges every process's registry
  into the fleet view).  The health payload comes from a pluggable
  source (:func:`set_health_source`) — the concurrent AsyncEA server
  registers ``{live_clients, inflight, drained}`` on ``start()``, so an
  external prober can distinguish "serving", "draining", and "dead"
  without parsing logs.

Everything is opt-in and honors the ``DISTLEARN_OBS`` kill switch:
disabled, :func:`write_snapshot` writes nothing and
:func:`start_http_server` returns ``None``.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

from distlearn_tpu_torch.obs import core

_health_lock = threading.Lock()
_health_source: Callable[[], dict] | None = None


def set_health_source(fn: Callable[[], dict] | None):
    """Install (or clear, with ``None``) the ``/healthz`` payload
    provider.  The callable must be cheap and thread-safe — it runs on
    the HTTP serving thread."""
    global _health_source
    with _health_lock:
        _health_source = fn


def health() -> dict:
    """The current health document (also used by ``/healthz``)."""
    with _health_lock:
        src = _health_source
    doc = {"ok": True, "ts": time.time()}
    if src is not None:
        try:
            doc.update(src())
        except Exception as e:  # a dying server must still answer probes
            doc["ok"] = False
            doc["error"] = repr(e)
    return doc


def write_snapshot(path: str) -> dict | None:
    """Append one full-registry snapshot record to ``path`` (JSONL).
    Returns the record, or ``None`` (and writes nothing) when the kill
    switch is off."""
    if not core.enabled():
        return None
    rec = core.snapshot_record()
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(rec) + "\n")
    return rec


class _Handler(BaseHTTPRequestHandler):
    def _reply(self, code: int, body: bytes, ctype: str):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802  (http.server API)
        path = self.path.split("?", 1)[0]
        if path == "/metrics":
            body = core.REGISTRY.render_prometheus().encode()
            self._reply(200, body, "text/plain; version=0.0.4")
        elif path == "/healthz":
            doc = health()
            self._reply(200 if doc.get("ok") else 503,
                        (json.dumps(doc) + "\n").encode(),
                        "application/json")
        elif path == "/snapshot":
            rec = core.snapshot_record()
            self._reply(200, (json.dumps(rec) + "\n").encode(),
                        "application/json")
        else:
            self._reply(404, b"not found\n", "text/plain")

    def log_message(self, fmt, *args):
        pass  # probes every few seconds must not spam the training logs


class ObsHTTPServer:
    """Handle for the background endpoint: ``.port`` and ``.close()``."""

    def __init__(self, host: str, port: int):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="distlearn-obs-http")
        self._thread.start()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_http_server(port: int = 0, host: str = "127.0.0.1"
                      ) -> ObsHTTPServer | None:
    """Serve ``/metrics`` and ``/healthz`` on a daemon thread.
    ``port=0`` binds an OS-assigned port (read it back from
    ``.port``).  Returns ``None`` when the kill switch is off."""
    if not core.enabled():
        return None
    return ObsHTTPServer(host, port)
