"""Tiny stdlib HTTP exporter for the metrics registry + flight recorder.

Served by ``launch/serve.py --metrics-port``.  Endpoints:

  * ``GET /metrics``       -- Prometheus text exposition format
  * ``GET /metrics.json``  -- JSON exporter
  * ``GET /trace``         -- recent traces (``?k=N``, ``?slow=1`` for
    the slowest-k view) + recorded events as JSON
  * ``GET /healthz``       -- liveness probe

Read-only, threaded, daemonized -- safe to leave attached to a serving
process.  Deliberately stdlib-only (http.server) so the obs subsystem
adds no dependencies.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .metrics import default_registry
from .trace import default_recorder

__all__ = ["MetricsServer", "start_metrics_server"]


class _Handler(BaseHTTPRequestHandler):
    registry = None
    recorder = None

    def do_GET(self):  # noqa: N802 (stdlib handler naming)
        url = urlparse(self.path)
        q = parse_qs(url.query)
        try:
            if url.path == "/metrics":
                body = self.registry.to_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif url.path == "/metrics.json":
                body = json.dumps(self.registry.to_json()).encode()
                ctype = "application/json"
            elif url.path == "/trace":
                k = int(q.get("k", ["16"])[0])
                slow = q.get("slow", ["0"])[0] not in ("0", "", "false")
                traces = (self.recorder.slowest(k) if slow
                          else self.recorder.recent(k))
                body = json.dumps({
                    "traces": [t.to_dict() for t in traces],
                    "events": self.recorder.events(k),
                }).encode()
                ctype = "application/json"
            elif url.path == "/healthz":
                body, ctype = b"ok\n", "text/plain"
            else:
                self.send_error(404)
                return
        except Exception as e:  # never take serving down from the exporter
            self.send_error(500, str(e))
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    """A threaded HTTP server exposing one registry + recorder."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 registry=None, recorder=None):
        handler = type("_BoundHandler", (_Handler,), {
            "registry": registry if registry is not None
            else default_registry(),
            "recorder": recorder if recorder is not None
            else default_recorder(),
        })
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-metrics-http",
            daemon=True)

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "MetricsServer":
        self._thread.start()
        return self

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(host: str = "127.0.0.1", port: int = 0, *,
                         registry=None, recorder=None) -> MetricsServer:
    """Create and start a metrics HTTP server; returns it (``.port`` is
    the bound port when ``port=0``)."""
    return MetricsServer(host, port, registry=registry,
                         recorder=recorder).start()
